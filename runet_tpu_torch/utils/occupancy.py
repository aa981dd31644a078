"""Registers, spills and resident blocks per SM of the kernels of a CUDA source.

    python -m runet_tpu_torch.utils.occupancy SOURCE KERNEL [KERNEL ...] [--out PATH]
        [--threads EXPR] [--smem EXPR]

Builds a probe library that includes SOURCE (a ``csrc/*.cu`` file of this
tree or of another checkout), so that its kernels and constants are in
scope, and asks the CUDA runtime, for each KERNEL (a C++ expression such as
``conv3x3_stats_kernel<true>``): ``cudaFuncGetAttributes`` (registers per
thread, local memory per thread: spills and stack) and
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the source's own
``NTHREADS`` threads per block and ``SMEM_BYTES`` bytes of dynamic shared
memory, as its launcher asks for them (``--threads`` and ``--smem`` name
other C++ expressions for a source that keeps them elsewhere, such as
``convk::DwGeom<1>::NTHREADS`` and ``convk::DwS1::SMEM_BYTES`` for
``conv3x3_dw.cu``). Prints one JSON object with the card's name and power
limit (also written to ``--out``). Needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from runet_tpu_torch.kernels import build
from runet_tpu_torch.utils.health import card_line

_FIELDS = ("registers", "local_bytes", "static_smem_bytes", "blocks_per_sm")


def probe_source(source: Path, kernels: list[str], threads: str = "NTHREADS",
                 smem: str = "SMEM_BYTES") -> str:
    """The probe's CUDA text: SOURCE included, one C entry that fills the
    four figures of kernel ``which`` (at ``threads`` threads per block and
    ``smem`` bytes of dynamic shared memory) and returns a cudaError_t."""
    cases = "\n".join(f"    case {i}: f = reinterpret_cast<const void*>(&{k}); break;"
                      for i, k in enumerate(kernels))
    return f"""#include "{Path(source).resolve()}"

extern "C" int occupancy_probe(int which, int* out) {{
  const void* f = nullptr;
  switch (which) {{
{cases}
    default: return (int)cudaErrorInvalidValue;
  }}
  cudaError_t e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       {smem});
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], f, {threads}, {smem});
}}
"""


def probe(source: Path, kernels: list[str], threads: str = "NTHREADS",
          smem: str = "SMEM_BYTES") -> dict[str, dict[str, int]]:
    """{kernel: {registers, local_bytes, static_smem_bytes, blocks_per_sm}}."""
    lib_path, job = build.start_probe(probe_source(source, kernels, threads, smem), source,
                                      "occupancy")
    if job is not None:
        build._finish_build(job)
    fn = ctypes.CDLL(str(lib_path)).occupancy_probe
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    out = {}
    for i, k in enumerate(kernels):
        vals = (ctypes.c_int * len(_FIELDS))()
        e = fn(i, vals)
        if e != 0:
            raise RuntimeError(f"occupancy probe of {k} in {source}: CUDA error {e}")
        out[k] = dict(zip(_FIELDS, vals))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("source", type=Path)
    ap.add_argument("kernels", nargs="+")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--threads", default="NTHREADS")
    ap.add_argument("--smem", default="SMEM_BYTES")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("occupancy: no CUDA device", file=sys.stderr)
        return 1
    result = {"card": card_line(), "source": str(args.source),
              "kernels": probe(args.source, args.kernels, args.threads, args.smem)}
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
