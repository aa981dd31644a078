"""Per-phase times of the v1 conv kernel (``csrc/conv3x3_stats_v1.cu``).

    python -m runet_tpu_torch.utils.phase_probe [--source PATH] [--out PATH]

The kernel guards its three phases with a compile-time mask, ``V1_PHASES``
(1 the im2col build, 2 the weight staging, 4 the GEMM; 7 when undefined).
This builds the source (this tree's, or another checkout's with
``--source``) four times, as probe libraries that ``#define V1_PHASES`` to
7, 6, 5 and 3 and then ``#include`` the source, and times each library's
``conv3x3_stats_v1_launch`` (the conv kernel and its moment reduction) with
CUDA events at three geometries, on the same random inputs: B 2, 128³,
32→32; B 2, 32³, 128→128; B 1, 8³, 320→320. A phase's share is
1 − t(without it) / t(all). A build without a phase computes a wrong y:
only its time is read. Prints one JSON object with the ms per mask, the
shares and the card's name and power limit (also written to ``--out``).
Needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from runet_tpu_torch.kernels import build
from runet_tpu_torch.kernels.conv_common import _CONV_STATS_API, pack_weight
from runet_tpu_torch.utils.health import card_line

SOURCE = build.CSRC / "conv3x3_stats_v1.cu"
ALL = 7
# The phase each mask leaves out.
WITHOUT = {"build": 6, "weights": 5, "gemm": 3}
MASKS = (ALL, *WITHOUT.values())
# name: (B, edge of the cubic volume, Cin, Cout)
GEOMETRIES = {"128^3 32->32": (2, 128, 32, 32), "32^3 128->128": (2, 32, 128, 128),
              "8^3 320->320": (1, 8, 320, 320)}


def probe_source(source: Path, mask: int) -> str:
    """The probe's CUDA text: the phase mask, then SOURCE included."""
    return f'#define V1_PHASES {mask}\n#include "{Path(source).resolve()}"\n'


def build_probes(source: Path, masks=MASKS) -> dict[int, ctypes.CDLL]:
    """One library per mask, compiled in parallel into the build directory,
    with the launch and nblk entries bound."""
    jobs = {m: build.start_probe(probe_source(source, m), source, "phase") for m in masks}
    libs = {}
    for mask, (path, job) in jobs.items():
        if job is not None:
            build._finish_build(job)
        lib = ctypes.CDLL(str(path))
        for suffix in ("launch", "nblk"):
            fn = getattr(lib, f"conv3x3_stats_v1_{suffix}")
            fn.argtypes, fn.restype = _CONV_STATS_API[suffix]
        libs[mask] = lib
    return libs


def time_masks(libs: dict[int, ctypes.CDLL], shape, gen, n=20, rounds=3) -> dict[int, float]:
    """ms per launch of each library at (B, edge, Cin, Cout): ``rounds``
    turns over the masks, ``n`` chained launches each; the least per mask."""
    B, e, cin, cout = shape
    dev = torch.device("cuda")
    x = torch.randn((B, e, e, cin, e), generator=gen, device=dev).to(torch.bfloat16)
    k = (torch.randn((3, 3, 3, cin, cout), generator=gen, device=dev) / (27 * cin) ** 0.5
         ).to(torch.bfloat16)
    packed = pack_weight(k)
    cout_p, cin_p = packed.shape[1], packed.shape[2]
    nblk = int(next(iter(libs.values())).conv3x3_stats_v1_nblk(e, e, e))
    y = torch.empty((B, e, e, cout, e), dtype=torch.bfloat16, device=dev)
    psum = torch.empty((B, cout_p, nblk), dtype=torch.float32, device=dev)
    psq = torch.empty_like(psum)
    sums = torch.empty((B, cout), dtype=torch.float32, device=dev)
    sqs = torch.empty_like(sums)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib):
        rc = lib.conv3x3_stats_v1_launch(x.data_ptr(), packed.data_ptr(), y.data_ptr(),
                                         psum.data_ptr(), psq.data_ptr(), sums.data_ptr(),
                                         sqs.data_ptr(), B, e, cin, e, e, cout, cin_p, cout_p,
                                         stream)
        if rc != 0:
            raise RuntimeError(f"conv3x3_stats_v1 probe launch failed with CUDA error {rc}")

    best = {}
    for _ in range(rounds):
        for mask, lib in libs.items():
            for _ in range(2):
                launch(lib)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                launch(lib)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / n
            best[mask] = min(ms, best.get(mask, ms))
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", type=Path, default=SOURCE)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phase_probe: no CUDA device", file=sys.stderr)
        return 1
    libs = build_probes(args.source)
    gen = torch.Generator(device="cuda").manual_seed(0)
    geoms = {}
    for name, shape in GEOMETRIES.items():
        ms = time_masks(libs, shape, gen)
        geoms[name] = {"shape": list(shape), "ms": {str(m): ms[m] for m in MASKS},
                       "share": {ph: 1.0 - ms[m] / ms[ALL] for ph, m in WITHOUT.items()}}
    result = {"card": card_line(), "source": str(args.source), "geometries": geoms}
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
