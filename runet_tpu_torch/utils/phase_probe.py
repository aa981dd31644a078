"""Per-phase times of the v1 conv kernel (``csrc/conv3x3_stats_v1.cu``), of
the stride-1 weight-gradient kernel (``csrc/conv3x3_dw.cu``), of the attic
NDHWC conv + moments (``csrc/conv3x3_ndhwc_stats.cu``), of the attic NDHWC
conv (``csrc/conv3x3_ndhwc.cu``), of the main-path v2m conv + moments
(``csrc/conv3x3_stats.cu``), of the v2 conv + moments
(``csrc/conv3x3_stats_v2.cu``), of the stride-2 conv + moments
(``csrc/conv3x3_s2_stats.cu``) or of the stride-2 weight gradient
(``csrc/conv3x3_s2_dw.cu``).

    python -m runet_tpu_torch.utils.phase_probe [--kernel {v1,dw1,v3,conv3d,v2m,v2,s2,dw2}]
        [--source PATH] [--out PATH]

Each kernel guards its three phases with a compile-time mask, 7 when
undefined: ``V1_PHASES`` for v1 (1 the im2col build, 2 the weight staging,
4 the GEMM), ``DW1_PHASES`` for dw1 (in ``conv3x3_dw_s1.cuh``: 1 the x
staging, 2 the g staging, 4 the MMAs), ``V3_PHASES`` for v3 (in
``conv3x3_ndhwc_stats.cuh``: 1 the halo copies, 2 the weight copies, 4 the
MMAs), ``CONV3D_PHASES`` for conv3d (in ``conv3x3_ndhwc.cuh``: the same
three phases), ``V2M_PHASES`` for v2m (in ``conv3x3_stats.cuh``: 1 the halo
copies and their transpose, 2 the weight copies, 4 the MMAs),
``V2_PHASES`` for v2 (in ``conv3x3_stats_v2.cuh``: the same three phases),
``S2_PHASES`` for s2 (in ``conv3x3_s2_stats.cuh``: 1 the raw plane copies
and their transpose, 2 the weight copies, 4 the MMAs), ``DW2_PHASES`` for
dw2 (in ``conv3x3_dw_s2.cuh``: 1 the x staging, 2 the g staging, 4 the
MMAs). This builds the source (this tree's, or another checkout's with
``--source``) four times, as probe libraries that ``#define`` the mask to
7, 6, 5 and 3 and then ``#include`` the source, and times each library's
launch entry with CUDA events on the same random inputs: for v1
``conv3x3_stats_v1_launch`` (the conv kernel and its moment reduction) at B
2, 128³, 32→32; B 2, 32³, 128→128; B 1, 8³, 320→320; for dw1
``conv3x3_dw_launch`` (the dw kernel and its split reduction) at B 2, 128³,
32→32; B 2, 32³, 128→128; B 2, 16³, 256→256; for v3
``conv3x3_ndhwc_stats_launch`` (the conv kernel and its moment reduction) at
the kernel bench's ``fine_l2`` (B 1, 32³, 128→128) and ``fine_l3`` (B 1,
16³, 256→256); for conv3d ``conv3x3_ndhwc_launch`` at the kernel bench's
``fine_l0`` (B 1, 128³, 32→32) and ``fine_l2``; for v2m
``conv3x3_stats_launch`` (the conv kernel and its moment reduction) at
``fine_l2``, ``fine_l3`` and B 2, 128³, 32→32, for v2
``conv3x3_stats_v2_launch`` at the same three, for s2
``conv3x3_s2_stats_launch`` at fine_kits' level-0, 2 and 3 down convs, x
(2, 128, 32, 128, 128)→64, (2, 32, 128, 32, 32)→256 and (2, 16, 256, 16,
16)→320, and at renal_anatomy's x (1, 24, 256, 12, 20)→320 (W = 20: element
loads); for dw2 ``conv3x3_s2_dw_launch`` (the dw kernel and its split
reduction) at the four main-path levels of fine_kits' down convs, x (2, 128,
32, 128, 128)→64, (2, 64, 64, 64, 64)→128, (2, 32, 128, 32, 32)→256 and (2,
16, 256, 16, 16)→320. A phase's share is 1 − t(without it) / t(all). A
build without a phase computes a wrong output: only its time is read.
Prints one JSON object with the ms per mask, the shares and the card's name
and power limit (also written to ``--out``). Needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from dataclasses import dataclass
from functools import partial
from pathlib import Path

import torch

from runet_tpu_torch.kernels import build
from runet_tpu_torch.kernels.conv_common import (_CONV_API, _CONV_DW_API, _CONV_STATS_API,
                                                 pack_weight)
from runet_tpu_torch.utils.health import card_line


def probe_source(source: Path, mask: int, macro: str = "V1_PHASES") -> str:
    """The probe's CUDA text: the phase mask, then SOURCE included."""
    return f'#define {macro} {mask}\n#include "{Path(source).resolve()}"\n'


def _v1_launcher(libs, shape, gen):
    """A launch of one v1 probe library at (B, edge, Cin, Cout)."""
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
        return lib.conv3x3_stats_v1_launch(x.data_ptr(), packed.data_ptr(), y.data_ptr(),
                                           psum.data_ptr(), psq.data_ptr(), sums.data_ptr(),
                                           sqs.data_ptr(), B, e, cin, e, e, cout, cin_p, cout_p,
                                           stream)
    return launch


def _conv_dw_launcher(prefix, libs, x_shape, cout, stride, gen):
    """A launch of one weight-gradient probe library, whose C entries start
    with ``prefix``, at x ``x_shape`` (B, D, C, H, W) -> ``cout`` with the
    given conv stride (g's extents are the input's over it)."""
    B, D, cin, H, W = x_shape
    dev = torch.device("cuda")
    x = torch.randn(x_shape, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn((B, D // stride, cout, H // stride, W // stride), generator=gen,
                    device=dev).to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_splits = int(getattr(next(iter(libs.values())), f"{prefix}_splits")(B, D, H, W, cin, cout,
                                                                           sms))
    part = torch.empty((n_splits, 27, cin, cout), dtype=torch.float32, device=dev)
    dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib):
        return getattr(lib, f"{prefix}_launch")(x.data_ptr(), g.data_ptr(), part.data_ptr(),
                                                dw.data_ptr(), B, D, cin, H, W, cout, n_splits,
                                                stream)
    return launch


def _dw1_launcher(libs, shape, gen):
    """A launch of one dw1 probe library at (B, edge, Cin, Cout)."""
    B, e, cin, cout = shape
    return _conv_dw_launcher("conv3x3_dw", libs, (B, e, cin, e, e), cout, 1, gen)


def _dw2_launcher(libs, shape, gen):
    """A launch of one dw2 probe library at x (B, D, Cin, H, W) -> Cout."""
    *x_shape, cout = shape
    return _conv_dw_launcher("conv3x3_s2_dw", libs, tuple(x_shape), cout, 2, gen)


def _conv_stats_launcher(prefix, libs, x_shape, cout, stride, gen):
    """A launch of one (B, D, C, H, W) conv + moments probe library, whose C
    entries start with ``prefix``, at x ``x_shape`` -> ``cout`` with the
    given conv stride (the output extents are the input's over it)."""
    B, D, cin, H, W = x_shape
    Do, Ho, Wo = D // stride, H // stride, W // stride
    dev = torch.device("cuda")
    x = torch.randn(x_shape, generator=gen, device=dev).to(torch.bfloat16)
    k = (torch.randn((3, 3, 3, cin, cout), generator=gen, device=dev) / (27 * cin) ** 0.5
         ).to(torch.bfloat16)
    packed = pack_weight(k)
    cout_p, cin_p = packed.shape[1], packed.shape[2]
    nblk = int(getattr(next(iter(libs.values())), f"{prefix}_nblk")(Do, Ho, Wo))
    y = torch.empty((B, Do, cout, Ho, Wo), dtype=torch.bfloat16, device=dev)
    psum = torch.empty((B, cout_p, nblk), dtype=torch.float32, device=dev)
    psq = torch.empty_like(psum)
    sums = torch.empty((B, cout), dtype=torch.float32, device=dev)
    sqs = torch.empty_like(sums)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib):
        return getattr(lib, f"{prefix}_launch")(x.data_ptr(), packed.data_ptr(), y.data_ptr(),
                                                psum.data_ptr(), psq.data_ptr(), sums.data_ptr(),
                                                sqs.data_ptr(), B, D, cin, H, W, cout, cin_p,
                                                cout_p, stream)
    return launch


def _dchw_launcher(prefix, libs, shape, gen):
    """A launch of one stride-1 (B, D, C, H, W) conv + moments probe library
    at (B, edge, Cin, Cout)."""
    B, e, cin, cout = shape
    return _conv_stats_launcher(prefix, libs, (B, e, cin, e, e), cout, 1, gen)


def _s2_launcher(libs, shape, gen):
    """A launch of one stride-2 probe library at x (B, D, Cin, H, W) -> Cout."""
    *x_shape, cout = shape
    return _conv_stats_launcher("conv3x3_s2_stats", libs, tuple(x_shape), cout, 2, gen)


def _ndhwc_launcher(prefix, stats, libs, shape, gen):
    """A launch of one NDHWC conv probe library, whose C entries start with
    ``prefix``, at (B, edge, Cin, Cout), with the moment scratch where
    ``stats``."""
    B, e, cin, cout = shape
    dev = torch.device("cuda")
    x = torch.randn((B, e, e, e, cin), generator=gen, device=dev).to(torch.bfloat16)
    k = (torch.randn((3, 3, 3, cin, cout), generator=gen, device=dev) / (27 * cin) ** 0.5
         ).to(torch.bfloat16)
    packed = pack_weight(k)
    cout_p, cin_p = packed.shape[1], packed.shape[2]
    y = torch.empty((B, e, e, e, cout), dtype=torch.bfloat16, device=dev)
    scratch = [None] * 4
    if stats:
        nblk = int(getattr(next(iter(libs.values())), f"{prefix}_nblk")(e, e, e))
        psum = torch.empty((B, cout_p, nblk), dtype=torch.float32, device=dev)
        sums = torch.empty((B, cout), dtype=torch.float32, device=dev)
        scratch = [psum, torch.empty_like(psum), sums, torch.empty_like(sums)]
    ptrs = [None if t is None else t.data_ptr() for t in scratch]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib):
        return getattr(lib, f"{prefix}_launch")(x.data_ptr(), packed.data_ptr(), y.data_ptr(),
                                                *ptrs, B, e, cin, e, e, cout, cin_p, cout_p,
                                                stream)
    return launch


@dataclass(frozen=True)
class Kernel:
    source: Path  # the .cu file the probe includes
    macro: str  # the phase mask it reads
    prefix: str  # the C entries' common prefix
    api: dict  # {suffix: (argtypes, restype)} of the entries bound
    without: dict  # phase name -> the mask that leaves it out
    # name -> (B, edge of the cubic volume, Cin, Cout); for s2 and dw2 x's (B, D, Cin, H, W)
    # and Cout
    geometries: dict
    launcher: object  # (libs, shape, generator) -> launch(lib) on fresh inputs


KERNELS = {
    "v1": Kernel(build.CSRC / "conv3x3_stats_v1.cu", "V1_PHASES", "conv3x3_stats_v1",
                 {k: _CONV_STATS_API[k] for k in ("launch", "nblk")},
                 {"build": 6, "weights": 5, "gemm": 3},
                 {"128^3 32->32": (2, 128, 32, 32), "32^3 128->128": (2, 32, 128, 128),
                  "8^3 320->320": (1, 8, 320, 320)}, _v1_launcher),
    "dw1": Kernel(build.CSRC / "conv3x3_dw.cu", "DW1_PHASES", "conv3x3_dw", _CONV_DW_API,
                  {"x": 6, "g": 5, "mma": 3},
                  {"128^3 32->32": (2, 128, 32, 32), "32^3 128->128": (2, 32, 128, 128),
                   "16^3 256->256": (2, 16, 256, 256)}, _dw1_launcher),
    "v3": Kernel(build.CSRC / "conv3x3_ndhwc_stats.cu", "V3_PHASES", "conv3x3_ndhwc_stats",
                 {k: _CONV_STATS_API[k] for k in ("launch", "nblk")},
                 {"halo": 6, "weights": 5, "mma": 3},
                 {"fine_l2": (1, 32, 128, 128), "fine_l3": (1, 16, 256, 256)},
                 partial(_ndhwc_launcher, "conv3x3_ndhwc_stats", True)),
    "conv3d": Kernel(build.CSRC / "conv3x3_ndhwc.cu", "CONV3D_PHASES", "conv3x3_ndhwc",
                     {"launch": _CONV_API["launch"]}, {"halo": 6, "weights": 5, "mma": 3},
                     {"fine_l0": (1, 128, 32, 32), "fine_l2": (1, 32, 128, 128)},
                     partial(_ndhwc_launcher, "conv3x3_ndhwc", False)),
    "v2m": Kernel(build.CSRC / "conv3x3_stats.cu", "V2M_PHASES", "conv3x3_stats",
                  {k: _CONV_STATS_API[k] for k in ("launch", "nblk")},
                  {"halo": 6, "weights": 5, "mma": 3},
                  {"fine_l2": (1, 32, 128, 128), "fine_l3": (1, 16, 256, 256),
                   "128^3 32->32": (2, 128, 32, 32)}, partial(_dchw_launcher, "conv3x3_stats")),
    "v2": Kernel(build.CSRC / "conv3x3_stats_v2.cu", "V2_PHASES", "conv3x3_stats_v2",
                 {k: _CONV_STATS_API[k] for k in ("launch", "nblk")},
                 {"halo": 6, "weights": 5, "mma": 3},
                 {"fine_l2": (1, 32, 128, 128), "fine_l3": (1, 16, 256, 256),
                  "128^3 32->32": (2, 128, 32, 32)}, partial(_dchw_launcher, "conv3x3_stats_v2")),
    "s2": Kernel(build.CSRC / "conv3x3_s2_stats.cu", "S2_PHASES", "conv3x3_s2_stats",
                 {k: _CONV_STATS_API[k] for k in ("launch", "nblk")},
                 {"halo": 6, "weights": 5, "mma": 3},
                 {"down_l0": (2, 128, 32, 128, 128, 64), "down_l2": (2, 32, 128, 32, 32, 256),
                  "down_l3": (2, 16, 256, 16, 16, 320), "renal W 20": (1, 24, 256, 12, 20, 320)},
                 _s2_launcher),
    "dw2": Kernel(build.CSRC / "conv3x3_s2_dw.cu", "DW2_PHASES", "conv3x3_s2_dw", _CONV_DW_API,
                  {"x": 6, "g": 5, "mma": 3},
                  {"down_l0": (2, 128, 32, 128, 128, 64), "down_l1": (2, 64, 64, 64, 64, 128),
                   "down_l2": (2, 32, 128, 32, 32, 256), "down_l3": (2, 16, 256, 16, 16, 320)},
                  _dw2_launcher),
}
SOURCE = KERNELS["v1"].source
ALL = 7
MASKS = (ALL, 6, 5, 3)


def build_probes(kernel: Kernel, source: Path, masks=MASKS) -> dict[int, ctypes.CDLL]:
    """One library per mask, compiled in parallel into the build directory,
    with the kernel's entries bound."""
    jobs = {m: build.start_probe(probe_source(source, m, kernel.macro), source, "phase")
            for m in masks}
    libs = {}
    for mask, (path, job) in jobs.items():
        if job is not None:
            build._finish_build(job)
        lib = ctypes.CDLL(str(path))
        for suffix, (argtypes, restype) in kernel.api.items():
            fn = getattr(lib, f"{kernel.prefix}_{suffix}")
            fn.argtypes, fn.restype = argtypes, restype
        libs[mask] = lib
    return libs


def time_masks(libs: dict[int, ctypes.CDLL], launch, n=20, rounds=3) -> dict[int, float]:
    """ms per launch of each library: ``rounds`` turns over the masks, ``n``
    chained launches each; the least per mask. ``launch(lib)`` returns the
    entry's CUDA error code."""
    def run(lib):
        rc = launch(lib)
        if rc != 0:
            raise RuntimeError(f"phase probe launch failed with CUDA error {rc}")

    best = {}
    for _ in range(rounds):
        for mask, lib in libs.items():
            for _ in range(2):
                run(lib)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                run(lib)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / n
            best[mask] = min(ms, best.get(mask, ms))
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="v1")
    ap.add_argument("--source", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phase_probe: no CUDA device", file=sys.stderr)
        return 1
    kernel = KERNELS[args.kernel]
    source = args.source or kernel.source
    libs = build_probes(kernel, source)
    gen = torch.Generator(device="cuda").manual_seed(0)
    geoms = {}
    for name, shape in kernel.geometries.items():
        ms = time_masks(libs, kernel.launcher(libs, shape, gen))
        geoms[name] = {"shape": list(shape), "ms": {str(m): ms[m] for m in MASKS},
                       "share": {ph: 1.0 - ms[m] / ms[ALL] for ph, m in kernel.without.items()}}
    result = {"card": card_line(), "source": str(source), "geometries": geoms}
    if args.kernel != "v1":
        result["kernel"] = args.kernel
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
