"""A conv + moments, attic NDHWC conv or stride-2 weight-gradient kernel of
another checkout against this tree's.

    python -m runet_tpu_torch.utils.bit_compare OTHER_CU [--log SMOKE_LOG ...] [--time]
        [--out PATH]

OTHER_CU is ``csrc/conv3x3_stats.cu``, ``csrc/conv3x3_stats_v2.cu``, the
stride-2 ``csrc/conv3x3_s2_stats.cu``, the attic NDHWC conv
``csrc/conv3x3_ndhwc.cu`` or the stride-2 weight gradient
``csrc/conv3x3_s2_dw.cu`` of another checkout (a parent unpacked with ``git
archive``). Both libraries are built (the other one as a probe library,
this tree's as the port builds it) and loaded into one process; at every
shape both run on the same random inputs (``torch.Generator`` seed 5). A
conv + moments kernel runs through ``conv_common.launch_conv_stats`` with x
aligned and at an odd element offset (the element-load instance); each of
the change's runs, and the other library's odd-offset run, must give the
other library's aligned y, sums and sqs bit for bit (``torch.equal``); the
attic NDHWC conv likewise, with x (B, D, H, W, C) and y alone. The
weight gradient runs through ``conv_common.launch_conv_dw`` aligned, with x
at an odd offset and with g at an odd offset; each of those runs of both
libraries must give the other library's aligned dw bit for bit. The shapes,
(B, D, C, H, W, Cout) with x (B, D, C, H, W): ``DEFAULT_SHAPES`` (for the
stride-2 kernels ``S2_DEFAULT_SHAPES`` and ``S2_DW_DEFAULT_SHAPES``, even,
their output extents half the input's; for the attic NDHWC conv
``NDHWC_DEFAULT_SHAPES``, (B, D, H, W, C, Cout) with x (B, D, H, W, C)),
and every ``[kernels] <name> ...``
line of the ``chip_smoke.py`` logs given with ``--log``, so a kernel change
is held to its parent at every shape the main paths launched. With
``--time`` both libraries are also timed at each logged shape on its
aligned inputs, in turns (other, this tree, this tree, other; CUDA events
over 20 launches after 3, the least of two rounds), into ``ms``: {shape:
{"other": [t1, t2], "tree": [t1, t2]}}. Prints one JSON object with the
card's name and power limit, the count of shapes and the unequal ones (also
written to ``--out``); exits 1 if any is unequal. Needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import torch

from runet_tpu_torch.kernels import build, conv_common
from runet_tpu_torch.utils.health import card_line

KERNELS = ("conv3x3_stats", "conv3x3_stats_v2", "conv3x3_s2_stats", "conv3x3_s2_dw",
           "conv3x3_ndhwc")
DEFAULT_SHAPES = [
    (2, 4, 32, 128, 128, 32), (2, 4, 64, 64, 64, 64), (2, 4, 128, 32, 32, 128),
    (2, 4, 256, 16, 16, 256), (2, 4, 320, 8, 8, 320), (1, 5, 1, 20, 128, 32),
    (2, 3, 40, 9, 24, 48), (1, 3, 33, 7, 20, 33), (1, 4, 16, 10, 96, 160),
    (1, 3, 24, 11, 100, 64), (2, 5, 48, 7, 19, 24), (1, 3, 70, 3, 5, 40),
    (1, 2, 1, 8, 96, 32), (1, 4, 16, 8, 8, 32), (1, 3, 16, 33, 40, 96),
    (2, 3, 64, 17, 16, 64), (1, 6, 96, 18, 12, 192), (1, 2, 512, 4, 4, 64),
]
S2_DEFAULT_SHAPES = [
    (2, 4, 32, 64, 64, 64), (1, 4, 64, 32, 32, 128), (2, 4, 128, 16, 16, 256),
    (1, 4, 256, 8, 8, 320), (2, 4, 320, 8, 8, 320), (1, 2, 1, 20, 128, 32),
    (2, 4, 24, 10, 36, 48), (1, 4, 48, 12, 20, 96), (1, 6, 40, 18, 66, 96),
    (1, 2, 16, 2, 2, 32), (1, 4, 24, 16, 34, 24), (1, 2, 70, 6, 10, 40),
    (1, 4, 256, 12, 20, 320), (2, 2, 64, 18, 16, 96),
]
# The stride-2 weight gradient's: the four main-path levels at D = 8, Cout
# 96 (an odd number of 32-channel tiles), Wo = 9 (element loads), splits of
# one K-tile, a split across a d and a b boundary, two K-tiles of a split
# with and without the k-step over columns 16-31, and ragged and minimal
# extents.
S2_DW_DEFAULT_SHAPES = [
    (2, 8, 32, 128, 128, 64), (2, 8, 64, 64, 64, 128), (2, 8, 128, 32, 32, 256),
    (2, 8, 256, 16, 16, 320), (1, 4, 48, 12, 64, 96), (1, 4, 24, 10, 18, 32),
    (1, 4, 16, 8, 64, 32), (3, 4, 256, 8, 64, 320), (2, 4, 256, 8, 80, 320),
    (1, 4, 16, 6, 8, 32), (1, 4, 32, 10, 16, 64), (2, 4, 24, 8, 32, 40), (1, 2, 1, 6, 64, 32),
    (1, 4, 16, 4, 6, 24), (1, 2, 48, 6, 18, 32), (2, 2, 16, 6, 128, 32), (2, 8, 24, 6, 34, 48),
    (1, 2, 1, 2, 2, 24),
]


# The attic NDHWC conv's, (B, D, H, W, C, Cout): one shape per tile (16 x 16
# x 32 where W <= 16, else 8 x 32 x 64 where Cout_pad % 64 == 0, 8 x 32 x 32)
# and edge, as the CUDA tests hold them (W = 16 and 17, a ragged 16-row
# tile, Cout 80 with Cout_pad 96, Cin % 16 = 8, C % 8 != 0, one voxel,
# several row and column tiles), chip_smoke's odd case, and the kernel
# bench's five geometries at B = 1.
NDHWC_DEFAULT_SHAPES = [
    (1, 7, 13, 29, 5, 11), (1, 4, 8, 64, 16, 32), (1, 3, 9, 40, 24, 40), (1, 2, 5, 7, 70, 33),
    (1, 4, 12, 16, 64, 64), (1, 4, 12, 17, 64, 64), (1, 5, 13, 16, 128, 96),
    (1, 3, 9, 33, 32, 80), (1, 4, 10, 40, 32, 64), (1, 2, 9, 48, 56, 64), (1, 1, 1, 1, 16, 32),
    (2, 3, 20, 70, 32, 160), (1, 128, 128, 128, 32, 32), (1, 64, 64, 64, 64, 64),
    (1, 32, 32, 32, 128, 128), (1, 16, 16, 16, 256, 256), (1, 160, 192, 256, 32, 32),
]


def logged_shapes(text: str, name: str) -> list[tuple[int, ...]]:
    """The x shape and Cout of every ``[kernels] <name> <path> x(...)->Cout``
    line of a ``chip_smoke.py`` log: (B, D, C, H, W, Cout), for the attic
    NDHWC conv (B, D, H, W, C, Cout)."""
    pat = re.compile(rf"\[kernels\] {re.escape(name)} \S+ x\(([\d, ]+)\)->(\d+) x")
    return [(*(int(v) for v in m.group(1).split(",")), int(m.group(2)))
            for m in pat.finditer(text)]


def _other_library(source: Path, name: str, api: dict) -> ctypes.CDLL:
    path, job = build.start_probe(f'#include "{source}"\n', source, f"other_{name}")
    if job is not None:
        build._finish_build(job)
    lib = ctypes.CDLL(str(path))
    for suffix, (argtypes, restype) in api.items():
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _at_odd_offset(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def _ms(fn, n: int = 20, rounds: int = 2) -> float:
    """Least ms per call of ``fn`` over ``rounds`` runs of ``n`` launches
    (after three), by CUDA events."""
    best = float("inf")
    for _ in range(rounds):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--log", type=Path, action="append", default=[])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bit_compare: no CUDA device", file=sys.stderr)
        return 1
    name = args.other.stem
    if name not in KERNELS:
        print(f"bit_compare: {name} is not one of {KERNELS}", file=sys.stderr)
        return 1
    dw, ndhwc = name == "conv3x3_s2_dw", name == "conv3x3_ndhwc"
    api = (conv_common._CONV_DW_API if dw else
           conv_common._CONV_API if ndhwc else conv_common._CONV_STATS_API)
    other = _other_library(args.other.resolve(), name, api)
    ours = conv_common._library(name, api)
    stride = 1 if name in ("conv3x3_stats", "conv3x3_stats_v2") else 2
    shapes = list(S2_DW_DEFAULT_SHAPES if dw else NDHWC_DEFAULT_SHAPES if ndhwc else
                  S2_DEFAULT_SHAPES if stride == 2 else DEFAULT_SHAPES)
    logged = [s for log in args.log for s in logged_shapes(log.read_text(), name)]
    shapes = list(dict.fromkeys(shapes + logged))

    def run(lib, x, operand, cout):
        """One launch of ``lib``'s kernel: operand is g for the weight
        gradient, the packed weights otherwise."""
        conv_common._bound[name] = lib
        try:
            if dw:
                return (conv_common.launch_conv_dw(name, x, operand),)
            if ndhwc:
                B, D, H, W, C = x.shape
                return conv_common.launch_conv_stats(name, x, operand, cout, (D, H, W), "dhwc",
                                                     stats=False)[:1]
            B, D, C, H, W = x.shape
            return conv_common.launch_conv_stats(name, x, operand, cout,
                                                 (D // stride, H // stride, W // stride))
        finally:
            conv_common._bound[name] = ours

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    unequal, timed = [], {}
    with torch.no_grad():
        for shape in shapes:
            *x_shape, Cout = shape
            x = torch.randn(x_shape, generator=gen, device=dev).to(torch.bfloat16)
            xo = _at_odd_offset(x)
            C = x_shape[4] if ndhwc else x_shape[2]
            if dw:
                B, D, _, H, W = x_shape
                g = torch.randn((B, D // 2, Cout, H // 2, W // 2), generator=gen, device=dev
                                ).to(torch.bfloat16)
                go = _at_odd_offset(g)
                want = run(other, x, g, Cout)
                runs = [("aligned", ours, x, g), ("odd x", ours, xo, g), ("odd g", ours, x, go),
                        ("other odd x", other, xo, g), ("other odd g", other, x, go)]
            else:
                k = (torch.randn((3, 3, 3, C, Cout), generator=gen, device=dev) / (27 * C) ** 0.5
                     ).to(torch.bfloat16)
                packed = conv_common.pack_weight(k)
                want = run(other, x, packed, Cout)
                runs = [("aligned", ours, x, packed), ("odd", ours, xo, packed),
                        ("other odd", other, xo, packed)]
            for tag, lib, xx, operand in runs:
                got = run(lib, xx, operand, Cout)
                if not all(torch.equal(u, v) for u, v in zip(got, want)):
                    unequal.append({"shape": list(shape), "run": tag})
            if args.time and shape in logged:
                operand = g if dw else packed
                ms = {"other": [], "tree": []}
                for tag, lib in (("other", other), ("tree", ours), ("tree", ours),
                                 ("other", other)):
                    ms[tag].append(_ms(lambda: run(lib, x, operand, Cout)))
                timed[str(list(shape))] = ms
    torch.cuda.synchronize()
    result = {"card": card_line(), "kernel": name, "other": str(args.other),
              "shapes": len(shapes), "unequal": unequal, **({"ms": timed} if args.time else {})}
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 1 if unequal else 0


if __name__ == "__main__":
    sys.exit(main())
