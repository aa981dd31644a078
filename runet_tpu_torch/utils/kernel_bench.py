"""Kernel A/B of the port on the card at named production geometries.

    python -m runet_tpu_torch.utils.kernel_bench --out kernel_bench_out/kernel_bench.json

Counterpart of the JAX package's ``scripts/kernel_bench.py``, with its
geometries and sections. Writes one JSON object to ``--out`` and nowhere
else (``KERNEL_BENCH.json`` at the root is the JAX package's artifact).
Probes the card first (``utils/health.py``) and exits non-zero without one;
it never runs on the CPU. A row that fails ends the run with a non-zero
exit: nothing is caught and written as an error field.

Sections (bf16 activations, weights scaled by 1/sqrt(27·Cin) so a chain
keeps its magnitude; inputs from ``torch.Generator`` seed 0 on the card):

- ``rows``: one 3x3x3 stride-1 conv + Σy, Σy² at each of ``GEOMETRIES``
  (B = 1; C = Cout, so a step feeds its output back): cuDNN's bf16
  ``F.conv3d`` + sums in NCDHW (``library_ms``), the v2m, v2 and v1 kernels
  in their layouts, the attic conv (``conv3x3x3_same``, NDHWC) everywhere,
  and the attic v3 conv (``conv3x3_v3``) at ``fine_l2`` and ``fine_l3``, as
  the JAX bench does; each in ms and TFLOP/s. ``dw_l0`` and ``dw_l1``: the
  weight-gradient kernel against cuDNN's ``conv3d_weight``.
- ``norm``: the attic InstanceNorm + LeakyReLU kernels
  (``fused_instance_norm_lrelu``) on the level-0 activation (2, 128, 128,
  128, 32) against the model's plain-torch ``InstanceNorm`` +
  ``F.leaky_relu`` on the same NDHWC tensor and against
  ``F.instance_norm`` + ``F.leaky_relu`` on the same values in contiguous
  NCDHW, its own layout (``library_ms``), with GB/s against 3.35 TB/s.
- ``budget``: the ops of the fine_kits forward at 128³ that the JAX
  budget names, each timed as the port's production runs it (the stride-2
  kernel for ``down_*``, the v2m kernel for ``enc0_in``, ``bot_l4`` and
  ``cat_*``, the pixelshuffle projection + ``depth_to_space_dchw``, the f32
  head), forward and backward (grad of Σy wrt input and weight, through
  the port's autograd Functions), beside cuDNN for the convs.
- ``model_fwd``: the whole fine_kits forward at 128³ under each
  ``fused_kernel`` value.

Protocol: ``utils/latency.py::scanned_ms``, a CUDA graph of ``iters``
chained steps (30 unless named), min of 3 replays. An op whose output
shape differs from its input runs as a step that returns its input (the
graph replays every kernel, so nothing is dropped). A step that cannot be
captured is timed with ``chained_ms`` and its row's ``protocol`` says so;
``model_fwd`` is timed with ``chained_ms`` (20 calls) as the JAX bench does.
Kernel launch counters count the launches of warm-up and capture, not of
the graph's replays.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth

# name: (D, H, W, C, Cout, iters) — scripts/kernel_bench.py:372-387.
GEOMETRIES = {
    "fine_l0": (128, 128, 128, 32, 32, 30),
    "fine_l1": (64, 64, 64, 64, 64, 30),
    "fine_l2": (32, 32, 32, 128, 128, 30),
    "fine_l3": (16, 16, 16, 256, 256, 30),
    "roi_l0": (160, 192, 256, 32, 32, 10),
}
V3_ROWS = ("fine_l2", "fine_l3")
DW_GEOMETRIES = {
    "dw_l0": (128, 128, 128, 32, 32, 30),
    "dw_l1": (64, 64, 64, 64, 64, 30),
}
NORM_SHAPE = (2, 128, 128, 128, 32)
MODEL_FWD_ITERS = 20

PROTOCOL = (
    "scanned_ms: a CUDA graph of `iters` chained steps (30 unless the row names "
    "fewer), replayed 3 times, min per iteration; CUDA-event timed; bf16. Steps "
    "whose output shape differs from the input return the input (the graph replays "
    "every captured kernel; no token folding, no re-pad glue). A row with a "
    "`protocol` field was timed with chained_ms instead. model_fwd: chained_ms, 20 "
    "calls. library_ms: one cuDNN call (+ the sums) in NCDHW, never called by the port."
)


def conv_flops(vox: int, c: int, cout: int) -> float:
    return 2.0 * 27 * c * cout * vox


def _weight(gen, c: int, cout: int, dev) -> torch.Tensor:
    return (torch.randn((3, 3, 3, c, cout), generator=gen, device=dev)
            / math.sqrt(27 * c)).to(torch.bfloat16)


def _tflops(flops: float, ms: float) -> float:
    return flops / (ms * 1e-3) / 1e12


def _timed(step, x0, iters: int) -> tuple[float, str | None]:
    """(ms, protocol note or None): scanned_ms, or chained_ms when the step
    cannot be captured into a CUDA graph."""
    from runet_tpu_torch.utils.latency import CaptureError, chained_ms, scanned_ms

    try:
        return scanned_ms(step, x0, iters=iters), None
    except CaptureError as e:
        ms = chained_ms(step, (x0,), n=iters)
        return ms, f"chained_ms ({iters} calls): {str(e)[:160]}"


def _put(row: dict, key: str, step, x0, iters: int, flops: float | None = None) -> None:
    ms, note = _timed(step, x0, iters)
    row[f"{key}_ms"] = ms
    if flops is not None:
        row[f"{key}_tflops"] = _tflops(flops, ms)
    if note:
        row.setdefault("protocol", {})[key] = note


def bench_geometry(name: str, dev) -> dict:
    """The stride-1 conv + moments at one geometry, every kernel that takes
    it and cuDNN."""
    from runet_tpu_torch.kernels import fused_block
    from runet_tpu_torch.kernels.attic.conv3d import conv3x3x3_same
    from runet_tpu_torch.kernels.attic.conv_v3_deep import conv3x3_v3
    from runet_tpu_torch.kernels.conv_common import pack_weight

    D, H, W, C, Cout, iters = GEOMETRIES[name]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((D, H, W, C), generator=gen, device=dev).to(torch.bfloat16)
    w = _weight(gen, C, Cout, dev)
    packed = pack_weight(w)
    fl = conv_flops(D * H * W, C, Cout)
    row = {"name": name, "D": D, "H": H, "W": W, "C": C, "Cout": Cout, "iters": iters,
           "gflop": fl / 1e9, "bound_ms": fl / PEAK_BF16_FLOPS * 1e3}
    wc = w.permute(4, 3, 0, 1, 2).contiguous()

    def cudnn_step(xx):
        y = F.conv3d(xx, wc, padding=1)
        yf = y.float()
        yf.sum((2, 3, 4)), (yf * yf).sum((2, 3, 4))
        return y

    with torch.no_grad():
        _put(row, "library", cudnn_step, x.permute(3, 0, 1, 2)[None].contiguous(), iters, fl)
        x_dchw = x.permute(0, 3, 1, 2)[None].contiguous()
        for version in ("v2m", "v2"):
            _put(row, version,
                 lambda xx, v=version: fused_block.conv_in_stats_dchw_batch(xx, w, packed, v)[0],
                 x_dchw, iters, fl)
        _put(row, "v1", lambda xx: fused_block.conv_in_stats_dhcw_batch(xx, w, packed)[0],
             x.permute(0, 1, 3, 2)[None].contiguous(), iters, fl)
        _put(row, "conv3d", lambda xx: conv3x3x3_same(xx, w, packed), x, iters, fl)
        if name in V3_ROWS:
            _put(row, "v3", lambda xx: conv3x3_v3(xx, w, packed)[0], x, iters, fl)
    print(f"kernel_bench row: {row}", file=sys.stderr, flush=True)
    return row


def bench_dw(name: str, dev) -> dict:
    """The stride-1 weight-gradient kernel against cuDNN's wgrad."""
    from runet_tpu_torch.kernels import fused_block

    D, H, W, C, Cout, iters = DW_GEOMETRIES[name]
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((1, D, C, H, W), generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn((1, D, Cout, H, W), generator=gen, device=dev).to(torch.bfloat16)
    fl = conv_flops(D * H * W, C, Cout)
    row = {"name": name, "kind": "dw", "D": D, "H": H, "W": W, "C": C, "Cout": Cout,
           "iters": iters, "gflop": fl / 1e9, "bound_ms": fl / PEAK_BF16_FLOPS * 1e3}
    xc, gc = x.permute(0, 2, 1, 3, 4).contiguous(), g.permute(0, 2, 1, 3, 4).contiguous()

    with torch.no_grad():
        _put(row, "dw", _side_step(fused_block.conv3x3_dw, g), x, iters, fl)
        _put(row, "library", _side_step(lambda xx: torch.nn.grad.conv3d_weight(
            xx, (Cout, C, 3, 3, 3), gc, padding=1)), xc, iters, fl)
    print(f"kernel_bench row: {row}", file=sys.stderr, flush=True)
    return row


def bench_norm(dev) -> dict:
    """The attic InstanceNorm + LeakyReLU pair against the model's plain
    torch and against F.instance_norm + F.leaky_relu."""
    from runet_tpu_torch.kernels.attic.fused_norm import fused_instance_norm_lrelu
    from runet_tpu_torch.models.norm import InstanceNorm

    B, D, H, W, C = NORM_SHAPE
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(NORM_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
    scale = 1.0 + 0.1 * torch.randn((C,), generator=gen, device=dev)
    bias = 0.1 * torch.randn((C,), generator=gen, device=dev)
    norm = InstanceNorm(C, 1e-5, torch.bfloat16, device=dev)
    with torch.no_grad():
        norm.scale.copy_(scale)
        norm.bias.copy_(bias)
    nbytes = x.numel() * x.element_size()
    row = {"name": "norm_l0", "shape": list(NORM_SHAPE), "dtype": "bfloat16", "iters": 30,
           "bytes_per_pass": nbytes,
           "bound_ms": 2 * nbytes / PEAK_HBM_BYTES * 1e3,
           "bound_note": "one read of x and one write of y at 3.35 TB/s"}

    def library_step(xx):  # NCDHW, contiguous: the layout F.instance_norm is made for
        return F.leaky_relu(F.instance_norm(xx, weight=scale, bias=bias, eps=1e-5), 1e-2)

    with torch.no_grad():
        _put(row, "kernel", lambda xx: fused_instance_norm_lrelu(xx, scale, bias), x, 30)
        _put(row, "model", lambda xx: F.leaky_relu(norm(xx, channel_axis=4), 1e-2), x, 30)
        _put(row, "library", library_step, x.permute(0, 4, 1, 2, 3).contiguous(), 30)
    # The kernels read x twice (stats, apply) and write y once.
    row["kernel_gbps"] = 3 * nbytes / (row["kernel_ms"] * 1e-3) / 1e9
    row["kernel_hbm_share"] = row["kernel_gbps"] * 1e9 / PEAK_HBM_BYTES
    print(f"kernel_bench norm: {row}", file=sys.stderr, flush=True)
    return row


def _side_step(fn, *args):
    """A step x → x that runs fn(x, *args) for its launches and returns x
    (for ops whose output shape differs from their input)."""

    def step(xx):
        fn(xx, *args)
        return xx

    return step


def _grad_step(fn, *params):
    """A step x → x that runs fn(x_leaf, *params) and the gradient of the
    f32 sum of its output wrt x and every param."""

    def step(xx):
        xl = xx.detach().requires_grad_(True)
        y = fn(xl, *params)
        torch.autograd.grad(y.float().sum(), (xl, *params))
        return xx

    return step


def bench_budget(dev) -> dict:
    """Per-op forward and backward of the fine_kits forward at 128³ (B 1,
    (B, D, C, H, W) layout), each op as the port's production runs it."""
    from runet_tpu_torch.kernels.conv_common import pack_weight
    from runet_tpu_torch.kernels.fused_block import conv_in_stats_dchw_batch
    from runet_tpu_torch.kernels.strided_conv import conv_s2_stats_dchw_batch
    from runet_tpu_torch.models.unet3d import _Head, _PixelShuffleProj, depth_to_space_dchw

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    conv_rows = [("enc0_in", 128, 1, 128, 32, 1), ("down_l1", 128, 32, 128, 64, 2),
                 ("down_l2", 64, 64, 64, 128, 2), ("down_l3", 32, 128, 32, 256, 2),
                 ("down_l4", 16, 256, 16, 320, 2), ("bot_l4", 8, 320, 8, 320, 1),
                 ("cat_l0", 128, 64, 128, 32, 1), ("cat_l1", 64, 128, 64, 64, 1),
                 ("cat_l2", 32, 256, 32, 128, 1), ("cat_l3", 16, 512, 16, 256, 1)]
    for name, D, C, HW, Cout, stride in conv_rows:
        x = torch.randn((1, D, C, HW, HW), generator=gen, device=dev).to(torch.bfloat16)
        w = _weight(gen, C, Cout, dev)
        packed = pack_weight(w)
        xc = x.permute(0, 2, 1, 3, 4).contiguous()
        wc = w.permute(4, 3, 0, 1, 2).contiguous()
        fl = conv_flops((D // stride) * (HW // stride) ** 2, C, Cout)
        row = {"name": name, "shape": [D, C, HW, HW], "Cout": Cout, "stride": stride,
               "gflop": fl / 1e9, "prod": "s2" if stride == 2 else "v2m"}

        def prod(xx, ww, pk, s=stride):
            if s == 2:
                return conv_s2_stats_dchw_batch(xx, ww, pk)[0]
            return conv_in_stats_dchw_batch(xx, ww, pk, "v2m")[0]

        def lib(xx, ww, s=stride):
            if s == 2:
                return F.conv3d(F.pad(xx, (0, 1, 0, 1, 0, 1)), ww, stride=2)
            return F.conv3d(xx, ww, padding=1)

        with torch.no_grad():
            _put(row, "prod", _side_step(prod, w, packed), x, 30, fl)
            _put(row, "library", _side_step(lib, wc), xc, 30, fl)
        wl = w.clone().requires_grad_(True)
        wcl = wc.clone().requires_grad_(True)
        _put(row, "prod_bwd", _grad_step(lambda xx, ww: prod(xx, ww, packed), wl), x, 10)
        _put(row, "library_bwd", _grad_step(lib, wcl), xc, 10)
        rows.append(row)
        print(f"kernel_bench budget row: {row}", file=sys.stderr, flush=True)

    for name, D, C, HW, Fo in (("proj_d3", 8, 320, 8, 256), ("proj_d2", 16, 256, 16, 128),
                               ("proj_d1", 32, 128, 32, 64), ("proj_d0", 64, 64, 64, 32)):
        proj = _PixelShuffleProj(C, 8 * Fo, torch.bfloat16, device=dev,
                                 param_dtype=torch.float32)
        with torch.no_grad():
            proj.kernel.copy_(torch.randn(proj.kernel.shape, generator=gen, device=dev)
                              / math.sqrt(C))
        x = torch.randn((1, D, C, HW, HW), generator=gen, device=dev).to(torch.bfloat16)
        fl = 2.0 * C * 8 * Fo * D * HW * HW
        row = {"name": name, "shape": [D, C, HW, HW], "F": Fo, "gflop": fl / 1e9,
               "prod": "matmul + depth_to_space_dchw"}

        def op(xx, *_, m=proj):  # the projection reads its own (trainable) kernel
            return depth_to_space_dchw(m(xx), 2)

        with torch.no_grad():
            _put(row, "prod", _side_step(op), x, 30, fl)
        _put(row, "prod_bwd", _grad_step(op, proj.kernel), x, 10)
        rows.append(row)
        print(f"kernel_bench budget row: {row}", file=sys.stderr, flush=True)

    head = _Head(32, 3, device=dev, param_dtype=torch.float32)
    with torch.no_grad():
        head.kernel.copy_(torch.randn(head.kernel.shape, generator=gen, device=dev) / math.sqrt(32))
    x = torch.randn((1, 128, 32, 128, 128), generator=gen, device=dev).to(torch.bfloat16)
    fl = 2.0 * 32 * 3 * 128 ** 3
    row = {"name": "head", "shape": [128, 32, 128, 128], "Cout": 3, "gflop": fl / 1e9,
           "prod": "f32 matmul + bias"}
    with torch.no_grad():
        _put(row, "prod", _side_step(head), x, 30, fl)
    _put(row, "prod_bwd", _grad_step(lambda xx, *_: head(xx), head.kernel, head.bias), x, 10)
    rows.append(row)
    print(f"kernel_bench budget row: {row}", file=sys.stderr, flush=True)
    return {"rows": rows, "geometry": "fine_kits forward at 128^3, B 1, (B, D, C, H, W)",
            "bwd": "grad of the f32 sum of the op's output wrt its input and weights, "
                   "through the port's autograd Functions (10 iterations)"}


def bench_model_fwd(dev) -> dict:
    """The whole fine_kits forward at 128³ under each ``fused_kernel``."""
    from runet_tpu_torch.config import get_config
    from runet_tpu_torch.models.unet3d import create_model, init_params
    from runet_tpu_torch.utils.latency import chained_ms

    cfg = get_config("fine_kits")
    x = torch.randn((1, 128, 128, 128, cfg.model.in_channels),
                    generator=torch.Generator(device=dev).manual_seed(3), device=dev
                    ).to(torch.bfloat16)
    res = {"geometry": [128, 128, 128], "batch": 1, "protocol": f"chained_ms, "
           f"{MODEL_FWD_ITERS} calls, under torch.inference_mode",
           "note": "no xla_over_fused: the port has no unfused path (every 3x3x3 conv runs "
                   "on a kernel) and no lane bucket to tune with it"}
    for version in ("v2m", "v2", "v1"):
        mcfg = dataclasses.replace(cfg.model, fused_kernel=version)
        model = init_params(create_model(mcfg, dev), torch.Generator().manual_seed(0))
        with torch.inference_mode():
            res[f"{version}_ms"] = chained_ms(model, (x,), n=MODEL_FWD_ITERS)
        del model
        torch.cuda.empty_cache()
    print(f"kernel_bench model_fwd: {res}", file=sys.stderr, flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, type=Path, help="where to write the JSON")
    args = ap.parse_args(argv)

    from runet_tpu_torch.utils.health import card_line, probe_backend

    ok, detail = probe_backend(tries=2)
    if not ok:
        print(f"kernel_bench: no CUDA device ({detail}); not starting", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "card": card_line(),
           "torch": torch.__version__, "cuda": torch.version.cuda, "protocol": PROTOCOL}
    out["rows"] = ([bench_geometry(n, dev) for n in GEOMETRIES]
                   + [bench_dw(n, dev) for n in DW_GEOMETRIES])
    out["norm"] = bench_norm(dev)
    out["budget"] = bench_budget(dev)
    out["model_fwd"] = bench_model_fwd(dev)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=2) + "\n")
    print(f"kernel_bench: wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
