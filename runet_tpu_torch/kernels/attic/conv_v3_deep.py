"""Stride-1 3x3x3 SAME conv + Σy, Σy² on a single NDHWC volume (the deep
levels' channels-innermost conv).

Counterpart of ``runet_tpu/kernels/attic/conv_v3_deep.py``:
``csrc/conv3x3_ndhwc_stats.cu`` replaces the Pallas kernel ``_v3_kernel``.
It computes the y of ``conv3x3_ndhwc.cu`` (the attic conv) bit for bit, in
tiles that W selects (``v3_tile``), staged one kd plane at a time through a
two-stage ``cp.async`` ring, with the moment epilogue of the production
kernels: the sums are of the output ROUNDED to bf16, over valid voxels,
from per-block partials reduced in a fixed order. Bound by tensor-core
throughput on the H100.

The TPU kernel's flattened, filler-padded slab and its ``TD`` and ``BM``
tiling existed for Mosaic; the port takes any D, H, W, C and Cout (no
``D % TD``). No model config routes here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from runet_tpu_torch.kernels.attic.conv3d import check_ndhwc_args, conv_ndhwc_f32
from runet_tpu_torch.kernels.conv_common import launch_conv_stats, no_tf32_conv, pack_weight

SOURCE = "conv3x3_ndhwc_stats"
# Kernel launches, one per launch on CUDA.
launches = 0

__all__ = ["conv3x3_v3", "conv3x3_v3_plain", "reference_conv3x3_ndhwc", "v3_nblk", "v3_tile"]


def v3_tile(W: int) -> tuple[int, int, int]:
    """(rows, columns, output channels) of the CUDA kernel's block tile at
    width W: 8 x 32 x 64 where W > 16, 16 x 16 x 32 where W <= 16."""
    return (8, 32, 64) if W > 16 else (16, 16, 32)


def v3_nblk(D: int, H: int, W: int) -> int:
    """The kernel's moment partials per (sample, channel) for a (D, H, W)
    volume: one per block of the tile that W selects."""
    th, tw, _ = v3_tile(W)
    return D * -(-H // th) * -(-W // tw)


def _sums(y: torch.Tensor):
    yf = y.float()
    return yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))


def conv3x3_v3_plain(x: torch.Tensor, w: torch.Tensor):
    """Plain PyTorch version of the kernel: w cast to x's dtype, the conv in
    f32 on the values, y rounded once to x's dtype; (y, Σy, Σy²) with the
    sums (Cout,) f32 of the ROUNDED y."""
    check_ndhwc_args(x, w)
    y = conv_ndhwc_f32(x, w.to(x.dtype)).to(x.dtype).contiguous()
    return (y, *_sums(y))


def reference_conv3x3_ndhwc(x: torch.Tensor, w: torch.Tensor):
    """The framework's conv in x's dtype (counterpart of the JAX
    ``reference_conv3x3_ndhwc``, XLA's conv), with (Σy, Σy²) f32."""
    check_ndhwc_args(x, w)
    xc = x.permute(3, 0, 1, 2)[None]
    wc = w.to(x.dtype).permute(4, 3, 0, 1, 2)
    with no_tf32_conv():
        y = F.conv3d(xc, wc, padding=1)[0].permute(1, 2, 3, 0)
    return (y, *_sums(y))


def conv3x3_v3(x: torch.Tensor, w: torch.Tensor, packed: torch.Tensor | None = None):
    """x: (D, H, W, C) NDHWC; w: (3, 3, 3, C, Cout), cast to x's dtype.
    Returns (y (D, H, W, Cout) in x's dtype, sums (Cout,) f32, sqs (Cout,)
    f32), the sums of y and y² over the volume (SAME padding).
    ``packed``: ``pack_weight(w)`` made once (made here when absent).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 only: anything else raises TypeError) or raises."""
    global launches
    check_ndhwc_args(x, w)
    if x.device.type == "cpu":
        return conv3x3_v3_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_v3: unsupported device {x.device}")
    if packed is None:
        packed = pack_weight(w.to(x.device, x.dtype))
    D, H, W, _ = x.shape
    y, s, q = launch_conv_stats(SOURCE, x[None], packed, w.shape[4], (D, H, W), "dhwc")
    launches += 1
    return y[0], s[0], q[0]
