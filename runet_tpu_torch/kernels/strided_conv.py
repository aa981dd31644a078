"""Stride-2 3x3x3 conv (the U-Net's downsample) fused with InstanceNorm
moments.

Counterpart of ``runet_tpu/kernels/strided_conv.py``. The kernel
(``csrc/conv3x3_s2_stats.cu``) replaces the Pallas kernel
``_conv_s2_kernel``: output (d, h, w) reads input (2d+kd, 2h+kh, 2w+kw) and
an index past the extent reads zero — XLA's asymmetric SAME padding
(low 0, high 1) for even extents, NOT torch's symmetric ``padding=1``.
It returns the bf16 output with f32 moments of the rounded output.

The Pallas kernel needed 0/1 selection matmuls to decimate W because TPU
lanes cannot be strided; the GPU kernel addresses the strided element
directly inside the same mma.sync implicit GEMM as the stride-1 kernel.
On the H100 it is bound by the HBM bytes of reading its input once (each
output reads 8x its volume; ~27*Cout/8 FLOP per input byte is below the
~295 FLOP/byte ridge); the design stages input halos in shared memory with
many loads in flight per thread. Unlike the Pallas gate (B == 1 only) it
takes any batch B >= 1 in one launch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from runet_tpu_torch.kernels.conv_common import launch_conv_stats, no_tf32_conv, pack_weight

SOURCE = "conv3x3_s2_stats"
# Kernel launches by conv_s2_stats_dchw_batch (one per call on CUDA).
launches = 0

__all__ = ["conv_s2_stats_dchw_batch", "conv3x3_s2_stats_plain", "pack_weight"]


def _check_even(x: torch.Tensor):
    B, D, C, H, W = x.shape
    if D % 2 or H % 2 or W % 2:
        raise ValueError(f"stride-2 conv needs even D, H, W; got {(D, H, W)}")


def conv3x3_s2_stats_plain(x: torch.Tensor, kernel: torch.Tensor):
    """Plain PyTorch version: f32 conv on the values with the (0, 1) SAME
    pad, rounded to x.dtype, moments from the rounded output.

    x: (B, D, C, H, W), even D/H/W; kernel (3, 3, 3, Cin, Cout)."""
    _check_even(x)
    w = kernel.float().permute(4, 3, 0, 1, 2)
    xc = F.pad(x.float().permute(0, 2, 1, 3, 4), (0, 1, 0, 1, 0, 1))
    with no_tf32_conv():
        y = F.conv3d(xc, w, stride=2).to(x.dtype)
    yf = y.float()
    n = float(yf.shape[2] * yf.shape[3] * yf.shape[4])
    mean = yf.sum(dim=(2, 3, 4)) / n
    sqmean = (yf * yf).sum(dim=(2, 3, 4)) / n
    return y.permute(0, 2, 1, 3, 4).contiguous(), mean, sqmean


def conv_s2_stats_dchw_batch(x: torch.Tensor, kernel: torch.Tensor,
                             packed: torch.Tensor | None = None):
    """Batched stride-2 conv + InstanceNorm moments, any B >= 1.

    x: (B, D, C, H, W) compute dtype, even D/H/W; kernel (3, 3, 3, Cin,
    Cout); ``packed`` as for ``conv_in_stats_dchw_batch``. Returns
    (y (B, D/2, Cout, H/2, W/2), mean (B, Cout) f32, sqmean (B, Cout) f32).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 only) or raises."""
    global launches
    if x.dim() != 5 or kernel.shape[3] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} does not match kernel {tuple(kernel.shape)}")
    if x.device.type == "cpu":
        return conv3x3_s2_stats_plain(x, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"conv_s2_stats_dchw_batch: unsupported device {x.device}")
    _check_even(x)
    if packed is None:
        packed = pack_weight(kernel.to(x.device))
    B, D, C, H, W = x.shape
    out = (D // 2, H // 2, W // 2)
    y, sums, sqs = launch_conv_stats(SOURCE, x, packed, kernel.shape[4], out)
    launches += 1
    n = float(out[0] * out[1] * out[2])
    return y, sums / n, sqs / n
