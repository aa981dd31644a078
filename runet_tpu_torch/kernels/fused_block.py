"""Stride-1 3x3x3 SAME conv fused with InstanceNorm moments.

Counterpart of ``runet_tpu/kernels/fused_block.py``. The kernel
(``csrc/conv3x3_stats.cu``) replaces the Pallas kernel
``_conv_stats_kernel_v2m`` (with its v2/v1 siblings, the same contract):
a bf16 conv with f32 accumulation that also returns per-(sample, channel)
sums of the bf16-ROUNDED output and of its square, so the InstanceNorm that
follows never re-reads the activation for its statistics.

On the H100 the conv is bound by tensor-core throughput at the U-Net's
widths (~27*Cout FLOP per input byte, far above the ~295 FLOP/byte
ridge). The kernel is an mma.sync implicit GEMM over shared-memory-staged
input halos; moments come out of its epilogue as per-block partials that a
second pass reduces in a fixed order (deterministic, no float atomics).

The TPU gate (``fused_block_applicable``) and channel padding to 16 exist
only for Mosaic's lane tiling; the CUDA kernel takes any Cin, Cout and
D/H/W, so the model routes EVERY stride-1 3x3x3 conv here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from runet_tpu_torch.kernels.conv_common import launch_conv_stats, no_tf32_conv, pack_weight

SOURCE = "conv3x3_stats"
# Kernel launches by conv_in_stats_dchw_batch (one per call on CUDA).
launches = 0

__all__ = ["conv_in_stats_dchw_batch", "conv3x3_stats_plain", "pack_weight"]


def conv3x3_stats_plain(x: torch.Tensor, kernel: torch.Tensor):
    """Plain PyTorch version of the kernel's contract.

    x: (B, D, C, H, W); kernel: (3, 3, 3, Cin, Cout). The conv runs in f32
    on the values of x and kernel (exact products of bf16 values), the
    output is rounded to x.dtype, and the moments are f32 means of the
    rounded output and of its square."""
    w = kernel.float().permute(4, 3, 0, 1, 2)  # (Cout, Cin, kd, kh, kw)
    xc = x.float().permute(0, 2, 1, 3, 4)  # (B, C, D, H, W)
    with no_tf32_conv():
        y = F.conv3d(xc, w, padding=1).to(x.dtype)
    yf = y.float()
    n = float(yf.shape[2] * yf.shape[3] * yf.shape[4])
    mean = yf.sum(dim=(2, 3, 4)) / n
    sqmean = (yf * yf).sum(dim=(2, 3, 4)) / n
    return y.permute(0, 2, 1, 3, 4).contiguous(), mean, sqmean


def conv_in_stats_dchw_batch(x: torch.Tensor, kernel: torch.Tensor,
                             packed: torch.Tensor | None = None):
    """Batched stride-1 conv + InstanceNorm moments.

    x: (B, D, C, H, W) in compute dtype; kernel: (3, 3, 3, Cin, Cout);
    ``packed``: ``pack_weight(kernel)`` made once at load (made here when
    absent). Returns (y (B, D, Cout, H, W), mean (B, Cout) f32,
    sqmean (B, Cout) f32).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 only) or raises."""
    global launches
    if x.dim() != 5 or kernel.shape[3] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} does not match kernel {tuple(kernel.shape)}")
    if x.device.type == "cpu":
        return conv3x3_stats_plain(x, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"conv_in_stats_dchw_batch: unsupported device {x.device}")
    if packed is None:
        packed = pack_weight(kernel.to(x.device))
    B, D, C, H, W = x.shape
    y, sums, sqs = launch_conv_stats(SOURCE, x, packed, kernel.shape[4], (D, H, W))
    launches += 1
    n = float(D * H * W)
    return y, sums / n, sqs / n
