"""Stride-1 3x3x3 SAME conv fused with InstanceNorm moments, and its
backward.

Counterpart of ``runet_tpu/kernels/fused_block.py``. Two CUDA kernels:

- ``csrc/conv3x3_stats.cu`` replaces the Pallas kernel
  ``_conv_stats_kernel_v2m`` (with its v2/v1 siblings, the same contract):
  a bf16 conv with f32 accumulation that also returns per-(sample, channel)
  sums of the bf16-ROUNDED output and of its square, so the InstanceNorm
  that follows never re-reads the activation for its statistics. On the
  H100 it is bound by tensor-core throughput at the U-Net's widths
  (~27*Cout FLOP per input byte, far above the ~295 FLOP/byte ridge): an
  mma.sync implicit GEMM over shared-memory-staged input halos, moments
  reduced in a fixed order by a second pass (no float atomics).
- ``csrc/conv3x3_dw.cu`` replaces ``_dw_kernel_v2``, the weight gradient:
  the same FLOPs as the forward, an mma.sync implicit GEMM whose K (the
  batch's voxels) is split over blocks into f32 partials reduced in a fixed
  order; one launch covers the whole batch.

``ConvStats`` is the autograd Function of ``conv3x3_dchw_m``'s custom_vjp:
its backward folds the moment cotangents into the output cotangent, runs dx
through the forward kernel on flipped, in/out-swapped weights (moments
discarded) and dw through the weight-gradient kernel.

The TPU gate (``fused_block_applicable``) and channel padding to 16 exist
only for Mosaic's lane tiling; the CUDA kernels take any Cin, Cout and
D/H/W, so the model routes EVERY stride-1 3x3x3 conv here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from runet_tpu_torch.kernels.conv_common import (
    fold_moment_cotangents,
    launch_conv_dw,
    launch_conv_stats,
    no_tf32_conv,
    pack_weight,
)

SOURCE = "conv3x3_stats"
DW_SOURCE = "conv3x3_dw"
# Kernel launches: the conv+moment kernel (forward and dx) and the
# weight-gradient kernel, one per launch on CUDA.
launches = 0
dw_launches = 0

__all__ = ["conv_in_stats_dchw_batch", "conv3x3_stats_plain", "conv3x3_dw",
           "conv3x3_dw_plain", "pack_weight"]


def _conv3x3_sums_plain(x: torch.Tensor, kernel: torch.Tensor):
    """(y rounded to x.dtype, Σy, Σy² of the rounded y) in f32 math on the
    values of x and kernel."""
    w = kernel.float().permute(4, 3, 0, 1, 2)  # (Cout, Cin, kd, kh, kw)
    xc = x.float().permute(0, 2, 1, 3, 4)  # (B, C, D, H, W)
    with no_tf32_conv():
        y = F.conv3d(xc, w, padding=1).to(x.dtype)
    yf = y.float()
    return y.permute(0, 2, 1, 3, 4).contiguous(), yf.sum(dim=(2, 3, 4)), (yf * yf).sum(dim=(2, 3, 4))


def conv3x3_stats_plain(x: torch.Tensor, kernel: torch.Tensor):
    """Plain PyTorch version of the kernel's contract.

    x: (B, D, C, H, W); kernel: (3, 3, 3, Cin, Cout). The conv runs in f32
    on the values of x and kernel (exact products of bf16 values), the
    output is rounded to x.dtype, and the moments are f32 means of the
    rounded output and of its square."""
    y, s, q = _conv3x3_sums_plain(x, kernel)
    n = float(y.shape[1] * y.shape[3] * y.shape[4])
    return y, s / n, q / n


def _conv3x3_sums(x: torch.Tensor, kernel: torch.Tensor, packed: torch.Tensor | None):
    """(y, Σy, Σy²): the kernel on CUDA (bf16 only), the plain version on
    the CPU."""
    global launches
    if x.device.type == "cpu":
        return _conv3x3_sums_plain(x, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"conv_in_stats_dchw_batch: unsupported device {x.device}")
    if packed is None:
        packed = pack_weight(kernel.to(x.device))
    B, D, C, H, W = x.shape
    out = launch_conv_stats(SOURCE, x, packed, kernel.shape[4], (D, H, W))
    launches += 1
    return out


def conv3x3_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the weight-gradient kernel: f32 math on the
    values of x (B, D, C, H, W) and g (B, D, Cout, H, W), summed over the
    batch; returns (3, 3, 3, C, Cout) f32."""
    xc = x.float().permute(0, 2, 1, 3, 4)
    gc = g.float().permute(0, 2, 1, 3, 4)
    with no_tf32_conv():
        dw = torch.nn.grad.conv3d_weight(xc, (g.shape[2], x.shape[2], 3, 3, 3), gc, padding=1)
    return dw.permute(2, 3, 4, 1, 0).contiguous()


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the stride-1 SAME conv, one launch for all B.

    x: (B, D, C, H, W) bf16; g: (B, D, Cout, H, W) bf16 folded cotangent.
    Returns dw (3, 3, 3, C, Cout) f32. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (bf16 only) or raises."""
    global dw_launches
    if x.dim() != 5 or g.dim() != 5 or g.shape[:2] != x.shape[:2] or g.shape[3:] != x.shape[3:]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} do not match")
    if x.device.type == "cpu":
        return conv3x3_dw_plain(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_dw: unsupported device {x.device}")
    dw = launch_conv_dw(DW_SOURCE, x, g)
    dw_launches += 1
    return dw


class ConvStats(torch.autograd.Function):
    """(y, Σy, Σy²) of the stride-1 conv with the backward of the JAX
    package's ``conv3x3_dchw_m`` custom_vjp (``_cv2m_fwd`` / ``_cv2m_bwd``).

    Saves (x, kernel, y). Backward: g = gy + gs + 2·gq·y folded in y's
    dtype; dx = the forward kernel on g with the taps flipped and Cin/Cout
    swapped (moments discarded; skipped when x needs no gradient); dw = the
    weight-gradient kernel, cast to the kernel's dtype."""

    @staticmethod
    def forward(ctx, x, kernel, packed):
        y, s, q = _conv3x3_sums(x, kernel, packed)
        ctx.save_for_backward(x, kernel, y)
        return y, s, q

    @staticmethod
    def backward(ctx, gy, gs, gq):
        x, kernel, y = ctx.saved_tensors
        g = fold_moment_cotangents(gy, gs, gq, y)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w_flip = torch.flip(kernel, dims=(0, 1, 2)).transpose(3, 4)
            dx, _, _ = _conv3x3_sums(g, w_flip, None)
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_dw(x, g).to(kernel.dtype)
        return dx, dw, None


def conv_in_stats_dchw_batch(x: torch.Tensor, kernel: torch.Tensor,
                             packed: torch.Tensor | None = None):
    """Batched stride-1 conv + InstanceNorm moments, differentiable.

    x: (B, D, C, H, W) in compute dtype; kernel: (3, 3, 3, Cin, Cout) in
    x's dtype; ``packed``: ``pack_weight(kernel)`` made once per weight
    (made here when absent). Returns (y (B, D, Cout, H, W), mean (B, Cout)
    f32, sqmean (B, Cout) f32).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 only) or raises."""
    if x.dim() != 5 or kernel.shape[3] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} does not match kernel {tuple(kernel.shape)}")
    y, s, q = ConvStats.apply(x, kernel, packed)
    n = float(y.shape[1] * y.shape[3] * y.shape[4])
    return y, s / n, q / n
