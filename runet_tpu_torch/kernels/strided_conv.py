"""Stride-2 3x3x3 conv (the U-Net's downsample) fused with InstanceNorm
moments, and its backward.

Counterpart of ``runet_tpu/kernels/strided_conv.py``. Output (d, h, w)
reads input (2d+kd, 2h+kh, 2w+kw) and an index past the extent reads zero —
XLA's asymmetric SAME padding (low 0, high 1) for even extents, NOT torch's
symmetric ``padding=1``. Two CUDA kernels:

- ``csrc/conv3x3_s2_stats.cu`` replaces the Pallas kernel
  ``_conv_s2_kernel``: the bf16 output with f32 moments of the rounded
  output. The Pallas kernel needed 0/1 selection matmuls to decimate W
  because TPU lanes cannot be strided; the GPU kernel addresses the strided
  element inside the same mma.sync implicit GEMM as the stride-1 kernel.
  On the H100 it is bound by the HBM bytes of reading its input once (each
  output reads 8x its volume).
- ``csrc/conv3x3_s2_dw.cu`` replaces ``_s2_dw_kernel``, the weight
  gradient: the stride-1 dw's implicit GEMM with the input halo staged as
  separate even and odd columns, one launch for the whole batch.

Unlike the Pallas gate (B == 1 only) both take any batch B >= 1.
``ConvS2Stats`` is the autograd Function of the JAX ``conv3x3_s2``
custom_vjp (``_s2_fwd`` / ``_s2_bwd``). Its dx stays a framework op, as in
JAX where XLA computes it: torch's transposed conv
(``F.conv_transpose3d(g, w, stride=2)``, cuDNN on the card) with the padded
high row of each axis cropped.
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

SOURCE = "conv3x3_s2_stats"
DW_SOURCE = "conv3x3_s2_dw"
# Kernel launches: the conv+moment kernel and the weight-gradient kernel,
# one per launch on CUDA.
launches = 0
dw_launches = 0

__all__ = ["conv_s2_stats_dchw_batch", "conv3x3_s2_stats_plain", "conv3x3_s2_dw",
           "conv3x3_s2_dw_plain", "conv3x3_s2_dx", "pack_weight"]


def _check_even(x: torch.Tensor):
    B, D, C, H, W = x.shape
    if D % 2 or H % 2 or W % 2:
        raise ValueError(f"stride-2 conv needs even D, H, W; got {(D, H, W)}")


def _conv3x3_s2_sums_plain(x: torch.Tensor, kernel: torch.Tensor):
    _check_even(x)
    w = kernel.float().permute(4, 3, 0, 1, 2)
    xc = F.pad(x.float().permute(0, 2, 1, 3, 4), (0, 1, 0, 1, 0, 1))
    with no_tf32_conv():
        y = F.conv3d(xc, w, stride=2).to(x.dtype)
    yf = y.float()
    return y.permute(0, 2, 1, 3, 4).contiguous(), yf.sum(dim=(2, 3, 4)), (yf * yf).sum(dim=(2, 3, 4))


def conv3x3_s2_stats_plain(x: torch.Tensor, kernel: torch.Tensor):
    """Plain PyTorch version: f32 conv on the values with the (0, 1) SAME
    pad, rounded to x.dtype, moments from the rounded output.

    x: (B, D, C, H, W), even D/H/W; kernel (3, 3, 3, Cin, Cout)."""
    y, s, q = _conv3x3_s2_sums_plain(x, kernel)
    n = float(y.shape[1] * y.shape[3] * y.shape[4])
    return y, s / n, q / n


def _conv3x3_s2_sums(x: torch.Tensor, kernel: torch.Tensor, packed: torch.Tensor | None):
    global launches
    if x.device.type == "cpu":
        return _conv3x3_s2_sums_plain(x, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"conv_s2_stats_dchw_batch: unsupported device {x.device}")
    _check_even(x)
    if packed is None:
        packed = pack_weight(kernel.to(x.device))
    B, D, C, H, W = x.shape
    out = launch_conv_stats(SOURCE, x, packed, kernel.shape[4], (D // 2, H // 2, W // 2))
    launches += 1
    return out


def conv3x3_s2_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the stride-2 weight-gradient kernel: f32
    math on x (B, D, C, H, W) hi-padded by one and g (B, D/2, Cout, H/2,
    W/2); returns (3, 3, 3, C, Cout) f32."""
    _check_even(x)
    xc = F.pad(x.float().permute(0, 2, 1, 3, 4), (0, 1, 0, 1, 0, 1))
    gc = g.float().permute(0, 2, 1, 3, 4)
    with no_tf32_conv():
        dw = torch.nn.grad.conv3d_weight(xc, (g.shape[2], x.shape[2], 3, 3, 3), gc, stride=2)
    return dw.permute(2, 3, 4, 1, 0).contiguous()


def conv3x3_s2_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the stride-2 conv, one launch for all B.

    x: (B, D, C, H, W) bf16, even D/H/W; g: (B, D/2, Cout, H/2, W/2) bf16.
    Returns dw (3, 3, 3, C, Cout) f32. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (bf16 only) or raises."""
    global dw_launches
    if x.dim() != 5 or g.dim() != 5:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} must be 5-D")
    _check_even(x)
    B, D, C, H, W = x.shape
    if g.shape[0] != B or (g.shape[1], g.shape[3], g.shape[4]) != (D // 2, H // 2, W // 2):
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} do not match")
    if x.device.type == "cpu":
        return conv3x3_s2_dw_plain(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_s2_dw: unsupported device {x.device}")
    dw = launch_conv_dw(DW_SOURCE, x, g)
    dw_launches += 1
    return dw


def conv3x3_s2_dx(g: torch.Tensor, kernel: torch.Tensor, in_dhw) -> torch.Tensor:
    """Input gradient of the stride-2 conv: torch's transposed conv of g
    (B, D/2, Cout, H/2, W/2) with kernel (3, 3, 3, Cin, Cout) in g's dtype,
    the padded high row of each axis cropped; returns (B, D, Cin, H, W)."""
    D, H, W = in_dhw
    gc = g.permute(0, 2, 1, 3, 4)
    w = kernel.to(g.dtype).permute(4, 3, 0, 1, 2)  # (Cout, Cin, kd, kh, kw)
    with no_tf32_conv():
        dx = F.conv_transpose3d(gc, w, stride=2)[:, :, :D, :H, :W]
    return dx.permute(0, 2, 1, 3, 4).contiguous()


class ConvS2Stats(torch.autograd.Function):
    """(y, Σy, Σy²) of the stride-2 conv with the backward of the JAX
    package's ``conv3x3_s2`` custom_vjp: the same bf16 fold as ``ConvStats``,
    dx by the framework's transposed conv, dw by the weight-gradient kernel
    cast to the kernel's dtype."""

    @staticmethod
    def forward(ctx, x, kernel, packed):
        y, s, q = _conv3x3_s2_sums(x, kernel, packed)
        ctx.save_for_backward(x, kernel, y)
        return y, s, q

    @staticmethod
    def backward(ctx, gy, gs, gq):
        x, kernel, y = ctx.saved_tensors
        g = fold_moment_cotangents(gy, gs, gq, y)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            B, D, C, H, W = x.shape
            dx = conv3x3_s2_dx(g, kernel, (D, H, W)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_s2_dw(x, g).to(kernel.dtype)
        return dx, dw, None


def conv_s2_stats_dchw_batch(x: torch.Tensor, kernel: torch.Tensor,
                             packed: torch.Tensor | None = None):
    """Batched stride-2 conv + InstanceNorm moments, any B >= 1,
    differentiable.

    x: (B, D, C, H, W) compute dtype, even D/H/W; kernel (3, 3, 3, Cin,
    Cout) in x's dtype; ``packed`` as for ``conv_in_stats_dchw_batch``.
    Returns (y (B, D/2, Cout, H/2, W/2), mean (B, Cout) f32, sqmean (B, Cout)
    f32).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 only) or raises."""
    if x.dim() != 5 or kernel.shape[3] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} does not match kernel {tuple(kernel.shape)}")
    y, s, q = ConvS2Stats.apply(x, kernel, packed)
    n = float(y.shape[1] * y.shape[3] * y.shape[4])
    return y, s / n, q / n
