"""Stride-1 3x3x3 SAME conv fused with InstanceNorm moments, and its
backward.

Counterpart of ``runet_tpu/kernels/fused_block.py``. Each of the JAX
package's three forward kernels has a CUDA kernel of its own, chosen by
``ModelConfig.fused_kernel``; all return per-(sample, channel) sums of the
bf16-ROUNDED output and of its square beside the bf16 conv output (f32
accumulation), so the InstanceNorm that follows never re-reads the
activation for its statistics, and all reduce the moments in a fixed order
by a second pass (no float atomics):

- ``csrc/conv3x3_stats.cu`` replaces ``_conv_stats_kernel_v2m``
  (``fused_kernel="v2m"``): (B, D, C, H, W), an mma.sync implicit GEMM over
  a channel-innermost shared-memory halo, 27 taps per 16-channel chunk.
- ``csrc/conv3x3_stats_v2.cu`` replaces ``_conv_stats_kernel_v2``
  (``"v2"``): the same contract, as nine (kh, kw) tap GEMMs with kd folded
  into K per 16-channel chunk, on the v2m kernel's 8 x 32 x 32 and 16 x 16
  x 32 tiles from three channel-innermost kd planes in shared memory.
- ``csrc/conv3x3_stats_v1.cu`` replaces ``_conv_stats_kernel`` (``"v1"``):
  the (B, D, H, C, W) layout in and out, one GEMM over the whole K = 27·C
  from an im2col tile built in shared memory.
- ``csrc/conv3x3_dw.cu`` replaces ``_dw_kernel_v2``, the weight gradient of
  the (B, D, C, H, W) kernels: the same FLOPs as the forward, an mma.sync
  implicit GEMM whose K (the batch's voxels) is split over blocks into f32
  partials reduced in a fixed order; one launch covers the whole batch.

On the H100 all are bound by tensor-core throughput at the U-Net's widths
(~27*Cout FLOP per input byte, far above the ~295 FLOP/byte ridge).

``ConvStats``, ``ConvStatsV2`` and ``ConvStatsV1`` are the autograd
Functions of the custom_vjps ``conv3x3_dchw_m``, ``conv3x3_dchw`` and
``conv3x3_dhcw``: the backward folds the moment cotangents into the output
cotangent and runs dx through the SAME forward kernel on flipped,
in/out-swapped weights (moments discarded). dw goes through the
weight-gradient kernel for v2m and v2; v1's dw is the framework's
(``torch.nn.grad.conv3d_weight``), as the JAX package leaves it to XLA's
correlation outside any Pallas kernel.

The TPU gates (``fused_block_applicable``, W % 64 or % 128) and channel
padding to 16 exist only for Mosaic's lane tiling; the CUDA kernels take
any Cin, Cout and D/H/W, so the model routes EVERY stride-1 3x3x3 conv here.
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
V2_SOURCE = "conv3x3_stats_v2"
V1_SOURCE = "conv3x3_stats_v1"
DW_SOURCE = "conv3x3_dw"
VERSIONS = ("v2m", "v2", "v1")
# Kernel launches, one per launch on CUDA: the three conv+moment kernels
# (forward and dx) and the weight-gradient kernel.
launches = 0
v2_launches = 0
v1_launches = 0
dw_launches = 0

__all__ = ["conv_in_stats_dchw_batch", "conv_in_stats_dhcw_batch", "conv3x3_stats_plain",
           "conv3x3_stats_v2_plain", "conv3x3_stats_dhcw_plain", "conv3x3_dw",
           "conv3x3_dw_plain", "conv3x3_dw_dhcw", "pack_weight"]


def _conv3x3_sums_plain(x: torch.Tensor, kernel: torch.Tensor, layout: str = "dchw"):
    """(y rounded to x.dtype, Σy, Σy² of the rounded y) in f32 math on the
    values of x and kernel; x and y in ``layout`` ((B, D, C, H, W) or
    (B, D, H, C, W))."""
    w = kernel.float().permute(4, 3, 0, 1, 2)  # (Cout, Cin, kd, kh, kw)
    to_ncdhw = (0, 3, 1, 2, 4) if layout == "dhcw" else (0, 2, 1, 3, 4)
    from_ncdhw = (0, 2, 3, 1, 4) if layout == "dhcw" else (0, 2, 1, 3, 4)
    with no_tf32_conv():
        y = F.conv3d(x.float().permute(to_ncdhw), w, padding=1).to(x.dtype)
    yf = y.float()
    return y.permute(from_ncdhw).contiguous(), yf.sum(dim=(2, 3, 4)), (yf * yf).sum(dim=(2, 3, 4))


def _moments(y, s, q, layout: str = "dchw"):
    """(y, mean, sqmean) from (y, Σy, Σy²)."""
    n = float(y.numel() // (y.shape[0] * y.shape[3 if layout == "dhcw" else 2]))
    return y, s / n, q / n


def conv3x3_stats_plain(x: torch.Tensor, kernel: torch.Tensor):
    """Plain PyTorch version of the v2m kernel's contract.

    x: (B, D, C, H, W); kernel: (3, 3, 3, Cin, Cout). The conv runs in f32
    on the values of x and kernel (exact products of bf16 values), the
    output is rounded to x.dtype, and the moments are f32 means of the
    rounded output and of its square."""
    return _moments(*_conv3x3_sums_plain(x, kernel))


def conv3x3_stats_v2_plain(x: torch.Tensor, kernel: torch.Tensor):
    """Plain PyTorch version of the v2 kernel (counterpart of
    ``reference_conv3x3_dchw``): the contract of ``conv3x3_stats_plain``."""
    return _moments(*_conv3x3_sums_plain(x, kernel))


def conv3x3_stats_dhcw_plain(x: torch.Tensor, kernel: torch.Tensor):
    """Plain PyTorch version of the v1 kernel (counterpart of
    ``reference_conv3x3_dhcw``): x (B, D, H, C, W) → y (B, D, H, Cout, W),
    mean and sqmean (B, Cout) f32 of the rounded output."""
    return _moments(*_conv3x3_sums_plain(x, kernel, "dhcw"), "dhcw")


def _conv3x3_sums(x: torch.Tensor, kernel: torch.Tensor, packed: torch.Tensor | None,
                  version: str = "v2m"):
    """(y, Σy, Σy²): the kernel of ``version`` on CUDA (bf16 only), its plain
    version on the CPU. "v1" takes and returns the (B, D, H, C, W) layout."""
    global launches, v2_launches, v1_launches
    if version not in VERSIONS:
        raise ValueError(f"unknown fused_kernel {version!r}; expected one of {VERSIONS}")
    layout = "dhcw" if version == "v1" else "dchw"
    if x.device.type == "cpu":
        return _conv3x3_sums_plain(x, kernel, layout)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 {version}: unsupported device {x.device}")
    if packed is None:
        packed = pack_weight(kernel.to(x.device))
    if layout == "dhcw":
        B, D, H, C, W = x.shape
    else:
        B, D, C, H, W = x.shape
    source = {"v2m": SOURCE, "v2": V2_SOURCE, "v1": V1_SOURCE}[version]
    out = launch_conv_stats(source, x, packed, kernel.shape[4], (D, H, W), layout)
    if version == "v2m":
        launches += 1
    elif version == "v2":
        v2_launches += 1
    else:
        v1_launches += 1
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


def conv3x3_dw_dhcw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the v1 conv, by the framework: x (B, D, H, C, W),
    g (B, D, H, Cout, W) → (3, 3, 3, C, Cout).

    The JAX package computes this one with XLA's correlation outside any
    Pallas kernel, so it is a library call here too
    (``torch.nn.grad.conv3d_weight``): in the activations' dtype on the
    card (cuDNN accumulates bf16 products in f32), in f32 rounded once to
    that dtype on the CPU."""
    xc, gc = x.permute(0, 3, 1, 2, 4), g.permute(0, 3, 1, 2, 4)
    if x.device.type == "cpu":
        xc, gc = xc.float(), gc.float()
    with no_tf32_conv():
        dw = torch.nn.grad.conv3d_weight(xc, (g.shape[3], x.shape[3], 3, 3, 3), gc, padding=1)
    return dw.to(x.dtype).permute(2, 3, 4, 1, 0).contiguous()


def _conv_stats_backward(ctx, gy, gs, gq, version: str):
    """The backward the three custom_vjps share: g = gy + gs + 2·gq·y folded
    in y's dtype; dx = the forward kernel of ``version`` on g with the taps
    flipped and Cin/Cout swapped (moments discarded; skipped when x needs no
    gradient); dw = the weight-gradient kernel (v1: the framework's
    correlation), cast to the kernel's dtype."""
    x, kernel, y = ctx.saved_tensors
    if version == "v1":
        g = fold_moment_cotangents(gy, gs, gq, y, channel_axis=3)
    else:
        g = fold_moment_cotangents(gy, gs, gq, y)
    dx = dw = None
    if ctx.needs_input_grad[0]:
        w_flip = torch.flip(kernel, dims=(0, 1, 2)).transpose(3, 4)
        dx, _, _ = _conv3x3_sums(g, w_flip, None, version)
        dx = dx.to(x.dtype)
    if ctx.needs_input_grad[1]:
        dw = (conv3x3_dw_dhcw(x, g) if version == "v1" else conv3x3_dw(x, g)).to(kernel.dtype)
    return dx, dw, None


class ConvStats(torch.autograd.Function):
    """(y, Σy, Σy²) of the stride-1 conv with the backward of the JAX
    package's ``conv3x3_dchw_m`` custom_vjp (``_cv2m_fwd`` / ``_cv2m_bwd``);
    saves (x, kernel, y)."""

    @staticmethod
    def forward(ctx, x, kernel, packed):
        y, s, q = _conv3x3_sums(x, kernel, packed, "v2m")
        ctx.save_for_backward(x, kernel, y)
        return y, s, q

    @staticmethod
    def backward(ctx, gy, gs, gq):
        return _conv_stats_backward(ctx, gy, gs, gq, "v2m")


class ConvStatsV2(torch.autograd.Function):
    """The v2 kernel with the backward of ``conv3x3_dchw``'s custom_vjp
    (``_cv2_fwd`` / ``_cv2_bwd``): dx through the v2 kernel, dw through the
    weight-gradient kernel."""

    @staticmethod
    def forward(ctx, x, kernel, packed):
        y, s, q = _conv3x3_sums(x, kernel, packed, "v2")
        ctx.save_for_backward(x, kernel, y)
        return y, s, q

    @staticmethod
    def backward(ctx, gy, gs, gq):
        return _conv_stats_backward(ctx, gy, gs, gq, "v2")


class ConvStatsV1(torch.autograd.Function):
    """The v1 kernel, (B, D, H, C, W) in and out, with the backward of
    ``conv3x3_dhcw``'s custom_vjp (``_cv_fwd`` / ``_cv_bwd``): dx through
    the v1 kernel, dw through the framework."""

    @staticmethod
    def forward(ctx, x, kernel, packed):
        y, s, q = _conv3x3_sums(x, kernel, packed, "v1")
        ctx.save_for_backward(x, kernel, y)
        return y, s, q

    @staticmethod
    def backward(ctx, gy, gs, gq):
        return _conv_stats_backward(ctx, gy, gs, gq, "v1")


def conv_in_stats_dchw_batch(x: torch.Tensor, kernel: torch.Tensor,
                             packed: torch.Tensor | None = None, version: str = "v2m"):
    """Batched stride-1 conv + InstanceNorm moments, differentiable.

    x: (B, D, C, H, W) in compute dtype; kernel: (3, 3, 3, Cin, Cout) in
    x's dtype; ``packed``: ``pack_weight(kernel)`` made once per weight
    (made here when absent); ``version``: "v2m" or "v2", the kernel that
    runs. Returns (y (B, D, Cout, H, W), mean (B, Cout) f32, sqmean
    (B, Cout) f32).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 only) or raises."""
    if version not in ("v2m", "v2"):
        raise ValueError(f"conv_in_stats_dchw_batch: version must be 'v2m' or 'v2', "
                         f"got {version!r}")
    if x.dim() != 5 or kernel.shape[3] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} does not match kernel {tuple(kernel.shape)}")
    fn = ConvStatsV2 if version == "v2" else ConvStats
    return _moments(*fn.apply(x, kernel, packed))


def conv_in_stats_dhcw_batch(x: torch.Tensor, kernel: torch.Tensor,
                             packed: torch.Tensor | None = None):
    """Batched v1 conv + InstanceNorm moments, differentiable.

    x: (B, D, H, C, W) in compute dtype; kernel: (3, 3, 3, Cin, Cout) in
    x's dtype. Returns (y (B, D, H, Cout, W), mean (B, Cout) f32, sqmean
    (B, Cout) f32). A CPU tensor takes the plain version; a CUDA tensor
    launches the v1 kernel (bf16 only) or raises."""
    if x.dim() != 5 or kernel.shape[3] != x.shape[3]:
        raise ValueError(f"x {tuple(x.shape)} does not match kernel {tuple(kernel.shape)}")
    return _moments(*ConvStatsV1.apply(x, kernel, packed), "dhcw")
