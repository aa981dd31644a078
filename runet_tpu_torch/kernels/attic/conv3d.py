"""Stride-1 3x3x3 SAME conv on a single NDHWC volume, no moments, and its
backward.

Counterpart of ``runet_tpu/kernels/attic/conv3d.py``: ``csrc/conv3x3_ndhwc.cu``
replaces the Pallas kernel ``_conv_kernel`` (an im2col tile per output row
block, one MXU GEMM with K = 27·Cin). On the H100 it is an mma.sync
implicit GEMM over channel-innermost shared-memory halo planes (the taps
read a plane in place; no im2col), bound by tensor-core throughput: in
tiles that W and the packed Cout select (``conv3d_tile``), one (16-channel
chunk, kd plane) phase a stage of a two-stage ring that TMA tensor copies
fill, the SAME padding zero-filled by the copy itself.

``AtticConv`` is the autograd Function of the custom_vjp
``pallas_conv3x3``: dx runs through the same kernel on the cotangent with
the taps flipped and Cin/Cout swapped, cast back to x's dtype; dw is the
framework's correlation (``torch.nn.grad.conv3d_weight``) in true f32, cast
to w's dtype, as JAX leaves it to XLA.

The TPU gate (D % 2, H % 8, W % 128, Cin % 8) existed only for Mosaic's
lane tiling: ``conv_shape_ok`` keeps its answer so both packages agree, but
the CUDA kernel takes any D, H, W, Cin and Cout. No model config routes
here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from runet_tpu_torch.kernels.conv_common import launch_conv_stats, no_tf32_conv, pack_weight

SOURCE = "conv3x3_ndhwc"
# Kernel launches (forward and dx), one per launch on CUDA.
launches = 0

__all__ = ["conv3x3x3_same", "conv3x3x3_same_plain", "reference_conv3x3x3", "attic_conv3x3",
           "AtticConv", "conv_shape_ok", "conv_applicable", "conv3d_tile"]


def conv3d_tile(W: int, cout_pad: int) -> tuple[int, int, int]:
    """(rows, columns, output channels) of the CUDA kernel's block tile at
    width W with the packed weights' Cout_pad (a multiple of 32): 16 x 16 x
    32 where W <= 16; else 8 x 32 x 64 where Cout_pad % 64 == 0, 8 x 32 x 32
    where it is 32."""
    if W <= 16:
        return (16, 16, 32)
    return (8, 32, 64) if cout_pad % 64 == 0 else (8, 32, 32)


def check_ndhwc_args(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise unless x is (D, H, W, Cin) and w (3, 3, 3, Cin, Cout)."""
    if x.dim() != 4 or w.dim() != 5 or w.shape[:3] != (3, 3, 3) or w.shape[3] != x.shape[3]:
        raise ValueError(f"expected x (D, H, W, Cin) and w (3, 3, 3, Cin, Cout); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")


def conv_ndhwc_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The SAME conv of x (D, H, W, Cin) with w (3, 3, 3, Cin, Cout) in true
    f32 on their values; returns (D, H, W, Cout) f32."""
    xc = x.float().permute(3, 0, 1, 2)[None]
    wc = w.float().permute(4, 3, 0, 1, 2)
    with no_tf32_conv():
        y = F.conv3d(xc, wc, padding=1)
    return y[0].permute(1, 2, 3, 0)


def reference_conv3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 oracle in the same layout (counterpart of the JAX
    ``reference_conv3x3x3``)."""
    check_ndhwc_args(x, w)
    return conv_ndhwc_f32(x, w)


def conv3x3x3_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: w cast to x's dtype, the conv in
    f32 on the values, rounded once to x's dtype."""
    check_ndhwc_args(x, w)
    return conv_ndhwc_f32(x, w.to(x.dtype)).to(x.dtype).contiguous()


def conv3x3x3_same(x: torch.Tensor, w: torch.Tensor,
                   packed: torch.Tensor | None = None) -> torch.Tensor:
    """x: (D, H, W, Cin); w: (3, 3, 3, Cin, Cout), cast to x's dtype.
    Returns (D, H, W, Cout) in x's dtype; stride 1, SAME zero padding.
    ``packed``: ``pack_weight(w)`` made once (made here when absent).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 only: anything else raises TypeError) or raises."""
    global launches
    check_ndhwc_args(x, w)
    if x.device.type == "cpu":
        return conv3x3x3_same_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3x3_same: unsupported device {x.device}")
    if packed is None:
        packed = pack_weight(w.to(x.device, x.dtype))
    D, H, W, _ = x.shape
    y, _, _ = launch_conv_stats(SOURCE, x[None], packed, w.shape[4], (D, H, W), "dhwc",
                                stats=False)
    launches += 1
    return y[0]


def _dw_f32(x: torch.Tensor, g: torch.Tensor, w_shape) -> torch.Tensor:
    """dw of the SAME conv in true f32 on the values of x (D, H, W, Cin) and
    g (D, H, W, Cout); returns (3, 3, 3, Cin, Cout) f32."""
    xc = x.float().permute(3, 0, 1, 2)[None]
    gc = g.float().permute(3, 0, 1, 2)[None]
    with no_tf32_conv():
        dw = torch.nn.grad.conv3d_weight(xc, (w_shape[4], w_shape[3], 3, 3, 3), gc, padding=1)
    return dw.permute(2, 3, 4, 1, 0)


class AtticConv(torch.autograd.Function):
    """``conv3x3x3_same`` with the backward of the JAX custom_vjp
    ``pallas_conv3x3`` (``_pc_fwd`` / ``_pc_bwd``); saves (x, w)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3x3_same(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w_flip = torch.flip(w, dims=(0, 1, 2)).transpose(3, 4)
            dx = conv3x3x3_same(g.contiguous(), w_flip.to(g.dtype)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _dw_f32(x, g, w.shape).to(w.dtype)
        return dx, dw


def attic_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable single-volume conv: (D, H, W, Cin) x (3, 3, 3, Cin,
    Cout); forward and dx on the kernel, dw by the framework in f32."""
    return AtticConv.apply(x, w)


def conv_shape_ok(shape: tuple[int, ...], cin: int) -> bool:
    """The JAX gate ``pallas_conv_shape_ok`` for a (B, D, H, W, C)
    activation, kept so both packages answer alike; the CUDA kernel itself
    takes any shape."""
    if len(shape) != 5:
        return False
    _, D, H, W, C = shape
    return D % 2 == 0 and H % 8 == 0 and W % 128 == 0 and C % 8 == 0 and cin % 8 == 0


def conv_applicable(x: torch.Tensor) -> bool:
    """Would ``conv3x3x3_same`` launch its kernel on ``x``? True for a bf16
    CUDA tensor, of any shape (JAX's counterpart asks for the TPU backend
    and the Mosaic gate)."""
    return x.device.type == "cuda" and x.dtype == torch.bfloat16
