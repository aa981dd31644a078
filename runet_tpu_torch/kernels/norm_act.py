"""InstanceNorm apply + affine + LeakyReLU from the conv kernels' moments,
in one CUDA pass over the model's own layouts.

``csrc/norm_lrelu_planes.cu`` replaces no Pallas kernel: it is XLA's
fusion of the norm's apply (``runet_tpu/models/norm.py``) and the
LeakyReLU after it, written by hand. Unfused, PyTorch runs the chain as
seven activation-sized launches (a cast to f32, four broadcast f32 ops, a
cast back, the LeakyReLU: 48 bytes an element in bf16) plus seven (B, C)
launches for the variance; the kernel reads the conv output once and
writes the activation once (4 bytes an element), so it is bound by those
bytes on the H100.

The arithmetic is ``models/norm.py::InstanceNorm.forward`` with moments,
then ``F.leaky_relu``, op for op: var = max(sqmean − mean², 0), rstd =
rsqrt(var + eps), z = ((y − mean)·rstd)·scale + bias, rounded to y's dtype,
then LeakyReLU on the rounded value, rounded again. ``norm_lrelu_plain`` is
that chain in torch. A CPU tensor takes it; a CUDA tensor launches the
kernel (bf16 or f32) or raises. ``models/unet3d.py::ConvNormAct`` routes a
call here when autograd records nothing for it; training keeps the
differentiable ``InstanceNorm``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from runet_tpu_torch.kernels import build

SOURCE = "norm_lrelu_planes"
# Kernel launches, one per launch on CUDA.
launches = 0

__all__ = ["norm_lrelu", "norm_lrelu_plain"]

_API = {"launch": ([ctypes.c_void_p] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                   ctypes.c_int)}


def _channel_axis(layout: str) -> int:
    if layout not in ("dchw", "dhcw"):
        raise ValueError(f"{SOURCE}: unknown layout {layout!r}; expected 'dchw' or 'dhcw'")
    return 3 if layout == "dhcw" else 2


def norm_lrelu_plain(y: torch.Tensor, mean: torch.Tensor, sqmean: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
                     negative_slope: float = 1e-2, layout: str = "dchw") -> torch.Tensor:
    """Plain PyTorch version: ``InstanceNorm.forward(y, moments=(mean,
    sqmean))`` then ``F.leaky_relu``. y (B, D, C, H, W) (``"dchw"``) or (B,
    D, H, C, W) (``"dhcw"``); mean, sqmean (B, C); scale, bias (C,); the
    result in y's dtype and layout."""
    ax = _channel_axis(layout)
    bshape = [y.shape[0]] + [1] * (y.dim() - 1)
    bshape[ax] = y.shape[ax]
    m = mean.float().reshape(bshape)
    sq = sqmean.float().reshape(bshape)
    var = torch.clamp_min(sq - m * m, 0.0)
    z = (y.float() - m) * torch.rsqrt(var + eps)
    z = z * scale.float().reshape(bshape[1:]) + bias.float().reshape(bshape[1:])
    return F.leaky_relu(z.to(y.dtype), negative_slope)


def norm_lrelu(y: torch.Tensor, mean: torch.Tensor, sqmean: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
               negative_slope: float = 1e-2, layout: str = "dchw") -> torch.Tensor:
    """The contract of ``norm_lrelu_plain``, in one launch on CUDA: y
    contiguous bf16 or f32, mean, sqmean (B, C) and scale, bias (C,) f32 on
    y's device. Not differentiable. A CPU tensor takes the plain version."""
    global launches
    ax = _channel_axis(layout)
    if y.device.type == "cpu":
        return norm_lrelu_plain(y, mean, sqmean, scale, bias, eps, negative_slope, layout)
    if y.device.type != "cuda":
        raise ValueError(f"{SOURCE}: unsupported device {y.device}")
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{SOURCE}: the CUDA kernel takes bf16 or f32, got {y.dtype}")
    if y.dim() != 5 or not y.is_contiguous():
        raise ValueError(f"{SOURCE}: y must be a contiguous 5-D tensor, got {tuple(y.shape)} "
                         f"with strides {y.stride()}")
    B, C = y.shape[0], y.shape[ax]
    params = (mean, sqmean, scale, bias)
    if any(t.dtype != torch.float32 or t.device != y.device or not t.is_contiguous()
           for t in params):
        raise TypeError(f"{SOURCE}: mean, sqmean, scale and bias must be contiguous f32 on "
                        f"{y.device}")
    if mean.shape != (B, C) or sqmean.shape != (B, C) or scale.shape != (C,) \
            or bias.shape != (C,):
        raise ValueError(f"{SOURCE}: y {tuple(y.shape)}: mean {tuple(mean.shape)}, sqmean "
                         f"{tuple(sqmean.shape)}, scale {tuple(scale.shape)}, bias "
                         f"{tuple(bias.shape)} do not match")
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    plane = y.shape[ax + 1] * y.shape[ax + 2] if layout == "dchw" else y.shape[4]
    lib = build.load(SOURCE, _API)
    sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.norm_lrelu_planes_launch(
            y.data_ptr(), *(t.data_ptr() for t in params), float(eps), float(negative_slope),
            out.data_ptr(), y.numel(), plane, y.numel() // (B * plane), C,
            int(y.dtype == torch.bfloat16), sms, stream)
    if rc != 0:
        raise RuntimeError(f"{SOURCE}: kernel launch failed with CUDA error {rc}")
    launches += 1
    return out
