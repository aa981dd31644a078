"""Standalone InstanceNorm + affine + LeakyReLU on a channels-innermost
activation, in two CUDA passes.

Counterpart of ``runet_tpu/kernels/attic/fused_norm.py``. The (B, D, H, W,
C) activation is viewed as (B, S, C), S = D·H·W:

- pass 1, ``csrc/instance_norm_stats.cu`` (replaces ``_stats_kernel``):
  per-(sample, channel) Σx and Σx² in f32 over S-tiles, the tiles' partials
  reduced in a fixed order by a second pass;
- between the passes, the (B, C) arithmetic in torch, as JAX leaves it to
  XLA: mean = Σx/S, var = max(Σx²/S − mean², 0), rstd = rsqrt(var + eps);
- pass 2, ``csrc/instance_norm_lrelu_apply.cu`` (replaces
  ``_apply_kernel``): ((x − mean)·rstd)·scale + bias, then LeakyReLU, in
  f32, output in x's dtype.

Two reads and one write of the activation, the least for an exact
(non-streaming) instance norm; both kernels are bound by those bytes on the
H100. The variance is the single-pass E[x²]−µ² clamped at 0, as
``models/norm.py`` does; the JAX kernel does not clamp (a reference bug not
copied: a constant channel can give var < 0 there and a NaN rstd).

Both kernels take bf16 and f32. A CPU tensor takes the plain version; a
CUDA tensor launches the kernels or raises. No model config routes here.
"""

from __future__ import annotations

import ctypes

import torch

from runet_tpu_torch.kernels import build

STATS_SOURCE = "instance_norm_stats"
APPLY_SOURCE = "instance_norm_lrelu_apply"
# Kernel launches, one per launch on CUDA.
stats_launches = 0
apply_launches = 0

__all__ = ["fused_instance_norm_lrelu", "fused_instance_norm_lrelu_plain",
           "reference_instance_norm_lrelu", "instance_norm_stats", "instance_norm_stats_plain",
           "instance_norm_lrelu_apply", "instance_norm_lrelu_apply_plain"]

_API = {
    STATS_SOURCE: {
        "launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int),
        "tile_rows": ([ctypes.c_longlong] * 2, ctypes.c_int),
    },
    APPLY_SOURCE: {
        "launch": ([ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p], ctypes.c_int),
        "tile_rows": ([ctypes.c_longlong] * 2, ctypes.c_int),
    },
}


def _as_bsc(x: torch.Tensor) -> torch.Tensor:
    if x.dim() < 3:
        raise ValueError(f"expected (B, ..., C) with at least 3 dims, got {tuple(x.shape)}")
    return x.reshape(x.shape[0], -1, x.shape[-1])


def _check_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the CUDA kernel takes bf16 or f32, got {x.dtype}")


def _grid(lib, name: str, B: int, S: int) -> tuple[int, int]:
    ts = int(getattr(lib, f"{name}_tile_rows")(B, S))
    return ts, -(-S // ts)


def instance_norm_stats_plain(x: torch.Tensor):
    """Plain PyTorch version of the stats kernel: (Σx, Σx²) over S in f32,
    each (B, C), of x (B, S, C) (or (B, D, H, W, C))."""
    xf = _as_bsc(x).float()
    return xf.sum(dim=1), (xf * xf).sum(dim=1)


def instance_norm_stats(x: torch.Tensor):
    """Per-(sample, channel) (Σx, Σx²) f32 of x (B, S, C) or (B, D, H, W, C),
    bf16 or f32. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    global stats_launches
    xs = _as_bsc(x)
    if xs.device.type == "cpu":
        return instance_norm_stats_plain(xs)
    _check_cuda(xs, STATS_SOURCE)
    xs = xs.contiguous()
    B, S, C = xs.shape
    lib = build.load(STATS_SOURCE, _API[STATS_SOURCE])
    ts, n_tiles = _grid(lib, STATS_SOURCE, B, S)
    psum = torch.empty((B, C, n_tiles), dtype=torch.float32, device=xs.device)
    psq = torch.empty_like(psum)
    sums = torch.empty((B, C), dtype=torch.float32, device=xs.device)
    sqs = torch.empty_like(sums)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = getattr(lib, f"{STATS_SOURCE}_launch")(
            xs.data_ptr(), psum.data_ptr(), psq.data_ptr(), sums.data_ptr(), sqs.data_ptr(),
            B, S, C, int(xs.dtype == torch.bfloat16), ts, n_tiles, stream)
    if rc != 0:
        raise RuntimeError(f"{STATS_SOURCE}: kernel launch failed with CUDA error {rc}")
    stats_launches += 1
    return sums, sqs


def _apply_args(x, mean, rstd, scale, bias):
    xs = _as_bsc(x)
    B, C = xs.shape[0], xs.shape[2]
    if mean.shape != (B, C) or rstd.shape != (B, C) or scale.numel() != C or bias.numel() != C:
        raise ValueError(f"x {tuple(x.shape)}: mean {tuple(mean.shape)}, rstd "
                         f"{tuple(rstd.shape)}, scale {tuple(scale.shape)}, bias "
                         f"{tuple(bias.shape)} do not match")
    return xs, mean.float(), rstd.float(), scale.reshape(C).float(), bias.reshape(C).float()


def instance_norm_lrelu_apply_plain(x, mean, rstd, scale, bias, negative_slope: float = 1e-2):
    """Plain PyTorch version of the apply kernel: z = ((x − mean)·rstd)·scale
    + bias in f32, one rounding per operation in that order, then
    LeakyReLU (z >= 0 ? z : z·slope), cast to x's dtype; x (B, S, C) or
    (B, D, H, W, C), mean and rstd (B, C), scale and bias (C,)."""
    xs, mean, rstd, scale, bias = _apply_args(x, mean, rstd, scale, bias)
    z = (xs.float() - mean[:, None]) * rstd[:, None] * scale + bias
    z = torch.where(z >= 0, z, z * negative_slope)
    return z.to(x.dtype).reshape(x.shape)


def instance_norm_lrelu_apply(x, mean, rstd, scale, bias, negative_slope: float = 1e-2):
    """The apply pass: the contract of ``instance_norm_lrelu_apply_plain``.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 or f32) or raises."""
    global apply_launches
    if x.device.type == "cpu":
        return instance_norm_lrelu_apply_plain(x, mean, rstd, scale, bias, negative_slope)
    xs, mean, rstd, scale, bias = _apply_args(x, mean, rstd, scale, bias)
    _check_cuda(xs, APPLY_SOURCE)
    params = [t.contiguous() for t in (mean, rstd, scale, bias)]
    if any(t.device != xs.device for t in params):
        raise ValueError(f"{APPLY_SOURCE}: mean, rstd, scale and bias must be on {xs.device}")
    xs = xs.contiguous()
    B, S, C = xs.shape
    lib = build.load(APPLY_SOURCE, _API[APPLY_SOURCE])
    ts, n_tiles = _grid(lib, APPLY_SOURCE, B, S)
    y = torch.empty_like(xs)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = getattr(lib, f"{APPLY_SOURCE}_launch")(
            xs.data_ptr(), *(t.data_ptr() for t in params), float(negative_slope), y.data_ptr(),
            B, S, C, int(xs.dtype == torch.bfloat16), ts, n_tiles, stream)
    if rc != 0:
        raise RuntimeError(f"{APPLY_SOURCE}: kernel launch failed with CUDA error {rc}")
    apply_launches += 1
    return y.reshape(x.shape)


def _mean_rstd(sums, sqs, n: int, eps: float):
    """(mean, rstd) from (Σx, Σx²) over n positions; the variance is
    E[x²]−µ² clamped at 0."""
    mean = sums / n
    var = torch.clamp_min(sqs / n - mean * mean, 0.0)
    return mean, torch.rsqrt(var + eps)


def fused_instance_norm_lrelu_plain(x, scale, bias, eps: float = 1e-5,
                                    negative_slope: float = 1e-2):
    """Plain PyTorch version of ``fused_instance_norm_lrelu``: the plain
    stats and apply with the same (B, C) arithmetic between them."""
    sums, sqs = instance_norm_stats_plain(x)
    mean, rstd = _mean_rstd(sums, sqs, _as_bsc(x).shape[1], eps)
    return instance_norm_lrelu_apply_plain(x, mean, rstd, scale, bias, negative_slope)


def fused_instance_norm_lrelu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                              eps: float = 1e-5, negative_slope: float = 1e-2) -> torch.Tensor:
    """InstanceNorm (per sample and channel over all positions) + affine +
    LeakyReLU. x: (B, D, H, W, C) or (B, S, C), bf16 or f32; scale, bias
    (C,). Returns the same shape and dtype.

    On CUDA: the stats kernel, the (B, C) mean/rstd arithmetic in torch,
    the apply kernel (two launches). A CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return fused_instance_norm_lrelu_plain(x, scale, bias, eps, negative_slope)
    sums, sqs = instance_norm_stats(x)
    mean, rstd = _mean_rstd(sums, sqs, _as_bsc(x).shape[1], eps)
    return instance_norm_lrelu_apply(x, mean, rstd, scale.to(x.device), bias.to(x.device),
                                     negative_slope)


def reference_instance_norm_lrelu(x, scale, bias, eps: float = 1e-5,
                                  negative_slope: float = 1e-2):
    """Two-pass oracle for tests (counterpart of the JAX
    ``reference_instance_norm_lrelu``): mean, then the mean of squared
    deviations, in f32."""
    xs = _as_bsc(x).float()
    mean = xs.mean(dim=1, keepdim=True)
    var = ((xs - mean) ** 2).mean(dim=1, keepdim=True)
    y = (xs - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    y = torch.where(y >= 0, y, y * negative_slope)
    return y.reshape(x.shape).to(x.dtype)
