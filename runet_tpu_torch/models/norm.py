"""InstanceNorm3D with optional precomputed moments.

Counterpart of ``runet_tpu/models/norm.py``: per-(sample, channel) mean and
variance over the spatial dims, the same at train and eval (no running
stats), statistics in f32 whatever the compute dtype. The variance is the
single-pass E[x²]−µ² clamped at 0 (not two-pass), and the output is cast to
the compute dtype before the activation that follows.
"""

from __future__ import annotations

import torch
from torch import nn


class InstanceNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5, dtype=torch.bfloat16,
                 affine: bool = True, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.affine = affine
        if affine:
            self.scale = nn.Parameter(torch.ones(channels, device=device), requires_grad=False)
            self.bias = nn.Parameter(torch.zeros(channels, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor, moments=None, channel_axis: int = 2) -> torch.Tensor:
        """x: (B, ...) with channels on ``channel_axis``; ``moments``: the
        per-(sample, channel) f32 (mean, sq_mean) of shape (B, C), e.g. from
        the fused conv kernels, so the activation is not re-read for them."""
        ax = channel_axis % x.dim()
        bshape = [x.shape[0]] + [1] * (x.dim() - 1)
        bshape[ax] = x.shape[ax]
        xf = x.float()
        if moments is None:
            dims = tuple(a for a in range(1, x.dim()) if a != ax)
            mean = xf.mean(dim=dims, keepdim=True)
            sq = (xf * xf).mean(dim=dims, keepdim=True)
        else:
            mean = moments[0].float().reshape(bshape)
            sq = moments[1].float().reshape(bshape)
        var = torch.clamp_min(sq - mean * mean, 0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * self.scale.float().reshape(bshape[1:]) + self.bias.float().reshape(bshape[1:])
        return y.to(self.dtype)
