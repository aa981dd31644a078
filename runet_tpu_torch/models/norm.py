"""InstanceNorm3D with optional precomputed moments.

Counterpart of ``runet_tpu/models/norm.py``: per-(sample, channel) mean and
variance over the spatial dims, the same at train and eval (no running
stats), statistics in f32 whatever the compute dtype. The variance is the
single-pass E[x²]−µ² clamped at 0 (not two-pass), and the output is cast to
the compute dtype before the activation that follows.

With ``axis_name`` set (``ModelConfig.spatial_axis``, spatial-partition
inference), the per-rank moments are averaged over the process group bound
to that mesh axis (``parallel/comm.py``) before the variance, as the JAX
package's ``pmean`` does; equal-size shards make the mean of the ranks'
moments the moments of the whole volume.

In training, autograd saves the f32 intermediates of this plain-torch
normalisation (about four f32 copies of the activation per conv block).
"""

from __future__ import annotations

import torch
from torch import nn


class InstanceNorm(nn.Module):
    """``param_dtype`` given: the affine scale and bias are parameters with
    gradients in that dtype (the train model's f32 masters); otherwise they
    are frozen f32 (serving)."""

    def __init__(self, channels: int, eps: float = 1e-5, dtype=torch.bfloat16,
                 affine: bool = True, device=None, param_dtype=None,
                 axis_name: str | None = None):
        super().__init__()
        self.eps = eps
        self.axis_name = axis_name
        self.dtype = dtype
        self.affine = affine
        if affine:
            trainable = param_dtype is not None
            pdt = param_dtype or torch.float32
            self.scale = nn.Parameter(torch.ones(channels, dtype=pdt, device=device),
                                      requires_grad=trainable)
            self.bias = nn.Parameter(torch.zeros(channels, dtype=pdt, device=device),
                                     requires_grad=trainable)

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
        if self.axis_name is not None:
            from runet_tpu_torch.parallel.comm import axis_mean

            mean, sq = axis_mean((mean, sq), self.axis_name)
        var = torch.clamp_min(sq - mean * mean, 0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * self.scale.float().reshape(bshape[1:]) + self.bias.float().reshape(bshape[1:])
        return y.to(self.dtype)


def instance_norm_reference(x: torch.Tensor, scale=None, bias=None,
                            eps: float = 1e-5) -> torch.Tensor:
    """The f32 oracle of the InstanceNorm of an NDHWC ``x``: two-pass mean
    and variance over the spatial axes (1, 2, 3), then ``scale`` and
    ``bias`` (broadcast over the last axis, as f32 on ``x``'s device) where
    given."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    var = torch.square(xf - mean).mean(dim=(1, 2, 3), keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    if scale is not None:
        y = y * torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if bias is not None:
        y = y + torch.as_tensor(bias, dtype=torch.float32, device=x.device)
    return y
