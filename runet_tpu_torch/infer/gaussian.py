"""Gaussian importance map for sliding-window blending: peak 1 at the patch
centre, sigma = patch size x sigma_scale, strictly positive (counterpart of
``runet_tpu/infer/gaussian.py``)."""

from __future__ import annotations

import numpy as np
import torch


def _axes(patch_size, sigma_scale):
    axes = []
    for n in patch_size:
        center = (n - 1) / 2.0
        sigma = max(n * sigma_scale, 1e-3)
        x = np.arange(n, dtype=np.float64)
        axes.append(np.exp(-0.5 * ((x - center) / sigma) ** 2))
    return axes


def gaussian_importance_map_device(patch_size: tuple[int, int, int],
                                   sigma_scale: float = 0.125, device=None) -> torch.Tensor:
    """(X, Y, Z) f32 map on ``device``, built from its three 1-D factors and
    floored at its smallest value, as the JAX package builds it."""
    axes = _axes(patch_size, sigma_scale)
    peak = float(axes[0].max() * axes[1].max() * axes[2].max())
    floor = float(max(axes[0].min() * axes[1].min() * axes[2].min() / peak, 1e-30))
    a, b, c = (torch.as_tensor(v / peak ** (1 / 3), dtype=torch.float32, device=device)
               for v in axes)
    out = a[:, None, None] * b[None, :, None] * c[None, None, :]
    return torch.clamp_min(out, floor)
