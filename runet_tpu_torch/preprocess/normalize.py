"""HU clipping + z-score normalization (counterpart of
``runet_tpu/preprocess/normalize.py``)."""

from __future__ import annotations

import torch


def normalize(
    x: torch.Tensor,
    hu_window: tuple[float, float] = (-79.0, 304.0),
    hu_stats: tuple[float, float] | None = (100.93, 76.9),
) -> torch.Tensor:
    """Clip to the HU window, then z-score with fixed stats or, when
    ``hu_stats`` is None, the volume's own mean and (population) std."""
    x = x.float()
    lo, hi = hu_window
    x = torch.clamp(x, lo, hi)
    if hu_stats is not None:
        mean, std = hu_stats
        return (x - mean) / std
    mean = x.mean()
    std = x.std(correction=0) + 1e-8
    return (x - mean) / std
