"""HU clipping + z-score normalization (counterpart of
``runet_tpu/preprocess/normalize.py``)."""

from __future__ import annotations

import torch

from runet_tpu_torch.preprocess.resample import resample_to_spacing


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


def preprocess_case(
    data: torch.Tensor,
    src_spacing: tuple[float, float, float],
    dst_spacing: tuple[float, float, float],
    hu_window: tuple[float, float] = (-79.0, 304.0),
    hu_stats: tuple[float, float] | None = (100.93, 76.9),
) -> torch.Tensor:
    """The L1 pipeline for one CT volume on ``data``'s device: linear
    resample to ``dst_spacing`` (static-scale, f64 positions), HU clip,
    z-score; an f32 tensor."""
    x = resample_to_spacing(data, src_spacing, dst_spacing, method="linear")
    return normalize(x, hu_window, hu_stats)
