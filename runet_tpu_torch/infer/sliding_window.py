"""Whole-volume inference: one forward when the volume fits the single-pass
budget, else overlapping windows blended with a Gaussian importance map in
f32, then argmax.

Counterpart of ``runet_tpu/infer/sliding_window.py``. The window loop,
accumulators and fusion stay on the volume's device; the host sees only the
label map (or probabilities).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from runet_tpu_torch.infer.gaussian import gaussian_importance_map_device
from runet_tpu_torch.utils.timing import span


def compute_window_starts(dim: int, patch: int, stride: int) -> list[int]:
    """1-D window origins covering [0, dim), the last flush with the end."""
    if dim <= patch:
        return [0]
    starts = list(range(0, dim - patch + 1, stride))
    if starts[-1] != dim - patch:
        starts.append(dim - patch)
    return starts


def make_start_table(
    shape: tuple[int, int, int],
    patch_size: tuple[int, int, int],
    overlap: float,
    window_batch: int = 1,
    strides: list[int] | None = None,
) -> np.ndarray:
    """(N, 3) int32 window origins, N padded to a multiple of window_batch
    (duplicated trailing windows scale accumulator and normalizer equally).
    ``strides`` overrides the overlap-derived strides (super-windows)."""
    if strides is None:
        strides = [max(1, int(round(p * (1.0 - overlap)))) for p in patch_size]
    axes = [compute_window_starts(s, p, st) for s, p, st in zip(shape, patch_size, strides)]
    table = np.array([(a, b, c) for a in axes[0] for b in axes[1] for c in axes[2]],
                     dtype=np.int32)
    rem = len(table) % window_batch
    if rem:
        table = np.concatenate([table, np.repeat(table[-1:], window_batch - rem, 0)])
    return table


def expand_window_size(
    vol_shape: tuple[int, int, int],
    patch_size: tuple[int, int, int],
    budget_ratio: float,
    grow: int = 64,
    div: int = 32,
) -> tuple[int, ...]:
    """Grow the window from ``patch_size`` toward the volume dims under a
    voxel budget of ``budget_ratio x prod(patch_size)``, in ``grow`` steps,
    least-covered axis first; axes are clamped to the volume rounded up to
    ``div`` (U-Net divisibility)."""
    vol32 = [-(-s // div) * div for s in vol_shape]
    win = [min(p, v) for p, v in zip(patch_size, vol32)]
    budget = float(budget_ratio) * float(np.prod(patch_size))
    while True:
        grown = False
        for a in sorted(range(3), key=lambda a: win[a] / vol32[a]):
            if win[a] >= vol32[a]:
                continue
            new = min(win[a] + grow, vol32[a])
            if new * win[(a + 1) % 3] * win[(a + 2) % 3] <= budget:
                win[a] = new
                grown = True
                break
        if not grown:
            return tuple(win)


def pad_volume(vol: torch.Tensor, patch_size: tuple[int, int, int],
               pad_value) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """Pad the spatial dims of an (X, Y, Z) or (X, Y, Z, C) volume at the
    high end up to at least ``patch_size`` with the constant ``pad_value``;
    returns the volume (``vol`` itself when no axis is short) and its
    spatial shape."""
    pads = [max(0, p - s) for s, p in zip(vol.shape[:3], patch_size)]
    if any(pads):
        px, py, pz = pads
        spec = (0, pz, 0, py, 0, px) if vol.dim() == 3 else (0, 0, 0, pz, 0, py, 0, px)
        with span("wait.scalar"):  # a device pad_value is read back
            value = float(pad_value)
        vol = F.pad(vol, spec, value=value)
    return vol, tuple(vol.shape[:3])


def _single_pass(apply_fn, params, volume: torch.Tensor):
    """(X, Y, Z, C) → (uint8 labels, f32 probs (X, Y, Z, K))."""
    logits = apply_fn(params, volume[None])[0]
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.argmax(probs, dim=-1).to(torch.uint8), probs


def _sliding_window(apply_fn, params, volume, starts, gauss, patch_size, num_classes,
                    window_batch):
    X, Y, Z, _ = volume.shape
    px, py, pz = patch_size
    accum = torch.zeros((X, Y, Z, num_classes), dtype=torch.float32, device=volume.device)
    norm = torch.full((X, Y, Z, 1), 1e-12, dtype=torch.float32, device=volume.device)
    g4 = gauss[..., None]
    for grp in starts.reshape(-1, window_batch, 3):
        windows = torch.stack([volume[a:a + px, b:b + py, c:c + pz] for a, b, c in grp])
        logits = apply_fn(params, windows)
        probs = torch.softmax(logits.float(), dim=-1) * g4
        for i, (a, b, c) in enumerate(grp):
            accum[a:a + px, b:b + py, c:c + pz] += probs[i]
            norm[a:a + px, b:b + py, c:c + pz] += g4
    probs = accum / norm
    return torch.argmax(probs, dim=-1).to(torch.uint8), probs


def sliding_window_predict(
    apply_fn,
    params,
    volume: torch.Tensor,
    patch_size: tuple[int, int, int],
    num_classes: int,
    overlap: float = 0.5,
    sigma_scale: float = 0.125,
    use_gaussian: bool = True,
    window_batch: int = 1,
    pad_value: float | None = None,
    return_probs: bool = False,
    single_pass_ratio: float = 1.75,
    expand_windows: bool = True,
):
    """Whole-volume prediction: uint8 labels (and f32 probs if asked) shaped
    like the input (X, Y, Z[, C]) volume, on its device.

    apply_fn(params, windows (B, px, py, pz, C)) → logits (B, px, py, pz, K).
    Fast path: when the volume padded to 32-divisible dims is at most
    ``single_pass_ratio`` x the patch volume, one whole-volume forward
    replaces the windows. Padding uses ``pad_value``, by default the volume
    minimum."""
    vol = volume if volume.dim() == 4 else volume[..., None]
    orig = tuple(vol.shape[:3])
    if pad_value is None:
        pad_value = vol.min()
    div = min(32, min(patch_size))
    div32 = tuple(-(-s // div) * div for s in orig)
    if single_pass_ratio > 0 and np.prod(div32) <= single_pass_ratio * np.prod(patch_size):
        v, _ = pad_volume(vol, div32, pad_value)
        labels, probs = _single_pass(apply_fn, params, v.float())
    else:
        win = tuple(patch_size)
        if expand_windows and single_pass_ratio > 0:
            win = expand_window_size(orig, tuple(patch_size), single_pass_ratio,
                                     grow=2 * div, div=div)
        v, padded = pad_volume(vol, win, pad_value)
        if win == tuple(patch_size):
            starts = make_start_table(padded, win, overlap, window_batch)
        else:
            # Absolute overlap of overlap x patch voxels between adjacent
            # super-windows (the same blend margin as the patch scheme).
            strides = [max(1, w - int(round(p * overlap))) for w, p in zip(win, patch_size)]
            starts = make_start_table(padded, win, overlap, window_batch, strides=strides)
        if use_gaussian:
            gauss = gaussian_importance_map_device(win, sigma_scale, v.device)
        else:
            gauss = torch.ones(win, dtype=torch.float32, device=v.device)
        labels, probs = _sliding_window(apply_fn, params, v.float(), starts, gauss, win,
                                        num_classes, window_batch)
    labels = labels[: orig[0], : orig[1], : orig[2]]
    if return_probs:
        return labels, probs[: orig[0], : orig[1], : orig[2]]
    return labels

