"""Foreground-biased ("patch-balanced") patch sampler; a copy of
``runet_tpu/data/sampler.py`` (numpy only), so the same seed draws the same
patches as the JAX package.

Host-side numpy: sampling is index bookkeeping, not compute; the device only
sees the final fixed-size patch batch. Volumes smaller than the patch are
padded (image: min value; labels: 0).
"""

from __future__ import annotations

import numpy as np

from runet_tpu_torch.data.dataset import PreparedCase


def _crop_with_pad(
    arr: np.ndarray, start: np.ndarray, size: tuple[int, int, int], pad_value
) -> np.ndarray:
    """Crop arr[start : start+size] with out-of-range regions padded."""
    out = np.full(size, pad_value, dtype=arr.dtype)
    src_lo = np.maximum(start, 0)
    src_hi = np.minimum(start + size, arr.shape)
    dst_lo = src_lo - start
    dst_hi = dst_lo + (src_hi - src_lo)
    if np.any(src_hi <= src_lo):
        return out
    out[dst_lo[0] : dst_hi[0], dst_lo[1] : dst_hi[1], dst_lo[2] : dst_hi[2]] = arr[
        src_lo[0] : src_hi[0], src_lo[1] : src_hi[1], src_lo[2] : src_hi[2]
    ]
    return out


def sample_patch(
    rng: np.random.Generator,
    case: PreparedCase,
    patch_size: tuple[int, int, int],
    fg_prob: float = 0.5,
) -> tuple[np.ndarray, np.ndarray]:
    """Draw one (image_patch, label_patch) pair.

    With probability ``fg_prob`` the patch is centered on a random foreground
    voxel of a uniformly chosen present class (tumor as likely as kidney
    regardless of voxel counts — that is the class-balancing part); otherwise
    the origin is uniform over valid positions.
    """
    size = np.asarray(patch_size)
    start = _sample_start(rng, case, size, fg_prob)
    img = _crop_with_pad(case.image, start, tuple(size), _case_min(case))
    lab = _crop_with_pad(case.labels, start, tuple(size), 0)
    return img, lab


def _case_min(case: PreparedCase) -> float:
    """Cached volume minimum for pad values (a full O(volume) host scan per
    draw otherwise)."""
    m = getattr(case, "image_min", None)
    if m is None:
        m = float(case.image.min())
        try:
            case.image_min = m
        except Exception:  # frozen/foreign case object: just return it
            pass
    return m


def _sample_start(
    rng: np.random.Generator,
    case: PreparedCase,
    size: np.ndarray,
    fg_prob: float,
) -> np.ndarray:
    """Patch origin for one draw (fg-biased with prob fg_prob)."""
    shape = np.asarray(case.image.shape)
    use_fg = (
        case.fg_coords is not None
        and len(case.fg_coords) > 0
        and rng.uniform() < fg_prob
    )
    if use_fg:
        cls = rng.choice(sorted(case.fg_coords.keys()))
        coords = case.fg_coords[cls]
        center = coords[rng.integers(len(coords))]
        start = np.clip(center - size // 2, 0, np.maximum(shape - size, 0))
    else:
        hi = np.maximum(shape - size, 0) + 1
        start = np.array([rng.integers(h) for h in hi])
    return start


def sample_batch(
    rng: np.random.Generator,
    cases: list[PreparedCase],
    batch_size: int,
    patch_size: tuple[int, int, int],
    fg_prob: float = 0.5,
    image_dtype=np.float32,
    label_dtype=np.int32,
) -> tuple[np.ndarray, np.ndarray]:
    """Batch of patches from uniformly chosen cases.

    Returns image (B, X, Y, Z, 1) and labels (B, X, Y, Z), NDHWC. Dtypes
    are parameters so the loader can request compact transfer dtypes
    (f16/uint8) directly; crops are written straight into the preallocated
    batch (the dtype conversion happens in that one copy).
    """
    size = np.asarray(patch_size)
    images = np.empty((batch_size, *patch_size, 1), image_dtype)
    labels = np.empty((batch_size, *patch_size), label_dtype)
    for b in range(batch_size):
        case = cases[rng.integers(len(cases))]
        shape = np.asarray(case.image.shape)
        start = _sample_start(rng, case, size, fg_prob)
        end = start + size
        if np.all(start >= 0) and np.all(end <= shape):
            sl = tuple(slice(int(s), int(e)) for s, e in zip(start, end))
            images[b, ..., 0] = case.image[sl]
            labels[b] = case.labels[sl]
        else:  # volume smaller than the patch: padded crop (rare path)
            images[b, ..., 0] = _crop_with_pad(
                case.image, start, tuple(size), _case_min(case)
            )
            labels[b] = _crop_with_pad(case.labels, start, tuple(size), 0)
    return images, labels
