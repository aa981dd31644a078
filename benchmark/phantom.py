"""The benchmark's frozen copy of the synthetic renal CT phantom.

A copy of ``runet_tpu_torch/data/phantom.py::make_phantom`` as it stood when
the benchmark was written, kept here so that a later change to the program
cannot move the yardstick: ellipsoidal kidneys with known HU, an embedded
tumor sphere, and artery/vein tubes. Labels: 0=background, 1=kidney,
2=tumor, 3=artery, 4=vein. One change: each shape's test runs only over the
voxels of its bounding box (the same arithmetic on the same values; outside
the box the test is false), which makes a KiTS-size case several times
faster to build. ``benchmark/tests/test_harness_phantom.py`` holds it equal
to the program's generator bit for bit.
"""

from __future__ import annotations

import numpy as np

KIDNEY, TUMOR, ARTERY, VEIN = 1, 2, 3, 4


def _box(shape, lo, hi) -> tuple[slice, ...]:
    """The voxels whose coordinates lie within [lo, hi] on every axis, with
    one voxel of margin: outside it a shape's test is false."""
    return tuple(slice(max(0, int(np.floor(lo_a)) - 1), min(n, int(np.ceil(hi_a)) + 2))
                 for n, lo_a, hi_a in zip(shape, lo, hi))


def _ellipsoid_mask(shape, center, radii) -> np.ndarray:
    box = _box(shape, [c - r for c, r in zip(center, radii)],
               [c + r for c, r in zip(center, radii)])
    axes = [np.arange(s.start, s.stop, dtype=np.float32).reshape([-1 if i == a else 1
                                                                  for i in range(3)])
            for a, s in enumerate(box)]
    d = sum(((axes[a] - center[a]) / radii[a]) ** 2 for a in range(3))
    out = np.zeros(shape, bool)
    out[box] = d <= 1.0
    return out


def _tube_mask(shape, start, end, radius) -> np.ndarray:
    """Cylinder from start to end (voxel coords)."""
    a, b = np.asarray(start, np.float32), np.asarray(end, np.float32)
    box = _box(shape, np.minimum(a, b) - radius, np.maximum(a, b) + radius)
    coords = np.mgrid[box].astype(np.float32)
    p = np.stack([c.ravel() for c in coords], axis=1)
    ab = b - a
    denom = float(ab @ ab) + 1e-8
    t = np.clip((p - a) @ ab / denom, 0.0, 1.0)
    closest = a + t[:, None] * ab
    dist2 = ((p - closest) ** 2).sum(axis=1)
    out = np.zeros(shape, bool)
    out[box] = (dist2 <= radius * radius).reshape(coords.shape[1:])
    return out


def make_phantom(
    shape: tuple[int, int, int] = (96, 96, 64),
    spacing: tuple[float, float, float] = (1.0, 1.0, 2.0),
    num_classes: int = 3,
    seed: int = 0,
    noise_hu: float = 8.0,
    vessel_radius: float | None = None,
    kidney_scale: float = 1.0,
    tumor_hu: float = 55.0,
    tumor_lobes: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Return (image_hu float32, labels uint8), both (X, Y, Z).

    Difficulty knobs (the defaults reproduce the historical output
    bit-exactly):

    - ``tumor_hu``: default 55 is ~3σ of the HU noise above kidney (30);
      42 gives a low-contrast (~1.5σ) tumor like the iso/hypodense RCCs
      that make KiTS19 hard.
    - ``tumor_lobes``: >1 adds overlapping off-center lobes — a
      non-ellipsoidal boundary the CC postprocess and Gaussian blending
      cannot exploit.
    - ``vessel_radius``: pass ~1-1.5 (voxels) for thin artery/vein tubes
      at production resolution (default is max(1.5, X*0.02) ≈ 5 at the
      bench geometry).
    """
    rng = np.random.default_rng(seed)
    X, Y, Z = shape

    image = np.full(shape, -60.0, dtype=np.float32)  # soft-tissue background
    labels = np.zeros(shape, dtype=np.uint8)

    # Body oval (higher HU than air outside).
    body = _ellipsoid_mask(shape, (X / 2, Y / 2, Z / 2), (X / 2.1, Y / 2.1, Z / 1.5))
    image[~body] = -1000.0

    # Two kidneys, slightly jittered.
    jitter = lambda s: rng.uniform(-s, s)
    k_radii = (
        X * 0.12 * kidney_scale,
        Y * 0.10 * kidney_scale,
        Z * 0.18 * kidney_scale,
    )
    centers = [
        (X * 0.30 + jitter(2), Y * 0.45 + jitter(2), Z * 0.50 + jitter(2)),
        (X * 0.70 + jitter(2), Y * 0.45 + jitter(2), Z * 0.50 + jitter(2)),
    ]
    for c in centers:
        m = _ellipsoid_mask(shape, c, k_radii)
        image[m] = 30.0
        labels[m] = KIDNEY

    # Tumor inside the left kidney.
    t_center = (centers[0][0] + k_radii[0] * 0.3, centers[0][1], centers[0][2])
    t_rad = (k_radii[0] * 0.45,) * 3
    tm = _ellipsoid_mask(shape, t_center, t_rad)
    for _ in range(max(0, tumor_lobes - 1)):
        # Overlapping off-center lobes (extra rng draws happen only in the
        # non-default branch — default output stays bit-identical).
        off = rng.uniform(-0.6, 0.6, size=3) * t_rad[0]
        lobe_c = tuple(c + o for c, o in zip(t_center, off))
        lobe_r = tuple(r * rng.uniform(0.5, 0.9) for r in t_rad)
        tm |= _ellipsoid_mask(shape, lobe_c, lobe_r)
    image[tm] = tumor_hu
    labels[tm] = TUMOR

    if num_classes >= 5:
        # Artery and vein: tubes from volume center toward each kidney.
        mid = (X / 2, Y * 0.55, Z / 2)
        r = vessel_radius if vessel_radius is not None else max(1.5, X * 0.02)
        for cls, hu, yoff in ((ARTERY, 180.0, -3.0), (VEIN, 90.0, 3.0)):
            for c in centers:
                t = _tube_mask(shape, (mid[0], mid[1] + yoff, mid[2]), c, r)
                t &= labels == 0
                image[t] = hu
                labels[t] = cls

    image += rng.normal(0.0, noise_hu, size=shape).astype(np.float32)
    return image, labels


def make_pool(kws: list[dict], labels: bool = False, threads: int | None = None):
    """``make_phantom`` of each entry of ``kws``, in parallel threads (numpy
    releases the interpreter lock in the array work, and each case draws from
    a generator of its own, so the results are those of one thread).
    Returns the images, or (image, labels) pairs with ``labels``."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    n = max(1, min(len(kws), threads or os.cpu_count() or 1))
    with ThreadPoolExecutor(n) as pool:
        out = list(pool.map(lambda kw: make_phantom(**kw), kws))
    return out if labels else [img for img, _ in out]
