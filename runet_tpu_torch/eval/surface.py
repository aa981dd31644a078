"""Surface-distance metrics and volumetry.

A copy of ``runet_tpu/eval/surface.py`` (numpy/scipy only), so the port
imports nothing of the JAX package.

The reference evaluates per-class Dice only (SURVEY.md §3.4, provenance
[RECALL]); KiTS-era renal-segmentation practice also reports boundary
metrics — 95th-percentile Hausdorff distance, average symmetric surface
distance, and normalized surface Dice at a tolerance — plus per-structure
volumetry in mL (provenance [DOMAIN]). All metrics are spacing-aware
(anisotropic voxels) and computed on host with scipy distance transforms:
boundary extraction is O(N) morphology and the EDT is scipy's native C —
this is post-hoc evaluation, not the serving path, so host numpy is the
right tier (the TPU analog would waste a compile class per volume shape).

Conventions for empty masks (matching the DeepMind surface-distance
library's semantics): both masks empty -> distances 0, NSD 1 (perfect
agreement on absence); exactly one empty -> distances +inf, NSD 0.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def _boundary(mask: np.ndarray) -> np.ndarray:
    """Voxels of ``mask`` that touch its complement (6-connectivity)."""
    if not mask.any():
        return mask
    eroded = ndimage.binary_erosion(
        mask, structure=ndimage.generate_binary_structure(3, 1), border_value=0
    )
    return mask & ~eroded


def surface_distances(
    pred: np.ndarray, gt: np.ndarray, spacing=(1.0, 1.0, 1.0)
) -> tuple[np.ndarray, np.ndarray]:
    """(pred_surface->gt_surface, gt_surface->pred_surface) distance samples
    in physical units (mm when ``spacing`` is mm/voxel)."""
    pred = np.asarray(pred, bool)
    gt = np.asarray(gt, bool)
    pred, gt = _crop_to_union(pred, gt)
    bp, bg = _boundary(pred), _boundary(gt)
    if not bp.any() and not bg.any():
        return np.zeros(1), np.zeros(1)
    if not bp.any() or not bg.any():
        return np.full(1, np.inf), np.full(1, np.inf)
    # EDT of the complement of a boundary = distance of every voxel to that
    # boundary; sampling makes it anisotropic-correct.
    dt_g = ndimage.distance_transform_edt(~bg, sampling=spacing)
    dt_p = ndimage.distance_transform_edt(~bp, sampling=spacing)
    return dt_g[bp], dt_p[bg]


def surface_metrics(
    pred: np.ndarray,
    gt: np.ndarray,
    spacing=(1.0, 1.0, 1.0),
    tolerance_mm: float = 2.0,
) -> dict:
    """hd95 / assd (average symmetric surface distance) / nsd@tolerance.

    nsd (normalized surface Dice) = fraction of surface points, pooled from
    both surfaces, lying within ``tolerance_mm`` of the other surface.
    """
    d_pg, d_gp = surface_distances(pred, gt, spacing)
    if np.isinf(d_pg).any():
        return {"hd95": float("inf"), "assd": float("inf"), "nsd": 0.0}
    both = np.concatenate([d_pg, d_gp])
    return {
        "hd95": float(np.percentile(both, 95)),
        "assd": float(both.mean()),
        "nsd": float((both <= tolerance_mm).mean()),
    }


def _crop_to_union(pred: np.ndarray, gt: np.ndarray, margin: int = 2):
    """Crop both masks to the union bounding box (+margin). Surface-to-
    surface distances and skeletons are unchanged by cropping as long as
    both structures stay inside the window; this turns O(volume) morphology
    into O(structure) — the difference between 0.1 s and 15 s per class on
    a 512^3 CT."""
    union = pred | gt
    if not union.any():
        return pred, gt
    lo, hi = [], []
    for ax in range(3):
        other = tuple(a for a in range(3) if a != ax)
        prof = union.any(axis=other)
        nz = np.flatnonzero(prof)
        lo.append(max(0, nz[0] - margin))
        hi.append(min(union.shape[ax], nz[-1] + 1 + margin))
    sl = tuple(slice(l, h) for l, h in zip(lo, hi))
    return pred[sl], gt[sl]


def morphological_skeleton(mask: np.ndarray) -> np.ndarray:
    """Medial skeleton by iterative erosion: union over k of
    erode^k(mask) - open(erode^k(mask)) (Lantuejoul's formula). Coarser
    than a true thinning skeleton but topology-tracking enough for the
    centerline-overlap metric below, with only scipy primitives."""
    st = ndimage.generate_binary_structure(3, 1)
    skel = np.zeros_like(mask, dtype=bool)
    cur = np.asarray(mask, bool)
    while cur.any():
        opened = ndimage.binary_opening(cur, structure=st)
        skel |= cur & ~opened
        cur = ndimage.binary_erosion(cur, structure=st, border_value=0)
    return skel


def cl_dice(pred: np.ndarray, gt: np.ndarray) -> float:
    """Centerline Dice (clDice, Shit et al., CVPR 2021): harmonic mean of
    topology precision (skeleton(pred) inside gt) and topology sensitivity
    (skeleton(gt) inside pred). The vessel-class metric the renal-anatomy
    configs need — a broken artery barely moves voxel Dice but collapses
    the centerline hit rate. Conventions: both masks empty -> 1.0; exactly
    one empty -> 0.0."""
    pred = np.asarray(pred, bool)
    gt = np.asarray(gt, bool)
    if not pred.any() and not gt.any():
        return 1.0
    if not pred.any() or not gt.any():
        return 0.0
    pred, gt = _crop_to_union(pred, gt)
    sp = morphological_skeleton(pred)
    sg = morphological_skeleton(gt)
    tprec = (sp & gt).sum() / max(int(sp.sum()), 1)
    tsens = (sg & pred).sum() / max(int(sg.sum()), 1)
    if tprec + tsens == 0:
        return 0.0
    return float(2.0 * tprec * tsens / (tprec + tsens))


def volumetry(labels: np.ndarray, spacing, num_classes: int) -> dict:
    """Per-class structure volume in mL (1 mL = 1000 mm^3)."""
    voxel_ml = float(np.prod(np.asarray(spacing, np.float64))) / 1000.0
    counts = np.bincount(np.asarray(labels).ravel().astype(np.int64), minlength=num_classes)
    return {f"volume_ml_c{k}": float(counts[k] * voxel_ml) for k in range(1, num_classes)}
