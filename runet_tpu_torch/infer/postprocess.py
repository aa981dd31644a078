"""Connected-component postprocessing on the host (scipy).

Counterpart of ``runet_tpu/infer/postprocess.py`` without its native C++
tier (queued in ROADMAP.md): 6-connected labeling by
``scipy.ndimage.label``, keep the <=2 largest kidney components, and the
component bounding boxes that seed the cascade's ROIs.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def label_components(mask: np.ndarray) -> tuple[np.ndarray, int]:
    """6-connected 3D labeling. Returns (labels int32, num_components)."""
    lab, n = ndimage.label(np.asarray(mask).astype(np.uint8))
    return lab.astype(np.int32), int(n)


def component_sizes(labels: np.ndarray, n: int) -> np.ndarray:
    return np.bincount(labels.ravel(), minlength=n + 1)[1:]


def keep_largest_components(
    seg: np.ndarray,
    foreground_classes: tuple[int, ...] | None = None,
    max_components: int = 2,
    min_voxels: int = 0,
) -> np.ndarray:
    """Keep the ``max_components`` largest CCs of the foreground union and
    zero out everything else."""
    fg = seg > 0 if foreground_classes is None else np.isin(seg, foreground_classes)
    labels, n = label_components(fg)
    if n == 0:
        return seg
    out = np.ascontiguousarray(seg.copy())
    sizes = component_sizes(labels, n)
    order = np.argsort(sizes)[::-1]
    keep = [i + 1 for i in order[:max_components] if sizes[i] > min_voxels]
    out[fg & ~np.isin(labels, keep)] = 0
    return out


def _merge_overlapping_boxes(boxes):
    """Union-merge boxes (face-adjacent ones too) until pairwise disjoint, so
    each voxel is labeled once and a component crossing two boxes is one."""
    boxes = [(np.asarray(lo), np.asarray(hi)) for lo, hi in boxes]
    merged = True
    while merged:
        merged = False
        out = []
        for lo, hi in boxes:
            for i, (olo, ohi) in enumerate(out):
                if np.all(lo <= ohi) and np.all(olo <= hi):
                    out[i] = (np.minimum(lo, olo), np.maximum(hi, ohi))
                    merged = True
                    break
            else:
                out.append((lo, hi))
        boxes = out
    return boxes


def keep_largest_components_in_boxes(
    seg: np.ndarray,
    boxes,
    max_components: int = 2,
    min_voxels: int = 0,
    inplace: bool = False,
) -> np.ndarray:
    """``keep_largest_components`` restricted to the (merged) ROI boxes — a
    cascade prediction is zero outside them. Component sizes are ranked
    globally across boxes."""
    boxes = _merge_overlapping_boxes(boxes)
    out = seg if inplace else seg.copy()
    crops, size_chunks = [], []
    for lo, hi in boxes:
        crop = out[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].copy()
        labels, n = label_components(crop > 0)
        crops.append((crop, labels, n))
        size_chunks.append(component_sizes(labels, n).astype(np.int64))
    all_sizes = np.concatenate(size_chunks) if size_chunks else np.zeros(0, np.int64)
    k = min(max_components, all_sizes.size)
    top = np.argpartition(all_sizes, -k)[-k:] if k else np.zeros(0, np.intp)
    top = top[all_sizes[top] > min_voxels]
    offsets = np.cumsum([0] + [s.size for s in size_chunks])
    for bi, (lo, hi) in enumerate(boxes):
        crop, labels, n = crops[bi]
        if n == 0:
            continue
        keep_lut = np.zeros(n + 1, bool)
        local = top[(top >= offsets[bi]) & (top < offsets[bi + 1])] - offsets[bi]
        keep_lut[local + 1] = True
        crop[~keep_lut[labels]] = 0
        out[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = crop
    return out


def component_bounding_boxes(mask: np.ndarray, max_components: int = 2, min_voxels: int = 32):
    """(lo, hi) inclusive-exclusive voxel bounds of the largest components,
    ordered by size."""
    labels, n = label_components(mask)
    if n == 0:
        return []
    sizes = component_sizes(labels, n)
    order = np.argsort(sizes)[::-1]
    objects = ndimage.find_objects(labels)
    boxes = []
    for i in order[:max_components]:
        if sizes[i] < min_voxels:
            continue
        sl = objects[i]
        boxes.append((np.asarray([s.start for s in sl]), np.asarray([s.stop for s in sl])))
    return boxes
