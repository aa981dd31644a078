"""Connected-component postprocessing on the host.

Counterpart of ``runet_tpu/infer/postprocess.py``: 6-connected labeling,
keep the <=2 largest kidney components, and the component bounding boxes
that seed the cascade's ROIs. Each function goes through the port's native
tier first (``utils/native.py``, C++ union-find over z-runs) and takes the
scipy/numpy chain when the tier is unavailable.
"""

from __future__ import annotations

import numpy as np

from runet_tpu_torch.utils.native import (
    native_component_stats,
    native_keep_largest,
    native_keep_largest_in_boxes,
    native_label_components,
    native_zero_nonkept,
)


def label_components(mask: np.ndarray) -> tuple[np.ndarray, int]:
    """6-connected 3D labeling. Returns (labels int32, num_components)."""
    mask = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    out = native_label_components(mask)
    if out is not None:
        return out
    from scipy import ndimage

    lab, n = ndimage.label(mask)
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
    if foreground_classes is None:
        # Nonzero is foreground: one fused native call over the whole
        # volume as a single box (no int32 label volume).
        out = np.ascontiguousarray(seg.copy())
        if out.dtype == np.uint8:
            box = np.asarray([[0, 0, 0, *out.shape]], np.int64)
            if native_keep_largest_in_boxes(out, box, max_components, min_voxels):
                return out
        fg = seg > 0
    else:
        fg = np.isin(seg, foreground_classes)
    labels, n = label_components(fg)
    if n == 0:
        return seg
    out = np.ascontiguousarray(seg.copy())
    if out.dtype == np.uint8 and native_keep_largest(out, labels, n, max_components, min_voxels):
        return out
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
    globally across boxes. One fused native call when the canvas is a
    C-contiguous uint8 array; the per-box label chain otherwise."""
    boxes = _merge_overlapping_boxes(boxes)
    out = seg if inplace else seg.copy()
    if out.dtype == np.uint8 and out.flags.c_contiguous and boxes:
        arr = np.asarray([np.concatenate([lo, hi]) for lo, hi in boxes], np.int64)
        if native_keep_largest_in_boxes(out, arr, max_components, min_voxels):
            return out
    crops, size_chunks = [], []
    for lo, hi in boxes:
        # A copy: a whole-volume box would otherwise alias ``out``.
        crop = out[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].copy()
        labels, n = label_components(crop > 0)
        crops.append((crop, labels, n))
        stats = native_component_stats(labels, n)
        sizes = stats[0] if stats is not None else component_sizes(labels, n)
        size_chunks.append(sizes.astype(np.int64))
    all_sizes = np.concatenate(size_chunks) if size_chunks else np.zeros(0, np.int64)
    k = min(max_components, all_sizes.size)
    top = np.argpartition(all_sizes, -k)[-k:] if k else np.zeros(0, np.intp)
    top = top[all_sizes[top] > min_voxels]
    offsets = np.cumsum([0] + [s.size for s in size_chunks])
    for bi, (lo, hi) in enumerate(boxes):
        crop, labels, n = crops[bi]
        if n == 0:
            continue
        keep_lut = np.zeros(n + 1, np.uint8)
        local = top[(top >= offsets[bi]) & (top < offsets[bi + 1])] - offsets[bi]
        keep_lut[local + 1] = 1
        if crop.dtype != np.uint8 or not native_zero_nonkept(crop, labels, keep_lut):
            crop[~keep_lut.view(np.bool_)[labels]] = 0
        out[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = crop
    return out


def component_bounding_boxes(mask: np.ndarray, max_components: int = 2, min_voxels: int = 32):
    """(lo, hi) inclusive-exclusive voxel bounds of the largest components,
    ordered by size."""
    labels, n = label_components(mask)
    if n == 0:
        return []
    stats = native_component_stats(labels, n)
    if stats is not None:
        sizes, all_boxes = stats
    else:
        from scipy import ndimage

        sizes = component_sizes(labels, n)
        objects = ndimage.find_objects(labels)
        all_boxes = np.asarray([[s.start for s in sl] + [s.stop for s in sl] for sl in objects],
                               np.int64)
    order = np.argsort(sizes)[::-1]
    return [(all_boxes[i, :3].copy(), all_boxes[i, 3:].copy())
            for i in order[:max_components] if sizes[i] >= min_voxels]
