"""Dataset fingerprinting: derive preprocessing parameters from the data.

Counterpart of ``runet_tpu/data/fingerprint.py``. The shipped presets
hardcode their KiTS19 preprocessing constants (HU window, z-score stats,
target spacing); nnU-Net-era pipelines derive them from a dataset
fingerprint instead: foreground-voxel HU percentiles for the clip window,
clipped mean/std for z-scoring, median voxel spacing for the resample
target. ``plan_json`` emits that derivation in the format ``get_config``
loads.

A one-shot host-side scan over NATIVE volumes with numpy: the quantities
are order statistics over irregularly sized foreground sets, and nothing
here runs on the device. The arithmetic and the draw order of the
subsampling follow the JAX package's, so the same dataset and seed give the
same fingerprint in both.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from runet_tpu_torch.config import PreprocessConfig
from runet_tpu_torch.data.dataset import index_cases
from runet_tpu_torch.io.nifti import load_volume


def fingerprint_dataset(
    root: str | Path,
    limit: int | None = None,
    fg_sample_per_case: int = 200_000,
    pooled_cap: int = 10_000_000,
    seed: int = 0,
) -> dict:
    """Scan a KiTS19-layout dataset and return its fingerprint.

    Per labeled case: voxel spacing, native shape, per-class voxel fractions,
    and a uniform subsample of foreground (label > 0) HU values. Pooled
    across cases these give the nnU-Net-style CT scheme: clip window =
    foreground HU percentiles (0.5, 99.5); z-score stats = mean/std of the
    clipped foreground pool; resample target = median spacing per axis.

    ``fg_sample_per_case`` bounds memory per case; ``pooled_cap`` bounds the
    pooled HU array (re-subsampled if exceeded). Unlabeled cases contribute
    spacing/shape only.
    """
    recs = index_cases(root)
    if limit is not None:
        recs = recs[:limit]
    if not recs:
        raise ValueError(f"no cases found under {root}")

    rng = np.random.default_rng(seed)
    spacings, shapes = [], []
    class_voxels: dict[int, int] = {}
    total_voxels = 0
    hu_pool: list[np.ndarray] = []
    pooled = 0
    labeled = 0

    for rec in recs:
        vol = load_volume(rec.image_path)
        spacings.append(vol.spacing)
        shapes.append(vol.shape)
        if rec.label_path is None:
            continue
        labeled += 1
        seg = np.asarray(load_volume(rec.label_path).data)
        img = np.asarray(vol.data, np.float32)
        total_voxels += seg.size
        fg_mask = seg > 0
        for cls in np.unique(seg):
            if cls == 0:
                continue
            class_voxels[int(cls)] = class_voxels.get(int(cls), 0) + int(
                np.count_nonzero(seg == cls)
            )
        fg = img[fg_mask]
        if fg.size > fg_sample_per_case:
            fg = rng.choice(fg, fg_sample_per_case, replace=False)
        if fg.size:
            hu_pool.append(fg.astype(np.float32))
            pooled += fg.size
        if pooled > pooled_cap:  # re-subsample the pool to stay bounded
            cat = np.concatenate(hu_pool)
            cat = rng.choice(cat, pooled_cap, replace=False)
            hu_pool, pooled = [cat], pooled_cap

    sp = np.asarray(spacings, np.float64)
    sh = np.asarray(shapes, np.int64)
    fp: dict = {
        "num_cases": len(recs),
        "num_labeled": labeled,
        "spacing_median": np.median(sp, axis=0).tolist(),
        "spacing_p10": np.percentile(sp, 10, axis=0).tolist(),
        "spacing_p90": np.percentile(sp, 90, axis=0).tolist(),
        "shape_min": sh.min(axis=0).tolist(),
        "shape_max": sh.max(axis=0).tolist(),
    }
    if total_voxels:
        fp["class_voxel_fraction"] = {
            str(c): class_voxels[c] / total_voxels for c in sorted(class_voxels)
        }
        fp["num_classes_incl_bg"] = max(class_voxels) + 1
    if hu_pool:
        hu = np.concatenate(hu_pool)
        lo, hi = np.percentile(hu, [0.5, 99.5])
        clipped = np.clip(hu, lo, hi)
        fp["hu_fg_samples"] = int(hu.size)
        fp["hu_window"] = [float(lo), float(hi)]
        fp["hu_stats"] = [float(clipped.mean()), float(max(clipped.std(), 1e-6))]
    return fp


def suggest_preprocess(fp: dict) -> PreprocessConfig:
    """Fingerprint → PreprocessConfig (the shipped KiTS defaults stand in
    for fields an unlabeled dataset cannot supply)."""
    kw: dict = {"spacing": tuple(float(s) for s in fp["spacing_median"])}
    if "hu_window" in fp:
        kw["hu_window"] = tuple(fp["hu_window"])
        kw["hu_stats"] = tuple(fp["hu_stats"])
    return PreprocessConfig(**kw)


def plan_json(fp: dict) -> str:
    """The fingerprint + suggested preprocess as a ``--config``-compatible
    JSON document (only the ``preprocess`` section is populated; other
    sections keep preset/default values when loaded)."""
    pp = suggest_preprocess(fp)
    doc = {
        "fingerprint": fp,
        "preprocess": dataclasses.asdict(pp),
    }
    return json.dumps(doc, indent=1)
