"""KiTS19-layout dataset index and the preprocessed case cache.

Counterpart of ``runet_tpu/data/dataset.py``. Preprocessing (static-scale
resample + HU normalize) runs once per case on the device; the result is
kept on the host as f32/uint8 arrays with per-class foreground coordinate
lists, so the patch sampler is O(1) per draw and training moves one batch
to the device per step.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from runet_tpu_torch import resolve_device
from runet_tpu_torch.config import PreprocessConfig
from runet_tpu_torch.io.nifti import load_volume
from runet_tpu_torch.preprocess.normalize import normalize
from runet_tpu_torch.preprocess.resample import output_shape_for_spacing, resample

# Foreground coordinates kept per class (a seeded random subset beyond it).
MAX_FG_PER_CLASS = 100_000


@dataclasses.dataclass
class CaseRecord:
    case_id: str
    image_path: Path
    label_path: Path | None


@dataclasses.dataclass
class PreparedCase:
    case_id: str
    image: np.ndarray  # (X, Y, Z) float32, normalized, target spacing
    labels: np.ndarray | None  # (X, Y, Z) uint8, target spacing
    native_shape: tuple[int, int, int]
    native_spacing: tuple[float, float, float]
    affine: np.ndarray
    # Per-class foreground voxel coordinates (N_c, 3) for fg-biased sampling.
    fg_coords: dict[int, np.ndarray] | None = None
    # Cached image minimum (the sampler's pad value).
    image_min: float | None = None


def index_cases(root: str | Path) -> list[CaseRecord]:
    """Scan a KiTS19-layout directory (``case_*/imaging.nii[.gz]``, optional
    ``segmentation.nii[.gz]``), sorted by case id."""
    root = Path(root)
    records = []
    for d in sorted(root.glob("case_*")):
        img = d / "imaging.nii.gz"
        if not img.exists():
            img = d / "imaging.nii"
        if not img.exists():
            continue
        seg = d / "segmentation.nii.gz"
        if not seg.exists():
            seg = d / "segmentation.nii"
        records.append(CaseRecord(d.name, img, seg if seg.exists() else None))
    return records


def prepare_case(rec: CaseRecord, pp: PreprocessConfig, device=None) -> PreparedCase:
    """Load one case, resample it to ``pp.spacing`` and normalize it on
    ``device`` (CUDA unless named), and keep the result on the host."""
    dev = resolve_device(device)
    vol = load_volume(rec.image_path)
    native_shape = vol.shape
    native_spacing = vol.spacing
    out_shape = output_shape_for_spacing(native_shape, native_spacing, pp.spacing)
    scale = tuple(d / s for s, d in zip(native_spacing, pp.spacing))

    x = torch.from_numpy(np.array(vol.data, np.float32)).to(dev)
    img = normalize(resample(x, out_shape, scale, method="linear"), pp.hu_window, pp.hu_stats)
    img = img.cpu().numpy().astype(np.float32)

    labels = None
    fg = None
    if rec.label_path is not None:
        seg = load_volume(rec.label_path)
        lab = resample(torch.from_numpy(np.array(seg.data, np.int32)).to(dev), out_shape,
                       scale, method="nearest")
        labels = lab.cpu().numpy().astype(np.uint8)
        rng = np.random.default_rng(0)
        fg = {}
        for cls in np.unique(labels):
            if cls == 0:
                continue
            coords = np.argwhere(labels == cls)
            if len(coords) > MAX_FG_PER_CLASS:
                coords = coords[rng.choice(len(coords), MAX_FG_PER_CLASS, replace=False)]
            fg[int(cls)] = coords.astype(np.int32)

    return PreparedCase(
        case_id=rec.case_id,
        image=img,
        labels=labels,
        native_shape=native_shape,
        native_spacing=native_spacing,
        affine=vol.affine,
        fg_coords=fg,
    )


def _pp_key(pp: PreprocessConfig) -> str:
    return json.dumps(
        {
            "spacing": list(pp.spacing),
            "hu_window": list(pp.hu_window),
            "hu_stats": list(pp.hu_stats) if pp.hu_stats else None,
        },
        sort_keys=True,
    )


def prepare_case_cached(rec: CaseRecord, pp: PreprocessConfig, cache_dir: Path,
                        device=None) -> PreparedCase:
    """Disk-backed ``prepare_case``: preprocess once, then memory-map. The
    cache key is the preprocess config; a changed config re-preprocesses.
    An entry is built in a process-unique staging directory and renamed into
    place, so a reader never maps a torn file."""
    d = Path(cache_dir) / rec.case_id
    meta_p = d / "meta.json"
    key = _pp_key(pp)
    if meta_p.exists():
        meta = json.loads(meta_p.read_text())
        if meta.get("pp_key") == key:
            labels = None
            fg = None
            if (d / "labels.npy").exists():
                labels = np.load(d / "labels.npy", mmap_mode="r")
                with np.load(d / "fg.npz") as fgz:
                    fg = {int(k): fgz[k] for k in fgz.files}
            return PreparedCase(
                case_id=rec.case_id,
                image=np.load(d / "image.npy", mmap_mode="r"),
                labels=labels,
                native_shape=tuple(meta["native_shape"]),
                native_spacing=tuple(meta["native_spacing"]),
                affine=np.asarray(meta["affine"]),
                fg_coords=fg,
            )
    pc = prepare_case(rec, pp, device=device)
    stage = d.with_name(f".{d.name}.tmp.{os.getpid()}")
    if stage.exists():
        shutil.rmtree(stage)
    stage.mkdir(parents=True)
    np.save(stage / "image.npy", pc.image)
    if pc.labels is not None:
        np.save(stage / "labels.npy", pc.labels)
        np.savez(stage / "fg.npz", **{str(k): v for k, v in (pc.fg_coords or {}).items()})
    (stage / "meta.json").write_text(json.dumps({
        "pp_key": key,
        "native_shape": list(pc.native_shape),
        "native_spacing": list(pc.native_spacing),
        "affine": np.asarray(pc.affine).tolist(),
    }))
    if d.exists():  # a concurrent preparer (or a stale config) got here first
        shutil.rmtree(d)
    try:
        os.replace(stage, d)
    except OSError:
        # Lost a creation race where replace-onto-nonempty fails: the
        # winner's entry is complete, use it.
        shutil.rmtree(stage, ignore_errors=True)
    return dataclasses.replace(
        pc,
        image=np.load(d / "image.npy", mmap_mode="r"),
        labels=np.load(d / "labels.npy", mmap_mode="r") if pc.labels is not None else None,
    )


def prepare_dataset(root: str | Path, pp: PreprocessConfig, limit: int | None = None,
                    cache_dir: str | Path | None = None, device=None) -> list[PreparedCase]:
    """Preprocess every case; with ``cache_dir``, disk-cached and
    memory-mapped."""
    recs = index_cases(root)
    if limit is not None:
        recs = recs[:limit]
    if cache_dir is None:
        return [prepare_case(r, pp, device=device) for r in recs]
    return [prepare_case_cached(r, pp, Path(cache_dir), device=device) for r in recs]


def split_folds(cases: list, num_folds: int, fold: int) -> tuple[list, list]:
    """Deterministic K-fold split → (train_cases, val_cases), round-robin
    over the dataset order."""
    if not 2 <= num_folds <= len(cases):
        raise ValueError(f"num_folds={num_folds} must be in [2, num_cases={len(cases)}]")
    if not 0 <= fold < num_folds:
        raise ValueError(f"fold={fold} out of range for num_folds={num_folds}")
    val = [c for i, c in enumerate(cases) if i % num_folds == fold]
    trn = [c for i, c in enumerate(cases) if i % num_folds != fold]
    return trn, val
