"""Small versions of the cells for the CPU tests: the same harness path, with
overrides that shrink the phantoms and the nets (f32 compute, so the program
and the reference agree to round-off) and weights written to a temporary
npz."""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from benchmark.reference.unet import param_shapes
from benchmark.weights import seeded_init

SERVE_TRAFFIC = {"pool": 2, "shape": [64, 64, 32], "spacing": [3.2, 3.2, 4.0], "workers": 2,
                 "check_cases": 2}
TRAIN_TRAFFIC = {"pool": 2, "shape": [48, 48, 24], "spacing": [1.6, 1.6, 2.0], "check_steps": 3}


def _model(base, levels, classes):
    return {"base_features": base, "max_features": 4 * base, "num_levels": levels,
            "num_classes": classes, "compute_dtype": "float32"}


def write_npz(path, model_cfg: dict, seed: int, fg_bias: float = 0.0) -> dict:
    """Seeded weights of a small net as a flax-keyed npz; ``fg_bias`` lifts
    every foreground logit, so a coarse net finds foreground everywhere."""
    full = dict(in_channels=1, **model_cfg)
    w = {k: v.numpy() for k, v in seeded_init(full, seed, "cpu").items()}
    w["Conv_0/bias"] = np.r_[0.0, np.full(full["num_classes"] - 1, fg_bias)].astype(np.float32)
    shapes = param_shapes(full)
    assert set(shapes) == set(w)
    np.savez(path, **w)
    return {"file": str(path), "sha256": hashlib.sha256(path.read_bytes()).hexdigest()}


def serve_overrides(tmp_path, classes: int = 3, tta_axes=()) -> dict:
    coarse = _model(4, 3, 2)
    fine = _model(4, 3, classes)
    weights = {"coarse": write_npz(tmp_path / "coarse.npz", coarse, 1, fg_bias=8.0),
               "fine": write_npz(tmp_path / "fine.npz", fine, 2)}
    return {
        "config": {
            "weights": weights,
            "coarse": {"model": coarse, "infer": {"patch_size": [32, 32, 32]},
                       "cascade": {"coarse_canonical": [64, 64, 32]}},
            "fine": {"model": fine, "preprocess": {"spacing": [3.2, 3.2, 4.0]},
                     "infer": {"patch_size": [32, 32, 32]},
                     "cascade": {"roi_bucket": 16, "coarse_canonical": [64, 64, 32],
                                 "roi_margin_mm": 8.0}},
        },
        "traffic": dict(SERVE_TRAFFIC, num_classes=classes, tta_axes=list(tta_axes)),
    }


def train_overrides() -> dict:
    return {
        "config": {"fine": {"model": _model(4, 3, 5), "preprocess": {"spacing": [1.6, 1.6, 2.0]},
                            "train": {"patch_size": [16, 16, 16], "batch_size": 2}}},
        "traffic": TRAIN_TRAFFIC,
    }


def cpu_threads():
    torch.set_num_threads(2)
