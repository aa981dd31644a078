"""Per-class Dice and the KiTS19 composite scores on host label maps
(the Dice part of ``runet_tpu/eval/evaluate.py::evaluate_prediction``)."""

from __future__ import annotations

import numpy as np


def _dice(p: np.ndarray, g: np.ndarray) -> float:
    denom = float(p.sum()) + float(g.sum())
    return 2.0 * float(np.logical_and(p, g).sum()) / denom if denom > 0 else 1.0


def evaluate_prediction(pred: np.ndarray, gt: np.ndarray, num_classes: int) -> dict:
    """``dice_c<k>`` per class (1.0 where a class is absent from both),
    ``kidney_composite`` (classes {1, 2} merged) and
    ``tumor`` (class 2)."""
    out = {f"dice_c{k}": _dice(pred == k, gt == k) for k in range(num_classes)}
    out["kidney_composite"] = _dice((pred == 1) | (pred == 2), (gt == 1) | (gt == 2))
    out["tumor"] = _dice(pred == 2, gt == 2)
    return out
