"""Evaluation sweep: per-case, per-class Dice and the KiTS19 composite, with
volumetry, boundary metrics and centerline Dice on request.

Counterpart of ``runet_tpu/eval/evaluate.py``. The Dice comes from the
port's ``train/losses.py`` (f32 on the CPU, as the JAX package takes it
from its own losses); the rest is ``eval/surface.py`` on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from runet_tpu_torch.eval.surface import cl_dice, surface_metrics, volumetry
from runet_tpu_torch.train.losses import hard_dice_per_class, kits_composite_dice


def evaluate_prediction(
    pred: np.ndarray,
    gt: np.ndarray,
    num_classes: int,
    spacing=None,
    surface: bool = False,
    cldice_classes=None,
) -> dict:
    """``dice_c<k>`` per class (1.0 where a class is absent from both),
    ``dice_fg_mean``, ``kidney_composite`` (classes {1, 2} merged) and
    ``tumor`` (class 2); with ``spacing`` also ``volume_ml_c<k>``, and with
    ``surface=True`` per-foreground-class ``hd95``/``assd``/``nsd``.

    ``cldice_classes``: the classes that also get centerline Dice. None
    means the vessel classes (ids >= 3) when ``surface`` is on, none
    otherwise; an explicit iterable is honoured with or without
    ``surface``."""
    p = torch.from_numpy(np.asarray(pred).astype(np.int32))
    g = torch.from_numpy(np.asarray(gt).astype(np.int32))
    d = hard_dice_per_class(p, g, num_classes)
    comp = kits_composite_dice(p, g)
    out = {f"dice_c{k}": float(d[k]) for k in range(num_classes)}
    out["dice_fg_mean"] = float(d[1:].mean()) if num_classes > 1 else float(d.mean())
    out["kidney_composite"] = float(comp["kidney_composite"])
    out["tumor"] = float(comp["tumor"])
    if spacing is not None:
        out.update(volumetry(pred, spacing, num_classes))
        if surface:
            for k in range(1, num_classes):
                sm = surface_metrics(pred == k, gt == k, spacing)
                out.update({f"{name}_c{k}": v for name, v in sm.items()})
    if cldice_classes is not None:
        cld = set(cldice_classes)
    elif surface:
        cld = set(range(3, num_classes))
    else:
        cld = set()
    for k in sorted(cld):
        if 1 <= k < num_classes:
            out[f"cldice_c{k}"] = cl_dice(pred == k, gt == k)
    return out


def finite_mean(values) -> float:
    """Mean over the finite entries (an empty prediction's inf hd95 must not
    erase every other case's value); inf when none is finite."""
    a = np.asarray(list(values), np.float64)
    m = np.isfinite(a)
    return float(a[m].mean()) if m.any() else float("inf")


def json_sanitize(obj):
    """Non-finite floats to None, recursively (``json.dumps`` would write
    the non-standard ``Infinity``/``NaN`` tokens)."""
    if isinstance(obj, dict):
        return {k: json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_sanitize(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def evaluate_cases(predict_fn, cases, num_classes: int, spacing=None,
                   surface: bool = False) -> dict:
    """``predict_fn(case)`` -> uint8 labels at the case's shape; ``cases``
    are ``PreparedCase``-likes with ``.labels`` or (image, gt) tuples.
    ``spacing`` is the voxel spacing of the grid the predictions and masks
    live on (for a ``PreparedCase`` the preprocess spacing, not its native
    one). Returns per-case rows (with ``seconds``) and a summary of their
    finite means plus ``volumes_per_min``."""
    rows = []
    t0 = time.monotonic()
    for case in cases:
        if isinstance(case, tuple):
            cid, gt = None, case[1]
        else:
            cid, gt = case.case_id, case.labels
        t = time.monotonic()
        pred = predict_fn(case)
        dt = time.monotonic() - t
        row = evaluate_prediction(pred, np.asarray(gt), num_classes, spacing=spacing,
                                  surface=surface)
        row["case_id"] = cid
        row["seconds"] = dt
        rows.append(row)
    total = time.monotonic() - t0
    summary = {k: finite_mean(r[k] for r in rows) for k in rows[0] if k != "case_id"}
    summary["volumes_per_min"] = 60.0 * len(rows) / total
    return {"cases": rows, "summary": summary}
