"""The port's ``eval/surface.py`` and ``eval/evaluate.py`` against
``runet_tpu.eval`` on the same label maps, at ``tests/test_surface_mesh.py``'s
shapes: floats within 1e-12 (infinities equal), counts and keys exact;
``seconds`` and ``volumes_per_min`` are timings and left out."""

import json
import math
import types

import numpy as np
import pytest

from runet_tpu.eval import evaluate as jev
from runet_tpu.eval import surface as jsurf
from runet_tpu_torch.eval import evaluate as tev
from runet_tpu_torch.eval import surface as tsurf

TIMINGS = ("seconds", "volumes_per_min")


def _ball(shape, center, r):
    idx = np.indices(shape).astype(np.float64)
    return sum((idx[i] - center[i]) ** 2 for i in range(3)) <= r * r


def _close(got, want, where="") -> None:
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            if k not in TIMINGS:
                _close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), (where, type(got))
        if math.isfinite(want):
            assert abs(got - want) <= 1e-12, (where, got, want)
        else:
            assert got == want or (math.isnan(got) and math.isnan(want)), (where, got, want)
    else:
        assert got == want, (where, got, want)


def _label_pair(seed, shape=(24, 24, 24), classes=5):
    """A ground truth with a kidney (1), a tumor (2) and, for 5 classes, an
    artery (3) and a vein (4) tube, and a prediction that shifts, dilates
    and speckles it."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    gt = np.zeros(shape, np.uint8)
    gt[_ball(shape, (12, 12, 12), 7)] = 1
    gt[_ball(shape, (14, 10, 12), 3)] = 2
    if classes == 5:
        gt[3:21, 3, 4:6] = 3
        gt[4:20, 20, 18:20] = 4
    pred = np.roll(gt, 1, axis=int(rng.integers(0, 3)))
    grown = ndimage.binary_dilation(pred == 1) & (pred == 0)
    pred[grown & (rng.random(shape) < 0.5)] = 1
    pred[(rng.random(shape) < 0.01)] = rng.integers(0, classes)
    return pred, gt


# ------------------------------------------------------------------- surface


@pytest.mark.parametrize("spacing", [(1, 1, 1), (1.0, 1.0, 2.5), (0.8, 1.3, 3.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_surface_metrics_equal_jax(seed, spacing):
    pred, gt = _label_pair(seed)
    for k in (1, 2, 3):
        for tol in (1.0, 2.0):
            _close(tsurf.surface_metrics(pred == k, gt == k, spacing, tol),
                   jsurf.surface_metrics(pred == k, gt == k, spacing, tol))
    d_t = tsurf.surface_distances(pred == 1, gt == 1, spacing)
    d_j = jsurf.surface_distances(pred == 1, gt == 1, spacing)
    for a, b in zip(d_t, d_j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["empty-both", "empty-one", "identical", "far-apart"])
def test_surface_metrics_edge_cases_equal_jax(case):
    e = np.zeros((12, 12, 12), bool)
    f = e.copy()
    f[5, 5, 2] = True
    g = e.copy()
    g[5, 5, 8] = True
    ball = _ball((20, 20, 20), (10, 10, 10), 5)
    a, b = {"empty-both": (e, e.copy()), "empty-one": (e, f), "identical": (ball, ball),
            "far-apart": (f, g)}[case]
    got = tsurf.surface_metrics(a, b, (1, 1, 2.5))
    _close(got, jsurf.surface_metrics(a, b, (1, 1, 2.5)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cl_dice_and_skeleton_equal_jax(seed):
    pred, gt = _label_pair(seed)
    for k in (1, 3, 4):
        _close(tsurf.cl_dice(pred == k, gt == k), jsurf.cl_dice(pred == k, gt == k))
        np.testing.assert_array_equal(tsurf.morphological_skeleton(gt == k),
                                      jsurf.morphological_skeleton(gt == k))
    empty = np.zeros_like(gt, bool)
    for a, b in ((empty, empty), (empty, gt == 1)):
        _close(tsurf.cl_dice(a, b), jsurf.cl_dice(a, b))


@pytest.mark.parametrize("spacing", [(1.0, 2.0, 0.5), (0.78125, 0.78125, 3.0)])
def test_volumetry_equals_jax(spacing):
    labels = np.zeros((10, 10, 10), np.uint8)
    labels[:2] = 1
    labels[9, 9, :5] = 2
    labels[5, 5, 5] = 4
    for k in (3, 5):
        _close(tsurf.volumetry(labels, spacing, k), jsurf.volumetry(labels, spacing, k))


# ------------------------------------------------------------------ evaluate


@pytest.mark.parametrize("kw", [
    dict(),
    dict(spacing=(1, 1, 1)),
    dict(spacing=(1.0, 1.0, 2.5), surface=True),
    dict(spacing=(0.8, 1.3, 3.0), surface=True, cldice_classes=(1, 4)),
    dict(cldice_classes=(3, 9)),
], ids=["dice", "volumetry", "surface", "surface+cldice", "cldice-alone"])
@pytest.mark.parametrize("classes", [3, 5])
def test_evaluate_prediction_equals_jax(classes, kw):
    pred, gt = _label_pair(classes, classes=classes)
    _close(tev.evaluate_prediction(pred, gt, classes, **kw),
           jev.evaluate_prediction(pred, gt, classes, **kw))


def test_evaluate_prediction_three_argument_call_keeps_its_keys():
    pred, gt = _label_pair(0, classes=3)
    row = tev.evaluate_prediction(pred, gt, 3)
    assert set(row) == {"dice_c0", "dice_c1", "dice_c2", "dice_fg_mean", "kidney_composite",
                        "tumor"}
    same = tev.evaluate_prediction(gt, gt, 3)
    assert all(v == 1.0 for v in same.values())


def test_finite_mean_and_json_sanitize_equal_jax():
    for vals in ([1.0, 2.0, float("inf")], [float("inf")] * 2, [0.5], [3, 4.5]):
        _close(tev.finite_mean(vals), jev.finite_mean(vals))
    obj = {"a": [1.0, float("inf"), {"b": float("nan")}], "c": (2, float("-inf")), "d": "x"}
    got, want = tev.json_sanitize(obj), jev.json_sanitize(obj)
    assert got == want
    json.dumps(got, allow_nan=False)


@pytest.mark.parametrize("surface", [False, True])
def test_evaluate_cases_equal_jax(surface):
    pairs = [_label_pair(s, classes=5) for s in range(3)]
    pairs.append((np.zeros_like(pairs[0][1]), pairs[0][1]))  # an empty prediction: inf hd95
    tuples = [(p, g) for p, g in pairs]
    objs = [types.SimpleNamespace(case_id=f"case_{i:05d}", labels=g, pred=p)
            for i, (p, g) in enumerate(pairs)]
    for cases, fn in ((tuples, lambda c: c[0]), (objs, lambda c: c.pred)):
        got = tev.evaluate_cases(fn, cases, 5, spacing=(1.0, 1.0, 2.0), surface=surface)
        want = jev.evaluate_cases(fn, cases, 5, spacing=(1.0, 1.0, 2.0), surface=surface)
        _close(got, want)
        assert got["summary"]["volumes_per_min"] > 0
        assert all(r["seconds"] >= 0 for r in got["cases"])
        if surface:
            assert math.isinf(got["cases"][-1]["hd95_c1"])
            assert math.isfinite(got["summary"]["hd95_c1"])
