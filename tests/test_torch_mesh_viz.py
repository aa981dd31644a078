"""The port's ``eval/mesh.py`` and ``eval/visualize.py`` against the JAX
package's (``tests/test_surface_mesh.py``'s shapes; meshes equal exactly,
STL and OBJ bytes identical, PNGs of the same pixel size), and the port's
``utils/debug.py``, ``utils/profiling.py`` and the warm-up's ``workers``."""

import json

import numpy as np
import pytest
import torch

from runet_tpu.eval import mesh as jmesh
from runet_tpu.eval import visualize as jviz
from runet_tpu_torch.eval import mesh as tmesh
from runet_tpu_torch.eval import visualize as tviz


def _ball(shape, center, r):
    idx = np.indices(shape).astype(np.float64)
    d2 = sum((idx[i] - center[i]) ** 2 for i in range(3))
    return d2 <= r * r


def _smoothed_ball(r=9.0, shape=(32, 32, 32), smooth=2):
    from scipy import ndimage

    m = _ball(shape, (16, 16, 16), r).astype(np.float32)
    for _ in range(smooth):
        m = ndimage.uniform_filter(m, size=3, mode="constant")
    return m


def _two_balls():
    labels = np.zeros((24, 24, 24), np.uint8)
    labels[_ball((24, 24, 24), (8, 12, 12), 5)] = 1
    labels[_ball((24, 24, 24), (17, 12, 12), 3)] = 2
    return labels


def _vessel_with_bulge():
    labels = np.zeros((40, 14, 14), np.uint8)
    labels[2:38, 6:8, 6:8] = 3
    labels[18:24, 4:10, 4:10] = 3
    return labels


AFFINE = np.array([[0.0, 0.0, 2.0, 5.0], [0.0, -1.5, 0.0, 7.0],
                   [1.0, 0.0, 0.0, -3.0], [0.0, 0.0, 0.0, 1.0]])


def _equal_meshes(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("field,level,affine", [
    (lambda: _smoothed_ball(), 0.5, None),
    (lambda: _smoothed_ball(r=6.0, shape=(20, 24, 28), smooth=1), 0.3, AFFINE),
    (lambda: np.zeros((8, 8, 8), np.float32), 0.5, None),
], ids=["sphere", "affine", "empty"])
def test_extract_surface_equals_jax(field, level, affine):
    f = field()
    got = tmesh.extract_surface(f, level=level, affine=affine)
    want = jmesh.extract_surface(f, level=level, affine=affine)
    _equal_meshes(got, want)
    assert tmesh.mesh_stats(*got) == jmesh.mesh_stats(*want)


@pytest.mark.parametrize("labels,classes,kw", [
    (_two_balls, [1, 2], dict(smooth_iters=1)),
    (_vessel_with_bulge, [3], dict(smooth_iters=2)),
    (lambda: np.pad(np.ones((6, 6, 6), np.uint8), ((28, 6), (30, 4), (20, 14))), [1, 2],
     dict(smooth_iters=1, affine=AFFINE)),
], ids=["two_balls", "vessel_bulge", "crop_affine_and_absent_class"])
def test_labelmap_to_meshes_equals_jax(labels, classes, kw):
    lab = labels()
    got = tmesh.labelmap_to_meshes(lab, classes, **kw)
    want = jmesh.labelmap_to_meshes(lab, classes, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        _equal_meshes(got[k], want[k])
        assert tmesh.mesh_stats(*got[k]) == jmesh.mesh_stats(*want[k])


@pytest.mark.parametrize("fmt", ["stl", "obj"])
def test_mesh_files_are_byte_identical(tmp_path, fmt):
    verts, faces = jmesh.extract_surface(_smoothed_ball(), level=0.5)
    t = getattr(tmesh, f"write_{fmt}")(tmp_path / f"t.{fmt}", verts, faces)
    j = getattr(jmesh, f"write_{fmt}")(tmp_path / f"j.{fmt}", verts, faces)
    assert t.read_bytes() == j.read_bytes()
    if fmt == "stl":
        np.testing.assert_array_equal(tmesh.read_stl(t), jmesh.read_stl(j))


def _png_size(path):
    import matplotlib.image as mpimg

    return mpimg.imread(path).shape


def test_case_panel_png_matches_jax_size(tmp_path):
    pytest.importorskip("matplotlib")
    from runet_tpu_torch.data.phantom import make_phantom

    img, seg = make_phantom((32, 32, 24), num_classes=3, seed=0)
    np.testing.assert_array_equal(tviz.overlay_slice(img, seg, 2, 12),
                                  jviz.overlay_slice(img, seg, 2, 12))
    t = tviz.save_case_panel(tmp_path / "t.png", img, labels=seg, pred=seg, title="t")
    j = jviz.save_case_panel(tmp_path / "j.png", img, labels=seg, pred=seg, title="t")
    assert t.stat().st_size > 1000
    assert _png_size(t) == _png_size(j)


def test_training_curves_png_matches_jax_size(tmp_path):
    pytest.importorskip("matplotlib")
    lines = []
    for s in range(0, 100, 10):
        lines.append(json.dumps({"step": s, "wall_s": s * 0.2, "loss": 2.0 / (s + 1),
                                 "imgs_per_s": 4.0}))
        if s % 20 == 0:
            lines.append(json.dumps({"step": s, "wall_s": s * 0.2, "val_dice": s / 100}))
    metrics = tmp_path / "metrics.jsonl"
    metrics.write_text("\n".join(lines) + "\n")
    t = tviz.save_training_curves(metrics, tmp_path / "t.png", title="run")
    j = jviz.save_training_curves(metrics, tmp_path / "j.png", title="run")
    assert t.stat().st_size > 5000
    assert _png_size(t) == _png_size(j)


def test_sanitize_raises_on_injected_nan_and_restores_state():
    from runet_tpu_torch.config import ModelConfig
    from runet_tpu_torch.models.unet3d import UNet3D, init_params
    from runet_tpu_torch.utils.debug import sanitize

    model = UNet3D(ModelConfig(num_classes=3, base_features=4, num_levels=2,
                               compute_dtype="float32"), device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    x = torch.randn(1, 8, 8, 8, 1, generator=torch.Generator().manual_seed(1))
    before = torch.is_anomaly_enabled()
    hooks = len(torch.nn.modules.module._global_forward_hooks)
    with sanitize():
        assert torch.is_anomaly_enabled()
        assert len(torch.nn.modules.module._global_forward_hooks) == hooks + 1
        assert torch.isfinite(model(x)).all()  # a finite run passes
        bad = x.clone()
        bad[0, 3, 3, 3, 0] = float("nan")
        with pytest.raises(FloatingPointError, match="non-finite"):
            model(bad)
    assert torch.is_anomaly_enabled() == before
    assert len(torch.nn.modules.module._global_forward_hooks) == hooks
    model(bad)  # no hook left: the NaN passes silently again

    # Restored also when the block raises.
    with pytest.raises(ValueError):
        with sanitize():
            raise ValueError("boom")
    assert torch.is_anomaly_enabled() == before
    assert len(torch.nn.modules.module._global_forward_hooks) == hooks


def test_trace_writes_a_chrome_trace(tmp_path):
    from runet_tpu_torch.utils.profiling import annotate, trace

    with trace(tmp_path / "prof"):
        with annotate("matmul_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = sorted((tmp_path / "prof").glob("trace_*.json"))
    doc = json.loads(path.read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "matmul_span" in names


def test_trace_writes_the_program_spans_on_their_threads(tmp_path):
    import threading

    from runet_tpu_torch.utils import timing
    from runet_tpu_torch.utils.profiling import annotate, trace

    def lane():
        with timing.span("case.lane_span"):
            torch.ones(32, 32) @ torch.ones(32, 32)

    with trace(tmp_path / "prof"):
        with timing.span("case.outer_span", trace=4):
            with annotate("matmul_span"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            t = threading.Thread(target=lane)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    (path,) = sorted((tmp_path / "prof").glob("trace_*.json"))
    events = json.loads(path.read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(spans) == {"case.outer_span", "case.lane_span"}
    outer, lane_ev = spans["case.outer_span"], spans["case.lane_span"]
    (mm,) = [e for e in events if e.get("name") == "matmul_span" and e.get("ph") == "X"]
    assert outer["ph"] == "X" and outer["tid"] == mm["tid"] and outer["args"]["trace_id"] == 4
    assert lane_ev["tid"] != outer["tid"]
    assert lane_ev["args"]["parent_id"] is None
    # One clock: the profiler's event lies inside the program's span around it.
    slack = 50.0  # us
    assert outer["ts"] - slack <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= outer["ts"] + outer["dur"] + slack
    assert outer["ts"] <= lane_ev["ts"] <= outer["ts"] + outer["dur"]


def test_trace_propagates_errors(tmp_path):
    from runet_tpu_torch.utils.profiling import trace

    with pytest.raises(RuntimeError, match="inside"):
        with trace(tmp_path / "prof"):
            raise RuntimeError("inside the traced block")


def test_warmup_workers_return_the_same_keys():
    from runet_tpu_torch.config import CascadeConfig, InferConfig, PreprocessConfig
    from runet_tpu_torch.data.phantom import make_phantom
    from runet_tpu_torch.infer.cascade import ModelBundle
    from runet_tpu_torch.infer.warmup import warmup_cases

    def oracle(k):
        def apply_fn(_p, w):
            x = torch.clamp(torch.round(w[..., 0]).long(), 0, k - 1)
            return 20.0 * torch.nn.functional.one_hot(x, k).float()
        return apply_fn

    pp = dict(hu_window=(0.0, 100.0), hu_stats=(0.0, 1.0))
    coarse = ModelBundle(oracle(2), None, 2, PreprocessConfig(spacing=(2.0,) * 3, **pp),
                         InferConfig(patch_size=(16,) * 3))
    fine = ModelBundle(oracle(3), None, 3, PreprocessConfig(spacing=(1.0,) * 3, **pp),
                       InferConfig(patch_size=(16,) * 3))
    _, seg = make_phantom((40, 40, 32), spacing=(1.0, 1.0, 1.5), num_classes=3, seed=0)
    img = seg.astype(np.float32)
    cases = [(img, (1.0, 1.0, 1.5)), (img[:32], (1.0, 1.0, 1.5)), (img, (1.0, 1.0, 1.5))]
    cas = CascadeConfig(roi_margin_mm=6.0, roi_bucket=16)
    one = warmup_cases(coarse, fine, cases, cas, workers=1, device="cpu")
    two = warmup_cases(coarse, fine, iter(cases), cas, workers=2, device="cpu")
    assert list(one) == list(two) == ["case0_s", "case1_s", "case2_s", "total_s"]
    assert all(v >= 0 for v in (*one.values(), *two.values()))
