"""Each cell's whole run on the CPU at a small size (``tiny.py``): the
program's plain path against the reference, the control and each fault the
cell can have coming out not correct, and a new mix, cell and per-layer
metric added as new files and entries alone."""

import json
import shutil

import pytest

from benchmark import control, run
from benchmark.tests import tiny

SEED = 2**31 + 12345


@pytest.fixture(autouse=True)
def _threads():
    tiny.cpu_threads()


def _run(workload, overrides, check=None, root=run.ROOT, trace=False):
    return run.run_cell(root, workload, SEED, 1.0, trace, device="cpu", overrides=overrides,
                        check=check)


def _values(res):
    return {k: c["value"] for k, c in res["checks"].items()}


@pytest.mark.parametrize("workload,classes,tta", [("fine_kits.serve.kits", 3, ()),
                                                  ("renal_anatomy.serve.tta8", 5, (0, 1, 2))])
def test_serving_cell_agrees_with_the_reference(tmp_path, workload, classes, tta):
    res = _run(workload, tiny.serve_overrides(tmp_path, classes, tta))
    assert res["correct"], res["checks"]
    assert _values(res)["mismatch"] < 1e-3
    assert res["attempted"] >= 1 and res["failed"] == 0
    rate = run.load_cell(run.ROOT, workload).traffic["metrics"]["rate"]
    assert set(res["metrics"]) >= {rate, "setup_s"}
    assert list(res)[-1] == "checks"


class _NoDeviceTracer:
    """The profiler's place on the CPU, where there is no device to trace."""

    def __init__(self, device):
        self.ops, self.window_s, self.offset_ns = [], 1.0, 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("trace", [False, True])
def test_serving_reference_finds_the_rois(tmp_path, monkeypatch, trace):
    """The grids of the box lists the served maps match; with ``--trace 1``
    for every pool case served (the work model's shapes)."""
    monkeypatch.setattr("benchmark.trace.Tracer", _NoDeviceTracer)
    seen, served = {}, set()

    def spy(r, st, win):
        out = run.importlib.import_module("benchmark.drivers.serve").check(r, st, win)
        seen.update(win["grids"])
        served.update(win["served"])
        return out

    res = _run("fine_kits.serve.kits", tiny.serve_overrides(tmp_path), check=spy, trace=trace)
    assert res["correct"], res["checks"]
    assert seen and all(g["rois"] for g in seen.values())
    if trace:
        assert set(seen) == served


def test_serving_readings_give_what_the_tie_bound_is_set_from(tmp_path):
    (r,) = control.readings("fine_kits.serve.kits", [SEED], [], [], [], 1.0, device="cpu",
                            overrides=tiny.serve_overrides(tmp_path))
    assert r["kind"] == "program" and r["correct"]
    assert r["cases"] and all(c["own"] < 1e-3 for c in r["cases"])
    for c in r["cases"]:
        assert [m for m, _ in c["nearest"]] == sorted(m for m, _ in c["nearest"])
        assert all(v is None for _, v in c["nearest"])  # only weighed past the limit
        assert c["coarse_roundoff"]["all_max"] > 0


def test_training_cell_agrees_with_the_reference():
    res = _run("renal_anatomy.train.p128", tiny.train_overrides())
    assert res["correct"], res["checks"]
    vals = _values(res)
    assert vals["loss_gap"] < 1e-5 and vals["grad_gap_median"] < 1e-4 and vals["change_gap"] < 1e-2
    assert res["metrics"]["train_imgs_per_s"]["value"] > 0


def test_serving_control_is_not_correct(tmp_path):
    res = _run("fine_kits.serve.kits", tiny.serve_overrides(tmp_path),
               check=control.serve_control)
    assert not res["correct"], res["checks"]


def test_training_control_is_not_correct():
    res = _run("renal_anatomy.train.p128", tiny.train_overrides(), check=control.train_control)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault,workload", [
    ("labels_altered", "fine_kits.serve.kits"),
    ("state_unchanged", "renal_anatomy.train.p128"),
    ("half_batch", "renal_anatomy.train.p128"),
])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault, workload):
    over = tiny.serve_overrides(tmp_path) if "serve" in workload else tiny.train_overrides()
    with control.FAULTS[fault]():
        res = _run(workload, over)
    assert not res["correct"], res["checks"]


def test_a_mix_a_cell_and_a_metric_are_new_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(run.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((root / "benchmark/traffic/serve_kits.json").read_text())
    (root / "benchmark/traffic/serve_kits_w1.json").write_text(json.dumps(dict(mix, workers=1)))
    (root / "benchmark/limits/fine_kits.serve.w1.json").write_text(
        (root / "benchmark/limits/fine_kits.serve.kits.json").read_text())
    (root / "benchmark/metrics/cases_seen.serve.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window['served']))\n")
    bench["workloads"].append({"name": "fine_kits.serve.w1", "config": "fine_kits_cascade",
                               "traffic": "serve_kits_w1", "chips": 1, "why": "one in flight"})
    bench["per_layer"].append({"name": "cases_seen.serve", "unit": "cases", "better": "higher",
                               "source": "host_clock", "layer": "Serving",
                               "moves": "cases_per_min", "workloads": ["fine_kits.serve.w1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.load_cell(root, "fine_kits.serve.w1")
    assert spec.traffic["workers"] == 1
    assert [m["name"] for m in spec.per_layer] == ["cases_seen.serve"]
    res = _run("fine_kits.serve.w1", tiny.serve_overrides(tmp_path), root=root)
    assert res["correct"], res["checks"]
    ctx = run.SimpleNamespace(window={"served": [0, 1, 0]})
    assert run.metric_reader(root, "cases_seen.serve")(ctx) == 3.0
