"""The span recorder of ``runet_tpu_torch/utils/timing.py`` and the spans the
serving cascade, the train step and the loader record with it, on the CPU."""

import statistics
import threading
import time

import numpy as np
import torch

from runet_tpu_torch.config import CascadeConfig, InferConfig, ModelConfig, PreprocessConfig
from runet_tpu_torch.config import TrainConfig
from runet_tpu_torch.data.phantom import make_phantom
from runet_tpu_torch.infer.cascade import ModelBundle, predict_case, predict_cases
from runet_tpu_torch.utils import timing
from runet_tpu_torch.utils.timing import PhaseTimer, SpanRecorder

SPACING = (1.0, 1.0, 1.5)
CASCADE = CascadeConfig(roi_margin_mm=6.0, roi_bucket=16, max_components=2)
# One case's spans beneath serving.run, in the order they end: the coarse
# stage (upload, three per-axis scale uploads of the resample, the whole-
# volume stage's read of its pad value), then per ROI its staging and
# enqueue (upload, three scale uploads in and three out), then per ROI its
# fetch and paste, then keep-largest.
COARSE = ["preprocess.coarse_input", "preprocess.quantize"] + ["wait.upload"] * 4 + [
    "wait.scalar", "case.coarse_enqueue", "wait.fetch", "host_post.boxes"]
ROI = ["case.roi_stage", "preprocess.quantize"] + ["wait.upload"] * 7 + ["case.roi_enqueue"]


def _oracle(k):
    """A stand-in model that decodes the input value as the class."""
    def apply_fn(_params, w):
        x = torch.clamp(torch.round(w[..., 0]).long(), 0, k - 1)
        return 20.0 * torch.nn.functional.one_hot(x, k).float()
    return apply_fn


def _bundles():
    pp = dict(hu_window=(0.0, 100.0), hu_stats=(0.0, 1.0))
    coarse = ModelBundle(_oracle(2), None, 2, PreprocessConfig(spacing=(2.0,) * 3, **pp),
                         InferConfig(patch_size=(32,) * 3))
    fine = ModelBundle(_oracle(3), None, 3, PreprocessConfig(spacing=(1.0,) * 3, **pp),
                       InferConfig(patch_size=(32,) * 3))
    return coarse, fine


def _image(seed=0):
    _, seg = make_phantom((64, 64, 48), spacing=SPACING, num_classes=3, seed=seed)
    return seg.astype(np.float32)


def _since(first_id):
    return [s for s in timing.spans() if s.span_id > first_id]


def test_spans_nest_and_share_a_trace_across_threads():
    rec = SpanRecorder()
    with rec.span("serving.case", trace=7) as root:
        with rec.span("case.inner") as inner:
            rec.count("n", 2)
            rec.count("n")
            assert rec.current() is inner

        def lane():
            with rec.span("serving.run", trace=7, parent=root.span_id):
                with rec.span("wait.fetch"):
                    pass

        t = threading.Thread(target=lane)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    got = {s.name: s for s in rec.spans()}
    assert set(got) == {"serving.case", "case.inner", "serving.run", "wait.fetch"}
    assert got["case.inner"].parent_id == root.span_id == got["serving.run"].parent_id
    assert got["wait.fetch"].parent_id == got["serving.run"].span_id
    assert {s.trace_id for s in got.values()} == {7}
    assert got["serving.run"].thread_id == got["wait.fetch"].thread_id
    assert got["serving.run"].thread_id != got["serving.case"].thread_id
    assert got["case.inner"].counters == {"n": 3} and inner.counters == {"n": 3}
    case = got["serving.case"]
    for s in got.values():
        assert case.start_ns <= s.start_ns <= s.end_ns <= case.end_ns
    assert rec.current() is None and rec.dropped() == 0


def test_record_takes_the_open_span_as_parent_and_count_needs_one():
    rec = SpanRecorder()
    rec.count("lost")  # no open span: nowhere to go
    with rec.span("outer", trace=3) as outer:
        sid = rec.record("serving.queue", 10, 20)
        own = rec.new_id()
        rec.record("serving.case", 5, 30, trace=4, span_id=own)
    got = {s.name: s for s in rec.spans()}
    assert got["serving.queue"] == (("serving.queue", 10, 20, sid, outer.span_id, 3)
                                    + (threading.get_native_id(), None))
    assert got["serving.case"].span_id == own and got["serving.case"].trace_id == 4
    assert got["outer"].counters is None


def test_ring_is_bounded_and_counts_what_it_dropped():
    rec = SpanRecorder(capacity=8)
    for i in range(20):
        with rec.span(f"s{i}"):
            pass
    kept = rec.spans()
    assert [s.name for s in kept] == [f"s{i}" for i in range(12, 20)]
    assert rec.dropped() == 12
    assert timing.RING_SPANS >= 2 ** 17 and timing.RECORDER._ring.maxlen == timing.RING_SPANS


def test_predict_cases_records_one_tree_per_case():
    coarse, fine = _bundles()
    images = [_image(0), _image(1), _image(0)]
    first = timing.new_id()
    out = list(predict_cases(coarse, fine, [(im, SPACING) for im in images], CASCADE,
                             workers=2, device="cpu"))
    assert len(out) == 3
    spans = _since(first)
    by_id = {s.span_id: s for s in spans}
    cases = sorted((s for s in spans if s.name == "serving.case"), key=lambda s: s.trace_id)
    assert [c.trace_id for c in cases] == [0, 1, 2]
    for case in cases:
        tree = [s for s in spans if s.trace_id == case.trace_id and s is not case]
        kids = {s.name: s for s in tree if s.parent_id == case.span_id}
        assert set(kids) == {"serving.queue", "serving.run", "serving.hold"}
        q, run, hold = kids["serving.queue"], kids["serving.run"], kids["serving.hold"]
        assert case.start_ns <= q.start_ns <= q.end_ns <= run.start_ns
        assert run.end_ns <= hold.start_ns <= hold.end_ns <= case.end_ns
        assert run.thread_id != case.thread_id
        inner = sorted((s for s in tree if _under(s, run, by_id)), key=lambda s: s.end_ns)
        assert len(inner) == len(tree) - 3  # all but queue, run and hold
        for s in inner:
            assert s.thread_id == run.thread_id
            assert run.start_ns <= s.start_ns <= s.end_ns <= run.end_ns
        names = [s.name for s in inner]
        n_roi = names.count("case.roi_stage")
        assert n_roi >= 1
        assert names == (COARSE + ROI * n_roi + ["wait.fetch", "host_post.paste"] * n_roi
                         + ["host_post.keep_largest"])


def _under(span, root, by_id):
    while span.parent_id is not None and span.parent_id in by_id:
        if span.parent_id == root.span_id:
            return True
        span = by_id[span.parent_id]
    return False


def test_labels_equal_with_and_without_an_open_outer_span():
    coarse, fine = _bundles()
    img = _image(2)
    plain = predict_case(coarse, fine, img, SPACING, CASCADE, device="cpu")
    first = timing.new_id()
    with timing.span("outer", trace=99) as outer:
        inside = list(predict_cases(coarse, fine, [(img, SPACING)], CASCADE, workers=2,
                                    device="cpu"))
    np.testing.assert_array_equal(inside[0], plain)
    (case,) = [s for s in _since(first) if s.name == "serving.case"]
    assert case.parent_id == outer.span_id and case.trace_id == 0


def test_phase_timer_totals_are_the_sums_of_its_spans():
    coarse, fine = _bundles()
    timer = PhaseTimer()
    for seed in (0, 1):
        predict_case(coarse, fine, _image(seed), SPACING, CASCADE, timer=timer, device="cpu")
    mine = [s for s in timing.spans() if s.span_id in set(timer.span_ids)]
    assert len(mine) == len(timer.span_ids) > 0
    sums = {}
    for s in mine:
        sums[s.name] = sums.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
    assert set(sums) == {"coarse_preprocess", "coarse_predict", "coarse_boxes", "roi_predict",
                         "roi_fetch_paste", "postprocess_cc"}
    assert timer.as_dict() == {k: round(v, 4) for k, v in sums.items()}
    off = PhaseTimer(enabled=False)
    with off.phase("x"):
        pass
    assert off.as_dict() == {} and off.span_ids == []


def test_train_step_records_its_children_and_blocking_copies():
    from runet_tpu_torch.models.unet3d import create_train_model, init_params
    from runet_tpu_torch.train.state import create_train_state, make_train_step

    cfg = ModelConfig(num_classes=3, base_features=4, num_levels=2, compute_dtype="float32")
    model = init_params(create_train_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    state = create_train_state(model, TrainConfig(warmup_steps=0))
    state.step = 5
    batch = 3
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(batch, 16, 16, 16, 1)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 3, (batch, 16, 16, 16)))
    first = timing.new_id()
    make_train_step(model, augment=True)(state, images, labels,
                                         (torch.Generator(), torch.Generator()), 11)
    spans = _since(first)
    (root,) = [s for s in spans if s.name == "train_step.step"]
    kids = sorted((s for s in spans if s.parent_id == root.span_id), key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["train_step.augment", "train_step.forward",
                                      "train_step.backward", "train_step.update"]
    assert {s.trace_id for s in spans} == {5} and state.step == 6
    copies = sum((s.counters or {}).get("blocking_copies", 0) for s in spans)
    assert copies == 6 * batch
    assert kids[0].counters == {"blocking_copies": 6 * batch}


def test_loader_records_its_samples_and_nexts():
    from runet_tpu_torch.data.dataset import PreparedCase
    from runet_tpu_torch.data.pipeline import PatchLoader

    img, seg = make_phantom((32, 32, 24), spacing=SPACING, num_classes=3, seed=0)
    case = PreparedCase(case_id="c0", image=img.astype(np.float32), labels=seg,
                        native_shape=img.shape, native_spacing=SPACING, affine=np.eye(4),
                        fg_coords={1: np.argwhere(seg == 1).astype(np.int32)})
    first = timing.new_id()
    loader = PatchLoader([case], batch_size=2, patch_size=(16, 16, 16), seed=0, device="cpu")
    try:
        for _ in range(3):
            next(loader)
    finally:
        loader.close()
    spans = _since(first)
    nexts = [s for s in spans if s.name == "train_loop.next"]
    samples = [s for s in spans if s.name == "train_loop.sample"]
    assert len(nexts) == 3 and len(samples) >= 3
    assert {s.thread_id for s in nexts} == {threading.get_native_id()}
    assert threading.get_native_id() not in {s.thread_id for s in samples}


def test_a_span_costs_under_5_us():
    rec = SpanRecorder()
    per = []
    for _ in range(10_000):
        a = time.perf_counter_ns()
        with rec.span("x"):
            pass
        per.append(time.perf_counter_ns() - a)
    assert statistics.median(per) < 5_000
