"""The readers of the program's own spans (``benchmark/program_spans.py``) on
hand-made device operations and spans: the rule that charges idle time to
the lanes' layers, the sum of the charged layers against ``device_idle``,
the tie of the device clock to the host's, and no reading where the ring
lost spans of the window or the program keeps none."""

import random
from types import SimpleNamespace

import pytest

import runet_tpu_torch.utils
from benchmark import program_spans as ps
from benchmark import run, trace
from runet_tpu_torch.utils.timing import Span

OFF = 1_000_000  # device clock minus host clock
W0, WIN = 1000, 1000  # the window on the host clock: [1000, 2000)
SERVE = ("idle_preprocess.serve", "idle_case.serve", "idle_host_post.serve")


def op(s, e, name="k"):
    """A device operation at host times [s, e)."""
    return trace.DeviceOp(name, s + OFF, e + OFF, 7)


def sp(name, s, e, sid, parent=None, thread=1, counters=None, trace_id=0):
    return Span(name, s, e, sid, parent, trace_id, thread, counters)


def ctx_of(spans, ops, dropped=0):
    rec = SimpleNamespace(spans=lambda: list(spans), dropped=lambda: dropped)
    bench = SimpleNamespace(items=[("wait_case", W0, W0 + 300)])
    return SimpleNamespace(run=SimpleNamespace(spans=bench), window={}, ops=ops,
                           window_s=WIN / 1e9, peaks=None, recorder=rec)


def read(name, ctx):
    return run.metric_reader(run.ROOT, name)(ctx)


# Idle on the host clock: [1010, 1100), [1200, 1500), [1900, 2000).
OPS = [op(1000, 1010, "marker"), op(1100, 1200), op(1500, 1700), op(1650, 1900)]
LANES = [
    sp("serving.case", 990, 1990, 1),
    sp("serving.queue", 995, 1000, 2, parent=1),
    sp("serving.run", 1000, 1600, 3, parent=1),
    sp("case.roi_enqueue", 1050, 1300, 4, parent=3),
    sp("wait.upload", 1250, 1290, 5, parent=4),
    sp("preprocess.quantize", 1400, 1450, 6, parent=3),
    sp("coarse_predict", 1450, 1480, 7, parent=3),  # a phase timer's: its parent's layer
    # the next case waits for lane 1 while it still runs this one
    sp("serving.case", 1500, 1995, 8, trace_id=1),
    sp("serving.queue", 1500, 1700, 9, parent=8, trace_id=1),
    sp("serving.run", 1150, 2000, 10, parent=20, thread=2),
    sp("host_post.paste", 1150, 1350, 11, parent=10, thread=2),
    sp("wait.fetch", 1350, 1950, 12, parent=10, thread=2),
]


def test_idle_is_charged_to_the_lanes_layers():
    ctx = ctx_of(LANES, OPS)
    assert ps.idle_intervals(ctx) == [(1010, 1100), (1200, 1500), (1900, 2000)]
    # By hand, per stretch: lane 1's innermost span | lane 2's.
    #  1010-1100 run, roi_enqueue | -            Case 90
    #  1200-1250 roi_enqueue | paste             Case 25, Host post 25
    #  1250-1290 wait | paste                    Host post 40
    #  1290-1300 roi_enqueue | paste             Case 5, Host post 5
    #  1300-1350 run | paste                     Case 25, Host post 25
    #  1350-1400 run | wait                      Case 50
    #  1400-1450 quantize | wait                 Preprocess 50
    #  1450-1500 phase span (run's layer) | wait Case 50
    #  1900-1950 - | wait                        outside 50
    #  1950-2000 - | run                         Case 50
    want = {"Case": 295.0, "Host post": 95.0, "Preprocess": 50.0, "outside": 50.0}
    assert ps.serve_idle(ctx) == pytest.approx({k: v / WIN * 100 for k, v in want.items()})
    got = [read(m, ctx) for m in SERVE]
    assert got == pytest.approx([5.0, 29.5, 9.5])
    assert sum(got) + ps.serve_idle(ctx)["outside"] == pytest.approx(read("device_idle.serve",
                                                                           ctx), abs=1e-9)
    # The window's one whole case (the first began before it) waited 200 of 495 ns.
    assert read("lane_wait_share.serve", ctx) == pytest.approx(100 * 200 / 495)


def test_the_layers_and_outside_add_up_to_device_idle():
    rng = random.Random(5)
    for _ in range(20):
        ops, t = [op(W0, W0 + 5, "marker")], W0 + 5
        while t < W0 + WIN - 20:
            s = t + rng.randrange(0, 30)
            if s >= W0 + WIN - 2:
                break
            e = min(s + rng.randrange(1, 40), W0 + WIN - 1)
            ops.append(op(s, e))
            t = rng.choice([s + 1, e])
        ops.sort(key=lambda o: o.start_ns)
        spans, sid = [], 100
        for thread in (1, 2, 3):
            t = W0 - 50
            while t < W0 + WIN:
                a, b = t, t + rng.randrange(20, 300)
                root = sid
                spans.append(sp("serving.run", a, b, root, thread=thread))
                c = a
                while c < b - 5:
                    d = min(b, c + rng.randrange(2, 60))
                    sid += 1
                    name = rng.choice(["case.roi_stage", "wait.fetch", "host_post.paste",
                                       "preprocess.quantize", "wait.upload"])
                    spans.append(sp(name, c, d, sid, parent=root, thread=thread))
                    c = d + rng.randrange(0, 10)
                sid += 1
                t = b + rng.randrange(0, 40)
        ctx = ctx_of(spans, ops)
        charged = sum(read(m, ctx) for m in SERVE) + ps.serve_idle(ctx)["outside"]
        assert charged == pytest.approx(read("device_idle.serve", ctx), abs=1e-9)
        assert all(read(m, ctx) >= 0 for m in SERVE)


def test_the_clocks_are_tied_by_the_first_operation():
    ctx = ctx_of(LANES, OPS)
    start, end, offset = ps.host_window(ctx)
    assert (start, end, offset) == (W0, W0 + WIN, OFF)
    # The same trace with the device clock moved: the same readings.
    shifted = [trace.DeviceOp(o.name, o.start_ns + 12345, o.end_ns + 12345, 7) for o in OPS]
    moved = ctx_of(LANES, shifted)
    assert ps.host_window(moved)[2] == OFF + 12345
    assert [read(m, moved) for m in SERVE] == [read(m, ctx) for m in SERVE]


STEPS = [
    sp("train_step.step", 900, 990, 50, counters=None, trace_id=2),  # set-up, before the window
    sp("train_step.augment", 900, 950, 51, parent=50, counters={"blocking_copies": 12}),
    sp("train_loop.next", 990, 1000, 52),
    sp("train_step.step", 1000, 1500, 53, trace_id=3),
    sp("train_step.augment", 1000, 1250, 54, parent=53, counters={"blocking_copies": 12}),
    sp("train_step.forward", 1250, 1400, 55, parent=53),
    sp("train_step.step", 1500, 1990, 56, trace_id=4),
    sp("train_step.augment", 1500, 1600, 57, parent=56, counters={"blocking_copies": 10}),
    sp("train_loop.sample", 1000, 1900, 58, thread=9, counters={"blocking_copies": 99}),
]


def test_train_readers():
    ctx = ctx_of(STEPS, OPS)
    assert read("blocking_copies_per_step.train", ctx) == pytest.approx(11.0)
    # idle while the step thread augments: 1010-1100 and 1200-1250
    assert read("idle_augment.train", ctx) == pytest.approx(100 * 140 / WIN)


def test_no_reading_after_the_ring_lost_spans_of_the_window(monkeypatch):
    names = SERVE + ("lane_wait_share.serve", "idle_augment.train",
                     "blocking_copies_per_step.train")
    lost = ctx_of(LANES + STEPS, OPS, dropped=3)  # the oldest kept ends inside the window
    assert all(read(m, lost) is None for m in names)
    early = [sp("setup", 10, 20, 999)] + LANES + STEPS  # dropped before the window began
    assert all(read(m, ctx_of(early, OPS, dropped=3)) is not None for m in names)
    # A program without the recorder (an older checkout): nothing to read.
    monkeypatch.setattr(runet_tpu_torch.utils, "timing", SimpleNamespace())
    bare = ctx_of(LANES, OPS)
    del bare.recorder
    assert ps.recorder(bare) is None
    assert all(read(m, bare) is None for m in names)
