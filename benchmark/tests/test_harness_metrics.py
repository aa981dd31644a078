"""The per-layer readers on a hand-made trace: unions rather than sums, a
kernel's second pass attributed by what precedes it on its stream, and no
reading where there is nothing to read."""

from types import SimpleNamespace

import pytest

from benchmark import run, trace
from benchmark.peaks import H100_SXM
from benchmark.work import bound_seconds, unet_layers

MODEL = {"in_channels": 1, "base_features": 4, "max_features": 8, "num_levels": 3,
         "num_classes": 3}


def op(name, s, e, stream=7):
    return trace.DeviceOp(name, s, e, stream)


def test_union_is_not_a_sum():
    assert trace.union_ns([(0, 10), (5, 15), (20, 30)]) == 25
    ops = [op("a", 0, 10), op("b", 5, 15, stream=8), op("c", 20, 30)]
    assert trace.busy_s(ops) == 25e-9


def test_followers_on_the_same_stream_only():
    ops = [op("void v2m::conv3x3_stats_kernel<x>", 0, 10), op("reduce_moments", 10, 12),
           op("conv3x3_s2_stats_kernel", 12, 20), op("reduce_moments", 20, 22),
           op("conv3x3_stats_kernel", 22, 30, stream=9), op("elementwise", 30, 31),
           op("reduce_moments", 31, 33, stream=9)]
    convs = trace.matching(ops, ("conv3x3_stats",))
    assert [o.start_ns for o in convs] == [0, 22]
    assert [o.start_ns for o in trace.followers(ops, convs, "reduce_moments")] == [10, 31]


def test_idle_gaps_named_by_host_span():
    ops = [op("a", 0, 10), op("b", 30, 40), op("c", 45, 50)]
    gaps = trace.idle_gaps(ops, [("loader", 15, 25)], offset_ns=0)
    assert gaps == [["loader", 20e-9], ["host", 5e-9]]


def _ctx(ops, window_s=1e-3, **window):
    r = SimpleNamespace()
    return SimpleNamespace(run=r, window=window, ops=ops, window_s=window_s, peaks=H100_SXM)


def test_train_rooflines_and_idle():
    steps, patch, batch = 30000, (8, 8, 4), 2
    layers = unet_layers(MODEL, patch, batch)
    s1 = sum(bound_seconds(l.flops, l.fwd_bytes, H100_SXM) for l in layers if l.kind == "s1")
    s1 += sum(bound_seconds(l.flops, l.dx_bytes, H100_SXM) for l in layers
              if l.kind == "s1" and l.name != "enc0.0")
    dev_ns = int(round(s1 * steps * 1e9 * 2))  # kernels at half their bound
    ops = [op("conv3x3_stats_kernel", 0, dev_ns), op("other", dev_ns, dev_ns + 10)]
    ctx = _ctx(ops, window_s=(dev_ns + 10) * 2e-9, model=MODEL, patch=patch, batch=batch,
               steps=steps, loader_wait_s=0.25, elapsed_s=1.0)
    roof = run.metric_reader(run.ROOT, "conv_s1_roofline.train")(ctx)
    assert roof == pytest.approx(50.0, rel=1e-3)
    assert run.metric_reader(run.ROOT, "device_idle.train")(ctx) == pytest.approx(50.0)
    assert run.metric_reader(run.ROOT, "loader_wait_share.train")(ctx) == 25.0
    assert run.metric_reader(run.ROOT, "conv_dw_roofline.train")(ctx) is None
    assert 0 < run.metric_reader(run.ROOT, "mfu.train")(ctx) < 100


def test_serve_readers_count_every_case_and_pass():
    grids = {0: {"coarse": (8, 8, 8), "rois": [(8, 8, 4), (8, 8, 8)]}}
    w = dict(served=[0, 0], grids=grids, coarse_model=MODEL, fine_model=MODEL, tta_passes=8)
    ctx = _ctx([op("conv3x3_stats_kernel", 0, 10**6)], window_s=1.0, **w)
    flops = 2 * (sum(l.flops for l in unet_layers(MODEL, (8, 8, 8)))
                 + 8 * sum(sum(l.flops for l in unet_layers(MODEL, g)) for g in grids[0]["rois"]))
    assert run.metric_reader(run.ROOT, "mfu.serve")(ctx) == pytest.approx(
        100 * flops / 989e12)
    assert run.metric_reader(run.ROOT, "conv_s1_roofline.serve")(ctx) > 0


def test_no_reading_without_device_work():
    ctx = _ctx([], served=[], steps=0)
    for name in ("mfu.serve", "conv_s1_roofline.serve", "device_idle.serve", "mfu.train",
                 "conv_s1_roofline.train", "conv_dw_roofline.train", "device_idle.train"):
        assert run.metric_reader(run.ROOT, name)(ctx) is None
