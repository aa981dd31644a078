"""The port's kernel-bench entry point and the latency and health
utilities it stands on, on the CPU (no CUDA here: the bench must refuse to
run, the timers run their host-clock loops)."""

import json

import pytest
import torch

from runet_tpu_torch.utils import health, kernel_bench, latency


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_kernel_bench_geometries_are_the_jax_bench_geometries():
    """scripts/kernel_bench.py:372-387: five conv geometries (roi_l0 at 10
    iterations), v3 at the two deep ones, two dw geometries."""
    conv = {n: g[:5] for n, g in kernel_bench.GEOMETRIES.items()}
    assert conv == {"fine_l0": (128, 128, 128, 32, 32), "fine_l1": (64, 64, 64, 64, 64),
                    "fine_l2": (32, 32, 32, 128, 128), "fine_l3": (16, 16, 16, 256, 256),
                    "roi_l0": (160, 192, 256, 32, 32)}
    assert kernel_bench.GEOMETRIES["roi_l0"][5] == 10
    assert kernel_bench.V3_ROWS == ("fine_l2", "fine_l3")
    assert {n: g[:5] for n, g in kernel_bench.DW_GEOMETRIES.items()} == {
        "dw_l0": (128, 128, 128, 32, 32), "dw_l1": (64, 64, 64, 64, 64)}
    assert kernel_bench.NORM_SHAPE == (2, 128, 128, 128, 32)


def test_kernel_bench_exits_nonzero_without_cuda_and_writes_nothing(no_cuda, tmp_path):
    out = tmp_path / "kb.json"
    assert kernel_bench.main(["--out", str(out)]) != 0
    assert not out.exists()


def test_kernel_bench_requires_out():
    with pytest.raises(SystemExit):
        kernel_bench.main([])


def test_timers_return_positive_host_times_on_the_cpu():
    x = torch.randn(6, 7, 8)
    step = lambda t: t * 0.5 + 1.0  # noqa: E731
    for ms in (latency.scanned_ms(step, x, iters=4, reps=2),
               latency.chained_ms(step, (x,), n=3, warmup=1),
               latency.pipelined_ms(step, (x,), n=3, warmup=1)):
        assert isinstance(ms, float) and ms > 0


@pytest.mark.parametrize("step", [lambda t: t[:-1], lambda t: t.double(), lambda t: (t, t)])
def test_scanned_ms_rejects_a_step_that_is_not_shape_preserving(step):
    with pytest.raises(ValueError):
        latency.scanned_ms(step, torch.zeros(4, 4), iters=2)


def test_probe_backend_fails_fast_without_cuda(no_cuda):
    ok, detail = health.probe_backend(timeout_s=120, tries=1)
    assert ok is False and detail.startswith("probe 1/1")


def test_doctor_report_has_its_keys(no_cuda):
    report = health.doctor_report(probe_timeout_s=120)
    assert {"torch_version", "cuda_version", "env", "backend_reachable", "backend_detail",
            "kernel_build"} <= set(report)
    assert report["backend_reachable"] is False and "devices" not in report
    assert set(report["kernel_build"]) == {"dir", "entries"}
    json.dumps(report)


def test_chip_smoke_launch_shapes_records_every_kernel_module(monkeypatch):
    """chip_smoke's ``launch_shapes`` wraps the launch functions of all ten
    kernels (the attic modules' too), keys each launch by (kernel, x shape,
    Cout or C) and puts the functions back afterwards."""
    import chip_smoke
    from runet_tpu_torch.kernels import fused_block, strided_conv
    from runet_tpu_torch.kernels.attic import conv3d, conv_v3_deep, fused_norm

    def stub(*args, **kw):
        return None

    attrs = [(m, "launch_conv_stats") for m in (fused_block, strided_conv, conv3d, conv_v3_deep)]
    attrs += [(m, "launch_conv_dw") for m in (fused_block, strided_conv)]
    attrs += [(fused_norm, "instance_norm_stats"), (fused_norm, "instance_norm_lrelu_apply")]
    for m, attr in attrs:
        monkeypatch.setattr(m, attr, stub)
    x = torch.zeros((1, 4, 5, 6, 8), dtype=torch.bfloat16)
    with chip_smoke.launch_shapes() as seen:
        conv3d.launch_conv_stats(conv3d.SOURCE, x, None, 11, (4, 5, 6), "dhwc", stats=False)
        conv3d.launch_conv_stats(conv3d.SOURCE, x, None, 11, (4, 5, 6), "dhwc", stats=False)
        conv_v3_deep.launch_conv_stats(conv_v3_deep.SOURCE, x, None, 40, (4, 5, 6), "dhwc")
        fused_block.launch_conv_stats(fused_block.SOURCE, x, None, 7, (4, 5, 6))
        strided_conv.launch_conv_dw(strided_conv.DW_SOURCE, x, torch.zeros((1, 2, 9, 3, 4)))
        fused_norm.instance_norm_stats(x)
        fused_norm.instance_norm_lrelu_apply(x, None, None, None, None)
        with pytest.raises(AssertionError):
            fused_norm.instance_norm_stats(x.float())
    shape = (1, 4, 5, 6, 8)
    assert seen == {(conv3d.SOURCE, shape, 11): 2, (conv_v3_deep.SOURCE, shape, 40): 1,
                    (fused_block.SOURCE, shape, 7): 1, (strided_conv.DW_SOURCE, shape, 9): 1,
                    (fused_norm.STATS_SOURCE, shape, 8): 1, (fused_norm.APPLY_SOURCE, shape, 8): 1}
    assert all(getattr(m, attr) is stub for m, attr in attrs)


@pytest.mark.parametrize("iters,reps", [(30, 3), (4, 1)])
def test_chip_smoke_replay_counting_adds_the_graph_replays(monkeypatch, iters, reps):
    """A step that launches two stats kernels, timed by a stand-in with
    ``scanned_ms``'s CUDA structure (two warm-up calls, ``iters`` captured
    calls that run nothing, WARM_REPLAYS + reps replays): the counters see
    2 + iters calls; the card ran 2 + iters·(WARM_REPLAYS + reps) of them."""
    import chip_smoke
    from runet_tpu_torch.kernels.attic import fused_norm

    monkeypatch.setattr(fused_norm, "stats_launches", 0)
    key = (fused_norm.STATS_SOURCE, (1, 3), 3)
    seen = {key: 0}

    def step(x):
        fused_norm.stats_launches += 2
        seen[key] += 2
        return x

    def cuda_like_scanned(step, x0, iters=30, reps=3):
        step(x0)
        step(x0)
        for _ in range(iters):
            step(x0)
        return 1.0

    extra = {}
    timed = chip_smoke.replay_counting(cuda_like_scanned, seen, extra)
    assert timed(step, torch.zeros(1, 3), iters=iters, reps=reps) == 1.0
    ran = 2 * (2 + iters * (latency.WARM_REPLAYS + reps))
    assert fused_norm.stats_launches + extra[fused_norm.STATS_SOURCE] == ran
    assert seen[key] == ran
    assert all(v == 0 for k, v in extra.items() if k != fused_norm.STATS_SOURCE)
