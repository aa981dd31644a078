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


@pytest.mark.parametrize("name", ["conv3x3_stats", "conv3x3_stats_v2"])
def test_chip_smoke_kernel_lines_split_rows_1_and_5_by_shape_class(name):
    """The ``kernels`` entries of rows 1 and 5 carry their main-path sums by
    shape class (``ms_by_class``), without the kernel bench's shapes and the
    untimed tile cases; the other rows carry none."""
    import chip_smoke

    def case(path, x_shape, ms, launches=1):
        return {"path": path, "x_shape": list(x_shape), "cout": 32, "launches": launches,
                "reused": False, "max_abs_err": 0.01, "rel_err": 1e-4, "ms": ms,
                "plain_ms": 10 * ms, "library_ms": 2 * ms, "bound_ms": ms / 4,
                "bound_by": "operations", "element_ms": ms}

    cases = [case("serve_renal", (1, 12, 320, 6, 10), 1.0),
             case("train_renal", (2, 32, 128, 32, 32), 2.0),
             case("train_renal", (2, 128, 32, 128, 128), 4.0),
             case("kernel_bench", (1, 32, 128, 32, 32), 8.0),
             {"path": "tiles", "x_shape": [1, 4, 24, 13, 128], "cout": 32, "launches": 0,
              "reused": False, "max_abs_err": 0.02, "rel_err": 1e-4}]
    measured = {name: cases, "conv3x3_dw": [case("train", (2, 128, 32, 128, 128), 3.0)]}
    lines = {k["name"]: k for k in chip_smoke.kernel_lines(measured, {"serve": {name: 5}})}
    assert lines[name]["ms_by_class"] == {
        "deep": {"shapes": 2, "ms": 3.0, "library_ms": 6.0, "bound_ms": 0.75},
        "narrow": {"shapes": 1, "ms": 1.0, "library_ms": 2.0, "bound_ms": 0.25},
        "rest": {"shapes": 1, "ms": 4.0, "library_ms": 8.0, "bound_ms": 1.0}}
    assert lines[name]["ms"] == 15.0 and lines[name]["max_abs_err"] == 0.02
    assert lines[name]["launches"] == 5 and "ms_by_class" not in lines["conv3x3_dw"]

def test_chip_smoke_kernel_lines_split_row_2_by_output_width():
    """Row 2's ``kernels`` entry carries its main-path sums by the tile its
    shapes take (wide: Wo > 16, narrow: Wo <= 16, Wo = W / 2 of the INPUT
    shape), without the kernel bench's shapes and the untimed tile cases,
    beside rows 1 and 5's classes."""
    import chip_smoke

    def case(path, x_shape, ms):
        return {"path": path, "x_shape": list(x_shape), "cout": 64, "launches": 2,
                "reused": False, "max_abs_err": 0.01, "rel_err": 1e-4, "ms": ms,
                "plain_ms": 10 * ms, "library_ms": 3 * ms, "bound_ms": ms / 8,
                "bound_by": "bytes", "element_ms": ms}

    cases = [case("serve", (1, 64, 24, 256, 256), 4.0),
             case("train", (2, 128, 32, 128, 128), 2.0),
             case("train", (2, 32, 128, 34, 34), 1.0),      # Wo = 17: wide
             case("serve_renal", (1, 24, 256, 12, 20), 0.5),
             case("train", (2, 16, 256, 32, 32), 0.25),     # Wo = 16: narrow
             case("kernel_bench", (1, 16, 256, 16, 16), 8.0),
             {"path": "tiles", "x_shape": [1, 4, 32, 10, 32], "cout": 64, "launches": 0,
              "reused": False, "max_abs_err": 0.03, "rel_err": 1e-4}]
    measured = {"conv3x3_s2_stats": cases,
                "conv3x3_stats": [case("serve", (1, 12, 320, 6, 10), 1.0)],
                "conv3x3_s2_dw": [case("train", (2, 128, 32, 128, 128), 3.0)]}
    lines = {k["name"]: k for k in chip_smoke.kernel_lines(measured, {"train": {}})}
    row2 = lines["conv3x3_s2_stats"]
    assert row2["ms_by_class"] == {
        "wide": {"shapes": 3, "ms": 7.0, "library_ms": 21.0, "bound_ms": 0.875},
        "narrow": {"shapes": 2, "ms": 0.75, "library_ms": 2.25, "bound_ms": 0.09375}}
    assert row2["ms"] == 15.75 and row2["element_ms"] == 15.75 and row2["max_abs_err"] == 0.03
    assert set(lines["conv3x3_stats"]["ms_by_class"]) == {"deep", "narrow", "rest"}
    assert lines["conv3x3_s2_dw"]["ms_by_class"] == {
        "wide": {"shapes": 1, "ms": 3.0, "library_ms": 9.0, "bound_ms": 0.375},
        "narrow": {"shapes": 0, "ms": 0, "library_ms": 0, "bound_ms": 0}}


def test_chip_smoke_kernel_lines_split_row_4_by_output_width():
    """Row 4's (the stride-2 weight gradient's) ``kernels`` entry carries its
    main-path sums by output width (wide: Wo > 16, both k-steps; narrow: Wo
    <= 16, one) and the time of its element-load instance, without the
    kernel bench's shapes; the stride-1 weight gradient carries no classes."""
    import chip_smoke

    def case(path, x_shape, cout, ms):
        return {"path": path, "x_shape": list(x_shape), "cout": cout, "launches": 2,
                "reused": False, "max_abs_err": 1e-6, "rel_err": 1e-7, "ms": ms,
                "plain_ms": 8 * ms, "library_ms": 2 * ms, "bound_ms": ms / 8,
                "bound_by": "operations", "element_ms": 3 * ms}

    cases = [case("train", (2, 128, 32, 128, 128), 64, 0.5),
             case("train", (2, 64, 64, 64, 64), 128, 0.25),
             case("train", (2, 32, 128, 32, 32), 256, 0.125),     # Wo = 16: narrow
             case("train_renal", (2, 16, 256, 16, 16), 320, 0.0625),
             case("kernel_bench", (1, 16, 256, 16, 16), 320, 8.0)]
    measured = {"conv3x3_s2_dw": cases,
                "conv3x3_dw": [case("train", (2, 128, 32, 128, 128), 32, 1.0)]}
    lines = {k["name"]: k for k in chip_smoke.kernel_lines(measured, {"train": {}})}
    row4 = lines["conv3x3_s2_dw"]
    assert row4["ms_by_class"] == {
        "wide": {"shapes": 2, "ms": 0.75, "library_ms": 1.5, "bound_ms": 0.09375},
        "narrow": {"shapes": 2, "ms": 0.1875, "library_ms": 0.375, "bound_ms": 0.0234375}}
    assert row4["ms"] == 8.9375 and row4["element_ms"] == 3 * 8.9375
    assert row4["replaces"] == "runet_tpu/kernels/strided_conv.py:223"
    assert "ms_by_class" not in lines["conv3x3_dw"] and lines["conv3x3_dw"]["element_ms"] == 3.0


def test_chip_smoke_kernel_lines_split_row_7_by_geometry():
    """Row 7 (the attic conv) has no main-path shape: its ``kernels`` entry
    carries its sums by the kernel bench's geometry, with the CUDA-graph
    times where every shape of the geometry has them, and the untimed attic
    cases count only in ``max_abs_err``."""
    import chip_smoke

    def case(x_shape, cout, ms, graph=True):
        return {"path": "kernel_bench", "x_shape": list(x_shape), "cout": cout, "launches": 30,
                "reused": False, "max_abs_err": 0.01, "rel_err": 0.0, "ms": ms,
                "plain_ms": 10 * ms, "library_ms": 2 * ms, "bound_ms": ms / 4,
                "bound_by": "operations",
                **({"graph_ms": ms / 2, "graph_library_ms": ms} if graph else {})}

    cases = [case((1, 128, 128, 128, 32), 32, 0.5), case((1, 64, 64, 64, 64), 64, 0.25),
             case((1, 32, 32, 32, 128), 128, 0.125), case((1, 16, 16, 16, 256), 256, 0.0625),
             case((1, 160, 192, 256, 32), 32, 2.0),
             {"path": "attic", "x_shape": [4, 12, 17, 64], "cout": 64, "launches": 0,
              "reused": False, "max_abs_err": 0.03, "rel_err": 0.0, "tag": "W 17"}]
    lines = {k["name"]: k for k in chip_smoke.kernel_lines({"conv3x3_ndhwc": cases},
                                                           {"kernel_bench": {}})}
    row7 = lines["conv3x3_ndhwc"]
    assert row7["ms_by_class"]["fine_l0"] == {"shapes": 1, "ms": 0.5, "library_ms": 1.0,
                                              "bound_ms": 0.125, "graph_ms": 0.25,
                                              "graph_library_ms": 0.5}
    assert list(row7["ms_by_class"]) == ["fine_l0", "fine_l1", "fine_l2", "fine_l3", "roi_l0"]
    assert all(c["shapes"] == 1 for c in row7["ms_by_class"].values())
    assert row7["ms"] == 2.9375 and row7["graph_ms"] == 2.9375 / 2
    assert row7["max_abs_err"] == 0.03 and row7["shapes_timed"] == 5
    assert row7["replaces"] == "runet_tpu/kernels/attic/conv3d.py:46"
    cases[0] = case((1, 128, 128, 128, 32), 32, 0.5, graph=False)
    row7 = chip_smoke.kernel_lines({"conv3x3_ndhwc": cases}, {"kernel_bench": {}})[0]
    assert "graph_ms" not in row7 and "graph_ms" not in row7["ms_by_class"]["fine_l0"]
    assert row7["ms_by_class"]["roi_l0"]["graph_ms"] == 1.0


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


def test_occupancy_probe_includes_the_source_and_names_each_kernel(tmp_path):
    from runet_tpu_torch.utils import occupancy

    src = tmp_path / "k.cu"
    text = occupancy.probe_source(src, ["a_kernel<true>", "a_kernel<false>"])
    assert text.startswith(f'#include "{src.resolve()}"')
    assert "case 0: f = reinterpret_cast<const void*>(&a_kernel<true>); break;" in text
    assert "case 1: f = reinterpret_cast<const void*>(&a_kernel<false>); break;" in text
    assert "f, NTHREADS, SMEM_BYTES)" in text


def test_occupancy_probe_takes_the_block_size_and_shared_memory_it_is_given(tmp_path):
    from runet_tpu_torch.utils import occupancy

    src = tmp_path / "k.cu"
    text = occupancy.probe_source(src, ["k<true, true>"], "convk::DwGeom<1>::NTHREADS",
                                  "convk::DwS1::SMEM_BYTES")
    assert "case 0: f = reinterpret_cast<const void*>(&k<true, true>); break;" in text
    assert text.count("convk::DwS1::SMEM_BYTES") == 2
    assert "f, convk::DwGeom<1>::NTHREADS, convk::DwS1::SMEM_BYTES)" in text
    assert "f, NTHREADS, SMEM_BYTES)" not in text


def test_occupancy_exits_nonzero_without_cuda(no_cuda, tmp_path):
    from runet_tpu_torch.utils import occupancy

    out = tmp_path / "occ.json"
    assert occupancy.main([str(tmp_path / "k.cu"), "k", "--out", str(out)]) != 0
    assert not out.exists()


def test_phase_probe_defines_the_mask_and_includes_the_source(tmp_path):
    from runet_tpu_torch.utils import phase_probe

    src = tmp_path / "k.cu"
    text = phase_probe.probe_source(src, 5)
    assert text.splitlines() == ["#define V1_PHASES 5", f'#include "{src.resolve()}"']
    assert phase_probe.MASKS == (7, 6, 5, 3)
    assert phase_probe.SOURCE.name == "conv3x3_stats_v1.cu" and phase_probe.SOURCE.exists()
    assert "#ifndef V1_PHASES" in phase_probe.SOURCE.read_text()


def test_phase_probe_exits_nonzero_without_cuda(no_cuda, tmp_path):
    from runet_tpu_torch.utils import phase_probe

    out = tmp_path / "phases.json"
    assert phase_probe.main(["--out", str(out)]) != 0
    assert not out.exists()


def test_phase_probe_dw1_defines_its_mask_and_includes_the_source(tmp_path):
    from runet_tpu_torch.kernels import build
    from runet_tpu_torch.utils import phase_probe

    src = tmp_path / "k.cu"
    text = phase_probe.probe_source(src, 3, "DW1_PHASES")
    assert text.splitlines() == ["#define DW1_PHASES 3", f'#include "{src.resolve()}"']
    dw1 = phase_probe.KERNELS["dw1"]
    assert dw1.macro == "DW1_PHASES" and dw1.source.name == "conv3x3_dw.cu"
    assert dw1.source.exists() and '#include "conv3x3_dw_s1.cuh"' in dw1.source.read_text()
    assert "#ifndef DW1_PHASES" in (build.CSRC / "conv3x3_dw_s1.cuh").read_text()
    assert dw1.without == {"x": 6, "g": 5, "mma": 3}
    assert sorted(dw1.geometries.values()) == [(2, 16, 256, 256), (2, 32, 128, 128),
                                               (2, 128, 32, 32)]
    for kernel in phase_probe.KERNELS.values():
        assert tuple(kernel.without.values()) == phase_probe.MASKS[1:]


def test_phase_probe_dw1_exits_nonzero_without_cuda(no_cuda, tmp_path):
    from runet_tpu_torch.utils import phase_probe

    out = tmp_path / "phases.json"
    assert phase_probe.main(["--kernel", "dw1", "--out", str(out)]) != 0
    assert not out.exists()


def test_phase_probe_dw2_defines_its_mask_and_includes_the_source(tmp_path):
    from runet_tpu_torch.kernels import build
    from runet_tpu_torch.utils import phase_probe

    src = tmp_path / "k.cu"
    text = phase_probe.probe_source(src, 5, "DW2_PHASES")
    assert text.splitlines() == ["#define DW2_PHASES 5", f'#include "{src.resolve()}"']
    dw2 = phase_probe.KERNELS["dw2"]
    assert dw2.macro == "DW2_PHASES" and dw2.source.name == "conv3x3_s2_dw.cu"
    assert dw2.source.exists() and '#include "conv3x3_dw_s2.cuh"' in dw2.source.read_text()
    assert "#ifndef DW2_PHASES" in (build.CSRC / "conv3x3_dw_s2.cuh").read_text()
    assert dw2.without == {"x": 6, "g": 5, "mma": 3}
    assert dw2.geometries == {"down_l0": (2, 128, 32, 128, 128, 64),
                              "down_l1": (2, 64, 64, 64, 64, 128),
                              "down_l2": (2, 32, 128, 32, 32, 256),
                              "down_l3": (2, 16, 256, 16, 16, 320)}
    assert all(s[1] % 2 == 0 and s[3] % 2 == 0 and s[4] % 2 == 0 for s in dw2.geometries.values())
    assert set(dw2.api) == {"launch", "splits"} and dw2.prefix == "conv3x3_s2_dw"


def test_phase_probe_dw2_exits_nonzero_without_cuda(no_cuda, tmp_path):
    from runet_tpu_torch.utils import phase_probe

    out = tmp_path / "phases.json"
    assert phase_probe.main(["--kernel", "dw2", "--out", str(out)]) != 0
    assert not out.exists()


def test_phase_probe_v3_defines_its_mask_and_includes_the_source(tmp_path):
    from runet_tpu_torch.kernels import build
    from runet_tpu_torch.utils import phase_probe

    src = tmp_path / "k.cu"
    text = phase_probe.probe_source(src, 6, "V3_PHASES")
    assert text.splitlines() == ["#define V3_PHASES 6", f'#include "{src.resolve()}"']
    v3 = phase_probe.KERNELS["v3"]
    assert v3.macro == "V3_PHASES" and v3.source.name == "conv3x3_ndhwc_stats.cu"
    assert v3.source.exists() and '#include "conv3x3_ndhwc_stats.cuh"' in v3.source.read_text()
    assert "#ifndef V3_PHASES" in (build.CSRC / "conv3x3_ndhwc_stats.cuh").read_text()
    assert v3.without == {"halo": 6, "weights": 5, "mma": 3}
    assert v3.geometries == {"fine_l2": (1, 32, 128, 128), "fine_l3": (1, 16, 256, 256)}
    assert set(v3.api) == {"launch", "nblk"}


def test_phase_probe_v3_exits_nonzero_without_cuda(no_cuda, tmp_path):
    from runet_tpu_torch.utils import phase_probe

    out = tmp_path / "phases.json"
    assert phase_probe.main(["--kernel", "v3", "--out", str(out)]) != 0
    assert not out.exists()


def test_phase_probe_conv3d_defines_its_mask_and_includes_the_source(tmp_path):
    from runet_tpu_torch.kernels import build
    from runet_tpu_torch.utils import phase_probe

    src = tmp_path / "k.cu"
    text = phase_probe.probe_source(src, 5, "CONV3D_PHASES")
    assert text.splitlines() == ["#define CONV3D_PHASES 5", f'#include "{src.resolve()}"']
    conv3d = phase_probe.KERNELS["conv3d"]
    assert conv3d.macro == "CONV3D_PHASES" and conv3d.source.name == "conv3x3_ndhwc.cu"
    assert conv3d.source.exists() and '#include "conv3x3_ndhwc.cuh"' in conv3d.source.read_text()
    assert "#ifndef CONV3D_PHASES" in (build.CSRC / "conv3x3_ndhwc.cuh").read_text()
    assert conv3d.without == {"halo": 6, "weights": 5, "mma": 3}
    assert conv3d.geometries == {"fine_l0": (1, 128, 32, 32), "fine_l2": (1, 32, 128, 128)}
    assert set(conv3d.api) == {"launch"} and conv3d.prefix == "conv3x3_ndhwc"


def test_phase_probe_conv3d_exits_nonzero_without_cuda(no_cuda, tmp_path):
    from runet_tpu_torch.utils import phase_probe

    out = tmp_path / "phases.json"
    assert phase_probe.main(["--kernel", "conv3d", "--out", str(out)]) != 0
    assert not out.exists()


def test_phase_probe_v2m_defines_its_mask_and_includes_the_source(tmp_path):
    from runet_tpu_torch.kernels import build
    from runet_tpu_torch.utils import phase_probe

    src = tmp_path / "k.cu"
    text = phase_probe.probe_source(src, 5, "V2M_PHASES")
    assert text.splitlines() == ["#define V2M_PHASES 5", f'#include "{src.resolve()}"']
    v2m = phase_probe.KERNELS["v2m"]
    assert v2m.macro == "V2M_PHASES" and v2m.source.name == "conv3x3_stats.cu"
    assert v2m.source.exists() and '#include "conv3x3_stats.cuh"' in v2m.source.read_text()
    assert "#ifndef V2M_PHASES" in (build.CSRC / "conv3x3_stats.cuh").read_text()
    assert v2m.without == {"halo": 6, "weights": 5, "mma": 3}
    assert v2m.geometries == {"fine_l2": (1, 32, 128, 128), "fine_l3": (1, 16, 256, 256),
                              "128^3 32->32": (2, 128, 32, 32)}
    assert set(v2m.api) == {"launch", "nblk"}


def test_phase_probe_v2m_exits_nonzero_without_cuda(no_cuda, tmp_path):
    from runet_tpu_torch.utils import phase_probe

    out = tmp_path / "phases.json"
    assert phase_probe.main(["--kernel", "v2m", "--out", str(out)]) != 0
    assert not out.exists()


def test_phase_probe_v2_defines_its_mask_and_includes_the_source(tmp_path):
    from runet_tpu_torch.kernels import build
    from runet_tpu_torch.utils import phase_probe

    src = tmp_path / "k.cu"
    text = phase_probe.probe_source(src, 3, "V2_PHASES")
    assert text.splitlines() == ["#define V2_PHASES 3", f'#include "{src.resolve()}"']
    v2 = phase_probe.KERNELS["v2"]
    assert v2.macro == "V2_PHASES" and v2.source.name == "conv3x3_stats_v2.cu"
    assert v2.source.exists() and '#include "conv3x3_stats_v2.cuh"' in v2.source.read_text()
    assert "#ifndef V2_PHASES" in (build.CSRC / "conv3x3_stats_v2.cuh").read_text()
    assert v2.without == {"halo": 6, "weights": 5, "mma": 3}
    assert v2.geometries == {"fine_l2": (1, 32, 128, 128), "fine_l3": (1, 16, 256, 256),
                             "128^3 32->32": (2, 128, 32, 32)}
    assert set(v2.api) == {"launch", "nblk"} and v2.prefix == "conv3x3_stats_v2"


def test_phase_probe_v2_exits_nonzero_without_cuda(no_cuda, tmp_path):
    from runet_tpu_torch.utils import phase_probe

    out = tmp_path / "phases.json"
    assert phase_probe.main(["--kernel", "v2", "--out", str(out)]) != 0
    assert not out.exists()

def test_phase_probe_s2_defines_its_mask_and_includes_the_source(tmp_path):
    from runet_tpu_torch.kernels import build
    from runet_tpu_torch.utils import phase_probe

    src = tmp_path / "k.cu"
    text = phase_probe.probe_source(src, 6, "S2_PHASES")
    assert text.splitlines() == ["#define S2_PHASES 6", f'#include "{src.resolve()}"']
    s2 = phase_probe.KERNELS["s2"]
    assert s2.macro == "S2_PHASES" and s2.source.name == "conv3x3_s2_stats.cu"
    assert s2.source.exists() and '#include "conv3x3_s2_stats.cuh"' in s2.source.read_text()
    assert "#ifndef S2_PHASES" in (build.CSRC / "conv3x3_s2_stats.cuh").read_text()
    assert s2.without == {"halo": 6, "weights": 5, "mma": 3}
    assert s2.geometries == {"down_l0": (2, 128, 32, 128, 128, 64),
                             "down_l2": (2, 32, 128, 32, 32, 256),
                             "down_l3": (2, 16, 256, 16, 16, 320),
                             "renal W 20": (1, 24, 256, 12, 20, 320)}
    assert all(s[1] % 2 == 0 and s[3] % 2 == 0 and s[4] % 2 == 0 for s in s2.geometries.values())
    assert set(s2.api) == {"launch", "nblk"} and s2.prefix == "conv3x3_s2_stats"


def test_phase_probe_s2_exits_nonzero_without_cuda(no_cuda, tmp_path):
    from runet_tpu_torch.utils import phase_probe

    out = tmp_path / "phases.json"
    assert phase_probe.main(["--kernel", "s2", "--out", str(out)]) != 0
    assert not out.exists()


def test_bit_compare_reads_the_kernel_lines_of_a_smoke_log():
    from runet_tpu_torch.utils import bit_compare

    log = "\n".join([
        "[kernels] conv3x3_stats serve x(1, 6, 320, 6, 10)->320 x2: err 0.0156 ms 0.1581",
        "[kernels] conv3x3_stats_v2 serve_renal x(1, 6, 64, 6, 10)->64 x2: err 0.0156",
        "[kernels] conv3x3_stats train x(2, 128, 32, 128, 128)->32 x14: err 0.0078",
        "[tiles] conv3x3_stats Wide32 x(1, 4, 24, 13, 128)->32: err 0.0078",
    ])
    assert bit_compare.logged_shapes(log, "conv3x3_stats") == [(1, 6, 320, 6, 10, 320),
                                                               (2, 128, 32, 128, 128, 32)]
    assert bit_compare.logged_shapes(log, "conv3x3_stats_v2") == [(1, 6, 64, 6, 10, 64)]
    assert all(len(s) == 6 for s in bit_compare.DEFAULT_SHAPES)


def test_bit_compare_reads_the_stride_2_kernel_lines_and_takes_even_shapes():
    from runet_tpu_torch.utils import bit_compare

    log = "\n".join([
        "[kernels] conv3x3_s2_stats serve x(1, 64, 24, 256, 256)->64 x2: err 0.0156 ms 1.2",
        "[kernels] conv3x3_s2_dw train x(2, 128, 32, 128, 128)->64 x2: err 1e-07",
        "[kernels] conv3x3_stats serve x(1, 6, 320, 6, 10)->320 x2: err 0.0156 ms 0.1581",
        "[kernels] conv3x3_s2_stats serve_renal x(1, 24, 256, 12, 20)->320 x1: err 0.0078",
        "[tiles] conv3x3_s2_stats Narrow64 Ho 5 x(1, 4, 32, 10, 32)->64: err 0.0078",
    ])
    assert bit_compare.logged_shapes(log, "conv3x3_s2_stats") == [
        (1, 64, 24, 256, 256, 64), (1, 24, 256, 12, 20, 320)]
    assert bit_compare.logged_shapes(log, "conv3x3_stats") == [(1, 6, 320, 6, 10, 320)]
    assert "conv3x3_s2_stats" in bit_compare.KERNELS
    assert all(len(s) == 6 and s[1] % 2 == 0 and s[3] % 2 == 0 and s[4] % 2 == 0
               for s in bit_compare.S2_DEFAULT_SHAPES)


def test_bit_compare_reads_the_stride_2_dw_kernel_lines_and_takes_even_shapes():
    from runet_tpu_torch.utils import bit_compare

    log = "\n".join([
        "[kernels] conv3x3_s2_dw train x(2, 128, 32, 128, 128)->64 x2: err 1e-07 ms 0.3",
        "[kernels] conv3x3_s2_stats serve x(1, 64, 24, 256, 256)->64 x2: err 0.0156 ms 1.2",
        "[kernels] conv3x3_dw train x(2, 128, 32, 128, 128)->32 x14: err 2e-07",
        "[kernels] conv3x3_s2_dw train_renal x(2, 16, 256, 16, 16)->320 x2: err 1e-07",
    ])
    assert bit_compare.logged_shapes(log, "conv3x3_s2_dw") == [
        (2, 128, 32, 128, 128, 64), (2, 16, 256, 16, 16, 320)]
    assert "conv3x3_s2_dw" in bit_compare.KERNELS
    shapes = bit_compare.S2_DW_DEFAULT_SHAPES
    assert len(set(shapes)) == len(shapes)
    assert all(len(s) == 6 and s[1] % 2 == 0 and s[3] % 2 == 0 and s[4] % 2 == 0
               for s in shapes)
    # The four main-path levels at D = 8, Cout 96 and Wo = 9 are among them.
    assert {(2, 8, 32, 128, 128, 64), (2, 8, 64, 64, 64, 128), (2, 8, 128, 32, 32, 256),
            (2, 8, 256, 16, 16, 320), (1, 4, 48, 12, 64, 96), (1, 4, 24, 10, 18, 32)} <= set(shapes)


def test_bit_compare_time_of_the_stride_2_dw_kernel_exits_nonzero_without_cuda(no_cuda,
                                                                              tmp_path):
    from runet_tpu_torch.utils import bit_compare

    out = tmp_path / "bits.json"
    log = tmp_path / "smoke.log"
    log.write_text("[kernels] conv3x3_s2_dw train x(2, 16, 256, 16, 16)->320 x2: err 1e-07\n")
    argv = [str(tmp_path / "conv3x3_s2_dw.cu"), "--log", str(log), "--time", "--out", str(out)]
    assert bit_compare.main(argv) != 0
    assert not out.exists()


def test_bit_compare_reads_the_attic_conv_lines_in_its_own_order():
    """The attic conv's lines give x as (B, D, H, W, C); its default shapes
    cover each tile and edge and the kernel bench's five geometries."""
    from runet_tpu_torch.kernels.attic import conv3d
    from runet_tpu_torch.utils import bit_compare
    from runet_tpu_torch.utils.kernel_bench import GEOMETRIES

    log = "\n".join([
        "[kernels] conv3x3_ndhwc kernel_bench x(1, 128, 128, 128, 32)->32 x30: err 0.0156",
        "[kernels] conv3x3_ndhwc_stats kernel_bench x(1, 32, 32, 32, 128)->128 x30: err 0.01",
        "[attic] conv3x3_ndhwc W 17 x(4, 12, 17, 64)->64: err 0.0078",
        "[kernels] conv3x3_ndhwc kernel_bench x(1, 160, 192, 256, 32)->32 x10: err 0.0156",
    ])
    assert bit_compare.logged_shapes(log, "conv3x3_ndhwc") == [(1, 128, 128, 128, 32, 32),
                                                               (1, 160, 192, 256, 32, 32)]
    assert "conv3x3_ndhwc" in bit_compare.KERNELS
    shapes = bit_compare.NDHWC_DEFAULT_SHAPES
    assert len(set(shapes)) == len(shapes) and all(len(s) == 6 for s in shapes)
    assert {(1, D, H, W, C, cout) for D, H, W, C, cout, _ in GEOMETRIES.values()} <= set(shapes)
    tiles = {conv3d.conv3d_tile(s[3], -(-s[5] // 32) * 32) for s in shapes}
    assert tiles == {(16, 16, 32), (8, 32, 32), (8, 32, 64)}
    assert any(s[4] % 8 for s in shapes) and any(s[4] % 16 == 8 for s in shapes)


def test_bit_compare_exits_nonzero_without_cuda(no_cuda, tmp_path):
    from runet_tpu_torch.utils import bit_compare

    out = tmp_path / "bits.json"
    assert bit_compare.main([str(tmp_path / "conv3x3_stats.cu"), "--out", str(out)]) != 0
    assert not out.exists()
