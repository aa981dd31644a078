"""Run one benchmark cell of ``runet_tpu_torch`` once and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout. Everything else is found by name: the configuration in
``benchmark/configs/<config>.json``, the traffic mix in
``benchmark/traffic/<traffic>.json`` (whose ``driver`` names the module of
``benchmark/drivers/`` that runs it), the limits of the correctness
comparison and the settings it judges by in ``benchmark/limits/<cell>.json``,
and each per-layer metric's reader in ``benchmark/metrics/<metric>.py``. A
new configuration, mix, cell or metric is new files and entries; no file
here changes.

A run: set-up (inputs and weights from ``--seed``, the program loaded and
every shape of the cell warmed), one measured window of ``--seconds`` (under
the profiler with ``--trace 1``), the device's peak memory, then the
program's state freed and its outputs judged against the plain reference.
The last line of standard output is one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error and the last key
of that object. Exit codes: 0 a result was printed, 2 no card or too few
cards, 3 a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "optax", "runet_tpu")
EXIT_NO_CARD, EXIT_BANNED = 2, 3


def process_start_s() -> float:
    """When this process started, on ``time.perf_counter``'s clock."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def use_checkout_caches(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths. The
    program builds its own CUDA and host libraries under
    ``runet_tpu_torch/build/``, which is inside the checkout already."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def load_cell(root: Path, workload: str) -> SimpleNamespace:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    here = root / "benchmark"
    comparison = json.loads((here / "limits" / f"{workload}.json").read_text())

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return SimpleNamespace(
        cell=cell,
        config=json.loads((here / "configs" / f"{cell['config']}.json").read_text()),
        traffic=json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=comparison["limits"],
        settings=comparison.get("settings", {}),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
    )


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def metric_reader(root: Path, name: str):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def host_counters() -> dict:
    """This process's CPU seconds and the wall clock."""
    t = os.times()
    return {"own_s": t.user + t.system, "wall_s": time.perf_counter()}


def host_window(a: dict, b: dict) -> dict:
    """What the host did over a window: this process's thread settings and
    its CPU seconds per second of the window. (The card's machine reads
    ``/proc/stat`` as zeros, so the host's other load cannot be seen.)"""
    import torch

    wall = b["wall_s"] - a["wall_s"]
    return {"cpus": len(os.sched_getaffinity(0)), "torch_threads": torch.get_num_threads(),
            "own_cpu_per_s": (b["own_s"] - a["own_s"]) / wall if wall > 0 else None}


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             t_start: float | None = None, check=None) -> dict:
    """One run of a cell; returns the result object (``checks`` last).
    ``overrides`` ({"config": {...}, "traffic": {...}, "limits": {...},
    "settings": {...}})
    are merged into the cell's files: the tests run the same path at a size
    the CPU holds. ``check`` replaces the driver's comparison
    (``benchmark/control.py`` judges its control with it)."""
    import torch

    from benchmark import trace as tr
    from benchmark.peaks import peaks_for

    t_start = process_start_s() if t_start is None else t_start
    spec = load_cell(root, workload)
    for key, over in (overrides or {}).items():
        setattr(spec, key, _merge(getattr(spec, key), over))
    if "torch_threads" in spec.traffic:
        # Intra-op threads of the host's own tensor work: the step path's
        # dispatch thread then shares the host with no idle pool.
        torch.set_num_threads(int(spec.traffic["torch_threads"]))
    dev = torch.device(device)
    run = SimpleNamespace(root=root, workload=workload, seed=int(seed), seconds=float(seconds),
                          trace=bool(trace), device=dev, t_start=t_start,
                          spans=tr.Spans(enabled=bool(trace)), **vars(spec))
    driver = importlib.import_module(f"benchmark.drivers.{spec.traffic['driver']}")

    state = driver.setup(run)
    tracer = tr.Tracer(dev) if trace else None
    host0 = host_counters()
    if tracer is not None:
        with tracer:
            window = driver.window(run, state)
    else:
        window = driver.window(run, state)
    host = host_window(host0, host_counters())
    print(f"host over the window: {json.dumps(host)}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    t_check = time.perf_counter()
    checks = (check or driver.check)(run, state, window)
    print(f"comparison with the reference: {time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    del state
    gc.collect()

    limits = spec.limits
    correct = all(checks[k] <= limits[k] for k in limits) and set(checks) == set(limits)
    metrics = {}
    if trace:
        ctx = SimpleNamespace(run=run, window=window, ops=tracer.ops, window_s=tracer.window_s,
                              peaks=peaks_for(torch.cuda.get_device_name(dev))
                              if dev.type == "cuda" else None)
        for m in spec.per_layer:
            value = metric_reader(root, m["name"])(ctx) if tracer.ops else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.end_to_end:
            value = window["setup_s"] if m["name"] == "setup_s" else window["metrics"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    n_dev = run.cell.get("chips", 1)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": n_dev,
        "memory_peak_bytes": int(peak),
        "power_limit": card_power_limit() if dev.type == "cuda" else None,
    }
    result = {"correct": bool(correct), "attempted": int(window["attempted"]),
              "failed": int(window["failed"]), "metrics": metrics, "device": device_info,
              "host": host}
    if trace:
        device_info["busy_s"] = tr.busy_s(tracer.ops)
        device_info["window_s"] = tracer.window_s
        result["breakdown"] = {
            "device_ops": tr.top_ops(tracer.ops),
            "idle_gaps": tr.idle_gaps(tracer.ops, run.spans.items, tracer.offset_ns),
        }
    result["checks"] = {k: {"value": checks.get(k), "limit": limits.get(k)}
                        for k in sorted(set(checks) | set(limits))}
    return result


def main(argv=None) -> int:
    t_start = process_start_s()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = ROOT
    spec = load_cell(root, args.workload)
    use_checkout_caches(root)
    import torch

    need = int(spec.cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {need} CUDA device(s); {have} available",
              file=sys.stderr)
        return EXIT_NO_CARD
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start)
    found = banned_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return EXIT_BANNED
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
