"""Where one serving-cascade case spends its time on the card.

    python -m runet_tpu_torch.utils.profile_serve [--out PATH] [--preset NAME] [--tta]

Loads the committed coarse weights and those of the fine preset
(``--preset``, fine_kits unless named; ``--tta``: 8-flip mirror
test-time augmentation on the fine stage), warms up on a KiTS-scale
phantom (512x512x160 at 0.78125x0.78125x3 mm, seed 0), then for seed 1:
times ``predict_case`` end to end (host clock around a synchronized run),
once more with a phase timer, and once under ``torch.profiler`` to sum the
device time per kernel and per kind of work. Prints a JSON summary (also
written to ``--out``) with the card's name and power limit, the native
host tier's calls in the timed run (``utils/native.py``), and the count
and seconds per name of the program's spans in that run
(``utils/timing.py``) and their counters summed (``norm_act.fused`` /
``norm_act.plain``: the conv blocks whose norm and LeakyReLU took the CUDA
pass or the plain chain). Needs a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from pathlib import Path

import torch

from runet_tpu_torch import resolve_device
from runet_tpu_torch.data.phantom import make_phantom
from runet_tpu_torch.infer.cascade import ModelBundle, predict_case
from runet_tpu_torch.params import load_model
from runet_tpu_torch.utils import native
from runet_tpu_torch.utils.device_time import device_rows, group_device_time
from runet_tpu_torch.utils import timing
from runet_tpu_torch.utils.timing import PhaseTimer

CASE_SHAPE = (512, 512, 160)
CASE_SPACING = (0.78125, 0.78125, 3.0)

# Device-time groups, by substring of the kernel name (first match wins).
GROUPS = [
    ("norm + LeakyReLU pass", ("norm_lrelu_planes_kernel",)),
    ("conv3x3_stats (stride-1 kernel)", ("conv3x3_stats_kernel",)),
    ("conv3x3_s2_stats (stride-2 kernel)", ("conv3x3_s2_stats_kernel",)),
    ("moment reduction (2nd pass)", ("reduce_moments",)),
    ("matmul (resample, projection, head)", ("gemm", "Gemm", "sm90_", "cutlass", "ampere_")),
    ("copies / layout", ("copy", "Copy", "cat", "Cat", "transpose", "permute", "Memcpy", "Memset")),
    ("softmax / argmax / reductions", ("softmax", "Softmax", "argmax", "Argmax", "reduce", "Reduce")),
    ("other plain-torch elementwise", ("elementwise_kernel",)),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="profile_serve.json")
    ap.add_argument("--preset", default="fine_kits")
    ap.add_argument("--tta", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    cm, ccfg = load_model("coarse", device=dev)
    fm, fcfg = load_model(args.preset, device=dev)
    coarse, fine = ModelBundle.from_model(cm, ccfg), ModelBundle.from_model(fm, fcfg)
    if args.tta:
        fine = dataclasses.replace(fine, infer=dataclasses.replace(fine.infer, tta=True))
    k = fcfg.model.num_classes
    warm, _ = make_phantom(CASE_SHAPE, CASE_SPACING, num_classes=k, seed=0)
    img, _ = make_phantom(CASE_SHAPE, CASE_SPACING, num_classes=k, seed=1)

    def run(timer=None):
        out = predict_case(coarse, fine, img, CASE_SPACING, fcfg.cascade, timer=timer, device=dev)
        torch.cuda.synchronize()
        return out

    predict_case(coarse, fine, warm, CASE_SPACING, fcfg.cascade, device=dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    run()
    case_s = time.monotonic() - t0
    timer = PhaseTimer()
    native.reset_call_counts()
    first = timing.new_id()
    run(timer)
    native_calls = native.call_counts()
    spans: dict[str, list] = {}
    counters: dict[str, int] = {}
    for s in timing.spans():
        if s.span_id > first:
            n_s = spans.setdefault(s.name, [0, 0.0])
            n_s[0] += 1
            n_s[1] += (s.end_ns - s.start_ns) / 1e9
            for name, n in (s.counters or {}).items():
                counters[name] = counters.get(name, 0) + n

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        run()
        prof_wall = time.monotonic() - t0
    rows = device_rows(prof)
    device_us = sum(r[1] for r in rows)
    groups, _ = group_device_time(rows, GROUPS)
    top = sorted(rows, key=lambda r: -r[1])[:15]
    summary = {
        "card": card,
        "preset": args.preset,
        "tta": args.tta,
        "case_seconds": case_s,
        "phases_seconds": timer.as_dict(),
        "spans_count_seconds": dict(sorted(spans.items())),
        "span_counters": dict(sorted(counters.items())),
        "native_tier": native.available(),
        "native_calls": native_calls,
        "profiled_wall_seconds": prof_wall,
        "device_seconds": device_us / 1e6,
        "device_busy_share_of_profiled_wall": device_us / 1e6 / prof_wall,
        "device_ms_by_group": {g: us / 1e3 for g, us in groups.items()},
        "top_kernels_ms": [{"name": k[:120], "ms": us / 1e3, "calls": n} for k, us, n in top],
    }
    text = json.dumps(summary, indent=1)
    print(text)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)


if __name__ == "__main__":
    main()
