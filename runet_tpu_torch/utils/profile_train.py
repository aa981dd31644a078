"""Where one fine_kits training step spends its time on the card.

    python -m runet_tpu_torch.utils.profile_train [--out PATH]

Builds the full-width fine_kits train model (base 32, max 320, 5 levels;
seeded init), takes one fixed 128³ batch of 2 phantom patches (seeds 0 and
1, normalized with the preset's HU window and stats), warms up 3 steps,
times 10 synchronized steps (host clock; median), and profiles 3
more under ``torch.profiler`` to sum the device time per kernel and per
kind of work. Prints a JSON summary (also written to ``--out``) with the
card's name and power limit and the peak device memory. Needs a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from runet_tpu_torch import resolve_device
from runet_tpu_torch.config import get_config
from runet_tpu_torch.data.phantom import make_phantom
from runet_tpu_torch.models.unet3d import create_train_model, init_params
from runet_tpu_torch.preprocess.normalize import normalize
from runet_tpu_torch.train.state import create_train_state, make_train_step
from runet_tpu_torch.utils.device_time import device_rows, group_device_time

# Device-time groups, by substring of the kernel name (first match wins).
GROUPS = [
    ("conv3x3_stats (stride-1 forward and dx)", ("conv3x3_stats_kernel",)),
    ("conv3x3_s2_stats (stride-2 forward)", ("conv3x3_s2_stats_kernel",)),
    ("conv3x3_dw (stride-1 weight gradient)", ("conv3x3_dw_kernel<1>",)),
    ("conv3x3_s2_dw (stride-2 weight gradient)", ("conv3x3_dw_kernel<2>",)),
    ("split and moment reductions (2nd passes)", ("reduce_splits", "reduce_moments")),
    ("cuDNN (stride-2 dx, transposed conv)", ("dgrad", "cudnn::", "implicit_convolve")),
    ("matmul (projection, head, zoom)", ("gemm", "Gemm", "cutlass", "ampere_")),
    ("copies / layout", ("copy", "Copy", "cat", "Cat", "transpose", "permute", "Memcpy",
                         "Memset", "flip")),
    ("reductions (norm, loss, grad norm)", ("reduce", "Reduce", "sum", "Sum", "norm", "softmax",
                                            "Softmax", "logsumexp")),
]


def fixed_batch(cfg, device):
    """(images (B, X, Y, Z, 1) f32, labels (B, X, Y, Z) int64): phantom
    patches of the preset's patch size, one per seed."""
    imgs, labs = [], []
    for seed in range(cfg.train.batch_size):
        img, lab = make_phantom(cfg.train.patch_size, cfg.preprocess.spacing,
                                num_classes=cfg.model.num_classes, seed=seed)
        imgs.append(normalize(torch.from_numpy(img), cfg.preprocess.hu_window,
                              cfg.preprocess.hu_stats).numpy())
        labs.append(lab.astype(np.int64))
    images = torch.from_numpy(np.stack(imgs)[..., None]).to(device)
    return images, torch.from_numpy(np.stack(labs)).to(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="profile_train.json")
    args = ap.parse_args(argv)
    dev = resolve_device()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    cfg = get_config("fine_kits")
    tcfg = dataclasses.replace(cfg.train, lr_schedule="const", warmup_steps=0, lr=1e-4)
    model = init_params(create_train_model(cfg.model, dev), torch.Generator().manual_seed(0))
    state = create_train_state(model, tcfg)
    step = make_train_step(model)
    images, labels = fixed_batch(cfg, dev)

    for _ in range(3):
        step(state, images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        t0 = time.monotonic()
        step(state, images, labels)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    peak = torch.cuda.max_memory_allocated()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    n_prof = 3
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(n_prof):
            step(state, images, labels)
        torch.cuda.synchronize()
        prof_wall = time.monotonic() - t0
    rows = device_rows(prof)
    device_us = sum(r[1] for r in rows)
    other = "other (elementwise: norm apply, LeakyReLU, fold, casts, optimizer)"
    groups, members = group_device_time(rows, GROUPS, other)
    top = sorted(rows, key=lambda r: -r[1])[:20]
    summary = {
        "card": card,
        "config": "fine_kits full width, 128^3 patch, batch 2, no augmentation",
        "step_ms_median": statistics.median(times) * 1e3,
        "step_ms_all": [t * 1e3 for t in times],
        "imgs_per_s": cfg.train.batch_size / statistics.median(times),
        "peak_device_gib": peak / 2**30,
        "profiled_steps": n_prof,
        "profiled_wall_ms_per_step": prof_wall / n_prof * 1e3,
        "device_ms_per_step": device_us / 1e3 / n_prof,
        "device_busy_share_of_profiled_wall": device_us / 1e6 / prof_wall,
        "device_ms_per_step_by_group": {g: us / 1e3 / n_prof for g, us in groups.items()},
        "group_members": {g: [{"name": k[:100], "ms": us / 1e3 / n_prof,
                               "calls_per_step": n / n_prof}
                              for us, n, k in sorted(ms, reverse=True)[:6]]
                          for g, ms in members.items() if g != other},
        "top_kernels_ms_per_step": [{"name": k[:120], "ms": us / 1e3 / n_prof,
                                     "calls_per_step": n / n_prof} for k, us, n in top],
    }
    text = json.dumps(summary, indent=1)
    print(text)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)


if __name__ == "__main__":
    main()
