"""Serving warm-up: pay a process's cold-start costs once, before traffic.

Counterpart of ``runet_tpu/infer/warmup.py``. PyTorch runs eagerly, so
there is no program to compile per shape; what a cold process pays on its
first case is the ``nvcc`` build of the CUDA kernels (when the build
directory is empty), loading them, the cuBLAS/cuDNN handles and workspaces
of the matmul resamplers and the strided transposed conv, the interpolation
matrices (cached per shape) and the caching allocator's first device
allocations at each ROI bucket's sizes. Running the product path once warms
all of them.

- ``warmup_cases``: run ``predict_case`` over representative case(s), the
  exact product path, results discarded.
- ``warmup_roi_buckets``: run the fine ROI program on dummy input at
  explicit bucketed fine shapes (when the buckets are known without data).

Both return per-item wall-clock seconds (device synchronized) and
``total_s``. ``warmup_cases`` runs its cases on a pool of ``workers``
threads, as the JAX package does and as ``predict_cases`` serves them, each
case timed inside its own callable; the threads share one device, so a
case's seconds include the device work of the cases beside it. With
``devices`` it warms each serving lane of ``predict_cases(devices=...)``
(every lane's first case pays its device's cold start), all lane-cases at
once. ``warmup_roi_buckets`` runs its items one after another.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from runet_tpu_torch import resolve_device
from runet_tpu_torch.config import CascadeConfig


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def warmup_cases(coarse, fine, cases, cascade: CascadeConfig = CascadeConfig(),
                 workers: int = 2, device=None, devices=None) -> dict[str, float]:
    """Warm everything the given cases (an iterable of (image,
    native_spacing)) touch on ``device`` (CUDA unless named), ``workers``
    cases at a time; returns ``{"case<i>_s": seconds, ..., "total_s":
    seconds}``. With ``devices``, every case on each lane's device
    (``predict_cases(devices=...)``'s lanes), ``workers`` x lanes at a
    time: ``{"lane<j>_case<i>_s": seconds, ..., "total_s": seconds}``."""
    from concurrent.futures import ThreadPoolExecutor

    from runet_tpu_torch.infer.cascade import device_lanes, predict_case

    def timed(img, sp, dev, c, f):
        # Timed inside the callable: completion deltas read on the caller
        # thread would give every case after the first almost nothing.
        t0 = time.monotonic()
        predict_case(c, f, img, sp, cascade, device=dev)
        _sync(dev)
        return time.monotonic() - t0

    out: dict[str, float] = {}
    t_all = time.monotonic()
    cases = list(cases)
    lanes = device_lanes(coarse, fine, devices or [device])
    with ThreadPoolExecutor(max_workers=max(1, workers) * len(lanes)) as pool:
        futs = {(j, i): pool.submit(timed, img, sp, *lane)
                for j, lane in enumerate(lanes) for i, (img, sp) in enumerate(cases)}
        for (j, i), f in futs.items():
            out[f"lane{j}_case{i}_s" if devices else f"case{i}_s"] = round(f.result(), 2)
    out["total_s"] = round(time.monotonic() - t_all, 2)
    return out


def warmup_roi_buckets(fine, fine_shapes, native_spacing,
                       cascade: CascadeConfig = CascadeConfig(), device=None) -> dict[str, float]:
    """Run the fine ROI program on zero crops for explicit bucketed fine
    shapes (e.g. ``(192, 160, 256)``), at B = 1 and, with
    ``cascade.roi_batch > 1``, at that batch too. The crops take the crop
    extent bucketing and the transfer encoding serving uses. Returns
    ``{"roi_<shape>_b<B>_s": seconds, ..., "total_s": seconds}``."""
    from runet_tpu_torch.infer.cascade import _roi_program, _roi_program_batch, _upload
    from runet_tpu_torch.infer.tta import effective_apply_fn

    dev = resolve_device(device)
    n_sp = np.asarray(native_spacing, np.float64)
    f_sp = np.asarray(fine.preprocess.spacing, np.float64)
    scale_nf = np.asarray([f / n for n, f in zip(n_sp, f_sp)], np.float32)
    scale_fn = np.asarray([n / f for n, f in zip(n_sp, f_sp)], np.float32)
    apply_fn = effective_apply_fn(fine)
    cb = max(1, int(cascade.crop_bucket))
    roi_batch = max(1, int(cascade.roi_batch))

    out: dict[str, float] = {}
    t_all = time.monotonic()
    with torch.inference_mode():
        for shape in fine_shapes:
            padded = tuple(int(p) for p in shape)
            want = tuple(-(-(int(np.ceil((p - 1) * float(s))) + 1) // cb) * cb
                         for p, s in zip(padded, scale_nf))
            for B in ([1] if roi_batch == 1 else [1, roi_batch]):
                t0 = time.monotonic()
                up = _upload(np.zeros(want, np.float16), fine.preprocess, dev)
                if B == 1:
                    _roi_program(apply_fn, fine, up, padded, want, scale_nf, scale_fn)
                else:
                    _roi_program_batch(apply_fn, fine, torch.stack([up] * B), padded, want,
                                       scale_nf, scale_fn)
                _sync(dev)
                out[f"roi_{'x'.join(map(str, padded))}_b{B}_s"] = round(time.monotonic() - t0, 2)
    out["total_s"] = round(time.monotonic() - t_all, 2)
    return out
