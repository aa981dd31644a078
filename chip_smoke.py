"""Chip smoke run of the PyTorch + CUDA port (``runet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and printed over):

1. report the card (name and power limit from nvidia-smi);
2. build the ten CUDA kernels from ``runet_tpu_torch/kernels/csrc`` (one
   nvcc per source, started together) and, beside them, the native host
   tier from ``runet_tpu_torch/native/cc3d.cpp`` (g++);
3. serve: load the committed coarse and fine_kits weights and run
   ``predict_cases`` over three KiTS-scale phantoms (512x512x160 at
   0.78125x0.78125x3 mm, seeds 0-2), then ``predict_case`` on a 192x192x64
   phantom gated on Dice (kidney_composite > 0.96, tumor > 0.82). Every
   kernel's launch counter is set to 0 just before this phase and read just
   after; the forward kernels must have launched. The shape of every launch
   is recorded (``launch_shapes``). The native tier's call counters are set
   to 0 with them: its components, component stats, fused keep-largest and
   2-bit ROI paste (K = 3) must each have been called. The three KiTS cases
   from ``predict_cases`` (two worker threads) must equal serial
   ``predict_case`` voxel for voxel;
3a. serve_http: the same full-width bundles behind
   ``infer/http_serve.py``'s ``make_server(port=0)`` in a thread: ``GET
   /healthz``, ``POST /v1/predict`` and ``/v1/report`` with the 192x192x64
   phantom as int16 ``.nii.gz``, and a garbage body that must get 400. The
   labelmap must equal an in-process ``predict_case`` of the same volume
   voxel for voxel, both reports' volumetry ``volumetry`` of it; the
   stride-1 and stride-2 kernels and the same native calls must have run
   between the first request and the last, and no attic kernel;
3b. api: the port's public counterparts of the JAX package's functions
   at full width: ``preprocess_case`` of a 512x512x160 phantom (integer HU)
   at 0.78125x0.78125x3 mm to the fine_kits spacing, the card against the
   CPU (API_CPU_TOL) and against the cascade's own staging from the f16
   upload and from the fine_kits uint8 upload of the window-clipped case
   (``_staging_bound``); ``pad_volume`` of a 112x100x72 crop around a
   kidney to the 128³ patch and ``sliding_window_predict`` of the committed
   fine_kits U-Net on it, labels equal to one forward on the explicitly
   padded volume cropped back (counts set to 0 just before, read after:
   rows 1 and 2 launched, no attic kernel); the ``resample_to_shape``
   round trip native → 0.8 mm → native of a smooth volume within
   ROUNDTRIP_BOUND; ``depth_to_space_3d`` ``torch.equal`` to
   ``depth_to_space_dchw`` at the decoder's widths; ``instance_norm_reference``
   against the model's InstanceNorm in f32 at every level's width
   (NORM_REF_TOL);
3c. cli: the command line, ``runet_tpu_torch.cli.main`` in-process at full
   width: ``phantom`` (two 512x512x160 cases), ``predict`` (the pipelined
   cascade with the committed coarse and fine_kits weights, saved with
   their configs by ``utils/export.py``), ``evaluate --surface``, ``serve
   --once --mesh-classes 1`` on a watch folder of one case, ``warmup
   --shape 512 512 160``, ``mesh``, ``train --config fine_kits`` (128³,
   batch 2) 2 steps and ``--resume`` to 4 on the phantom folder, ``export
   --average 2`` of that run and ``predict --fine`` from the npz on one
   case. Counters set to 0 before the phase; each command's launches and
   wall printed. Every written labelmap must equal in-process
   ``predict_case`` (``predict_volume`` for the fine-only command) voxel
   for voxel, ``evaluate``'s rows ``evaluate_prediction`` of them, the
   served report's volumetry ``volumetry`` of its labels; the export must
   be the mean of the run's two retained checkpoints; rows 1 and 2 must
   launch in each serving command and rows 1, 3 and 4 in training (dw
   launches exact), no attic kernel, and the native tier's calls made;
3d. serve, renal_anatomy: the committed coarse and renal_anatomy (5 classes)
   weights, once per ``fused_kernel`` in ("v2m", "v2", "v1"): ``warmup_cases``
   (seconds printed), ``predict_case`` on the 5-class 192x192x64 phantom
   (seed 13, vessel radius 2.5) gated on Dice (kidney_composite > 0.93,
   tumor > 0.80, artery > 0.40, vein > 0.05), labels of "v2" and "v1" equal
   to "v2m"'s on >= 99.5% of voxels, and one KiTS-scale 5-class case with
   its seconds. Under "v2" also one case each with mirror-flip TTA (8
   flips), with an ensemble of the model with itself (labels equal to the
   single model's on >= 99.9%) and with ``roi_batch=2`` (the same bound
   against ``roi_batch=1``; also on a KiTS-scale case at ``roi_bucket=64``,
   where the two kidney ROIs share a bucket and must run as one batched
   forward). Counters are set to 0 before each value's
   cases and read after: the stride-1 kernel of the value in force must
   have launched and the other two must not, and the native tier must have
   done the components and the 4-bit ROI paste (K = 5);
4. reference: the fine_kits U-Net, and the renal_anatomy U-Net under "v2"
   and "v1", on the card against the same weights on the CPU (plain PyTorch
   path) at a 64³ input;
5. train: two phantom cases (160x144x128 at 0.8 mm iso, so the resample is
   the identity) written in the KiTS19 layout, then ``train`` with the full
   ``fine_kits`` preset (base 32, max 320, 5 levels, 128³ patches, batch 2,
   AdamW with warmup+poly, augmentation on) for 6 steps and a resume to
   step 8. Counters are set to 0 before and read after: every kernel must
   have launched, each weight-gradient kernel once per conv per step, and
   the stride-1 forward kernel at least its forward plus dx launches. Losses
   must be finite and a checkpoint must exist at the last step. The shape of
   every launch (forward, dx, weight gradient, validation) is recorded;
5b. train, renal_anatomy: the ``renal_anatomy`` preset (the same net with 5
   classes) through ``train`` with ``deep_supervision``, ``elastic`` and
   ``steps_per_dispatch=2`` on two 5-class phantom cases: 4 steps under
   each of "v2m", "v2" and "v1", then 4 with ``remat`` and 4 with
   ``upsample_mode="convtranspose"`` (both "v2m"; two chunks each, so the
   second chunk's imgs/s is a warm one); no validation, so the
   launch counts per step are exact (27 forward + dx launches of the value's
   own kernel, 14 weight-gradient launches, none under "v1" whose dw is the
   framework's; under ``remat`` the forward count rises by each block's
   recomputation: expected and found are printed). Losses finite,
   ``ds_aux_loss`` logged, a checkpoint at the last step, peak device memory
   printed per run;
6. gradient reference: the fine_kits train model on the card against its
   deep copy on the CPU (plain path, bf16) at a (1, 32, 64, 64, 1) input:
   per-tensor cosine of the gradients >= GRAD_COSINE, global norms within
   GRAD_NORM_REL; the CPU path summed in another order (oneDNN off) and the
   same weights in f32 on the CPU print the floor that bf16 sets. Then the
   renal_anatomy train model with deep supervision under "v2" and "v1", to
   the same gates;
7. overfit gate: the same full-width model on one fixed 128³ batch of 2,
   constant lr, no augmentation, 20 steps; the last loss must fall below
   OVERFIT_FRACTION of the first. Prints the warm step median (host clock
   around synchronized steps), images/s, peak device memory, and the
   kernel launches of one step;
7b. parallel (``runet_tpu_torch/parallel``): data parallelism at world
   size 1 over NCCL, ``train(mesh=make_mesh(1))`` with fine_kits (128³,
   batch 2) for 2 steps in a rank process, its aux and parameters
   ``torch.equal`` to the one-device ``train`` on the same data and seed
   where two one-device runs are themselves equal, else within their spread
   (printed); world size 2 over gloo, both ranks on the one card (NCCL
   refuses two ranks on one GPU), one augmented fine_kits step of batch 1 +
   1 (SGD at a constant rate): the reduced gradients each rank's optimizer
   step is given, bit-equal to the f32 mean of the two one-process batch-1
   steps' (the DP step's arithmetic in one process; ``grad_norm`` within
   DP_NORM_EXACT_REL of that mean's), equal on both ranks, and against the
   one-process batch-2 step the whole gradient's cosine >= DP_COSINE and
   ``grad_norm`` within DP_NORM_REL (per-tensor cosines printed, and where
   one process's batch-2 step first leaves its batch-1 steps: forward
   logits, then gradients in backward order, with the bf16 rounding of
   the conv kernels' gradients and the two samples' cancellation); both ranks' parameters
   equal, rows 1, 3 and 4 launched in each; the DP step's ms at both world
   sizes (DP_TIMED_STEPS warm synchronized steps); the same two ranks then
   run fine_kits spatially partitioned over a 256x128x128 phantom (halo
   32), labels equal on every voxel to a one-process reference of the
   sharded forward (the same X blocks and halos, the threads' norm moments
   averaged by hand) and agreeing with the dense forward of the same
   weights on >= SPATIAL_AGREE of voxels (two controls, norms not averaged
   and zero halos, each printed against the dense forward and required to
   leave the reference on some voxel), the halo exchange and label gather staged
   through pinned host memory (counted); then ``warmup_cases`` and
   ``predict_cases`` on two serving lanes of the card (``devices=["cuda:0",
   "cuda:0"]``) over three KiTS-scale phantoms, labels equal to serial
   ``predict_case``, rows 1-2 and the native tier's calls made, and one
   lane on the card from bundles loaded on the CPU (``bundle_on_device``
   copies their modules there; labels equal to serial). Every rank returns its kernel counts
   (set to 0 before its driven work) and launch shapes; with the lanes'
   they are the ``parallel`` path of the ``kernels`` line, and no attic
   kernel runs;
8. kernel bench: ``python -m runet_tpu_torch.utils.kernel_bench`` run
   in-process into ``chip_smoke_work/``, the path of the four attic
   kernels (``kernels/attic``; no model config routes through them, and
   every main path above must have launched each 0 times): counts set to 0
   before and read after, the shape of every launch recorded, and the
   kernels that its CUDA graphs replay added to both (``replay_counting``);
   every one of the ten kernels must have launched, and every row must
   carry a finite positive ms for each kernel it names;
9. kernel vs plain: each kernel on random inputs at every distinct shape
   the serve, api, cli, train, parallel and kernel-bench phases launched it with,
   against its
   plain version on the same inputs, with timings (``utils/latency.py``'s
   ``chained_ms``) of kernel, plain version and the library yardstick
   (bf16 ``F.conv3d`` + sums for the forward kernels, without sums for the
   attic conv, bf16 ``torch.nn.grad.conv3d_weight`` for the weight
   gradients, ``F.instance_norm`` + ``F.leaky_relu`` for the instance-norm
   pair; never called by the port; for the "v1" kernel on its own (B, D,
   H, C, W) layout, the permutes to and from cuDNN's layout included; for
   the instance-norm stats kernel ``torch.var_mean`` over the same
   (sample, channel) groups). At every shape of the four conv + moments
   kernels of the main paths ("v2m", "v2", "v1" with its 4-row x 32-column
   tiles, built one kd plane at a time, and the stride-2 kernel) the kernel
   also runs on x at an odd element offset, its element-load instance,
   which must give the aligned run's y, sums and sqs bit for bit
   (``element_ms`` times it); at every shape of
   the two weight-gradient kernels (each staged in two stages) x, and
   separately g, at an odd offset must give the aligned run's dw bit for
   bit (``element_ms`` times the odd x); at every shape of the two attic
   NDHWC convs (the conv + moments: its tile follows W, its kd planes go
   through a cp.async ring; the conv: its tile follows W and the packed
   Cout, TMA fills its ring of kd planes) x at an odd offset must give the
   aligned run's y (and sums and sqs) bit for bit, and where C == Cout the
   kernel and its library yardstick are also timed in a CUDA graph
   (``scanned_ms``, the kernel bench's protocol: ``graph_ms``,
   ``graph_library_ms``);
10. attic: the four attic kernels against their plain versions, untimed,
   at shapes the bench does not launch: the NDHWC conv at (7, 13, 29,
   5)→11 and at one shape per tile and edge (``ATTIC_CONV_CASES``: W = 16
   and 17, a ragged 16-row tile, Cout 80 with Cout_pad 96, Cout 64 at W >
   16, Cin % 16 = 8, one voxel), the NDHWC conv + moments at (6, 9, 11,
   24)→40, W = 16 and 17 (4, 12, W, 64)→64, a ragged 16-row tile (5, 13,
   16, 128)→96 and Cout 80 (3, 9, 33, 40)→80, both with x also at an odd
   offset, bits equal; the instance-norm
   stats and apply kernels (alone and as the pair) at (1, 8, 8, 8, 320)
   bf16 and at (1, 3, 5, 7, 20) bf16 and f32; row 1 (v2m) at one shape
   per tile, instance and edge (``V2M_TILE_CASES``: 8 x 32 x 32 with and
   without 16-byte copies and at Cout_pad 96, 8 x 32 x 64 at W = 32 and 17,
   16 x 16 x 32 at H = 16, 12 and 8 and W = 12, one voxel) and row 5 (v2)
   likewise (``V2_TILE_CASES``: 8 x 32 x 32 with and without 16-byte
   copies, at Cout_pad 96, Cout 128, W = 17 and Cin 1, 16 x 16 x 32 at H =
   16, 12 and 8 and W = 12, one voxel) and row 2 (stride 2) likewise
   (``S2_TILE_CASES``: 4 x 32 x 64 at Wo = 64 and 18, 4 x 32 x 32 at Cin 1
   and Cout_pad 96, 8 x 16 x 64 at Ho = 5 and 8, Cout 320 and W = 20, 8 x
   16 x 32 at Ho = 9 and D = 2, one output voxel), x also at an odd offset,
   bits equal. Then the gradient of the attic conv's autograd Function (dx
   through the kernel, dw by the framework in f32) at two small shapes
   against autograd through ``F.conv3d`` in true f32.

Tolerances of kernel vs plain. Forward: both accumulate in f32 and round to
bf16 in different orders, so y may differ by one bf16 ulp (2^-7 relative)
or, near zero, by 1e-3 of the tensor's largest magnitude; sq-means agree to
1e-3 relative and means to 1e-3 of the channel rms (the attic convs too).
Weight gradient: both
sum exact bf16 products in f32 in different orders; within DW_TOL of the
same sum over |x|·|g| (a wrong tap is off by the order of that sum).
Instance-norm stats: f32 sums in different orders, within NORM_SUM_TOL of
the same sum over |x| (and of Σx²); apply: each f32 operation rounded once
in the plain version's order, within one ulp of the output dtype (2^-7
relative for bf16, 2^-22 for f32; expected bit-equal, and the count of
differing elements is printed); the pair: one ulp plus 1e-5 of the largest
magnitude (its mean and rstd come from sums taken in another order). Attic
conv gradient: dx and dw are rounded to bf16 once on both sides, so one
bf16 ulp plus 1e-3 of the largest magnitude.

The line before the last is the ``kernels`` JSON object, the last line
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import shutil
import statistics
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

CASE_SHAPE = (512, 512, 160)
CASE_SPACING = (0.78125, 0.78125, 3.0)
QUALITY_SHAPE = (192, 192, 64)
QUALITY_SEED = 7
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores
TRAIN_CASE_SHAPE = (160, 144, 128)
TRAIN_SPACING = (0.8, 0.8, 0.8)
TRAIN_STEPS, RESUME_STEPS = 6, 8
CLI_CASES = 2
CLI_TRAIN_STEPS = (2, 4)  # train, then --resume to step 4
OVERFIT_STEPS = 20
OVERFIT_LR = 1e-3
OVERFIT_FRACTION = 0.75  # measured 0.581 (H100 80GB HBM3, 700 W)
# The gradient reference's gates. Both sides compute in bf16 and round at
# the same places but sum in other orders; an untrained net's gradients are
# sums with heavy cancellation, so one bf16 ulp of difference in a forward
# activation turns a tensor's gradient. The phase prints the floor this
# sets: the CPU path against itself with oneDNN off (torch's own conv loops,
# another summation order) agrees per tensor only to ~0.95, so no correct
# bf16 path can meet a gate of 0.99. A fault in the backward (unflipped dx
# taps, a fold without the 2, rotated dw taps) turns some tensor's gradient
# far below 0.90 (tests/test_torch_grad.py holds the gate to both). The card
# against the CPU bf16 path measured a per-tensor minimum of 0.952 and
# norms 0.16% apart (H100 80GB HBM3, 700 W).
GRAD_COSINE = 0.90
GRAD_NORM_REL = 0.02
DW_TOL = 1e-5  # measured at most 2.7e-7 at the train shapes (H100 80GB HBM3, 700 W)
NORM_SUM_TOL = 1e-5
ATTIC = ("conv3x3_ndhwc", "conv3x3_ndhwc_stats", "instance_norm_stats",
         "instance_norm_lrelu_apply")
WORK = Path(__file__).resolve().parent / "chip_smoke_work"


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Per-call ms of ``fn()``: ``utils/latency.py``'s ``chained_ms``, one
    warm-up call, ``reps`` calls between two CUDA events."""
    from runet_tpu_torch.utils.latency import chained_ms

    return chained_ms(fn, (), n=reps, warmup=1)


def kernel_counts() -> dict[str, int]:
    from runet_tpu_torch.kernels import fused_block, strided_conv
    from runet_tpu_torch.kernels.attic import conv3d, conv_v3_deep, fused_norm

    return {fused_block.SOURCE: fused_block.launches, strided_conv.SOURCE: strided_conv.launches,
            fused_block.DW_SOURCE: fused_block.dw_launches,
            strided_conv.DW_SOURCE: strided_conv.dw_launches,
            fused_block.V2_SOURCE: fused_block.v2_launches,
            fused_block.V1_SOURCE: fused_block.v1_launches,
            conv3d.SOURCE: conv3d.launches, conv_v3_deep.SOURCE: conv_v3_deep.launches,
            fused_norm.STATS_SOURCE: fused_norm.stats_launches,
            fused_norm.APPLY_SOURCE: fused_norm.apply_launches}


def reset_counts() -> None:
    from runet_tpu_torch.kernels import fused_block, strided_conv
    from runet_tpu_torch.kernels.attic import conv3d, conv_v3_deep, fused_norm

    fused_block.launches = fused_block.dw_launches = 0
    fused_block.v2_launches = fused_block.v1_launches = 0
    strided_conv.launches = strided_conv.dw_launches = 0
    conv3d.launches = conv_v3_deep.launches = 0
    fused_norm.stats_launches = fused_norm.apply_launches = 0


def no_attic(counts: dict, phase: str) -> None:
    """The main paths launch none of the attic kernels."""
    if any(counts[k] for k in ATTIC):
        raise AssertionError(f"{phase}: an attic kernel launched on a main path: {counts}")


def add_counts(total: dict, counts: dict) -> dict:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


@contextmanager
def launch_shapes():
    """Yields {(kernel, x shape, Cout): launches} of every kernel launch made
    inside the block (forward, dx, weight gradient, validation alike; x in
    the layout the kernel takes; for the instance-norm kernels x as the
    caller gave it and its C in place of Cout), by wrapping the launch
    functions that the kernel modules call; the wrappers' own counters are
    untouched. Thread-safe: ``predict_cases`` runs cases on worker
    threads."""
    from runet_tpu_torch.kernels import fused_block, strided_conv
    from runet_tpu_torch.kernels.attic import conv3d, conv_v3_deep, fused_norm

    seen: dict[tuple, int] = {}
    lock = threading.Lock()

    def note(key):
        with lock:
            seen[key] = seen.get(key, 0) + 1

    def conv(launch, cout_of):
        def wrapped(name, x, *args, **kw):
            note((name, tuple(x.shape), int(cout_of(*args))))
            return launch(name, x, *args, **kw)
        return wrapped

    def norm(launch, name):
        def wrapped(x, *args, **kw):
            # The key holds no dtype: the held case (phase_kernels) is bf16.
            if x.dtype != torch.bfloat16:
                raise AssertionError(f"{name}: a {x.dtype} launch cannot be recorded")
            note((name, tuple(x.shape), int(x.shape[-1])))
            return launch(x, *args, **kw)
        return wrapped

    patches = [(m, "launch_conv_stats", conv(m.launch_conv_stats, lambda packed, cout, *_: cout))
               for m in (fused_block, strided_conv, conv3d, conv_v3_deep)]
    patches += [(m, "launch_conv_dw", conv(m.launch_conv_dw, lambda g: g.shape[2]))
                for m in (fused_block, strided_conv)]
    patches += [(fused_norm, "instance_norm_stats",
                 norm(fused_norm.instance_norm_stats, fused_norm.STATS_SOURCE)),
                (fused_norm, "instance_norm_lrelu_apply",
                 norm(fused_norm.instance_norm_lrelu_apply, fused_norm.APPLY_SOURCE))]
    saved = [(m, attr, getattr(m, attr)) for m, attr, _ in patches]
    for m, attr, f in patches:
        setattr(m, attr, f)
    try:
        yield seen
    finally:
        for m, attr, f in saved:
            setattr(m, attr, f)


@contextmanager
def nifti_seconds():
    """Yields {"read": s, "write": s}: the seconds spent inside the NIfTI
    reader's file read + gunzip (``io/nifti.py``'s ``_read_bytes``) and the
    writer's serialization + gzip (``volume_to_bytes``) within the block,
    summed over threads (a writer thread's time overlaps the device's)."""
    from runet_tpu_torch.io import nifti

    spent = {"read": 0.0, "write": 0.0}
    lock = threading.Lock()

    def timed(fn, key):
        def wrapped(*a, **kw):
            t0 = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    spent[key] += time.monotonic() - t0
        return wrapped

    saved = nifti._read_bytes, nifti.volume_to_bytes
    nifti._read_bytes = timed(saved[0], "read")
    nifti.volume_to_bytes = timed(saved[1], "write")
    try:
        yield spent
    finally:
        nifti._read_bytes, nifti.volume_to_bytes = saved


def replay_counting(scanned, seen: dict, extra: dict):
    """``scanned`` (``utils/latency.py``'s ``scanned_ms``) that adds to
    ``extra`` ({kernel: launches}) and to ``seen`` (``launch_shapes``' dict)
    the kernels its CUDA graph runs and no wrapper counts: the counters
    count each captured call once, at capture, where nothing runs, and the
    graph then runs it ``WARM_REPLAYS + reps`` times."""
    from runet_tpu_torch.utils.latency import WARM_REPLAYS

    def timed(step, x0, iters=30, reps=3):
        marks = []

        def marked(x):
            before = (kernel_counts(), dict(seen))
            y = step(x)
            marks.append((before, (kernel_counts(), dict(seen))))
            return y

        ms = scanned(marked, x0, iters=iters, reps=reps)
        # The last ``iters`` calls are the capture.
        (c0, s0), _ = marks[-iters]
        _, (c1, s1) = marks[-1]
        times = WARM_REPLAYS + reps - 1
        for k, v in c1.items():
            extra[k] = extra.get(k, 0) + (v - c0[k]) * times
        for k, v in s1.items():
            seen[k] += (v - s0.get(k, 0)) * times
        return ms

    return timed


def phase_build():
    from runet_tpu_torch.kernels import build, fused_block, strided_conv
    from runet_tpu_torch.kernels.attic import conv3d, conv_v3_deep, fused_norm

    from runet_tpu_torch.utils import native

    t0 = time.monotonic()
    # g++ for the host tier runs beside the ten nvcc builds.
    host = threading.Thread(target=native.available)
    host.start()
    logs = build.build([fused_block.SOURCE, strided_conv.SOURCE, fused_block.DW_SOURCE,
                        strided_conv.DW_SOURCE, fused_block.V2_SOURCE, fused_block.V1_SOURCE,
                        conv3d.SOURCE, conv_v3_deep.SOURCE, fused_norm.STATS_SOURCE,
                        fused_norm.APPLY_SOURCE])
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    host.join()
    if not native.available():
        raise AssertionError(f"the native host tier did not build:\n{native.build_error()}")
    log(f"[build] kernels and native host tier ({native.library_path().name}) ready in "
        f"{time.monotonic() - t0:.1f} s")


NATIVE_SERVE = ("label_components_3d", "component_stats_3d", "keep_largest_in_boxes_3d")


def native_calls(phase: str, paste: str) -> dict:
    """The native tier's calls since the last reset; fails the run unless
    the tier is loaded and the components, their boxes, the fused keep and
    the ROI paste of the label width in force (``paste``) all went through
    it (a run that fell back to scipy or numpy fails)."""
    from runet_tpu_torch.utils import native

    calls = native.call_counts()
    log(f"[{phase}] native host tier calls: {calls}")
    missing = [k for k in (*NATIVE_SERVE, paste) if calls[k] <= 0]
    if not native.available() or missing:
        raise AssertionError(f"{phase}: the native host tier was not used for {missing} "
                             f"(available: {native.available()})")
    return calls


def phase_serve(dev):
    """Drive the serving path; returns per-kernel launch counts, the shapes
    of its launches and the fine U-Net."""
    from runet_tpu_torch.data.phantom import make_phantom
    from runet_tpu_torch.eval.evaluate import evaluate_prediction
    from runet_tpu_torch.infer.cascade import ModelBundle, predict_case, predict_cases
    from runet_tpu_torch.kernels import fused_block, strided_conv
    from runet_tpu_torch.params import load_model
    from runet_tpu_torch.utils import native
    from runet_tpu_torch.utils.timing import PhaseTimer

    t0 = time.monotonic()
    cm, ccfg = load_model("coarse", device=dev)
    fm, fcfg = load_model("fine_kits", device=dev)
    coarse, fine = ModelBundle.from_model(cm, ccfg), ModelBundle.from_model(fm, fcfg)
    cases = [make_phantom(CASE_SHAPE, CASE_SPACING, num_classes=3, seed=s) for s in range(3)]
    q_img, q_seg = make_phantom(QUALITY_SHAPE, CASE_SPACING, num_classes=3, seed=QUALITY_SEED)
    log(f"[serve] set-up (weights, phantoms) {time.monotonic() - t0:.1f} s")

    reset_counts()
    native.reset_call_counts()
    torch.cuda.synchronize()
    with launch_shapes() as shapes:
        t0 = time.monotonic()
        arrivals = []
        preds = []
        for pred in predict_cases(coarse, fine, [(img, CASE_SPACING) for img, _ in cases],
                                  fcfg.cascade, device=dev):
            arrivals.append(time.monotonic() - t0)
            preds.append(pred)
        wall = time.monotonic() - t0
        timer = PhaseTimer()
        t1 = time.monotonic()
        q_pred = predict_case(coarse, fine, q_img, CASE_SPACING, fcfg.cascade, timer=timer,
                              device=dev)
        q_sec = time.monotonic() - t1
        torch.cuda.synchronize()
    counts = kernel_counts()
    native_calls("serve", "paste_crumbs_3d")

    # The pipelined results (two worker threads sharing the modules' packed
    # weight caches and the cached matrices) against serial predict_case.
    for i, ((img, _), pred) in enumerate(zip(cases, preds)):
        serial = predict_case(coarse, fine, img, CASE_SPACING, fcfg.cascade, device=dev)
        if not np.array_equal(serial, pred):
            raise AssertionError(f"case {i}: predict_cases differs from serial predict_case on "
                                 f"{int((serial != pred).sum())} voxels")
    log("[serve] predict_cases (workers=2) equals serial predict_case voxel for voxel, 3 cases")

    for i, ((img, seg), pred) in enumerate(zip(cases, preds)):
        if pred.shape != img.shape or pred.dtype != np.uint8 or pred.max() > 2:
            raise AssertionError(f"case {i}: bad output {pred.shape} {pred.dtype} max {pred.max()}")
        m = evaluate_prediction(pred, seg, 3)
        log(f"[serve] kits case {i}: done at {arrivals[i]:.3f} s, "
            f"kidney_composite {m['kidney_composite']:.4f} tumor {m['tumor']:.4f}")
    log(f"[serve] predict_cases: 3 cases in {wall:.3f} s = {wall / 3:.3f} s/case "
        f"({180.0 / wall:.2f} volumes/min)")
    m = evaluate_prediction(q_pred, q_seg, 3)
    log(f"[serve] quality phantom {QUALITY_SHAPE}: {q_sec:.3f} s, phases {timer.as_dict()}, "
        f"kidney_composite {m['kidney_composite']:.4f} tumor {m['tumor']:.4f}")
    if not (m["kidney_composite"] > 0.96 and m["tumor"] > 0.82):
        raise AssertionError(f"quality gate failed: {m}")
    log(f"[serve] kernel launches in this phase: {counts}")
    no_attic(counts, "serve")
    for name in (fused_block.SOURCE, strided_conv.SOURCE):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the serving path")
    return counts, shapes, fm, (coarse, fine, fcfg.cascade)


def phase_serve_http(dev, coarse, fine, cascade):
    """The HTTP entry point over the serve phase's full-width coarse and
    fine_kits bundles: ``make_server(port=0)`` in a thread, ``GET /healthz``,
    ``POST /v1/predict`` and ``/v1/report`` with the quality phantom as
    ``.nii.gz``, and a garbage body that must get 400. The labelmap must
    equal an in-process ``predict_case`` of the same volume voxel for voxel,
    the report's volumetry ``volumetry`` of it, and the stride-1 and
    stride-2 kernels must have launched in the phase (counts set to 0 just
    before the first request, read after the last); returns the launch
    counts and shapes."""
    import urllib.error
    import urllib.request

    from runet_tpu_torch.data.phantom import make_phantom
    from runet_tpu_torch.eval.surface import volumetry
    from runet_tpu_torch.infer.cascade import predict_case
    from runet_tpu_torch.infer.http_serve import InferenceService, make_server
    from runet_tpu_torch.io.nifti import volume_from_bytes, volume_to_bytes
    from runet_tpu_torch.kernels import fused_block, strided_conv
    from runet_tpu_torch.utils import native

    img, _ = make_phantom(QUALITY_SHAPE, CASE_SPACING, num_classes=3, seed=QUALITY_SEED)
    body = volume_to_bytes(np.rint(img).astype(np.int16), spacing=CASE_SPACING, gz=True)
    vol = volume_from_bytes(body)
    service = InferenceService(fine, coarse, cascade, device=dev)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]

    def call(path, data=None):
        t0 = time.monotonic()
        req = urllib.request.Request(base + path, data=data)
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                out = resp.status, dict(resp.headers), resp.read()
        except urllib.error.HTTPError as e:
            out = e.code, dict(e.headers), e.read()
        log(f"[serve_http] {'POST' if data is not None else 'GET'} {path}: {out[0]}, "
            f"{len(out[2])} bytes in {time.monotonic() - t0:.3f} s")
        return out

    reset_counts()
    native.reset_call_counts()
    torch.cuda.synchronize()
    try:
        with launch_shapes() as shapes:
            health = json.loads(call("/healthz")[2])
            p_status, p_headers, p_body = call("/v1/predict", body)
            r_status, _, r_body = call("/v1/report", body)
            bad_status, _, bad_body = call("/v1/predict", b"not a NIfTI volume")
            torch.cuda.synchronize()
        counts = kernel_counts()
    finally:
        server.shutdown()
        thread.join(timeout=30)
        server.server_close()
    native_calls("serve_http", "paste_crumbs_3d")
    log(f"[serve_http] body {len(body)} bytes ({QUALITY_SHAPE} int16 .nii.gz); healthz {health}")
    want_health = {"status": "ok", "device": torch.cuda.get_device_name(dev), "cascade": True,
                   "num_classes": 3}
    if health != want_health:
        raise AssertionError(f"serve_http: /healthz gave {health}, expected {want_health}")
    if (p_status, r_status, bad_status) != (200, 200, 400):
        raise AssertionError(f"serve_http: statuses {p_status} {r_status} {bad_status}, "
                             f"expected 200 200 400 ({bad_body[:200]!r})")
    got = volume_from_bytes(p_body)
    want = predict_case(coarse, fine, vol.data, vol.spacing, cascade, device=dev)
    if got.data.shape != want.shape or not np.array_equal(got.data, want):
        raise AssertionError(f"serve_http: /v1/predict's labelmap differs from in-process "
                             f"predict_case on {int((got.data != want).sum())} voxels")
    vols = volumetry(want, vol.spacing, 3)
    for tag, report in (("X-Runet-Report", json.loads(p_headers["X-Runet-Report"])),
                        ("/v1/report", json.loads(r_body))):
        shown = {k: report[k] for k in vols}
        if shown != vols or report["shape"] != list(QUALITY_SHAPE):
            raise AssertionError(f"serve_http: {tag} {report} against volumetry {vols}")
        log(f"[serve_http] {tag}: {report}")
    log("[serve_http] labelmap equals in-process predict_case voxel for voxel; both reports' "
        "volumetry equals volumetry() of it")
    log(f"[serve_http] kernel launches in this phase: {counts}")
    no_attic(counts, "serve_http")
    for name in (fused_block.SOURCE, strided_conv.SOURCE):
        if counts[name] <= 0:
            raise AssertionError(f"serve_http: kernel {name} was not launched")
    return counts, shapes


# The api phase's shapes and bounds. A crop of the preprocessed case under
# the 128³ patch on every axis, around the first kidney (the phantom puts it
# at 0.30 x, 0.45 y, 0.50 z of the volume).
API_CROP = (112, 100, 72)
API_CPU_TOL = 1e-4  # preprocess_case card vs CPU (tests/test_torch_api_parity.py's JAX bound)
ROUNDTRIP_BOUND = 0.05  # tests/test_resample.py::test_roundtrip_native_iso_native_error_bound
NORM_REF_TOL = 1e-4  # the model's single-pass f32 InstanceNorm against the two-pass oracle


def _staging_bound(pp, out_shape, scale) -> float:
    """Largest |cascade staging - preprocess_case| on integer HU inside what
    the upload keeps: the cascade's interpolation positions and weights are
    f32 (off by a few f32 ulps of the largest position, 3 axes) where
    ``preprocess_case``'s are f64, each weight error times a jump of at most
    2000 HU between neighbours; a uint8 upload adds half a quantization
    step. In normalized units."""
    max_pos = max((o - 1) * float(s) for o, s in zip(out_shape, scale))
    hu = 2000.0 * 3 * max_pos * 2.0 ** -23
    if pp.transfer_quant:
        lo, hi = pp.hu_window
        hu += (hi - lo) / 255.0 / 2.0
    return hu / pp.hu_stats[1] + 1e-5


def phase_api(dev, fm):
    """The port's public counterparts of the JAX package's API on the card:
    ``preprocess_case`` of a KiTS-scale phantom to the fine_kits spacing
    against the same call on the CPU and against the cascade's own staging;
    ``pad_volume`` + ``sliding_window_predict`` of the fine_kits U-Net
    (``fm``, the committed weights) on a crop under the patch, labels equal
    to one forward on the explicitly padded volume, cropped back (counts set
    to 0 just before, read after: rows 1 and 2 launched, no attic kernel);
    the ``resample_to_shape`` round trip native → iso → native;
    ``depth_to_space_3d`` against ``depth_to_space_dchw`` at the decoder's
    widths; ``instance_norm_reference`` against the model's InstanceNorm in
    f32. Returns the launch counts and shapes."""
    from runet_tpu_torch.config import get_config
    from runet_tpu_torch.data.phantom import make_phantom
    from runet_tpu_torch.infer import cascade
    from runet_tpu_torch.infer.sliding_window import pad_volume, sliding_window_predict
    from runet_tpu_torch.kernels import fused_block, strided_conv
    from runet_tpu_torch.models.norm import InstanceNorm, instance_norm_reference
    from runet_tpu_torch.models.unet3d import (
        depth_to_space_3d,
        depth_to_space_dchw,
        level_features,
    )
    from runet_tpu_torch.preprocess.normalize import preprocess_case
    from runet_tpu_torch.preprocess.resample import (
        output_shape_for_spacing,
        resample_to_shape,
        resample_to_spacing,
    )

    t_phase = time.monotonic()
    fcfg = get_config("fine_kits")
    pp = fcfg.preprocess
    img, seg = make_phantom(CASE_SHAPE, CASE_SPACING, num_classes=3, seed=0)
    img = np.rint(img)  # integer HU, as a CT volume stores it

    # preprocess_case: the card against the CPU, then against the cascade's
    # staging (f32 runtime positions from the f16 upload, and from the
    # fine_kits uint8 upload on the case clipped to the HU window, where
    # clipping before the resample is clipping after it).
    args = (CASE_SPACING, pp.spacing, pp.hu_window, pp.hu_stats)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    x = preprocess_case(torch.from_numpy(img).to(dev), *args)
    torch.cuda.synchronize()
    card_s = time.monotonic() - t0
    t0 = time.monotonic()
    x_cpu = preprocess_case(torch.from_numpy(img), *args)
    cpu_s = time.monotonic() - t0
    out_shape = output_shape_for_spacing(CASE_SHAPE, CASE_SPACING, pp.spacing)
    if tuple(x.shape) != out_shape or x.dtype != torch.float32 or not torch.isfinite(x).all():
        raise AssertionError(f"preprocess_case: {tuple(x.shape)} {x.dtype}, want {out_shape}")
    err = (x.cpu() - x_cpu).abs().max().item()
    log(f"[api] preprocess_case {CASE_SHAPE} at {CASE_SPACING} -> {out_shape} at {pp.spacing}: "
        f"card {card_s:.3f} s, CPU {cpu_s:.3f} s, max |card - CPU| {err:.3g} "
        f"(tolerance {API_CPU_TOL})")
    if not err <= API_CPU_TOL:
        raise AssertionError(f"preprocess_case: card and CPU differ by {err}")
    del x_cpu
    scale = np.asarray([d / s for s, d in zip(CASE_SPACING, pp.spacing)], np.float32)
    for tag, stage_pp, image in (
            ("f16 upload", dataclasses.replace(pp, transfer_quant=False), img),
            ("uint8 upload (fine_kits), window-clipped case", pp, np.clip(img, *pp.hu_window))):
        want = x if image is img else preprocess_case(torch.from_numpy(image).to(dev), *args)
        with torch.inference_mode():
            got = cascade._stage_resample_in(cascade._upload(image, stage_pp, dev), out_shape,
                                             scale, stage_pp)
        err = (got - want).abs().max().item()
        bound = _staging_bound(stage_pp, out_shape, scale)
        log(f"[api] preprocess_case vs the cascade's staging, {tag}: max |Δ| {err:.3g} "
            f"(bound {bound:.3g})")
        if not err <= bound:
            raise AssertionError(f"preprocess_case and the cascade's staging differ by {err}")
        del got, want

    # pad_volume + sliding_window_predict on a crop under the patch.
    patch = tuple(fcfg.infer.patch_size)
    c = [int(round(f * n)) for f, n in zip((0.30, 0.45, 0.50), out_shape)]
    lo = [ci - s // 2 for ci, s in zip(c, API_CROP)]
    crop = x[lo[0]:lo[0] + API_CROP[0], lo[1]:lo[1] + API_CROP[1], lo[2]:lo[2] + API_CROP[2]]
    crop = crop.contiguous()
    del x
    pad_value = crop.min()
    reset_counts()
    torch.cuda.synchronize()
    with launch_shapes() as shapes, torch.inference_mode():
        t0 = time.monotonic()
        padded, padded_shape = pad_volume(crop, patch, pad_value)
        labels = sliding_window_predict(
            cascade.module_apply, fm, padded, patch_size=patch, num_classes=3,
            overlap=fcfg.infer.overlap, sigma_scale=fcfg.infer.sigma_scale,
            window_batch=fcfg.infer.window_batch,
            single_pass_ratio=fcfg.infer.single_pass_ratio)
        labels = labels[:API_CROP[0], :API_CROP[1], :API_CROP[2]]
        torch.cuda.synchronize()
        sw_s = time.monotonic() - t0
        ref = torch.full(patch, float(pad_value), device=dev)
        ref[:API_CROP[0], :API_CROP[1], :API_CROP[2]] = crop
        logits = fm(ref[None, ..., None])[0]
        want = torch.argmax(torch.softmax(logits.float(), dim=-1), dim=-1).to(torch.uint8)
        want = want[:API_CROP[0], :API_CROP[1], :API_CROP[2]]
        torch.cuda.synchronize()
    counts = kernel_counts()
    if padded_shape != patch or not torch.equal(padded, ref):
        raise AssertionError(f"pad_volume: {padded_shape} differs from the explicit padding")
    if not torch.equal(labels, want):
        raise AssertionError(f"pad_volume + sliding_window_predict differs from the forward on "
                             f"the padded volume on {int((labels != want).sum())} voxels")
    n_kidney = int((labels == 1).sum())
    log(f"[api] pad_volume {API_CROP} -> {padded_shape}, sliding_window_predict {sw_s:.3f} s: "
        f"labels equal to the padded forward cropped back on all {labels.numel()} voxels "
        f"(classes {torch.bincount(labels.flatten().long(), minlength=3).tolist()})")
    log(f"[api] kernel launches in the window pass and its reference: {counts}")
    no_attic(counts, "api")
    for name in (fused_block.SOURCE, strided_conv.SOURCE):
        if counts[name] <= 0:
            raise AssertionError(f"api: kernel {name} was not launched")
    if n_kidney == 0:
        raise AssertionError("api: no kidney voxel in a crop around the kidney")
    del padded, ref, logits, crop

    # resample_to_shape: native → iso → native on a smooth volume.
    g = [torch.arange(n, dtype=torch.float32, device=dev) for n in CASE_SHAPE]
    smooth = (torch.sin(g[0] / 5)[:, None, None] + torch.cos(g[1] / 7)[None, :, None]
              + (g[2] / 16.0)[None, None, :])
    iso = resample_to_spacing(smooth, CASE_SPACING, pp.spacing)
    back = resample_to_shape(iso, CASE_SHAPE, pp.spacing, CASE_SPACING)
    rt = (back - smooth).abs().mean().item()
    log(f"[api] resample_to_shape round trip {CASE_SHAPE} -> {tuple(iso.shape)} -> "
        f"{tuple(back.shape)}: mean |error| {rt:.4g} (bound {ROUNDTRIP_BOUND})")
    if tuple(back.shape) != CASE_SHAPE or not rt < ROUNDTRIP_BOUND:
        raise AssertionError(f"resample_to_shape round trip: {tuple(back.shape)}, {rt}")
    del smooth, iso, back

    # depth_to_space_3d at the decoder's widths (batch 2, 128³ patch).
    feats = level_features(fcfg.model)
    gen = torch.Generator(device=dev).manual_seed(0)
    for lvl in range(len(feats) - 1):
        s = patch[0] // 2 ** (lvl + 1)
        xs = torch.randn((2, s, s, s, 8 * feats[lvl]), generator=gen, device=dev
                         ).to(torch.bfloat16)
        got = depth_to_space_3d(xs, 2)
        want = depth_to_space_dchw(xs.permute(0, 1, 4, 2, 3), 2).permute(0, 1, 3, 4, 2)
        if not torch.equal(got, want):
            raise AssertionError(f"depth_to_space_3d differs from depth_to_space_dchw at "
                                 f"{tuple(xs.shape)}")
    log(f"[api] depth_to_space_3d torch.equal to depth_to_space_dchw at decoder levels "
        f"0-{len(feats) - 2} ({[8 * f for f in feats[:-1]]} channels)")

    # instance_norm_reference against the model's InstanceNorm in f32.
    worst = 0.0
    for lvl, f in enumerate(feats):
        s = patch[0] // 2 ** lvl
        xs = torch.randn((2, s, s, s, f), generator=gen, device=dev) * 2 + 0.5
        norm = InstanceNorm(f, dtype=torch.float32, device=dev)
        with torch.no_grad():
            norm.scale.copy_(torch.randn(f, generator=gen, device=dev))
            norm.bias.copy_(torch.randn(f, generator=gen, device=dev))
            got = norm(xs, channel_axis=-1)
        want = instance_norm_reference(xs, norm.scale, norm.bias)
        worst = max(worst, (got - want).abs().max().item())
    log(f"[api] instance_norm_reference vs InstanceNorm (f32) at fine_kits widths {feats}: "
        f"max |Δ| {worst:.3g} (tolerance {NORM_REF_TOL})")
    if not worst <= NORM_REF_TOL:
        raise AssertionError(f"instance_norm_reference differs from InstanceNorm by {worst}")
    torch.cuda.empty_cache()
    log(f"[api] phase wall {time.monotonic() - t_phase:.1f} s")
    return counts, shapes


def phase_cli(dev):
    """The command line, ``runet_tpu_torch.cli.main`` called in-process at
    full width: ``phantom`` (CLI_CASES cases at the KiTS geometry), the
    committed coarse and fine_kits weights written with their configs by
    ``save_params_npz``, ``predict`` (the pipelined cascade, two workers),
    ``evaluate --surface``, ``serve --once --mesh-classes 1`` on a watch
    folder of one case, ``warmup --shape``, ``mesh``, ``train --config
    fine_kits`` (128³, batch 2) for 2 steps and ``--resume`` to 4,
    ``export --average 2`` of that run and ``predict --fine`` from that npz
    on one case. Counts set to 0 before the phase; each command's launches
    are the difference around it. Every written labelmap must equal
    in-process ``predict_case`` (``predict_volume`` for the fine-only
    command) voxel for voxel, ``evaluate``'s rows ``evaluate_prediction`` of
    those labels, the served report's volumetry ``volumetry`` of its labels;
    rows 1 and 2 must launch in each serving command, rows 1, 3 and 4 in
    training, no attic kernel anywhere, and the native tier must have run.
    Returns the launch counts and shapes."""
    from runet_tpu_torch import cli
    from runet_tpu_torch.config import Config, get_config
    from runet_tpu_torch.eval.evaluate import evaluate_prediction, json_sanitize
    from runet_tpu_torch.eval.surface import volumetry
    from runet_tpu_torch.infer.cascade import ModelBundle, predict_case, predict_volume
    from runet_tpu_torch.io.nifti import load_volume
    from runet_tpu_torch.kernels import fused_block, strided_conv
    from runet_tpu_torch.models.unet3d import UNet3D
    from runet_tpu_torch.params import ARTIFACT_DIR, load_model, load_npz, load_state
    from runet_tpu_torch.train.checkpoint import CheckpointManager
    from runet_tpu_torch.utils import native
    from runet_tpu_torch.utils.export import checkpoint_params, load_params_npz, save_params_npz

    root = WORK / "cli"
    data, preds, watch, served = root / "data", root / "preds", root / "watch", root / "served"
    run_dir, avg = root / "run", root / "avg.npz"
    npz = {}
    t0 = time.monotonic()
    for name in ("coarse", "fine_kits"):
        npz[name] = str(save_params_npz(root / f"{name}.npz",
                                        load_npz(ARTIFACT_DIR / f"bench_params_{name}.npz"),
                                        get_config(name).to_json()))
    log(f"[cli] set-up (coarse and fine_kits npz with their configs) "
        f"{time.monotonic() - t0:.1f} s")
    stages = ["--coarse", npz["coarse"], "--fine", npz["fine_kits"]]
    times, per = {}, {}

    def run(tag, *argv):
        before, io0 = kernel_counts(), dict(io)
        t0 = time.monotonic()
        rc = cli.main([str(a) for a in argv])
        torch.cuda.synchronize()
        times[tag] = time.monotonic() - t0
        per[tag] = {k: v - before[k] for k, v in kernel_counts().items()}
        log(f"[cli] {tag}: rc {rc}, {times[tag]:.3f} s (NIfTI read {io['read'] - io0['read']:.3f}"
            f" s, write {io['write'] - io0['write']:.3f} s), launches "
            f"{ {k: v for k, v in per[tag].items() if v} }")
        return rc

    reset_counts()
    native.reset_call_counts()
    torch.cuda.synchronize()
    with launch_shapes() as shapes, nifti_seconds() as io:
        t_phase = time.monotonic()
        run("phantom", "phantom", "--out", data, "--cases", CLI_CASES,
            "--shape", *CASE_SHAPE, "--spacing", *CASE_SPACING)
        run("predict", "predict", "--data", data, *stages, "--out", preds, "--workers", 2)
        run("evaluate", "evaluate", "--data", data, *stages, "--surface",
            "--out", root / "eval.json")
        watch.mkdir()
        shutil.copy(data / "case_00000" / "imaging.nii.gz", watch / "case_00000.nii.gz")
        serve_rc = run("serve", "serve", "--watch", watch, "--out", served, *stages,
                       "--once", "--mesh-classes", 1)
        run("warmup", "warmup", *stages, "--shape", *CASE_SHAPE)
        run("mesh", "mesh", "--labels", preds / "case_00000.nii.gz", "--out", root / "meshes")
        run("train", "train", "--config", "fine_kits", "--data", data, "--out", run_dir,
            "--steps", CLI_TRAIN_STEPS[0])
        run("train_resume", "train", "--config", "fine_kits", "--data", data,
            "--out", run_dir, "--steps", CLI_TRAIN_STEPS[1], "--resume")
        run("export", "export", "--run", run_dir, "--out", avg, "--average", 2)
        run("predict_export", "predict", "--data", data / "case_00000" / "imaging.nii.gz",
            "--fine", avg, "--out", root / "preds_export")
        wall = time.monotonic() - t_phase
    counts = kernel_counts()
    log(f"[cli] phase wall {wall:.3f} s: "
        + ", ".join(f"{tag} {sec:.3f}" for tag, sec in times.items())
        + f"; NIfTI read {io['read']:.3f} s, write {io['write']:.3f} s (summed over threads)")
    # Where a train call's time went: its metrics lines' wall_s count from
    # the logger's start, after the dataset was loaded and preprocessed.
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        log(f"[cli] train metrics: {line}")
    native_calls("cli", "paste_crumbs_3d")

    # In-process references on the same volumes and weights.
    cm, ccfg = load_model("coarse", device=dev)
    fm, fcfg = load_model("fine_kits", device=dev)
    coarse, fine = ModelBundle.from_model(cm, ccfg), ModelBundle.from_model(fm, fcfg)
    rows = {r["case_id"]: r for r in json.loads((root / "eval.json").read_text())["cases"]}
    for i in range(CLI_CASES):
        cid = f"case_{i:05d}"
        vol = load_volume(data / cid / "imaging.nii.gz")
        want = predict_case(coarse, fine, vol.data, vol.spacing, fcfg.cascade, device=dev)
        written = [preds / f"{cid}.nii.gz"] + ([served / f"{cid}.nii.gz"] if i == 0 else [])
        for path in written:
            got = load_volume(path)
            if got.data.shape != want.shape or not np.array_equal(got.data, want):
                raise AssertionError(f"cli: {path.relative_to(root)} differs from in-process "
                                     f"predict_case on {int((got.data != want).sum())} voxels")
        gt = np.asarray(load_volume(data / cid / "segmentation.nii.gz").data)
        row = evaluate_prediction(want, gt, 3, spacing=vol.spacing, surface=True)
        row["case_id"] = cid
        if rows[cid] != json.loads(json.dumps(json_sanitize(row))):
            raise AssertionError(f"cli: evaluate's row {rows[cid]} != evaluate_prediction {row}")
        log(f"[cli] {cid}: labels equal in-process predict_case; evaluate row equal "
            f"(dice_fg_mean {row['dice_fg_mean']:.4f}, hd95_c1 {row['hd95_c1']:.3f} mm)")
    report = json.loads((served / "case_00000.json").read_text())
    labels = load_volume(served / "case_00000.nii.gz")
    vols = volumetry(labels.data, labels.spacing, 3)
    if serve_rc != 0 or {k: report[k] for k in vols} != vols or not (
            served / "case_00000_c1.stl").exists():
        raise AssertionError(f"cli: serve returned {serve_rc}, report {report}, "
                             f"volumetry {vols}")
    log(f"[cli] serve report {report}")

    # The export averaged the run's two retained f32 checkpoints, and its
    # npz serves: the fine-only predict equals in-process predict_volume.
    ckpt = CheckpointManager(run_dir / "ckpt")
    steps = ckpt.best_steps(2)
    got, cfg_json = load_params_npz(avg)
    a, b = (checkpoint_params(ckpt, s) for s in steps)
    if len(steps) != 2 or any(not np.array_equal(got[k], ((a[k] + b[k]) / 2).astype(np.float32))
                              for k in a):
        raise AssertionError(f"cli: export --average 2 is not the mean of steps {steps}")
    ecfg = Config.from_json(cfg_json)
    em = load_state(UNet3D(ecfg.model, device=dev), got).eval()
    vol = load_volume(data / "case_00000" / "imaging.nii.gz")
    want = predict_volume(ModelBundle.from_model(em, ecfg), vol.data, vol.spacing, device=dev)
    got_labels = load_volume(root / "preds_export" / "imaging.nii.gz").data
    if not np.array_equal(got_labels, want):
        raise AssertionError(f"cli: predict from the exported npz differs from in-process "
                             f"predict_volume on {int((got_labels != want).sum())} voxels")
    log(f"[cli] export --average 2 is the mean of checkpoints {steps}; predict from it equals "
        f"in-process predict_volume ({want.shape}, classes {np.unique(want).tolist()})")

    log(f"[cli] kernel launches in this phase: {counts}")
    no_attic(counts, "cli")
    for tag in ("predict", "evaluate", "serve", "warmup", "predict_export"):
        for name in (fused_block.SOURCE, strided_conv.SOURCE):
            if per[tag][name] <= 0:
                raise AssertionError(f"cli {tag}: kernel {name} was not launched")
    trained = {k: per["train"][k] + per["train_resume"][k] for k in counts}
    n = CLI_TRAIN_STEPS[1]
    if trained[fused_block.SOURCE] < 27 * n or trained[fused_block.DW_SOURCE] != 14 * n or (
            trained[strided_conv.DW_SOURCE] != 4 * n):
        raise AssertionError(f"cli train: launches {trained} for {n} steps")
    return counts, shapes


RENAL_GATE = {"kidney_composite": 0.93, "tumor": 0.80, "dice_c3": 0.40, "dice_c4": 0.05}
OWN_KERNEL = {"v2m": "conv3x3_stats", "v2": "conv3x3_stats_v2", "v1": "conv3x3_stats_v1"}


def _renal_bundles(version: str, dev):
    """(coarse bundle, renal_anatomy bundle, its config, the fine module)
    with every stride-1 conv of both models on ``fused_kernel=version``."""
    from runet_tpu_torch.config import get_config
    from runet_tpu_torch.infer.cascade import ModelBundle
    from runet_tpu_torch.params import load_model

    out = []
    for preset in ("coarse", "renal_anatomy"):
        cfg = get_config(preset)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, fused_kernel=version))
        model, cfg = load_model(cfg, device=dev)
        out.append((ModelBundle.from_model(model, cfg), cfg, model))
    return out[0][0], out[1][0], out[1][1], out[1][2]


def phase_serve_renal(dev):
    """The renal_anatomy cascade under each ``fused_kernel`` value and with
    TTA, an ensemble, ``roi_batch=2`` and warm-up; returns (launch counts
    summed over the values' runs, the launch shapes, {value: fine module})."""
    from runet_tpu_torch.data.phantom import make_phantom
    from runet_tpu_torch.eval.evaluate import evaluate_prediction
    from runet_tpu_torch.infer import cascade as cascade_mod
    from runet_tpu_torch.infer.cascade import predict_case
    from runet_tpu_torch.infer.ensemble import ensemble_bundle
    from runet_tpu_torch.infer.warmup import warmup_cases
    from runet_tpu_torch.utils import native

    q_img, q_seg = make_phantom(QUALITY_SHAPE, CASE_SPACING, num_classes=5, seed=13,
                                vessel_radius=2.5)
    k_img, k_seg = make_phantom(CASE_SHAPE, CASE_SPACING, num_classes=5, seed=3)
    # For roi_batch: a case whose two kidney ROIs share a bucket. With the
    # preset's roi_bucket of 32 the kidneys of these phantoms land in
    # different buckets (and the 5-class case above gives one merged ROI);
    # at a bucket of 64 both of this case's ROIs take a (192, 192, 256) grid.
    b_img, _ = make_phantom(CASE_SHAPE, CASE_SPACING, num_classes=3, seed=0)
    total, all_shapes, labels, models = {}, {}, {}, {}

    def timed_case(coarse, fine, cascade, img):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        pred = predict_case(coarse, fine, img, CASE_SPACING, cascade, device=dev)
        torch.cuda.synchronize()
        return pred, time.monotonic() - t0

    def gate(tag, pred):
        if pred.shape != q_seg.shape or pred.dtype != np.uint8 or pred.max() > 4:
            raise AssertionError(f"{tag}: bad output {pred.shape} {pred.dtype} max {pred.max()}")
        m = evaluate_prediction(pred, q_seg, 5)
        shown = {k: round(m[k], 4) for k in RENAL_GATE}
        if not all(m[k] > lo for k, lo in RENAL_GATE.items()):
            raise AssertionError(f"{tag}: renal_anatomy Dice gate failed: {shown}")
        return shown

    def agree(tag, a, b, bound):
        frac = float((a == b).mean())
        log(f"[serve-renal] {tag}: labels agree on {frac:.6f} of voxels (gate >= {bound})")
        if frac < bound:
            raise AssertionError(f"{tag}: label agreement {frac} < {bound}")

    for version in ("v2m", "v2", "v1"):
        coarse, fine, fcfg, fmodel = _renal_bundles(version, dev)
        models[version] = fmodel
        cas = fcfg.cascade
        reset_counts()
        native.reset_call_counts()
        torch.cuda.synchronize()
        with launch_shapes() as shapes:
            warm = warmup_cases(coarse, fine, [(q_img, CASE_SPACING)], cas, device=dev)
            pred, sec = timed_case(coarse, fine, cas, q_img)
            k_pred, k_sec = timed_case(coarse, fine, cas, k_img)
            extras = {}
            if version == "v2":
                tta = [dataclasses.replace(b, infer=dataclasses.replace(b.infer, tta=True))
                       for b in (coarse, fine)]
                extras["tta (8 flips)"] = timed_case(*tta, cas, q_img)
                extras["ensemble of 2"] = timed_case(coarse, ensemble_bundle([fine, fine]), cas,
                                                     q_img)
                batched = []
                real = cascade_mod._roi_program_batch
                cascade_mod._roi_program_batch = \
                    lambda *a, **k: (batched.append(int(a[2].shape[0])), real(*a, **k))[1]
                try:
                    extras["roi_batch=2"] = timed_case(
                        coarse, fine, dataclasses.replace(cas, roi_batch=2), q_img)
                    n_quality = len(batched)
                    cas64 = dataclasses.replace(cas, roi_bucket=64)
                    b1_pred, b1_sec = timed_case(coarse, fine, cas64, b_img)
                    b2_pred, b2_sec = timed_case(
                        coarse, fine, dataclasses.replace(cas64, roi_batch=2), b_img)
                finally:
                    cascade_mod._roi_program_batch = real
        counts = kernel_counts()
        native_calls(f"serve-renal {version}", "paste_nibbles_3d")
        labels[version] = pred
        log(f"[serve-renal] fused_kernel={version}: warmup_cases {warm}; quality phantom "
            f"{QUALITY_SHAPE} {sec:.3f} s, Dice {gate(version, pred)}")
        km = evaluate_prediction(k_pred, k_seg, 5)
        log(f"[serve-renal] fused_kernel={version}: KiTS-scale 5-class case {CASE_SHAPE} "
            f"{k_sec:.3f} s, kidney_composite {km['kidney_composite']:.4f} "
            f"tumor {km['tumor']:.4f}")
        log(f"[serve-renal] fused_kernel={version}: kernel launches {counts}")
        for v, name in OWN_KERNEL.items():
            if (counts[name] > 0) != (v == version):
                raise AssertionError(
                    f"fused_kernel={version}: {name} launched {counts[name]} times")
        if counts["conv3x3_s2_stats"] <= 0:
            raise AssertionError(f"fused_kernel={version}: the stride-2 kernel did not launch")
        no_attic(counts, f"serve-renal {version}")
        for tag, (p, s) in extras.items():
            log(f"[serve-renal] v2 with {tag}: {s:.3f} s, Dice {gate(tag, p)}")
        if extras:
            log(f"[serve-renal] roi_batch=2 ran {n_quality} batched forward(s) on the quality "
                f"phantom and {len(batched) - n_quality} on the KiTS-scale case at roi_bucket=64 "
                f"({b2_sec:.3f} s against {b1_sec:.3f} s unbatched), batch sizes {batched}")
            if len(batched) == n_quality:
                raise AssertionError("roi_batch=2: the same-bucket case ran no batched forward")
            agree("roi_batch=2 vs roi_batch=1, KiTS-scale case at roi_bucket=64", b2_pred,
                  b1_pred, 0.999)
            agree("ensemble of the model with itself vs the single model",
                  extras["ensemble of 2"][0], pred, 0.999)
            agree("roi_batch=2 vs roi_batch=1", extras["roi_batch=2"][0], pred, 0.999)
            agree("TTA vs no TTA (no gate on flips; printed for the record)",
                  extras["tta (8 flips)"][0], pred, 0.0)
        add_counts(total, counts)
        add_counts(all_shapes, shapes)
    agree("fused_kernel v2 vs v2m", labels["v2"], labels["v2m"], 0.995)
    agree("fused_kernel v1 vs v2m", labels["v1"], labels["v2m"], 0.995)
    return total, all_shapes, models


def phase_reference(fm, dev, label="fine U-Net"):
    """A U-Net on the card vs the same weights on the CPU plain path."""
    fm_cpu = copy.deepcopy(fm).to("cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 64, 64, 64, 1), generator=g)
    with torch.inference_mode():
        got = fm(x.to(dev)).float().cpu()
        want = fm_cpu(x).float()
    err = (got - want).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"[reference] {label} 64³ card vs CPU: max |Δlogit| {err:.4f}, "
        f"argmax agreement {agree:.5f}")
    if not (math.isfinite(err) and agree >= 0.995):
        raise AssertionError(f"{label}: card forward disagrees with the CPU reference")


def phase_train(dev):
    """Drive ``train`` at the full fine_kits width from a KiTS19-layout
    directory, then resume; returns (launch counts, the shapes of its
    launches, the prepared cases)."""
    from runet_tpu_torch.config import get_config
    from runet_tpu_torch.data.dataset import prepare_dataset
    from runet_tpu_torch.data.phantom import write_phantom_dataset
    from runet_tpu_torch.train.checkpoint import CheckpointManager
    from runet_tpu_torch.train.loop import train

    cfg = get_config("fine_kits")
    t0 = time.monotonic()
    write_phantom_dataset(WORK / "data", num_cases=2, shape=TRAIN_CASE_SHAPE,
                          spacing=TRAIN_SPACING)
    log(f"[train] set-up (2 phantom cases {TRAIN_CASE_SHAPE} written) "
        f"{time.monotonic() - t0:.1f} s")

    reset_counts()
    torch.cuda.synchronize()
    with launch_shapes() as shapes:
        t0 = time.monotonic()
        train(cfg, data_root=WORK / "data", out_dir=WORK / "run", max_steps=TRAIN_STEPS,
              log_every=1, device=dev)
        t1 = time.monotonic()
        ckpt = CheckpointManager(WORK / "run" / "ckpt")
        if ckpt.latest_step() != TRAIN_STEPS:
            raise AssertionError(f"no checkpoint at step {TRAIN_STEPS}: {ckpt.all_steps()}")
        state, aux = train(cfg, data_root=WORK / "data", out_dir=WORK / "run",
                           max_steps=RESUME_STEPS, resume=True, log_every=1, device=dev)
        torch.cuda.synchronize()
        t2 = time.monotonic()
    counts = kernel_counts()

    lines = [json.loads(l) for l in (WORK / "run" / "metrics.jsonl").read_text().splitlines()]
    losses = [(l["step"], l["loss"], l["imgs_per_s"]) for l in lines if "loss" in l]
    for step, loss, ips in losses:
        log(f"[train] step {step}: loss {loss} imgs/s {ips:.3f} (first steps include warm-up)")
    if [s for s, _, _ in losses] != list(range(1, RESUME_STEPS + 1)) or not all(
            loss is not None and math.isfinite(loss) for _, loss, _ in losses):
        raise AssertionError(f"missing or non-finite losses: {losses}")
    if state.step != RESUME_STEPS or ckpt.latest_step() != RESUME_STEPS:
        raise AssertionError(f"resume ended at step {state.step}, checkpoints {ckpt.all_steps()}")
    vals = [l for l in lines if "val_full_dice" in l]
    log(f"[train] {TRAIN_STEPS} steps + validation + checkpoint in {t1 - t0:.1f} s; resume to "
        f"step {RESUME_STEPS} in {t2 - t1:.1f} s; full-volume val Dice {vals}")
    log(f"[train] kernel launches in this phase: {counts}")
    no_attic(counts, "train")
    # 14 stride-1 convs (13 with dx: enc0's first conv has no input
    # gradient) and 4 stride-2 convs per step; validation adds forwards only.
    n = RESUME_STEPS
    need = {"conv3x3_stats": 27 * n, "conv3x3_s2_stats": 4 * n}
    exact = {"conv3x3_dw": 14 * n, "conv3x3_s2_dw": 4 * n}
    for name, lo in need.items():
        if counts[name] < lo:
            raise AssertionError(f"{name}: {counts[name]} launches < forward + dx {lo}")
    for name, want in exact.items():
        if counts[name] != want:
            raise AssertionError(f"{name}: {counts[name]} launches, expected {want}")
    log(f"[train] distinct launch shapes (kernel, x, Cout): {len(shapes)}")
    return counts, shapes, prepare_dataset(WORK / "data", cfg.preprocess, device=dev)


def phase_train_renal(dev):
    """``train`` at the full renal_anatomy width with deep supervision,
    elastic warps and two micro-steps per call, under each ``fused_kernel``
    value, then
    with ``remat`` and with the transposed-conv upsample; returns (launch
    counts summed over the runs, the launch shapes)."""
    from runet_tpu_torch.config import get_config
    from runet_tpu_torch.data.phantom import write_phantom_dataset
    from runet_tpu_torch.train.checkpoint import CheckpointManager
    from runet_tpu_torch.train.loop import train

    base = get_config("renal_anatomy")
    t0 = time.monotonic()
    write_phantom_dataset(WORK / "data5", num_cases=2, shape=TRAIN_CASE_SHAPE,
                          spacing=TRAIN_SPACING, num_classes=5)
    log(f"[train-renal] set-up (2 five-class phantom cases {TRAIN_CASE_SHAPE} written) "
        f"{time.monotonic() - t0:.1f} s")
    # Per step: 14 stride-1 forwards + 13 dx (enc0's first conv has no input
    # gradient), 14 stride-1 and 4 stride-2 weight gradients, 4 stride-2
    # forwards. remat runs every block's forward a second time in the
    # backward: + 14 stride-1 and + 4 stride-2 forwards.
    runs = [
        ("v2m", dict(), 4, {"conv3x3_stats": 27, "conv3x3_dw": 14}),
        ("v2", dict(fused_kernel="v2"), 4,
         {"conv3x3_stats_v2": 27, "conv3x3_dw": 14}),
        ("v1", dict(fused_kernel="v1"), 4, {"conv3x3_stats_v1": 27}),
        ("remat", dict(remat=True), 4,
         {"conv3x3_stats": 41, "conv3x3_dw": 14, "conv3x3_s2_stats": 8}),
        ("convtranspose", dict(upsample_mode="convtranspose"), 4,
         {"conv3x3_stats": 27, "conv3x3_dw": 14}),
    ]
    total, all_shapes, peaks = {}, {}, {}
    for tag, model_kw, steps, per_step in runs:
        cfg = dataclasses.replace(
            base,
            model=dataclasses.replace(base.model, deep_supervision=True, **model_kw),
            # No validation (its forwards would blur the per-step counts);
            # one checkpoint, at the last step.
            train=dataclasses.replace(base.train, elastic=True, steps_per_dispatch=2,
                                      val_every=0, val_full_every=0, ckpt_every=steps))
        out = WORK / f"run_{tag}"
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with launch_shapes() as shapes:
            t0 = time.monotonic()
            state, aux = train(cfg, data_root=WORK / "data5", out_dir=out, max_steps=steps,
                               log_every=2, device=dev)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        counts = kernel_counts()
        peaks[tag] = torch.cuda.max_memory_allocated() / 2**30
        lines = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
        logged = [l for l in lines if "loss" in l]
        for l in logged:
            log(f"[train-renal] {tag} step {l['step']}: loss {l['loss']} ds_aux_loss "
                f"{l.get('ds_aux_loss')} imgs/s {l['imgs_per_s']:.3f} (chunk means; the first "
                f"chunk includes warm-up)")
        if [l["step"] for l in logged] != list(range(2, steps + 1, 2)) or not all(
                math.isfinite(l["loss"]) and math.isfinite(l.get("ds_aux_loss", math.nan))
                for l in logged):
            raise AssertionError(f"{tag}: missing or non-finite loss / ds_aux_loss: {logged}")
        if state.step != steps or CheckpointManager(out / "ckpt").latest_step() != steps:
            raise AssertionError(f"{tag}: ended at step {state.step} without its checkpoint")
        want = {"conv3x3_stats": 0, "conv3x3_stats_v2": 0, "conv3x3_stats_v1": 0,
                "conv3x3_dw": 0, "conv3x3_s2_stats": 4, "conv3x3_s2_dw": 4,
                **{k: 0 for k in ATTIC}, **per_step}
        want = {k: v * steps for k, v in want.items()}
        log(f"[train-renal] {tag}: {steps} steps in {wall:.1f} s, peak device memory "
            f"{peaks[tag]:.2f} GiB; kernel launches expected {want} found {counts}")
        if counts != want:
            raise AssertionError(f"{tag}: launches {counts}, expected {want}")
        add_counts(total, counts)
        add_counts(all_shapes, shapes)
        del state, aux
        torch.cuda.empty_cache()
    log(f"[train-renal] peak device memory GiB: {({k: round(v, 2) for k, v in peaks.items()})} "
        f"(remat against v2m, the same net and kernel without it)")
    return total, all_shapes


def phase_overfit(dev, cases):
    """The full-width model on one fixed batch, constant lr, no
    augmentation: the loss must fall; prints step time, imgs/s, peak
    memory and one step's kernel launches."""
    from runet_tpu_torch.config import get_config
    from runet_tpu_torch.data.sampler import sample_batch
    from runet_tpu_torch.models.unet3d import create_train_model, init_params
    from runet_tpu_torch.train.state import create_train_state, make_train_step

    cfg = get_config("fine_kits")
    tcfg = dataclasses.replace(cfg.train, lr=OVERFIT_LR, lr_schedule="const", warmup_steps=0,
                               weight_decay=0.0)
    model = init_params(create_train_model(cfg.model, dev), torch.Generator().manual_seed(1))
    state = create_train_state(model, tcfg)
    step = make_train_step(model)
    images, labels = sample_batch(np.random.default_rng(0), cases, cfg.train.batch_size,
                                  cfg.train.patch_size, fg_prob=1.0)
    images, labels = torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, one_step = [], [], None
    for i in range(OVERFIT_STEPS):
        if i == 5:
            reset_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        aux = step(state, images, labels)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        if i == 5:
            one_step = kernel_counts()
        losses.append(float(aux["loss"]))
    peak = torch.cuda.max_memory_allocated()
    warm = times[3:]
    med = statistics.median(warm)
    log(f"[overfit] losses {[round(v, 4) for v in losses]}")
    log(f"[overfit] train step (fine_kits full width, 128³, batch {cfg.train.batch_size}): "
        f"median {med * 1e3:.1f} ms over {len(warm)} warm synchronized steps "
        f"(min {min(warm) * 1e3:.1f}, max {max(warm) * 1e3:.1f}); "
        f"{cfg.train.batch_size / med:.2f} imgs/s; "
        f"peak device memory {peak / 2**30:.2f} GiB")
    log(f"[overfit] kernel launches of one step: {one_step}")
    want = {"conv3x3_stats": 27, "conv3x3_s2_stats": 4, "conv3x3_dw": 14, "conv3x3_s2_dw": 4,
            "conv3x3_stats_v2": 0, "conv3x3_stats_v1": 0, **{k: 0 for k in ATTIC}}
    if one_step != want:
        raise AssertionError(f"one step launched {one_step}, expected {want}")
    ratio = losses[-1] / losses[0]
    log(f"[overfit] last/first loss {ratio:.4f} (gate < {OVERFIT_FRACTION})")
    if not (all(math.isfinite(v) for v in losses) and ratio < OVERFIT_FRACTION):
        raise AssertionError(f"overfit gate failed: {losses}")
    return {"step_ms_median": med * 1e3, "imgs_per_s": cfg.train.batch_size / med,
            "peak_gib": peak / 2**30}


# ---- parallel: data parallelism, spatial partitioning, serving lanes --------

PARALLEL_STEPS = 2
SPATIAL_SHAPE = (256, 128, 128)
SPATIAL_HALO = 32
SPATIAL_AGREE = 0.99
DP_COSINE = 0.999
DP_NORM_REL = 1e-4
DP_NORM_EXACT_REL = 1e-6
DP_TIMED_STEPS = 3


def _dp_sgd_config():
    """fine_kits with SGD at a constant rate, no warm-up and no weight decay:
    one step moves each weight by a fixed multiple of its clipped gradient,
    so updated-minus-initial compares the gradients (Adam's first step is
    about lr·sign(g) and would turn a tiny gradient's rounding into a whole
    step)."""
    from runet_tpu_torch.config import get_config

    cfg = get_config("fine_kits")
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, optimizer="sgd", lr=1e-2, lr_schedule="const", warmup_steps=0,
        weight_decay=0.0))


def _spatial_config():
    """fine_kits with its norms bound to the ``space`` mesh axis."""
    from runet_tpu_torch.config import get_config
    from runet_tpu_torch.parallel.comm import SPACE_AXIS

    cfg = get_config("fine_kits")
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, spatial_axis=SPACE_AXIS))


def _keep_grads(optimizer, kept: dict, names) -> None:
    """Wrap ``optimizer.step`` (this instance only) so that its next call
    first keeps f32 host copies of the gradients it is given: after the
    step's ``reduce_grads`` (the data-parallel mean), before the clip.
    The wrapper removes itself after that call."""
    inner = optimizer.step

    def step(params, grads, norm=None):
        kept.update((n, g.detach().float().to("cpu", copy=True)) for n, g in zip(names, grads))
        del optimizer.step
        return inner(params, grads, norm)

    optimizer.step = step


def _rank_device_check():
    from runet_tpu_torch.parallel import comm

    dev = comm.device()
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise AssertionError(f"a parallel rank found no CUDA device (device {dev})")
    return dev


def _timed_steps(step, state, images, labels, *rest) -> float:
    """ms per step over DP_TIMED_STEPS synchronized steps (warm)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(DP_TIMED_STEPS):
        step(state, images, labels, *rest)
    torch.cuda.synchronize()
    return (time.monotonic() - t0) * 1e3 / DP_TIMED_STEPS


def _rank_train_world1(rank, world, data_root, out_dir, batch):
    """World 1 over NCCL: ``train(mesh=make_mesh(1))`` at full fine_kits
    width, then DP_TIMED_STEPS timed data-parallel steps on ``batch``."""
    import torch.distributed as dist

    from runet_tpu_torch.config import get_config
    from runet_tpu_torch.parallel import comm
    from runet_tpu_torch.parallel.dp import make_dp_train_step
    from runet_tpu_torch.train.loop import train

    dev = _rank_device_check()
    cfg = get_config("fine_kits")
    mesh = comm.make_mesh(world)
    reset_counts()
    with launch_shapes() as shapes:
        t0 = time.monotonic()
        state, aux = train(cfg, data_root=data_root, out_dir=out_dir, max_steps=PARALLEL_STEPS,
                           mesh=mesh, log_every=1)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    counts = kernel_counts()
    params = {k: v.detach().to("cpu", copy=True) for k, v in state.model.state_dict().items()}
    step = make_dp_train_step(state.model, mesh, augment=True, elastic=cfg.train.elastic)
    images, labels = comm.shard_batch(mesh, batch)
    gens = (torch.Generator(), torch.Generator(device=dev))
    ms = _timed_steps(step, state, images, labels, gens, 5)
    return {"backend": dist.get_backend(), "device": str(dev), "wall": wall, "counts": counts,
            "shapes": dict(shapes), "aux": {k: float(v) for k, v in aux.items()},
            "params": params, "step_ms": ms}


def _rank_dp_spatial(rank, world, batch, seed, volume):
    """Two ranks on one card over gloo: one augmented data-parallel step of
    fine_kits (SGD) on this rank's half of ``batch``, DP_TIMED_STEPS timed
    steps, then the spatially partitioned fine_kits forward of ``volume``
    (halo SPATIAL_HALO); counts and launch shapes of both."""
    import hashlib

    import torch.distributed as dist

    from runet_tpu_torch.models.unet3d import create_train_model, init_params
    from runet_tpu_torch.params import load_model
    from runet_tpu_torch.parallel import comm
    from runet_tpu_torch.parallel.dp import make_dp_train_step
    from runet_tpu_torch.parallel.spatial import spatial_shard_predict
    from runet_tpu_torch.train.state import create_train_state

    dev = _rank_device_check()
    mesh = comm.make_mesh(world)
    cfg = _dp_sgd_config()
    model = init_params(create_train_model(cfg.model, dev),
                        torch.Generator().manual_seed(cfg.train.seed))
    state = create_train_state(model, cfg.train)
    step = make_dp_train_step(model, mesh, augment=True, elastic=cfg.train.elastic)
    images, labels = comm.shard_batch(mesh, batch)
    gens = (torch.Generator(), torch.Generator(device=dev))
    grads: dict = {}
    _keep_grads(state.optimizer, grads, [n for n, _ in model.named_parameters()])
    reset_counts()
    with launch_shapes() as dp_shapes:
        aux = step(state, images, labels, gens, seed)
        torch.cuda.synchronize()
    dp_counts = kernel_counts()
    params = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    digest = hashlib.sha256(b"".join(p.numpy().tobytes() for p in params.values())).hexdigest()
    ms = _timed_steps(step, state, images, labels, gens, seed + 1)
    del model, state, step, images, labels
    torch.cuda.empty_cache()

    sp_cfg = _spatial_config()
    space = comm.make_mesh(world, (sp_cfg.model.spatial_axis,))
    fm, _ = load_model(sp_cfg, device=dev)
    comm.reset_staged_calls()
    reset_counts()
    with launch_shapes() as sp_shapes, torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        pred = spatial_shard_predict(lambda _p, x: fm(x), None, volume, space, SPATIAL_HALO,
                                     divisor=2 ** (sp_cfg.model.num_levels - 1))
        torch.cuda.synchronize()
        sp_wall = time.monotonic() - t0
    return {"backend": dist.get_backend(), "device": str(dev),
            "dp": {"aux": {k: float(v) for k, v in aux.items()}, "counts": dp_counts,
                   "shapes": dict(dp_shapes), "digest": digest, "step_ms": ms,
                   "grads": grads},
            "spatial": {"labels": pred.cpu().numpy(), "counts": kernel_counts(),
                        "shapes": dict(sp_shapes), "staged": comm.staged_calls(),
                        "wall": sp_wall}}


def _cosines(got: dict, want: dict) -> dict:
    """Per-tensor cosine of ``got`` and ``want``, in f64."""
    out = {}
    for k in want:
        a, b = got[k].double().flatten(), want[k].double().flatten()
        out[k] = float(torch.dot(a, b) / (a.norm() * b.norm()))
    return out


def _spatial_reference(model, volume: torch.Tensor, n: int, halo: int,
                       neighbours: bool = True) -> np.ndarray:
    """One-process reference of ``spatial_shard_predict``'s arithmetic: the
    n X blocks of ``volume`` ((X, Y, Z, C) on the card, X a multiple of n
    times the model's divisor), each extended by its neighbours' ``halo``
    slabs (zeros at the two global edges; zeros at every face with
    ``neighbours=False``), run as n batch-1 forwards on n threads. Where
    the model's norms are bound to an axis, the threads meet at each norm
    and average its moments by hand (the f32 sum over the blocks, then / n,
    as the ranks' all-reduce); a model without ``spatial_axis`` keeps each
    block's own. Returns the (X, Y, Z) uint8 labels."""
    from concurrent.futures import ThreadPoolExecutor
    from unittest import mock

    from runet_tpu_torch.parallel import comm

    X = volume.shape[0]
    block = X // n
    zeros = volume.new_zeros((halo, *volume.shape[1:]))

    def face(lo, hi):
        return volume[lo:hi] if neighbours and lo >= 0 and hi <= X else zeros

    blocks = [torch.cat([face(i * block - halo, i * block), volume[i * block:(i + 1) * block],
                         face((i + 1) * block, (i + 1) * block + halo)]) for i in range(n)]
    meet = threading.Barrier(n, timeout=300)
    slots: list = [None] * n
    me = threading.local()

    def axis_mean(tensors, axis_name):
        # One CUDA stream serves both threads; the barriers order the reads.
        slots[me.i] = torch.stack([t.float() for t in tensors])
        meet.wait()
        total = slots[0].clone()
        for other in slots[1:]:
            total += other
        meet.wait()
        return (total / n).unbind(0)

    def run(i):
        me.i = i
        with torch.inference_mode():
            logits = model(blocks[i][None])[0][halo:-halo]
            return torch.argmax(logits.float(), dim=-1).to(torch.uint8)

    with mock.patch.object(comm, "axis_mean", axis_mean), ThreadPoolExecutor(n) as pool:
        return torch.cat(list(pool.map(run, range(n)))).cpu().numpy()


def _dw64(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The stride-1 3x3x3 weight gradient of (B, D, C, H, W) ``x`` and
    ``g`` summed over the batch in f64, as (Cout, Cin, 3, 3, 3)."""
    xs, gs = (t.permute(0, 2, 1, 3, 4).double() for t in (x, g))
    return torch.nn.grad.conv3d_weight(xs, (gs.shape[1], xs.shape[1], 3, 3, 3), gs, padding=1)


def _enc0_dw_check(b2: dict, b1, dw_b2: torch.Tensor, dw_b1: torch.Tensor) -> dict:
    """Where the first conv's weight gradient parts between one process's
    batch-2 step and its two batch-1 steps: ``b2`` and ``b1`` hold the (x,
    g) its weight-gradient kernel was given in each; ``dw_b2`` is the
    batch-2 gradient and ``dw_b1`` the mean of the two batch-1 ones
    (3, 3, 3, Cin, Cout). The f64 sums say whether g already differs, and
    how much the sum cancels."""
    def cos(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return float(torch.dot(a, b) / (a.norm() * b.norm()))

    x1, g1 = (torch.cat([e[k] for e in b1]) for k in ("x", "g"))
    r2 = _dw64(b2["x"], b2["g"])
    r1 = sum(_dw64(e["x"], e["g"]) for e in b1) / 2
    terms = _dw64(x1.abs(), g1.abs()) / 2
    as_f64 = (4, 3, 0, 1, 2)  # (kd, kh, kw, Cin, Cout) -> (Cout, Cin, kd, kh, kw)
    return {"x_equal": torch.equal(b2["x"], x1), "g_off": int((b2["g"] * 2 != g1).sum()),
            "g_n": g1.numel(), "cos_f64": cos(r2, r1), "cancel": float(r1.norm() / terms.norm()),
            "cos_b2": cos(dw_b2.to(r2.device).permute(as_f64), r2),
            "cos_b1": cos(dw_b1.to(r1.device).permute(as_f64), r1)}


def phase_parallel(dev, cases):
    """Data parallelism at world sizes 1 (NCCL) and 2 (gloo, one card),
    spatial-partition inference over 2 ranks and the per-device serving
    lanes, each against its one-process reference; returns the launch
    counts and launch shapes of the parallel path (every rank's and the
    lanes')."""
    from concurrent.futures import ThreadPoolExecutor
    from unittest import mock

    from runet_tpu_torch.config import get_config
    from runet_tpu_torch.data.phantom import make_phantom
    from runet_tpu_torch.data.sampler import sample_batch
    from runet_tpu_torch.infer.cascade import (
        ModelBundle,
        device_lanes,
        predict_case,
        predict_cases,
    )
    from runet_tpu_torch.infer.warmup import warmup_cases
    from runet_tpu_torch.kernels import fused_block, strided_conv
    from runet_tpu_torch.models.unet3d import create_train_model, init_params
    from runet_tpu_torch.params import load_model
    from runet_tpu_torch.parallel.launch import spawn
    from runet_tpu_torch.preprocess.normalize import normalize
    from runet_tpu_torch.train.loop import train
    from runet_tpu_torch.train.state import create_train_state, global_norm, make_train_step
    from runet_tpu_torch.utils import native

    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    total, shapes = {}, {}

    def gather(counts, launch):
        add_counts(total, counts)
        for k, v in launch.items():
            shapes[k] = shapes.get(k, 0) + v

    # The lanes' KiTS-scale phantoms are made on the host while the ranks run.
    pool = ThreadPoolExecutor(max_workers=1)
    phantoms = pool.submit(lambda: [make_phantom(CASE_SHAPE, CASE_SPACING, num_classes=3,
                                                 seed=s)[0] for s in range(3)])

    cfg = get_config("fine_kits")
    batch = sample_batch(np.random.default_rng(3), cases, cfg.train.batch_size,
                         cfg.train.patch_size, fg_prob=1.0)

    # -- world 1, NCCL: train(mesh=make_mesh(1)) against two one-device runs.
    refs = []
    for i in range(2):
        state, aux = train(cfg, data_root=WORK / "data", out_dir=WORK / f"par_single{i}",
                           max_steps=PARALLEL_STEPS, log_every=1, device=dev)
        sd = state.model.state_dict()
        refs.append(({k: v.detach().to("cpu", copy=True) for k, v in sd.items()},
                     {k: float(v) for k, v in aux.items()}))
    del state
    t0 = time.monotonic()
    (w1,) = spawn(_rank_train_world1, 1, backend="nccl", device="cuda:0",
                  args=(str(WORK / "data"), str(WORK / "par_dp1"), batch))
    w1_wall = time.monotonic() - t0
    if w1["backend"] != "nccl":
        raise AssertionError(f"world 1 ran on {w1['backend']}, not NCCL")
    gather(w1["counts"], w1["shapes"])
    (p0, a0), (p1, a1) = refs
    single_equal = all(torch.equal(p0[k], p1[k]) for k in p0) and a0 == a1
    spread = max((p0[k].float() - p1[k].float()).abs().max().item() for k in p0)
    diff = max((w1["params"][k].float() - p0[k].float()).abs().max().item() for k in p0)
    aux_diff = max(abs(w1["aux"][k] - a0[k]) for k in a0)
    aux_spread = max(abs(a1[k] - a0[k]) for k in a0)
    log(f"[parallel] DP world 1 (nccl, {w1['device']}): train(mesh=make_mesh(1)) fine_kits 128³ "
        f"batch {cfg.train.batch_size}, {PARALLEL_STEPS} steps in {w1['wall']:.1f} s "
        f"({w1_wall:.1f} s with the process start); aux {w1['aux']}")
    log(f"[parallel] DP world 1 vs one-device train: max |Δparam| {diff:.3g}, max |Δaux| "
        f"{aux_diff:.3g}; two one-device runs equal: {single_equal} (spread: param "
        f"{spread:.3g}, aux {aux_spread:.3g})")
    if single_equal:
        if not (all(torch.equal(w1["params"][k], p0[k]) for k in p0) and w1["aux"] == a0):
            raise AssertionError("DP world 1 differs from the one-device run, which repeats "
                                 "bit for bit")
    elif diff > spread or aux_diff > aux_spread:
        raise AssertionError(f"DP world 1 differs from the one-device run by {diff} (aux "
                             f"{aux_diff}), beyond the spread of two one-device runs")
    log(f"[parallel] DP step at world 1 (nccl, batch {cfg.train.batch_size} per rank): "
        f"{w1['step_ms']:.1f} ms (mean of {DP_TIMED_STEPS} warm synchronized steps)")

    # -- world 2, gloo on the one card: a DP step and the spatial forward.
    # One-process references from the same initial weights, each keeping
    # the gradients its optimizer step is given: the batch-2 step, and the
    # two batch-1 steps (each sample's draws at its global index), whose
    # f32 mean is the DP step's arithmetic done in one process.
    scfg = _dp_sgd_config()
    names = [n for n, _ in create_train_model(scfg.model, "meta").named_parameters()]

    dw_kernel = fused_block.conv3x3_dw

    def one_process_step(lo, hi):
        model = init_params(create_train_model(scfg.model, dev),
                            torch.Generator().manual_seed(scfg.train.seed))
        state = create_train_state(model, scfg.train)
        grads: dict = {}
        _keep_grads(state.optimizer, grads, names)
        images, labels = (torch.from_numpy(a[lo:hi]).to(dev) for a in batch)
        enc0: dict = {}

        def dw_keeping(x, g):
            if x.shape[2] == 1:  # enc0's first conv, the only one with Cin 1
                enc0.update(x=x.detach().clone(), g=g.detach().clone())
            return dw_kernel(x, g)

        with mock.patch.object(fused_block, "conv3x3_dw", dw_keeping):
            aux = make_train_step(model, augment=True, elastic=scfg.train.elastic)(
                state, images, labels, (torch.Generator(), torch.Generator(device=dev)), 17, lo)
        return grads, float(aux["grad_norm"]), enc0

    ref, ref_norm, enc0_b2 = one_process_step(0, 2)
    halves, _, enc0_b1 = zip(*(one_process_step(i, i + 1) for i in range(2)))
    # The all-reduce's sum of the two ranks' f32 gradients, then / 2.
    mean_halves = {k: (halves[0][k] + halves[1][k]) / 2 for k in names}
    halves_norm = float(global_norm([mean_halves[k].to(dev) for k in names]))
    # Where one process's batch-2 step leaves its batch-1 steps: the forward
    # logits of the two samples at batch 2 against batch 1 each, and the
    # gradients in backward order (head first).
    model = init_params(create_train_model(scfg.model, dev),
                        torch.Generator().manual_seed(scfg.train.seed))
    with torch.no_grad():
        x = torch.from_numpy(batch[0]).to(dev).float()
        l2 = model(x)
        l1 = torch.cat([model(x[i:i + 1]) for i in range(2)])
    fwd_diff, fwd_n = int((l2 != l1).sum()), l2.numel()
    del model, x, l1, l2
    diverged = [k for k in reversed(names) if not torch.equal(ref[k], mean_halves[k])]
    # The conv kernels' gradients leave the weight-gradient kernels rounded
    # to the compute dtype: batch 2 rounds the two samples' sum, batch 1 + 1
    # each sample's. How far the two samples cancel says how much that
    # rounding weighs in their mean.
    rounded = [k for k in names if all(torch.equal(g[k], g[k].bfloat16().float())
                                       for g in (*halves, ref))]
    cancel = {k: float((halves[0][k] + halves[1][k]).norm()
                       / (halves[0][k].norm() + halves[1][k].norm())) for k in names}
    enc0 = _enc0_dw_check(enc0_b2, enc0_b1, ref[names[0]], mean_halves[names[0]])
    del enc0_b2, enc0_b1
    torch.cuda.empty_cache()

    pp = _spatial_config().preprocess
    img, _ = make_phantom(SPATIAL_SHAPE, CASE_SPACING, num_classes=3, seed=21)
    volume = normalize(torch.from_numpy(img.astype(np.float32)), pp.hu_window,
                       pp.hu_stats)[..., None].numpy()
    t0 = time.monotonic()
    ranks = spawn(_rank_dp_spatial, 2, backend="gloo", device=["cuda:0", "cuda:0"],
                  args=(batch, 17, volume))
    w2_wall = time.monotonic() - t0
    for r, res in enumerate(ranks):
        if res["backend"] != "gloo":
            raise AssertionError(f"rank {r} ran on {res['backend']}")
        gather(res["dp"]["counts"], res["dp"]["shapes"])
        gather(res["spatial"]["counts"], res["spatial"]["shapes"])
        log(f"[parallel] rank {r} ({res['device']}) launches: DP step {res['dp']['counts']}; "
            f"spatial {res['spatial']['counts']}")
        for name in (fused_block.SOURCE, fused_block.DW_SOURCE, strided_conv.DW_SOURCE):
            if res["dp"]["counts"][name] <= 0:
                raise AssertionError(f"rank {r}: {name} was not launched in the DP step")
        for name in (fused_block.SOURCE, strided_conv.SOURCE):
            if res["spatial"]["counts"][name] <= 0:
                raise AssertionError(f"rank {r}: {name} was not launched in the spatial forward")
    if ranks[0]["dp"]["digest"] != ranks[1]["dp"]["digest"]:
        raise AssertionError("the two DP ranks hold different parameters after the step")
    dp = ranks[0]["dp"]["grads"]
    if not all(torch.equal(dp[k], ranks[1]["dp"]["grads"][k]) for k in names):
        raise AssertionError("the two DP ranks updated with different reduced gradients")
    off = {k: float((dp[k] - mean_halves[k]).abs().max() / mean_halves[k].abs().max())
           for k in names if not torch.equal(dp[k], mean_halves[k])}
    cos = _cosines(dp, ref)
    whole = _cosines({"all": torch.cat([dp[k].flatten() for k in names])},
                     {"all": torch.cat([ref[k].flatten() for k in names])})["all"]
    dp_norm = ranks[0]["dp"]["aux"]["grad_norm"]
    rel = abs(dp_norm - ref_norm) / ref_norm
    rel_halves = abs(dp_norm - halves_norm) / halves_norm
    low = sorted(cos, key=cos.get)[:4]
    log(f"[parallel] DP world 2 (gloo, 2 ranks on cuda:0, batch 1 + 1, augmented, SGD): "
        f"reduced gradients bit-equal to the f32 mean of the one-process batch-1 steps' in "
        f"{len(names) - len(off)} of {len(names)} tensors"
        + (f" (largest |Δ| / max|g| {max(off.values()):.3g} at {max(off, key=off.get)})"
           if off else "")
        + f", grad_norm {dp_norm:.7g} vs {halves_norm:.7g} (rel {rel_halves:.2e})")
    log(f"[parallel] DP world 2 vs the one-process batch-2 step: gradient cosine, whole "
        f"{whole:.8f}, per tensor lowest " + ", ".join(f"{k} {cos[k]:.6f}" for k in low)
        + f" ({sum(c < DP_COSINE for c in cos.values())} of {len(names)} below {DP_COSINE}); "
        f"grad_norm {dp_norm:.7g} vs {ref_norm:.7g} (rel {rel:.2e}); "
        f"{w2_wall:.1f} s for the two ranks' DP and spatial work with their process starts")
    log(f"[parallel] one process, batch 2 against batch 1 + 1 (same weights, draws and "
        f"samples): forward logits differ in {fwd_diff} of {fwd_n} elements; gradients "
        f"bit-equal to the batch-1 steps' mean in {len(names) - len(diverged)} of "
        f"{len(names)} tensors, the first to differ in backward order "
        f"{diverged[0] if diverged else None}; bf16-exact in all three steps: "
        f"{len(rounded)} tensors ({', '.join(k for k in rounded if k in low) or 'none'} of "
        f"the lowest four); |g0 + g1| / (|g0| + |g1|) of the batch-1 gradients at the "
        f"lowest four " + ", ".join(f"{cancel[k]:.4f}" for k in low)
        + f" (median over all {statistics.median(cancel.values()):.4f})")
    log(f"[parallel] one process, {names[0]}'s weight gradient at batch 2 against batch "
        f"1 + 1: its input x equal {enc0['x_equal']}; its output gradient g (doubled at "
        f"batch 2, whose loss is the mean over 2 samples) differs in {enc0['g_off']} of "
        f"{enc0['g_n']} bf16 elements; the f64 sums over each step's own x and g reach a "
        f"cosine of {enc0['cos_f64']:.6f}; |sum| / sum of |terms| {enc0['cancel']:.3g}; "
        f"the kernel's dw against its f64 sum, cosine {enc0['cos_b2']:.6f} (batch 2) and "
        f"{enc0['cos_b1']:.6f} (batch 1 + 1)")
    # The DP step is held to its own arithmetic done in one process (the
    # mean of the batch-1 steps, bit for bit) and to the batch-2 step as a
    # whole. Per tensor, one process's batch-2 step already differs from
    # its batch-1 steps' mean (printed above), so it is not a gate.
    if off or rel_halves > DP_NORM_EXACT_REL or whole < DP_COSINE or rel > DP_NORM_REL:
        raise AssertionError(f"DP world 2 disagrees: {len(off)} tensors off the batch-1 "
                             f"steps' mean {off}, grad_norm rel {rel_halves} to it; whole "
                             f"cosine to the batch-2 step {whole}, grad_norm rel {rel}")
    log(f"[parallel] DP step at world 2 (gloo, one card, batch 1 per rank): "
        f"{ranks[0]['dp']['step_ms']:.1f} / {ranks[1]['dp']['step_ms']:.1f} ms (ranks 0 / 1, "
        f"mean of {DP_TIMED_STEPS} warm synchronized steps)")

    fm, fcfg = load_model("fine_kits", device=dev)
    sm, _ = load_model(_spatial_config(), device=dev)
    vol = torch.from_numpy(volume).to(dev)
    with torch.inference_mode():
        dense = torch.argmax(fm(vol[None]).float(), dim=-1)[0]
    dense = dense.to(torch.uint8).cpu().numpy()
    # The ranks against a one-process reference of their arithmetic, and
    # two controls with a fault the path exists to avoid, each against the
    # dense forward: norms not averaged over the blocks (spatial_axis=None),
    # and zero halos at the interior faces.
    reference = _spatial_reference(sm, vol, 2, SPATIAL_HALO)
    controls = {"spatial_axis=None": _spatial_reference(fm, vol, 2, SPATIAL_HALO),
                "zero halos": _spatial_reference(sm, vol, 2, SPATIAL_HALO, neighbours=False)}
    ref_agree = float((reference == dense).mean())
    seen = {k: int((v != reference).sum()) for k, v in controls.items()}
    log(f"[parallel] spatial one-process reference (2 X blocks, neighbour halos, moments "
        f"averaged by hand) agrees with the dense forward on {ref_agree:.5f} of voxels; "
        f"controls against the dense forward: " + ", ".join(
            f"{k} {float((v == dense).mean()):.5f}" for k, v in controls.items())
        + "; voxels where each control leaves the reference: " + ", ".join(
            f"{k} {n}" for k, n in seen.items()))
    if not all(seen.values()):
        raise AssertionError(f"a spatial control equals the reference, which then cannot "
                             f"tell its fault: {seen}")
    del sm, vol
    for r, res in enumerate(ranks):
        labels = res["spatial"]["labels"]
        if labels.shape != SPATIAL_SHAPE or labels.dtype != np.uint8:
            raise AssertionError(f"rank {r}: spatial labels {labels.shape} {labels.dtype}")
        agree = float((labels == dense).mean())
        off_ref = int((labels != reference).sum())
        log(f"[parallel] spatial rank {r}: fine_kits on {SPATIAL_SHAPE} over 2 ranks (halo "
            f"{SPATIAL_HALO}) in {res['spatial']['wall']:.3f} s, labels agree with the dense "
            f"forward on {agree:.5f} of voxels and differ from the one-process reference on "
            f"{off_ref}; staged-halo calls (gloo, pinned host) {res['spatial']['staged']}")
        if off_ref or agree < SPATIAL_AGREE or res["spatial"]["staged"] <= 0:
            raise AssertionError(f"rank {r}: {off_ref} voxels off the one-process reference, "
                                 f"spatial agreement {agree} < {SPATIAL_AGREE} or no staged "
                                 f"call")
    del fm

    # -- serving lanes: predict_cases(devices=[cuda:0, cuda:0]).
    cm, ccfg = load_model("coarse", device=dev)
    fm, fcfg = load_model("fine_kits", device=dev)
    coarse, fine = ModelBundle.from_model(cm, ccfg), ModelBundle.from_model(fm, fcfg)
    imgs = phantoms.result()
    pool.shutdown()
    serial = [predict_case(coarse, fine, img, CASE_SPACING, fcfg.cascade, device=dev)
              for img in imgs]
    lanes = ["cuda:0", "cuda:0"]
    reset_counts()
    native.reset_call_counts()
    with launch_shapes() as lane_shapes:
        warm = warmup_cases(coarse, fine, [(imgs[0], CASE_SPACING)], fcfg.cascade, devices=lanes)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        preds = list(predict_cases(coarse, fine, [(img, CASE_SPACING) for img in imgs],
                                   fcfg.cascade, devices=lanes))
        lane_wall = time.monotonic() - t0
    lane_counts = kernel_counts()
    native_calls("parallel", "paste_crumbs_3d")
    gather(lane_counts, lane_shapes)
    for i, (a, b) in enumerate(zip(serial, preds)):
        if not np.array_equal(a, b):
            raise AssertionError(f"lanes: case {i} differs from serial predict_case on "
                                 f"{int((a != b).sum())} voxels")
    for name in (fused_block.SOURCE, strided_conv.SOURCE):
        if lane_counts[name] <= 0:
            raise AssertionError(f"lanes: {name} was not launched")
    log(f"[parallel] lanes {lanes}: warmup_cases {warm}; predict_cases 3 cases "
        f"{CASE_SHAPE} in {lane_wall:.3f} s = {lane_wall / 3:.3f} s/case, equal to serial "
        f"predict_case voxel for voxel; launches {lane_counts}")

    # A lane on another device than its bundles': the bundles loaded on the
    # CPU, one lane on the card, so bundle_on_device copies their modules.
    cpu = [load_model(name, device="cpu")[0] for name in ("coarse", "fine_kits")]
    cpu_coarse, cpu_fine = ModelBundle.from_model(cpu[0], ccfg), ModelBundle.from_model(cpu[1], fcfg)
    ((lane_dev, lane_coarse, lane_fine),) = device_lanes(cpu_coarse, cpu_fine, ["cuda:0"])
    held = {t.device for b in (lane_coarse, lane_fine)
            for t in (*b.params.parameters(), *b.params.buffers())}
    left = {t.device for m in cpu for t in (*m.parameters(), *m.buffers())}
    copied = list(predict_cases(cpu_coarse, cpu_fine, [(imgs[0], CASE_SPACING)],
                                fcfg.cascade, devices=["cuda:0"]))[0]
    log(f"[parallel] lane cuda:0 from bundles on the CPU: the lane's modules on {held}, "
        f"the bundles' left on {left}; labels equal to serial predict_case: "
        f"{np.array_equal(copied, serial[0])}")
    if (held != {torch.device("cuda", 0)} or left != {torch.device("cpu")}
            or lane_dev != torch.device("cuda", 0) or not np.array_equal(copied, serial[0])):
        raise AssertionError("lanes: the copy of CPU bundles onto cuda:0 failed")
    del cpu, cpu_coarse, cpu_fine, lane_coarse, lane_fine

    log(f"[parallel] kernel launches of the path (ranks and lanes): {total}")
    no_attic(total, "parallel")
    log(f"[parallel] phase wall {time.monotonic() - t_phase:.1f} s")
    return total, shapes


def grad_agreement(names, got, want) -> dict:
    """Two gradients (lists of tensors in ``names`` order) compared in f64:
    per-tensor cosines, the whole gradient's cosine, the relative difference
    of the global norms, and whether they pass the gradient reference's
    gates (every cosine >= GRAD_COSINE, norms within GRAD_NORM_REL)."""
    a = [t.detach().double().flatten() for t in got]
    b = [t.detach().double().flatten() for t in want]
    cos = {n: float(torch.nn.functional.cosine_similarity(u, v, dim=0))
           for n, u, v in zip(names, a, b, strict=True)}
    fa, fb = torch.cat(a), torch.cat(b)
    rel = abs(float(fa.norm()) - float(fb.norm())) / float(fb.norm())
    return {"cos": cos, "whole": float(torch.nn.functional.cosine_similarity(fa, fb, dim=0)),
            "norm_rel": rel, "ok": min(cos.values()) >= GRAD_COSINE and rel <= GRAD_NORM_REL}


def phase_grad_reference(dev, model_cfg=None, label="fine_kits", floors=True):
    """A train model on the card vs its deep copy on the CPU (bf16 plain
    path); with ``cfg.deep_supervision`` through the deep-supervised loss.
    ``floors``: for scale, the CPU path against itself summed in another
    order (the floor of any two correct bf16 paths), and against the same
    weights in f32."""
    from runet_tpu_torch.config import get_config
    from runet_tpu_torch.models.unet3d import create_train_model, init_params
    from runet_tpu_torch.train.losses import deep_supervised_loss, dice_ce_loss

    mcfg = model_cfg if model_cfg is not None else get_config("fine_kits").model
    model = init_params(create_train_model(mcfg, dev), torch.Generator().manual_seed(2))
    cpu = copy.deepcopy(model).to("cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, 32, 64, 64, 1), generator=g)
    labels = torch.randint(0, mcfg.num_classes, (1, 32, 64, 64), generator=g)
    names = [n for n, _ in model.named_parameters()]

    def grads(m, d):
        if mcfg.deep_supervision:
            loss, _ = deep_supervised_loss(*m(x.to(d), deep_outputs=True), labels.to(d))
        else:
            loss, _ = dice_ce_loss(m(x.to(d)), labels.to(d))
        return [t.float().cpu() for t in torch.autograd.grad(loss, list(m.parameters()))]

    cpu_dev = torch.device("cpu")
    card, ref = grads(model, dev), grads(cpu, cpu_dev)

    def summary(r):
        kernels = min(c for n, c in r["cos"].items() if n.endswith("kernel"))
        return (f"lowest cosine {min(r['cos'].values()):.4f}, over kernels {kernels:.4f}, "
                f"whole gradient {r['whole']:.5f}, norms {r['norm_rel']:.5f} apart")

    got = grad_agreement(names, card, ref)
    worst = [(n, round(c, 4)) for n, c in sorted(got["cos"].items(), key=lambda kv: kv[1])[:3]]
    log(f"[grad-reference] {label} (1, 32, 64, 64) card vs CPU (both bf16): {summary(got)}; "
        f"lowest three {worst}")
    if floors:
        with torch.backends.mkldnn.flags(enabled=False):  # torch's own conv loops
            reordered = grads(cpu, cpu_dev)
        cpu32 = create_train_model(dataclasses.replace(mcfg, compute_dtype="float32"), "cpu")
        cpu32.load_state_dict(cpu.state_dict())
        f32 = grads(cpu32, cpu_dev)
        log(f"[grad-reference] floor, CPU bf16 vs the same with oneDNN off (another summation "
            f"order): {summary(grad_agreement(names, reordered, ref))}")
        log(f"[grad-reference] CPU bf16 vs CPU f32: {summary(grad_agreement(names, ref, f32))}")
    if not got["ok"]:
        raise AssertionError(f"{label}: card gradients disagree with the CPU reference")


def _check_y(y, yr) -> float:
    """One bf16 ulp, or 1e-3 of the largest magnitude near zero; returns the
    largest error."""
    y, yr = y.float(), yr.float()
    if y.shape != yr.shape:
        raise AssertionError(f"shape {tuple(y.shape)} != {tuple(yr.shape)}")
    err = (y - yr).abs()
    bad = int((err > 2.0 ** -7 * yr.abs() + 1e-3 * yr.abs().max()).sum())
    if bad:
        raise AssertionError(f"{bad} outputs off (largest error {err.max().item()})")
    return err.max().item()


def _check(got, want):
    """(y, mean, sq-mean) against the plain version's: y by ``_check_y``,
    sq-means to 1e-3 relative, means to 1e-3 of the channel rms."""
    m, q = (t.float() for t in got[1:])
    mr, qr = (t.float() for t in want[1:])
    max_err = _check_y(got[0], want[0])
    rel_q = ((q - qr).abs() / qr.abs().clamp_min(1e-12)).max().item()
    rel_m = ((m - mr).abs() / qr.clamp_min(1e-12).sqrt()).max().item()
    if rel_q > 1e-3 or rel_m > 1e-3:
        raise AssertionError(f"sq-mean rel {rel_q}, mean rel {rel_m}")
    return max_err, max(rel_q, rel_m)


def _bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _stats_case(mod, x_shape, cout, gen, dev, version="v2m"):
    """One conv+moment kernel against its plain version on random inputs;
    returns the case's errors and times. ``version`` picks among the
    stride-1 kernels; "v1" takes x (B, D, H, C, W)."""
    from runet_tpu_torch.kernels import strided_conv
    from runet_tpu_torch.kernels.conv_common import pack_weight

    stride2 = mod is strided_conv
    dhcw = version == "v1"
    if stride2:
        wrap, plain = mod.conv_s2_stats_dchw_batch, mod.conv3x3_s2_stats_plain
    elif dhcw:
        wrap, plain = mod.conv_in_stats_dhcw_batch, mod.conv3x3_stats_dhcw_plain
    elif version == "v2":
        wrap = lambda x, k, p: mod.conv_in_stats_dchw_batch(x, k, p, "v2")  # noqa: E731
        plain = mod.conv3x3_stats_v2_plain
    else:
        wrap, plain = mod.conv_in_stats_dchw_batch, mod.conv3x3_stats_plain
    if dhcw:
        B, D, H, C, W = x_shape
    else:
        B, D, C, H, W = x_shape
    x = torch.randn(x_shape, generator=gen, device=dev).to(torch.bfloat16)
    k = (torch.randn((3, 3, 3, C, cout), generator=gen, device=dev) / math.sqrt(27 * C)
         ).to(torch.bfloat16)
    packed = pack_weight(k)
    extra = {}
    with torch.no_grad():
        max_err, rel = _check(wrap(x, k, packed), plain(x, k))
        ms = cuda_ms(lambda: wrap(x, k, packed), reps=10)
        extra["element_ms"] = _element_loads_case(mod, x, k, packed,
                                                  "s2" if stride2 else version)
        plain_ms = cuda_ms(lambda: plain(x, k), reps=3)
        # Library yardstick: cuDNN bf16 conv in its own NCDHW layout + sums
        # (for the v1 kernel, from and back to the layout the kernel takes).
        xc = x.permute(0, 2, 1, 3, 4).contiguous()
        wc = k.permute(4, 3, 0, 1, 2).contiguous()

        def lib():
            if stride2:
                y = F.conv3d(F.pad(xc, (0, 1, 0, 1, 0, 1)), wc, stride=2)
            elif dhcw:
                y = F.conv3d(x.permute(0, 3, 1, 2, 4).contiguous(), wc, padding=1)
            else:
                y = F.conv3d(xc, wc, padding=1)
            yf = y.float()
            if dhcw:
                y = y.permute(0, 2, 3, 1, 4).contiguous()
            return y, yf.sum((2, 3, 4)), (yf * yf).sum((2, 3, 4))

        library_ms = cuda_ms(lib, reps=10)
    s = 2 if stride2 else 1
    n_out = B * (D // s) * (H // s) * (W // s)
    flops = 2.0 * 27 * C * cout * n_out
    nbytes = 2.0 * B * D * C * H * W + 2.0 * 27 * C * cout + 2.0 * n_out * cout + 8.0 * B * cout
    return {"max_abs_err": max_err, "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "flops": flops, **_bound(flops, nbytes), **extra}


def _at_odd_offset(t):
    """A contiguous copy of t that starts one element past a 16-byte
    boundary, so a kernel cannot take 16-byte loads from it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    if not view.is_contiguous() or view.data_ptr() % 16 == 0:
        raise AssertionError("the odd-offset copy is not contiguous and unaligned")
    return view


def _own_sums(mod, version):
    """(x, k, packed) -> the kernel's own (y, sums, sqs) of ``version``:
    "v2m", "v2" or "v1" of ``fused_block``, or "s2", the stride-2 kernel."""
    if version == "s2":
        return mod._conv3x3_s2_sums
    return lambda x, k, packed: mod._conv3x3_sums(x, k, packed, version)


def _element_loads_case(mod, x, k, packed, version) -> float:
    """The element-load instance of the conv + moments kernel of
    ``version`` ("v2m", "v2", "v1" or "s2"): x at an odd offset must give
    the aligned run's y, sums and sqs bit for bit (where W % 8 != 0 both
    runs take element loads). Returns its time."""
    sums = _own_sums(mod, version)
    xo = _at_odd_offset(x)
    want = sums(x, k, packed)
    got = sums(xo, k, packed)
    for name, u, v in zip(("y", "sums", "sqs"), got, want):
        if not torch.equal(u, v):
            raise AssertionError(f"{version} at x {tuple(x.shape)}: {name} at an odd offset "
                                 f"differs from the aligned run")
    return cuda_ms(lambda: sums(xo, k, packed), reps=10)


def _dw_case(mod, x_shape, cout, gen, dev):
    """One weight-gradient kernel against its plain version on random
    inputs; ``rel_err`` is |dw − plain| over the same sum of |x|·|g|."""
    from runet_tpu_torch.kernels import strided_conv

    stride2 = mod is strided_conv
    wrap = mod.conv3x3_s2_dw if stride2 else mod.conv3x3_dw
    plain = mod.conv3x3_s2_dw_plain if stride2 else mod.conv3x3_dw_plain
    s = 2 if stride2 else 1
    B, D, C, H, W = x_shape
    g_shape = (B, D // s, cout, H // s, W // s)
    x = torch.randn(x_shape, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(g_shape, generator=gen, device=dev).to(torch.bfloat16)
    got, want = wrap(x, g), plain(x, g)
    bound = plain(x.abs(), g.abs())
    rel = float(((got - want).abs() / bound.clamp_min(1e-30)).max())
    max_err = float((got - want).abs().max())
    if not rel <= DW_TOL:
        raise AssertionError(f"|dw - plain| reaches {rel} of Σ|x||g| (> {DW_TOL})")
    extra = {"element_ms": _dw_element_loads_case(wrap, x, g, got)}
    del got, want, bound
    ms = cuda_ms(lambda: wrap(x, g), reps=10)
    plain_ms = cuda_ms(lambda: plain(x, g), reps=3)
    # Library yardstick: cuDNN's bf16 weight gradient in NCDHW.
    xc = x.permute(0, 2, 1, 3, 4).contiguous()
    gc = g.permute(0, 2, 1, 3, 4).contiguous()
    wshape = (cout, C, 3, 3, 3)

    def lib():
        if stride2:
            return torch.nn.grad.conv3d_weight(F.pad(xc, (0, 1, 0, 1, 0, 1)), wshape, gc,
                                               stride=2)
        return torch.nn.grad.conv3d_weight(xc, wshape, gc, padding=1)

    library_ms = cuda_ms(lib, reps=10)
    n_out = B * g_shape[1] * g_shape[3] * g_shape[4]
    flops = 2.0 * 27 * C * cout * n_out
    nbytes = 2.0 * B * D * C * H * W + 2.0 * n_out * cout + 4.0 * 27 * C * cout
    return {"max_abs_err": max_err, "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "flops": flops, **_bound(flops, nbytes), **extra}


def _dw_element_loads_case(wrap, x, g, aligned) -> float:
    """The element-load instances of a weight-gradient kernel (stride 1 or
    2): x, and separately g, at an odd offset must give the aligned run's dw
    bit for bit (where W % 8 != 0 all runs take element loads). Returns the
    time with x at the odd offset."""
    xo, go = _at_odd_offset(x), _at_odd_offset(g)
    for which, u, v in (("x", xo, g), ("g", x, go)):
        if not torch.equal(wrap(u, v), aligned):
            raise AssertionError(f"dw at x {tuple(x.shape)}: {which} at an odd offset differs "
                                 f"from the aligned run")
    del go
    return cuda_ms(lambda: wrap(xo, g), reps=10)


def phase_kernels(dev, path_shapes):
    """Every kernel at every distinct shape each path launched it with
    (forward, dx and weight gradient alike; the kernel bench's launches
    too), on random inputs against its plain version, timed beside the
    plain version and the library yardstick; returns {kernel: [case, ...]}."""
    from runet_tpu_torch.kernels import fused_block, strided_conv
    from runet_tpu_torch.kernels.attic import conv3d, conv_v3_deep, fused_norm

    def variant(version):
        return lambda mod, x_shape, cout, gen, dev: _stats_case(mod, x_shape, cout, gen, dev,
                                                               version)

    def ndhwc(stats):
        def case(mod, x_shape, cout, gen, dev):
            if x_shape[0] != 1:
                raise AssertionError(f"the NDHWC kernels take one volume, got {x_shape}")
            return _attic_conv_case(stats, x_shape[1:], cout, gen, dev)
        return case

    norm_pairs = {}  # x shape -> (stats case, apply case), made once per shape

    def norm(which):
        def case(mod, x_shape, c, gen, dev):
            if x_shape not in norm_pairs:
                norm_pairs[x_shape] = _attic_norm_cases(x_shape, torch.bfloat16, gen, dev)
            return norm_pairs[x_shape][which]
        return case

    run = {fused_block.SOURCE: (fused_block, _stats_case),
           fused_block.V2_SOURCE: (fused_block, variant("v2")),
           fused_block.V1_SOURCE: (fused_block, variant("v1")),
           strided_conv.SOURCE: (strided_conv, _stats_case),
           fused_block.DW_SOURCE: (fused_block, _dw_case),
           strided_conv.DW_SOURCE: (strided_conv, _dw_case),
           conv3d.SOURCE: (conv3d, ndhwc(False)),
           conv_v3_deep.SOURCE: (conv_v3_deep, ndhwc(True)),
           fused_norm.STATS_SOURCE: (fused_norm, norm(0)),
           fused_norm.APPLY_SOURCE: (fused_norm, norm(1))}
    gen = torch.Generator(device=dev).manual_seed(0)
    out, timed = {}, {}
    for path, shapes in path_shapes.items():
        for (name, x_shape, cout), n in sorted(shapes.items()):
            mod, case_fn = run[name]
            key = (name, x_shape, cout)
            # A shape that an earlier path launched too is held and timed once.
            reused = key in timed
            if not reused:
                timed[key] = case_fn(mod, x_shape, cout, gen, dev)
            case = {"path": path, "x_shape": list(x_shape), "cout": cout, "launches": n,
                    "reused": reused, **timed[key]}
            if not reused:
                lib = case["library_ms"]
                log(f"[kernels] {name} {path} x{x_shape}->{cout} x{n}: "
                    f"err {case['max_abs_err']:.3g} (rel {case['rel_err']:.2e}) "
                    f"ms {case['ms']:.4f} plain {case['plain_ms']:.4f} "
                    f"library {'-' if lib is None else f'{lib:.4f}'} "
                    f"bound {case['bound_ms']:.4f} ({case['bound_by']}) "
                    f"{case['flops'] / case['ms'] / 1e9:.1f} TFLOP/s"
                    + (f" element loads {case['element_ms']:.4f} (bits equal)"
                       if "element_ms" in case else "")
                    + (f" graph {case['graph_ms']:.4f} graph library "
                       f"{case['graph_library_ms']:.4f}" if "graph_ms" in case else ""))
            out.setdefault(name, []).append(case)
    log(f"[kernels] {len(timed)} distinct (kernel, shape) cases held against their plain "
        f"versions")
    # The stride-2 dx is no kernel of the port: torch's transposed conv
    # (cuDNN), as the JAX package leaves it to XLA. Timed for the record at
    # the largest stride-2 shape of the train path.
    _, x_shape, cout = max((k for k in path_shapes["train"] if k[0] == strided_conv.DW_SOURCE),
                           key=lambda k: math.prod(k[1]))
    B, D, C, H, W = x_shape
    g = torch.randn((B, D // 2, cout, H // 2, W // 2), generator=gen, device=dev
                    ).to(torch.bfloat16)
    k = torch.randn((3, 3, 3, C, cout), generator=gen, device=dev).to(torch.bfloat16)
    dx_ms = cuda_ms(lambda: strided_conv.conv3x3_s2_dx(g, k, (D, H, W)), reps=10)
    log(f"[kernels] stride-2 dx (torch conv_transpose3d, cuDNN bf16) at x {x_shape}->{cout}: "
        f"{dx_ms:.4f} ms")
    # Nor is the v1 conv's weight gradient: the framework's correlation, as
    # in the JAX package. Timed at the largest v1 shape of the train path,
    # permutes from the (B, D, H, C, W) layout included.
    _, x_shape, cout = max((k for k in path_shapes["train_renal"]
                            if k[0] == fused_block.V1_SOURCE), key=lambda k: math.prod(k[1]))
    x = torch.randn(x_shape, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn((*x_shape[:3], cout, x_shape[4]), generator=gen, device=dev
                    ).to(torch.bfloat16)
    v1_dw_ms = cuda_ms(lambda: fused_block.conv3x3_dw_dhcw(x, g), reps=10)
    log(f"[kernels] v1 dw (torch conv3d_weight, cuDNN bf16) at x(B,D,H,C,W) {x_shape}->{cout}: "
        f"{v1_dw_ms:.4f} ms")
    return out


# The attic phase's cases, beyond the kernel bench's shapes (which
# phase_kernels holds): (tag, shape, Cout) for the NDHWC convs, (tag, shape,
# dtype) for the instance-norm kernels; shapes with no multiple of 8 or 16
# anywhere, the deepest level's norm, and f32.
ATTIC_CONV_CASES = [("odd", (7, 13, 29, 5), 11), ("W 16", (4, 12, 16, 64), 64),
                    ("W 17", (4, 12, 17, 64), 64), ("ragged H", (5, 13, 16, 128), 96),
                    ("Cout 80", (3, 9, 33, 32), 80), ("Wide64", (4, 10, 40, 32), 64),
                    ("Cin 56", (2, 9, 48, 56), 64), ("one voxel", (1, 1, 1, 16), 32)]
ATTIC_V3_CASES = [("odd", (6, 9, 11, 24), 40), ("W 16", (4, 12, 16, 64), 64),
                  ("W 17", (4, 12, 17, 64), 64), ("ragged H", (5, 13, 16, 128), 96),
                  ("Cout 80", (3, 9, 33, 40), 80)]
# Row 1 (v2m) at one shape per tile, instance and edge, (tag, (D, C, H, W),
# Cout) at B = 1: its tile follows W and Cout_pad (8 x 32 x 64, 8 x 32 x 32,
# 16 x 16 x 32), x takes cp.async copies where W % 8 == 0.
V2M_TILE_CASES = [("Wide32", (4, 24, 13, 128), 32), ("Wide32 Cout_pad 96", (3, 40, 9, 33), 80),
                  ("Wide64", (4, 128, 12, 32), 128), ("Wide64 W 17", (4, 64, 13, 17), 64),
                  ("Narrow", (2, 256, 16, 16), 256), ("Narrow H 12", (4, 64, 12, 16), 64),
                  ("Narrow H 8", (3, 320, 8, 8), 320), ("Narrow W 12", (5, 128, 13, 12), 96),
                  ("one voxel", (1, 16, 1, 1), 32)]
# Row 5 (v2) likewise: its tile follows W (8 x 32 x 32, 16 x 16 x 32).
V2_TILE_CASES = [("Wide32", (4, 24, 13, 128), 32), ("Wide32 Cout_pad 96", (3, 40, 9, 33), 80),
                 ("Wide32 Cout 128", (4, 128, 12, 32), 128), ("Wide32 W 17", (4, 64, 13, 17), 64),
                 ("Wide32 Cin 1", (2, 1, 10, 40), 24), ("Narrow", (2, 256, 16, 16), 256),
                 ("Narrow H 12", (4, 64, 12, 16), 64), ("Narrow H 8", (3, 320, 8, 8), 320),
                 ("Narrow W 12", (5, 128, 13, 12), 80), ("one voxel", (1, 16, 1, 1), 32)]
# Row 2 (stride 2) likewise, (D, C, H, W) of the INPUT: its tile follows Wo
# and Cout_pad (4 x 32 or 8 x 16 output rows x columns, by 64 or 32
# channels), x takes cp.async copies where W % 8 == 0.
S2_TILE_CASES = [("Narrow64 Ho 5", (4, 32, 10, 32), 64), ("Wide64 Wo 18", (4, 24, 8, 36), 48),
                 ("Narrow32 Ho 9 D 2", (2, 64, 18, 16), 96),
                 ("Narrow64 Cout 320", (2, 256, 16, 16), 320),
                 ("Wide64 two column tiles", (4, 32, 16, 128), 64),
                 ("Wide32 Cin 1", (4, 1, 12, 72), 32), ("Wide32 Cout_pad 96", (2, 40, 10, 66), 96),
                 ("Narrow64 W 20", (4, 256, 12, 20), 320), ("one voxel", (2, 16, 2, 2), 32)]
ATTIC_NORM_CASES = [("deep", (1, 8, 8, 8, 320), torch.bfloat16),
                    ("odd", (1, 3, 5, 7, 20), torch.bfloat16),
                    ("odd f32", (1, 3, 5, 7, 20), torch.float32)]


def _attic_conv_case(stats: bool, shape, cout, gen, dev, timed: bool = True) -> dict:
    """The NDHWC conv (``stats``: with moments) against its plain version on
    random inputs; ``timed``: also timed beside the plain version and
    cuDNN's bf16 conv (+ sums), chained (``cuda_ms``), and with moments
    where C == Cout also in a CUDA graph (``utils/latency.py``'s
    ``scanned_ms``, the kernel bench's protocol: ``graph_ms``,
    ``graph_library_ms``), without them where C == Cout likewise. x at an
    odd offset (the element-load instance) must give the aligned run's y
    (with moments also its sums and sqs) bit for bit."""
    from runet_tpu_torch.kernels.attic import conv3d, conv_v3_deep
    from runet_tpu_torch.kernels.conv_common import pack_weight
    from runet_tpu_torch.utils.latency import scanned_ms

    D, H, W, C = shape
    n = D * H * W
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((3, 3, 3, C, cout), generator=gen, device=dev) / math.sqrt(27 * C)
         ).to(torch.bfloat16)
    packed = pack_weight(w)
    if stats:
        wrap = lambda: conv_v3_deep.conv3x3_v3(x, w, packed)  # noqa: E731
        plain = lambda: conv_v3_deep.conv3x3_v3_plain(x, w)  # noqa: E731
    else:
        wrap = lambda: conv3d.conv3x3x3_same(x, w, packed)  # noqa: E731
        plain = lambda: conv3d.conv3x3x3_same_plain(x, w)  # noqa: E731
    with torch.no_grad():
        got, want = wrap(), plain()
        if stats:
            max_err, rel = _check(((got[0]), got[1] / n, got[2] / n),
                                  (want[0], want[1] / n, want[2] / n))
            odd = conv_v3_deep.conv3x3_v3(_at_odd_offset(x), w, packed)
            for name, u, v in zip(("y", "sums", "sqs"), odd, got):
                if not torch.equal(u, v):
                    raise AssertionError(f"v3 at x {tuple(shape)}->{cout}: {name} at an odd "
                                         f"offset differs from the aligned run")
            del odd
        else:
            max_err, rel = _check_y(got, want), 0.0
            if not torch.equal(conv3d.conv3x3x3_same(_at_odd_offset(x), w, packed), got):
                raise AssertionError(f"attic conv at x {tuple(shape)}->{cout}: y at an odd "
                                     f"offset differs from the aligned run")
        del got, want
        if not timed:
            return {"max_abs_err": max_err, "rel_err": rel}
        ms = cuda_ms(wrap, reps=10)
        plain_ms = cuda_ms(plain, reps=3)
        xc = x.permute(3, 0, 1, 2)[None].contiguous()
        wc = w.permute(4, 3, 0, 1, 2).contiguous()

        def lib():
            y = F.conv3d(xc, wc, padding=1)
            if stats:
                yf = y.float()
                return y, yf.sum((2, 3, 4)), (yf * yf).sum((2, 3, 4))
            return y

        library_ms = cuda_ms(lib, reps=10)
        graph = {}
        if stats and C == cout:
            def lib_step(xx):
                y = F.conv3d(xx, wc, padding=1)
                yf = y.float()
                yf.sum((2, 3, 4)), (yf * yf).sum((2, 3, 4))
                return y

            graph = {"graph_ms": scanned_ms(lambda xx: conv_v3_deep.conv3x3_v3(xx, w, packed)[0],
                                            x),
                     "graph_library_ms": scanned_ms(lib_step, xc)}
        elif C == cout:
            graph = {"graph_ms": scanned_ms(lambda xx: conv3d.conv3x3x3_same(xx, w, packed), x),
                     "graph_library_ms": scanned_ms(lambda xx: F.conv3d(xx, wc, padding=1), xc)}
    flops = 2.0 * 27 * C * cout * n
    nbytes = 2.0 * n * C + 2.0 * 27 * C * cout + 2.0 * n * cout + (8.0 * cout if stats else 0)
    return {"max_abs_err": max_err, "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "flops": flops, **_bound(flops, nbytes), **graph}


def _attic_norm_cases(shape, dtype, gen, dev, timed: bool = True) -> tuple[dict, dict]:
    """The instance-norm stats and apply kernels, alone and as the pair
    (``fused_instance_norm_lrelu``), against their plain versions; returns
    (stats case, apply case). ``timed``: the cases also carry their times,
    the stats case its library yardstick (``torch.var_mean`` of x in f32
    per (sample, channel)), the apply case the pair's times and its library
    yardstick (``F.instance_norm`` + ``F.leaky_relu``)."""
    from runet_tpu_torch.kernels.attic import fused_norm as fn

    C = shape[-1]
    x = (1.5 + 2.0 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
    scale = 1.0 + 0.1 * torch.randn((C,), generator=gen, device=dev)
    bias = 0.1 * torch.randn((C,), generator=gen, device=dev)
    n = x[0, ..., 0].numel()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    with torch.no_grad():
        s, q = fn.instance_norm_stats(x)
        sr, qr = fn.instance_norm_stats_plain(x)
        sa, _ = fn.instance_norm_stats_plain(x.abs())
        rel_stats = max(((s - sr).abs() / sa).max().item(), ((q - qr).abs() / qr).max().item())
        stats_err = max((s - sr).abs().max().item(), (q - qr).abs().max().item())
        if not rel_stats <= NORM_SUM_TOL:
            raise AssertionError(f"instance_norm_stats {tuple(shape)}: {rel_stats} > "
                                 f"{NORM_SUM_TOL} of the sums over |x|")
        mean = sr / n
        rstd = torch.rsqrt(torch.clamp_min(qr / n - mean * mean, 0.0) + 1e-5)
        got = fn.instance_norm_lrelu_apply(x, mean, rstd, scale, bias).float()
        want = fn.instance_norm_lrelu_apply_plain(x, mean, rstd, scale, bias).float()
        apply_err = (got - want).abs()
        differ = int((got != want).sum())
        if (apply_err > ulp * want.abs()).any():
            raise AssertionError(f"instance_norm_lrelu_apply {tuple(shape)}: more than one ulp "
                                 f"off (largest error {apply_err.max().item()})")
        got = fn.fused_instance_norm_lrelu(x, scale, bias).float()
        want = fn.fused_instance_norm_lrelu_plain(x, scale, bias).float()
        pair_err = (got - want).abs()
        if (pair_err > ulp * want.abs() + 1e-5 * want.abs().max()).any():
            raise AssertionError(f"fused_instance_norm_lrelu {tuple(shape)}: off by up to "
                                 f"{pair_err.max().item()}")
        del got, want
        log(f"[attic] norm {tuple(shape)} {dtype}: stats within {rel_stats:.2e} of Σ|x|, apply "
            f"differs from its plain version in {differ} of {x.numel()} elements, pair max err "
            f"{pair_err.max().item():.3g}")
        if not timed:
            return ({"max_abs_err": stats_err, "rel_err": rel_stats},
                    {"max_abs_err": apply_err.max().item(), "rel_err": 0.0})

        xc = x.permute(0, 4, 1, 2, 3).contiguous()  # NCDHW, F.instance_norm's own layout

        def lib():
            return F.leaky_relu(F.instance_norm(xc, weight=scale, bias=bias, eps=1e-5), 1e-2)

        times = {
            "stats": cuda_ms(lambda: fn.instance_norm_stats(x), reps=10),
            "stats_plain": cuda_ms(lambda: fn.instance_norm_stats_plain(x), reps=3),
            "stats_library": cuda_ms(lambda: torch.var_mean(
                x.float(), dim=(1, 2, 3), correction=0), reps=10),
            "apply": cuda_ms(lambda: fn.instance_norm_lrelu_apply(x, mean, rstd, scale, bias),
                             reps=10),
            "apply_plain": cuda_ms(lambda: fn.instance_norm_lrelu_apply_plain(
                x, mean, rstd, scale, bias), reps=3),
            "pair": cuda_ms(lambda: fn.fused_instance_norm_lrelu(x, scale, bias), reps=10),
            "pair_plain": cuda_ms(lambda: fn.fused_instance_norm_lrelu_plain(x, scale, bias),
                                  reps=3),
            "pair_library": cuda_ms(lib, reps=10),
        }
    N, B = x.numel(), shape[0]
    nb = N * x.element_size()
    stats_case = {"max_abs_err": stats_err, "rel_err": rel_stats, "ms": times["stats"],
                  "plain_ms": times["stats_plain"], "library_ms": times["stats_library"],
                  "flops": 3.0 * N,
                  **_bound(3.0 * N, nb + 8.0 * B * C, PEAK_F32_FLOPS)}
    apply_case = {"max_abs_err": apply_err.max().item(), "rel_err": 0.0, "ms": times["apply"],
                  "plain_ms": times["apply_plain"], "library_ms": None, "flops": 6.0 * N,
                  "pair_ms": times["pair"], "pair_plain_ms": times["pair_plain"],
                  "pair_library_ms": times["pair_library"],
                  **_bound(6.0 * N, 2.0 * nb + 16.0 * B * C, PEAK_F32_FLOPS)}
    return stats_case, apply_case


def _attic_grad_check(shape, cout, gen, dev) -> tuple[float, float]:
    """The attic conv's Function: dx and dw on the card against autograd
    through ``F.conv3d`` in true f32 on the same bf16 values, with a linear
    loss whose cotangent is bf16-exact; returns the largest errors."""
    from runet_tpu_torch.kernels.attic import conv3d
    from runet_tpu_torch.kernels.conv_common import no_tf32_conv

    C = shape[-1]
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((3, 3, 3, C, cout), generator=gen, device=dev) / math.sqrt(27 * C)
         ).to(torch.bfloat16)
    r = torch.randn((*shape[:3], cout), generator=gen, device=dev).to(torch.bfloat16).float()
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    (conv3d.attic_conv3x3(xk, wk).float() * r).sum().backward()
    xr, wr = x.float().requires_grad_(), w.float().requires_grad_()
    with no_tf32_conv():
        y = F.conv3d(xr.permute(3, 0, 1, 2)[None], wr.permute(4, 3, 0, 1, 2), padding=1)
    (y[0].permute(1, 2, 3, 0) * r).sum().backward()
    return _check_y(xk.grad, xr.grad), _check_y(wk.grad, wr.grad)


def _v2m_tile_case(x_shape, cout, gen, dev, version: str = "v2m") -> dict:
    """Row 1 (``version`` "v2": row 5, "s2": row 2) against its plain
    version on random inputs, untimed; x at an odd offset (the element-load
    instance) must give the aligned run's y, sums and sqs bit for bit."""
    from runet_tpu_torch.kernels import fused_block, strided_conv
    from runet_tpu_torch.kernels.conv_common import pack_weight

    if version == "s2":
        mod, conv, plain = (strided_conv, strided_conv.conv_s2_stats_dchw_batch,
                            strided_conv.conv3x3_s2_stats_plain)
    else:
        mod = fused_block
        plain = fused_block.conv3x3_stats_v2_plain if version == "v2" \
            else fused_block.conv3x3_stats_plain

        def conv(x, k, packed):
            return fused_block.conv_in_stats_dchw_batch(x, k, packed, version)
    sums = _own_sums(mod, version)
    C = x_shape[2]
    x = torch.randn(x_shape, generator=gen, device=dev).to(torch.bfloat16)
    k = (torch.randn((3, 3, 3, C, cout), generator=gen, device=dev) / math.sqrt(27 * C)
         ).to(torch.bfloat16)
    packed = pack_weight(k)
    with torch.no_grad():
        max_err, rel = _check(conv(x, k, packed), plain(x, k))
        want = sums(x, k, packed)
        got = sums(_at_odd_offset(x), k, packed)
    for name, u, v in zip(("y", "sums", "sqs"), got, want):
        if not torch.equal(u, v):
            raise AssertionError(f"{version} at x {tuple(x_shape)}->{cout}: {name} at an odd "
                                 f"offset differs from the aligned run")
    return {"max_abs_err": max_err, "rel_err": rel}


def phase_attic(dev) -> dict:
    """The four attic kernels against their plain versions at the shapes
    the kernel bench does not launch (odd shapes, the deepest level's norm,
    f32), untimed; rows 1, 5 and 2 at one shape per tile, instance and edge
    (``V2M_TILE_CASES``, ``V2_TILE_CASES``, ``S2_TILE_CASES``), untimed; the
    attic conv's
    gradient. Returns {kernel: [case, ...]} in ``phase_kernels``' form,
    without times."""
    from runet_tpu_torch.kernels import fused_block, strided_conv
    from runet_tpu_torch.kernels.attic import conv3d, conv_v3_deep, fused_norm

    gen = torch.Generator(device=dev).manual_seed(4)
    out = {conv3d.SOURCE: [], conv_v3_deep.SOURCE: [], fused_norm.STATS_SOURCE: [],
           fused_norm.APPLY_SOURCE: []}
    t0 = time.monotonic()
    for name, stats, cases in ((conv3d.SOURCE, False, ATTIC_CONV_CASES),
                               (conv_v3_deep.SOURCE, True, ATTIC_V3_CASES)):
        for tag, shape, cout in cases:
            case = _attic_conv_case(stats, shape, cout, gen, dev, timed=False)
            out[name].append({"path": "attic", "x_shape": list(shape), "cout": cout,
                              "launches": 0, "reused": False, "tag": tag, **case})
            log(f"[attic] {name} {tag} x{shape}->{cout}: err {case['max_abs_err']:.3g} "
                f"(rel {case['rel_err']:.2e})")
    for tag, shape, dtype in ATTIC_NORM_CASES:
        cases = _attic_norm_cases(shape, dtype, gen, dev, timed=False)
        for name, case in zip((fused_norm.STATS_SOURCE, fused_norm.APPLY_SOURCE), cases):
            out[name].append({"path": "attic", "x_shape": list(shape), "cout": shape[-1],
                              "launches": 0, "reused": False, "tag": tag,
                              "dtype": str(dtype).removeprefix("torch."), **case})
    for version, source, cases in (("v2m", fused_block.SOURCE, V2M_TILE_CASES),
                                   ("v2", fused_block.V2_SOURCE, V2_TILE_CASES),
                                   ("s2", strided_conv.SOURCE, S2_TILE_CASES)):
        for tag, (D, C, H, W), cout in cases:
            case = _v2m_tile_case((1, D, C, H, W), cout, gen, dev, version)
            out.setdefault(source, []).append(
                {"path": "tiles", "x_shape": [1, D, C, H, W], "cout": cout, "launches": 0,
                 "reused": False, "tag": tag, **case})
            log(f"[tiles] {source} {tag} x{(1, D, C, H, W)}->{cout}: err "
                f"{case['max_abs_err']:.3g} (rel {case['rel_err']:.2e}), odd offset bit-equal")
    for shape, cout in (((5, 7, 9, 12), 10), ((16, 24, 40, 32), 48)):
        dx_err, dw_err = _attic_grad_check(shape, cout, gen, dev)
        log(f"[attic] attic conv Function gradient at x{shape}->{cout} vs f32 autograd "
            f"through F.conv3d: dx max err {dx_err:.3g}, dw max err {dw_err:.3g} "
            f"(gate: one bf16 ulp + 1e-3 of the largest)")
    log(f"[attic] {sum(len(v) for v in out.values())} cases in {time.monotonic() - t0:.1f} s")
    return out


# What each kernel-bench section must time, by row.
BENCH_KEYS = {"rows": {"library", "v2m", "v2", "v1", "conv3d"}, "dw": {"dw", "library"},
              "norm": {"kernel", "model", "library"}, "model_fwd": {"v2m", "v2", "v1"}}


def phase_kernel_bench(dev) -> tuple[dict, dict]:
    """``utils/kernel_bench.py`` end to end into chip_smoke_work/, its own
    path: every kernel must launch and every row must carry a finite
    positive ms for each kernel it names. Returns the path's launch counts
    and launch shapes, each counting the kernels its CUDA graphs replayed
    (``replay_counting``)."""
    from runet_tpu_torch.utils import kernel_bench, latency

    out = WORK / "kernel_bench.json"
    replayed: dict[str, int] = {}
    real_scanned = latency.scanned_ms
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with launch_shapes() as shapes:
        latency.scanned_ms = replay_counting(real_scanned, shapes, replayed)
        try:
            rc = kernel_bench.main(["--out", str(out)])
        finally:
            latency.scanned_ms = real_scanned
        torch.cuda.synchronize()
    counts = add_counts(kernel_counts(), replayed)
    if rc != 0:
        raise AssertionError(f"kernel_bench exited {rc}")
    data = json.loads(out.read_text())

    def check(row, need):
        bad = [k for k in row if k.endswith("_error")]
        for k in need:
            v = row.get(f"{k}_ms")
            if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
                bad.append(f"{k}_ms={v}")
        if bad:
            raise AssertionError(f"kernel_bench {row.get('name', '')}: {bad}")

    for row in data["rows"]:
        need = BENCH_KEYS["dw"] if row.get("kind") == "dw" else set(BENCH_KEYS["rows"])
        if row["name"] in kernel_bench.V3_ROWS:
            need = need | {"v3"}
        check(row, need)
        log(f"[kernel-bench] {row['name']}: " + ", ".join(
            f"{k} {row[f'{k}_ms']:.4f} ms ({row[f'{k}_tflops']:.1f} TFLOP/s)" for k in sorted(need)))
    check(data["norm"], BENCH_KEYS["norm"])
    for row in data["budget"]["rows"]:
        need = {"prod", "prod_bwd"} | ({"library", "library_bwd"} if "stride" in row else set())
        check(row, need)
        log(f"[kernel-bench] budget {row['name']}: " + ", ".join(
            f"{k} {row[f'{k}_ms']:.4f}" for k in sorted(need)) + " ms")
    check(data["model_fwd"], BENCH_KEYS["model_fwd"])
    n = data["norm"]
    log(f"[kernel-bench] norm {n['shape']}: kernels {n['kernel_ms']:.4f} ms "
        f"({n['kernel_gbps']:.0f} GB/s), model's plain torch {n['model_ms']:.4f}, "
        f"F.instance_norm + F.leaky_relu {n['library_ms']:.4f}")
    m = data["model_fwd"]
    log(f"[kernel-bench] model_fwd fine_kits 128³ B 1: v2m {m['v2m_ms']:.2f} ms, v2 "
        f"{m['v2_ms']:.2f}, v1 {m['v1_ms']:.2f}")
    fell_back = {r["name"]: r["protocol"] for r in data["rows"] + data["budget"]["rows"]
                 + [data["norm"]] if "protocol" in r}
    log(f"[kernel-bench] rows timed with chained_ms (not capturable): {fell_back or 'none'}")
    log(f"[kernel-bench] {time.monotonic() - t0:.1f} s; kernel launches (graph replays "
        f"included) {counts}; of them replays {replayed}; distinct launch shapes {len(shapes)}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernel_bench did not launch {missing}")
    return counts, shapes


def kernel_lines(measured, path_counts):
    """One entry per kernel for the ``kernels`` JSON line. ``ms``,
    ``plain_ms``, ``library_ms`` and ``bound_ms`` are sums over the distinct
    shapes timed (each once, whatever the number of paths that launched it;
    ``timed_ms_by_path`` splits ``ms`` by the path that first launched the
    shape); ``path_ms`` weighs each shape's time by its launches on that
    path; ``launches`` is over every path driven (the four main paths, the
    HTTP entry point, the api phase's window pass, the command line, the
    parallel path and the kernel bench, split in ``launches_by_path``; the bench's count the
    kernels its CUDA graphs replayed). ``max_abs_err`` also covers the
    attic phase's untimed cases. ``library_ms`` is null where no single
    library call computes the kernel's function (the instance-norm apply
    pass alone; the stats pass has ``torch.var_mean``); the apply kernel's
    line carries the pair's times (``pair_ms``, ``pair_plain_ms``,
    ``pair_library_ms``: ``F.instance_norm`` + ``F.leaky_relu``), and the
    lines of the four conv + moments kernels of the main paths (v2m, v2,
    v1, stride 2) and of the two weight gradients the time of their
    element-load instance over the same shapes (``element_ms``); the v2m,
    v2, stride-2 and stride-2 weight-gradient lines their main-path sums by
    shape class (``ms_by_class``), the attic conv's line, which has no
    main-path shape, its sums by kernel-bench geometry; the lines of the two
    attic NDHWC convs carry their kernel's and their library call's
    CUDA-graph times over the same shapes (``graph_ms``,
    ``graph_library_ms``)."""
    classes = {"conv3x3_stats": _v2m_classes, "conv3x3_stats_v2": _v2m_classes,
               "conv3x3_s2_stats": _s2_classes, "conv3x3_s2_dw": _s2_classes,
               "conv3x3_ndhwc": _geometry_classes}
    replaces = {
        "conv3x3_stats": "runet_tpu/kernels/fused_block.py:639",
        "conv3x3_s2_stats": "runet_tpu/kernels/strided_conv.py:80",
        "conv3x3_dw": "runet_tpu/kernels/fused_block.py:429",
        "conv3x3_s2_dw": "runet_tpu/kernels/strided_conv.py:223",
        "conv3x3_stats_v2": "runet_tpu/kernels/fused_block.py:286",
        "conv3x3_stats_v1": "runet_tpu/kernels/fused_block.py:53",
        "conv3x3_ndhwc": "runet_tpu/kernels/attic/conv3d.py:46",
        "conv3x3_ndhwc_stats": "runet_tpu/kernels/attic/conv_v3_deep.py:53",
        "instance_norm_stats": "runet_tpu/kernels/attic/fused_norm.py:30",
        "instance_norm_lrelu_apply": "runet_tpu/kernels/attic/fused_norm.py:39",
    }
    kernels = []
    for name, every in measured.items():
        checked = [c for c in every if not c["reused"]]
        cs = [c for c in checked if "ms" in c]
        total = sum(c["bound_ms"] for c in cs)
        ops = sum(c["bound_ms"] for c in cs if c["bound_by"] == "operations")
        by_path = {p: counts.get(name, 0) for p, counts in path_counts.items()}
        paths = sorted({c["path"] for c in every})
        launched = sorted({c["path"] for c in every if c["launches"]})
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"runet_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in checked),
            "max_rel_err": max(c["rel_err"] for c in checked),
            "ms": sum(c["ms"] for c in cs),
            "plain_ms": sum(c["plain_ms"] for c in cs),
            "bound_ms": total,
            "bound_by": "operations" if ops >= total / 2 else "bytes",
            "library_ms": (None if any(c["library_ms"] is None for c in cs)
                           else sum(c["library_ms"] for c in cs)),
            **{k: sum(c[k] for c in cs) for k in ("pair_ms", "pair_plain_ms", "pair_library_ms",
                                             "element_ms", "graph_ms", "graph_library_ms")
               if all(k in c for c in cs)},
            "shapes_timed": len(cs),
            "shapes_by_path": {p: sum(c["path"] == p for c in every) for p in paths},
            "timed_ms_by_path": {p: sum(c["ms"] for c in cs if c["path"] == p)
                                 for p in sorted({c["path"] for c in cs})},
            "path_ms": {p: sum(c["ms"] * c["launches"] for c in every if c["path"] == p)
                        for p in launched},
            **({"ms_by_class": classes[name](
                cs if name == "conv3x3_ndhwc" else [c for c in cs if c["path"] != "kernel_bench"])}
               if name in classes else {}),
        })
    return kernels


def _v2m_classes(cases) -> dict:
    """Row 1's (or row 5's) timed main-path shapes in the classes their
    tiles were redesigned for: deep (Cin >= 128, W < 128), narrow (W <= 16;
    on the main paths all are also deep) and the rest (neither); shapes,
    ms, cuDNN + sums ms and bound ms of each."""
    classes = {"deep": lambda C, W: C >= 128 and W < 128, "narrow": lambda C, W: W <= 16,
               "rest": lambda C, W: not (C >= 128 and W < 128) and W > 16}
    out = {}
    for tag, member in classes.items():
        cs = [c for c in cases if member(c["x_shape"][2], c["x_shape"][4])]
        out[tag] = {"shapes": len(cs), **{k: sum(c[k] for c in cs)
                                          for k in ("ms", "library_ms", "bound_ms")}}
    return out


def _geometry_classes(cases) -> dict:
    """The attic conv's timed shapes by the kernel bench's geometry (x (1, D,
    H, W, C) -> Cout; ``utils/kernel_bench.py``'s ``GEOMETRIES``); shapes,
    ms, cuDNN ms, bound ms and, where timed, the CUDA-graph ms of each."""
    from runet_tpu_torch.utils.kernel_bench import GEOMETRIES

    out = {}
    for tag, (D, H, W, C, cout, _) in GEOMETRIES.items():
        cs = [c for c in cases if c["x_shape"] == [1, D, H, W, C] and c["cout"] == cout]
        keys = ["ms", "library_ms", "bound_ms"] + [
            k for k in ("graph_ms", "graph_library_ms") if cs and all(k in c for c in cs)]
        out[tag] = {"shapes": len(cs), **{k: sum(c[k] for c in cs) for k in keys}}
    return out


def _s2_classes(cases) -> dict:
    """A stride-2 kernel's (row 2's or row 4's) timed main-path shapes by
    output width: wide (Wo > 16) and narrow (Wo <= 16: row 2's 8 x 16
    tiles, row 4's single k-step); shapes, ms, library ms (cuDNN + sums,
    or cuDNN's weight gradient) and bound ms of each."""
    out = {}
    for tag, narrow in (("wide", False), ("narrow", True)):
        cs = [c for c in cases if (c["x_shape"][4] // 2 <= 16) == narrow]
        out[tag] = {"shapes": len(cs), **{k: sum(c[k] for c in cs)
                                          for k in ("ms", "library_ms", "bound_ms")}}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from runet_tpu_torch.utils.health import card_line

    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_start = time.monotonic()

    from runet_tpu_torch.config import get_config

    phase_build()
    serve_counts, serve_shapes, fine, bundles = phase_serve(dev)
    http_counts, http_shapes = phase_serve_http(dev, *bundles)
    del bundles
    api_counts, api_shapes = phase_api(dev, fine)
    try:
        cli_counts, cli_shapes = phase_cli(dev)
    finally:
        shutil.rmtree(WORK / "cli", ignore_errors=True)
    torch.cuda.empty_cache()
    phase_reference(fine, dev)
    del fine
    renal_counts, renal_shapes, renal_models = phase_serve_renal(dev)
    for version in ("v2", "v1"):
        phase_reference(renal_models[version], dev,
                        f"renal_anatomy U-Net, fused_kernel={version},")
    del renal_models
    torch.cuda.empty_cache()
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        train_counts, train_shapes, cases = phase_train(dev)
        rtrain_counts, rtrain_shapes = phase_train_renal(dev)
        phase_grad_reference(dev)
        for version in ("v2", "v1"):
            mcfg = dataclasses.replace(get_config("renal_anatomy").model, deep_supervision=True,
                                       fused_kernel=version)
            phase_grad_reference(dev, mcfg, f"renal_anatomy, deep supervision, "
                                 f"fused_kernel={version},", floors=False)
        phase_overfit(dev, cases)
        parallel_counts, parallel_shapes = phase_parallel(dev, cases)
        del cases
        torch.cuda.empty_cache()
        bench_counts, bench_shapes = phase_kernel_bench(dev)
        measured = phase_kernels(dev, {"serve": serve_shapes, "serve_http": http_shapes,
                                       "api": api_shapes, "cli": cli_shapes,
                                       "train": train_shapes,
                                       "serve_renal": renal_shapes,
                                       "train_renal": rtrain_shapes,
                                       "parallel": parallel_shapes,
                                       "kernel_bench": bench_shapes})
        for name, cases in phase_attic(dev).items():
            measured[name] += cases
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    kernels = kernel_lines(measured, {"serve": serve_counts, "serve_http": http_counts,
                                      "api": api_counts, "cli": cli_counts,
                                      "train": train_counts,
                                      "serve_renal": renal_counts,
                                      "train_renal": rtrain_counts,
                                      "parallel": parallel_counts,
                                      "kernel_bench": bench_counts})
    if len(kernels) != 10:
        raise AssertionError(f"expected ten kernels, got {[k['name'] for k in kernels]}")
    log(f"[done] total {time.monotonic() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
