"""Chip smoke run of the PyTorch + CUDA port (``runet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and printed over):

1. report the card (name and power limit from nvidia-smi);
2. build the six CUDA kernels from ``runet_tpu_torch/kernels/csrc`` (one
   nvcc per source, started together);
3. serve: load the committed coarse and fine_kits weights and run
   ``predict_cases`` over three KiTS-scale phantoms (512x512x160 at
   0.78125x0.78125x3 mm, seeds 0-2), then ``predict_case`` on a 192x192x64
   phantom gated on Dice (kidney_composite > 0.96, tumor > 0.82). Every
   kernel's launch counter is set to 0 just before this phase and read just
   after; the forward kernels must have launched. The shape of every launch
   is recorded (``launch_shapes``). The three KiTS cases from
   ``predict_cases`` (two worker threads) must equal serial ``predict_case``
   voxel for voxel;
3b. serve, renal_anatomy: the committed coarse and renal_anatomy (5 classes)
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
   have launched and the other two must not;
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
7. kernel vs plain: each kernel on random inputs at every distinct shape
   the serve and train phases launched it with, against its plain version
   on the same inputs, with timings of kernel, plain version and the cuDNN
   yardstick (bf16 ``F.conv3d`` + sums for the forward kernels, bf16
   ``torch.nn.grad.conv3d_weight`` for the weight gradients; never called
   by the port; for the "v1" kernel on its own (B, D, H, C, W) layout, the
   permutes to and from cuDNN's layout included);
8. overfit gate: the same full-width model on one fixed 128³ batch of 2,
   constant lr, no augmentation, 20 steps; the last loss must fall below
   OVERFIT_FRACTION of the first. Prints the warm step median (host clock
   around synchronized steps), images/s, peak device memory, and the
   kernel launches of one step.

Tolerances of kernel vs plain. Forward: both accumulate in f32 and round to
bf16 in different orders, so y may differ by one bf16 ulp (2^-7 relative)
or, near zero, by 1e-3 of the tensor's largest magnitude; sq-means agree to
1e-3 relative and means to 1e-3 of the channel rms. Weight gradient: both
sum exact bf16 products in f32 in different orders; within DW_TOL of the
same sum over |x|·|g| (a wrong tap is off by the order of that sum).

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
import subprocess
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
TRAIN_CASE_SHAPE = (160, 144, 128)
TRAIN_SPACING = (0.8, 0.8, 0.8)
TRAIN_STEPS, RESUME_STEPS = 6, 8
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
WORK = Path(__file__).resolve().parent / "chip_smoke_work"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_counts() -> dict[str, int]:
    from runet_tpu_torch.kernels import fused_block, strided_conv

    return {fused_block.SOURCE: fused_block.launches, strided_conv.SOURCE: strided_conv.launches,
            fused_block.DW_SOURCE: fused_block.dw_launches,
            strided_conv.DW_SOURCE: strided_conv.dw_launches,
            fused_block.V2_SOURCE: fused_block.v2_launches,
            fused_block.V1_SOURCE: fused_block.v1_launches}


def reset_counts() -> None:
    from runet_tpu_torch.kernels import fused_block, strided_conv

    fused_block.launches = fused_block.dw_launches = 0
    fused_block.v2_launches = fused_block.v1_launches = 0
    strided_conv.launches = strided_conv.dw_launches = 0


def add_counts(total: dict, counts: dict) -> dict:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


@contextmanager
def launch_shapes():
    """Yields {(kernel, x shape, Cout): launches} of every kernel launch made
    inside the block (forward, dx, weight gradient, validation alike; x in
    the layout the kernel takes), by
    wrapping the launch functions that the kernel modules call; the
    wrappers' own counters are untouched. Thread-safe: ``predict_cases``
    runs cases on worker threads."""
    from runet_tpu_torch.kernels import fused_block, strided_conv

    seen: dict[tuple, int] = {}
    lock = threading.Lock()
    saved = [(m, m.launch_conv_stats, m.launch_conv_dw) for m in (fused_block, strided_conv)]

    def recording(launch, cout_of):
        def wrapped(name, x, *args):
            key = (name, tuple(x.shape), int(cout_of(*args)))
            with lock:
                seen[key] = seen.get(key, 0) + 1
            return launch(name, x, *args)
        return wrapped

    for m, stats, dw in saved:
        m.launch_conv_stats = recording(
            stats, lambda packed, cout, out_dhw, layout="dchw": cout)
        m.launch_conv_dw = recording(dw, lambda g: g.shape[2])
    try:
        yield seen
    finally:
        for m, stats, dw in saved:
            m.launch_conv_stats, m.launch_conv_dw = stats, dw


def phase_build():
    from runet_tpu_torch.kernels import build, fused_block, strided_conv

    t0 = time.monotonic()
    logs = build.build([fused_block.SOURCE, strided_conv.SOURCE, fused_block.DW_SOURCE,
                        strided_conv.DW_SOURCE, fused_block.V2_SOURCE, fused_block.V1_SOURCE])
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] kernels ready in {time.monotonic() - t0:.1f} s")


def phase_serve(dev):
    """Drive the serving path; returns per-kernel launch counts, the shapes
    of its launches and the fine U-Net."""
    from runet_tpu_torch.data.phantom import make_phantom
    from runet_tpu_torch.eval.evaluate import evaluate_prediction
    from runet_tpu_torch.infer.cascade import ModelBundle, predict_case, predict_cases
    from runet_tpu_torch.kernels import fused_block, strided_conv
    from runet_tpu_torch.params import load_model
    from runet_tpu_torch.utils.timing import PhaseTimer

    t0 = time.monotonic()
    cm, ccfg = load_model("coarse", device=dev)
    fm, fcfg = load_model("fine_kits", device=dev)
    coarse, fine = ModelBundle.from_model(cm, ccfg), ModelBundle.from_model(fm, fcfg)
    cases = [make_phantom(CASE_SHAPE, CASE_SPACING, num_classes=3, seed=s) for s in range(3)]
    q_img, q_seg = make_phantom(QUALITY_SHAPE, CASE_SPACING, num_classes=3, seed=QUALITY_SEED)
    log(f"[serve] set-up (weights, phantoms) {time.monotonic() - t0:.1f} s")

    reset_counts()
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
    for name in (fused_block.SOURCE, strided_conv.SOURCE):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the serving path")
    return counts, shapes, fm


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
                "conv3x3_dw": 0, "conv3x3_s2_stats": 4, "conv3x3_s2_dw": 4, **per_step}
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
            "conv3x3_stats_v2": 0, "conv3x3_stats_v1": 0}
    if one_step != want:
        raise AssertionError(f"one step launched {one_step}, expected {want}")
    ratio = losses[-1] / losses[0]
    log(f"[overfit] last/first loss {ratio:.4f} (gate < {OVERFIT_FRACTION})")
    if not (all(math.isfinite(v) for v in losses) and ratio < OVERFIT_FRACTION):
        raise AssertionError(f"overfit gate failed: {losses}")
    return {"step_ms_median": med * 1e3, "imgs_per_s": cfg.train.batch_size / med,
            "peak_gib": peak / 2**30}


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


def _check(got, want):
    y, m, q = (t.float() for t in got)
    yr, mr, qr = (t.float() for t in want)
    if y.shape != yr.shape:
        raise AssertionError(f"shape {tuple(y.shape)} != {tuple(yr.shape)}")
    err = (y - yr).abs()
    bad = int((err > 2.0 ** -7 * yr.abs() + 1e-3 * yr.abs().max()).sum())
    rel_q = ((q - qr).abs() / qr.abs().clamp_min(1e-12)).max().item()
    rel_m = ((m - mr).abs() / qr.clamp_min(1e-12).sqrt()).max().item()
    if bad or rel_q > 1e-3 or rel_m > 1e-3:
        raise AssertionError(f"{bad} outputs off, sq-mean rel {rel_q}, mean rel {rel_m}")
    return err.max().item(), max(rel_q, rel_m)


def _bound(flops: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
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
    with torch.no_grad():
        max_err, rel = _check(wrap(x, k, packed), plain(x, k))
        ms = cuda_ms(lambda: wrap(x, k, packed), reps=10)
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
            "library_ms": library_ms, "flops": flops, **_bound(flops, nbytes)}


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
            "library_ms": library_ms, "flops": flops, **_bound(flops, nbytes)}


def phase_kernels(dev, path_shapes):
    """Every kernel at every distinct shape each main path launched it with
    (forward, dx and weight gradient alike), on random inputs against its
    plain version, timed beside the plain version and the cuDNN yardstick;
    returns {kernel: [case, ...]}."""
    from runet_tpu_torch.kernels import fused_block, strided_conv

    def variant(version):
        return lambda mod, x_shape, cout, gen, dev: _stats_case(mod, x_shape, cout, gen, dev,
                                                               version)

    run = {fused_block.SOURCE: (fused_block, _stats_case),
           fused_block.V2_SOURCE: (fused_block, variant("v2")),
           fused_block.V1_SOURCE: (fused_block, variant("v1")),
           strided_conv.SOURCE: (strided_conv, _stats_case),
           fused_block.DW_SOURCE: (fused_block, _dw_case),
           strided_conv.DW_SOURCE: (strided_conv, _dw_case)}
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
                log(f"[kernels] {name} {path} x{x_shape}->{cout} x{n}: "
                    f"err {case['max_abs_err']:.3g} (rel {case['rel_err']:.2e}) "
                    f"ms {case['ms']:.4f} plain {case['plain_ms']:.4f} "
                    f"cuDNN {case['library_ms']:.4f} bound {case['bound_ms']:.4f} "
                    f"({case['bound_by']}) {case['flops'] / case['ms'] / 1e9:.1f} TFLOP/s")
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


def kernel_lines(measured, path_counts):
    """One entry per kernel for the ``kernels`` JSON line. ``ms``,
    ``plain_ms``, ``library_ms`` and ``bound_ms`` are sums over the distinct
    shapes timed (each once, whatever the number of paths that launched it);
    ``path_ms`` weighs each shape's time by its launches on that path;
    ``launches`` is over the main paths."""
    replaces = {
        "conv3x3_stats": "runet_tpu/kernels/fused_block.py:639",
        "conv3x3_s2_stats": "runet_tpu/kernels/strided_conv.py:80",
        "conv3x3_dw": "runet_tpu/kernels/fused_block.py:429",
        "conv3x3_s2_dw": "runet_tpu/kernels/strided_conv.py:223",
        "conv3x3_stats_v2": "runet_tpu/kernels/fused_block.py:286",
        "conv3x3_stats_v1": "runet_tpu/kernels/fused_block.py:53",
    }
    kernels = []
    for name, every in measured.items():
        cs = [c for c in every if not c["reused"]]
        total = sum(c["bound_ms"] for c in cs)
        ops = sum(c["bound_ms"] for c in cs if c["bound_by"] == "operations")
        by_path = {p: counts.get(name, 0) for p, counts in path_counts.items()}
        paths = sorted({c["path"] for c in every})
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"runet_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "max_rel_err": max(c["rel_err"] for c in cs),
            "ms": sum(c["ms"] for c in cs),
            "plain_ms": sum(c["plain_ms"] for c in cs),
            "bound_ms": total,
            "bound_by": "operations" if ops >= total / 2 else "bytes",
            "library_ms": sum(c["library_ms"] for c in cs),
            "shapes_timed": len(cs),
            "shapes_by_path": {p: sum(c["path"] == p for c in every) for p in paths},
            "path_ms": {p: sum(c["ms"] * c["launches"] for c in every if c["path"] == p)
                        for p in paths},
        })
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_start = time.monotonic()

    from runet_tpu_torch.config import get_config

    phase_build()
    serve_counts, serve_shapes, fine = phase_serve(dev)
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
        measured = phase_kernels(dev, {"serve": serve_shapes, "train": train_shapes,
                                       "serve_renal": renal_shapes,
                                       "train_renal": rtrain_shapes})
        phase_overfit(dev, cases)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    kernels = kernel_lines(measured, {"serve": serve_counts, "train": train_counts,
                                      "serve_renal": renal_counts,
                                      "train_renal": rtrain_counts})
    if len(kernels) != 6:
        raise AssertionError(f"expected six kernels on the main paths, got "
                             f"{[k['name'] for k in kernels]}")
    log(f"[done] total {time.monotonic() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
