"""Chip smoke run of the PyTorch + CUDA port (``runet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and printed over):

1. report the card (name and power limit from nvidia-smi);
2. build the four CUDA kernels from ``runet_tpu_torch/kernels/csrc`` (one
   nvcc per source, started together);
3. serve: load the committed coarse and fine_kits weights and run
   ``predict_cases`` over three KiTS-scale phantoms (512x512x160 at
   0.78125x0.78125x3 mm, seeds 0-2), then ``predict_case`` on a 192x192x64
   phantom gated on Dice (kidney_composite > 0.96, tumor > 0.82). Every
   kernel's launch counter is set to 0 just before this phase and read just
   after; the forward kernels must have launched. The shape of every launch
   is recorded (``launch_shapes``);
4. reference: the fine U-Net on the card against the same weights on the
   CPU (plain PyTorch path) at a 64³ input;
5. train: two phantom cases (160x144x128 at 0.8 mm iso, so the resample is
   the identity) written in the KiTS19 layout, then ``train`` with the full
   ``fine_kits`` preset (base 32, max 320, 5 levels, 128³ patches, batch 2,
   AdamW with warmup+poly, augmentation on) for 6 steps and a resume to
   step 8. Counters are set to 0 before and read after: every kernel must
   have launched, each weight-gradient kernel once per conv per step, and
   the stride-1 forward kernel at least its forward plus dx launches. Losses
   must be finite and a checkpoint must exist at the last step. The shape of
   every launch (forward, dx, weight gradient, validation) is recorded;
6. gradient reference: the fine_kits train model on the card against its
   deep copy on the CPU (plain path, bf16) at a (1, 32, 64, 64, 1) input:
   per-tensor cosine of the gradients >= GRAD_COSINE, global norms within
   GRAD_NORM_REL; the CPU path summed in another order (oneDNN off) and the
   same weights in f32 on the CPU print the floor that bf16 sets;
7. kernel vs plain: each kernel on random inputs at every distinct shape
   the serve and train phases launched it with, against its plain version
   on the same inputs, with timings of kernel, plain version and the cuDNN
   yardstick (bf16 ``F.conv3d`` + sums for the forward kernels, bf16
   ``torch.nn.grad.conv3d_weight`` for the weight gradients; never called
   by the port);
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
            strided_conv.DW_SOURCE: strided_conv.dw_launches}


def reset_counts() -> None:
    from runet_tpu_torch.kernels import fused_block, strided_conv

    fused_block.launches = fused_block.dw_launches = 0
    strided_conv.launches = strided_conv.dw_launches = 0


@contextmanager
def launch_shapes():
    """Yields {(kernel, x shape, Cout): launches} of every kernel launch made
    inside the block (forward, dx, weight gradient, validation alike), by
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
        m.launch_conv_stats = recording(stats, lambda packed, cout, out_dhw: cout)
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
                        strided_conv.DW_SOURCE])
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


def phase_reference(fm, dev):
    """The fine U-Net on the card vs the same weights on the CPU plain path."""
    fm_cpu = copy.deepcopy(fm).to("cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 64, 64, 64, 1), generator=g)
    with torch.inference_mode():
        got = fm(x.to(dev)).float().cpu()
        want = fm_cpu(x).float()
    err = (got - want).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"[reference] fine U-Net 64³ card vs CPU: max |Δlogit| {err:.4f}, "
        f"argmax agreement {agree:.5f}")
    if not (math.isfinite(err) and agree >= 0.995):
        raise AssertionError("card forward disagrees with the CPU reference")


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
    want = {"conv3x3_stats": 27, "conv3x3_s2_stats": 4, "conv3x3_dw": 14, "conv3x3_s2_dw": 4}
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


def phase_grad_reference(dev):
    """fine_kits train model on the card vs its deep copy on the CPU (bf16
    plain path). For scale: the CPU path against itself summed in another
    order (the floor of any two correct bf16 paths), and against the same
    weights in f32."""
    from runet_tpu_torch.config import get_config
    from runet_tpu_torch.models.unet3d import create_train_model, init_params
    from runet_tpu_torch.train.losses import dice_ce_loss

    cfg = get_config("fine_kits")
    model = init_params(create_train_model(cfg.model, dev), torch.Generator().manual_seed(2))
    cpu = copy.deepcopy(model).to("cpu")
    cpu32 = create_train_model(dataclasses.replace(cfg.model, compute_dtype="float32"), "cpu")
    cpu32.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, 32, 64, 64, 1), generator=g)
    labels = torch.randint(0, cfg.model.num_classes, (1, 32, 64, 64), generator=g)
    names = [n for n, _ in model.named_parameters()]

    def grads(m, d):
        loss, _ = dice_ce_loss(m(x.to(d)), labels.to(d))
        return [t.float().cpu() for t in torch.autograd.grad(loss, list(m.parameters()))]

    cpu_dev = torch.device("cpu")
    card, ref = grads(model, dev), grads(cpu, cpu_dev)
    with torch.backends.mkldnn.flags(enabled=False):  # torch's own conv loops
        reordered = grads(cpu, cpu_dev)
    f32 = grads(cpu32, cpu_dev)

    def summary(r):
        kernels = min(c for n, c in r["cos"].items() if n.endswith("kernel"))
        return (f"lowest cosine {min(r['cos'].values()):.4f}, over kernels {kernels:.4f}, "
                f"whole gradient {r['whole']:.5f}, norms {r['norm_rel']:.5f} apart")

    got = grad_agreement(names, card, ref)
    worst = [(n, round(c, 4)) for n, c in sorted(got["cos"].items(), key=lambda kv: kv[1])[:3]]
    log(f"[grad-reference] fine_kits (1, 32, 64, 64) card vs CPU (both bf16): {summary(got)}; "
        f"lowest three {worst}")
    log(f"[grad-reference] floor, CPU bf16 vs the same with oneDNN off (another summation "
        f"order): {summary(grad_agreement(names, reordered, ref))}")
    log(f"[grad-reference] CPU bf16 vs CPU f32: {summary(grad_agreement(names, ref, f32))}")
    if not got["ok"]:
        raise AssertionError("card gradients disagree with the CPU reference")


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


def _stats_case(mod, x_shape, cout, gen, dev):
    """One conv+moment kernel against its plain version on random inputs;
    returns the case's errors and times."""
    from runet_tpu_torch.kernels import strided_conv
    from runet_tpu_torch.kernels.conv_common import pack_weight

    stride2 = mod is strided_conv
    wrap = mod.conv_s2_stats_dchw_batch if stride2 else mod.conv_in_stats_dchw_batch
    plain = mod.conv3x3_s2_stats_plain if stride2 else mod.conv3x3_stats_plain
    B, D, C, H, W = x_shape
    x = torch.randn(x_shape, generator=gen, device=dev).to(torch.bfloat16)
    k = (torch.randn((3, 3, 3, C, cout), generator=gen, device=dev) / math.sqrt(27 * C)
         ).to(torch.bfloat16)
    packed = pack_weight(k)
    with torch.no_grad():
        max_err, rel = _check(wrap(x, k, packed), plain(x, k))
        ms = cuda_ms(lambda: wrap(x, k, packed), reps=10)
        plain_ms = cuda_ms(lambda: plain(x, k), reps=3)
        # Library yardstick: cuDNN bf16 conv in its own NCDHW layout + sums.
        xc = x.permute(0, 2, 1, 3, 4).contiguous()
        wc = k.permute(4, 3, 0, 1, 2).contiguous()

        def lib():
            if stride2:
                y = F.conv3d(F.pad(xc, (0, 1, 0, 1, 0, 1)), wc, stride=2)
            else:
                y = F.conv3d(xc, wc, padding=1)
            yf = y.float()
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

    run = {fused_block.SOURCE: (fused_block, _stats_case),
           strided_conv.SOURCE: (strided_conv, _stats_case),
           fused_block.DW_SOURCE: (fused_block, _dw_case),
           strided_conv.DW_SOURCE: (strided_conv, _dw_case)}
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for path, shapes in path_shapes.items():
        for (name, x_shape, cout), n in sorted(shapes.items()):
            mod, case_fn = run[name]
            case = {"path": path, "x_bdchw": list(x_shape), "cout": cout, "launches": n,
                    **case_fn(mod, x_shape, cout, gen, dev)}
            log(f"[kernels] {name} {path} x{x_shape}->{cout} x{n}: err {case['max_abs_err']:.3g} "
                f"(rel {case['rel_err']:.2e}) ms {case['ms']:.4f} plain {case['plain_ms']:.4f} "
                f"cuDNN {case['library_ms']:.4f} bound {case['bound_ms']:.4f} "
                f"({case['bound_by']}) {case['flops'] / case['ms'] / 1e9:.1f} TFLOP/s")
            out.setdefault(name, []).append(case)
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
    return out


def kernel_lines(measured, path_counts):
    """One entry per kernel for the ``kernels`` JSON line. ``ms``,
    ``plain_ms``, ``library_ms`` and ``bound_ms`` are sums over the distinct
    shapes timed (each once); ``path_ms`` weighs each shape's time by its
    launches on that path; ``launches`` is over the main paths."""
    replaces = {
        "conv3x3_stats": "runet_tpu/kernels/fused_block.py:639",
        "conv3x3_s2_stats": "runet_tpu/kernels/strided_conv.py:80",
        "conv3x3_dw": "runet_tpu/kernels/fused_block.py:429",
        "conv3x3_s2_dw": "runet_tpu/kernels/strided_conv.py:223",
    }
    kernels = []
    for name, cs in measured.items():
        total = sum(c["bound_ms"] for c in cs)
        ops = sum(c["bound_ms"] for c in cs if c["bound_by"] == "operations")
        by_path = {p: counts[name] for p, counts in path_counts.items()}
        paths = sorted({c["path"] for c in cs})
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
            "shapes_timed": {p: sum(c["path"] == p for c in cs) for p in paths},
            "path_ms": {p: sum(c["ms"] * c["launches"] for c in cs if c["path"] == p)
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

    phase_build()
    serve_counts, serve_shapes, fine = phase_serve(dev)
    phase_reference(fine, dev)
    del fine
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        train_counts, train_shapes, cases = phase_train(dev)
        phase_grad_reference(dev)
        measured = phase_kernels(dev, {"serve": serve_shapes, "train": train_shapes})
        phase_overfit(dev, cases)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    kernels = kernel_lines(measured, {"serve": serve_counts, "train": train_counts})
    log(f"[done] total {time.monotonic() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
