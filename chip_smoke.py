"""Chip smoke run of the PyTorch + CUDA port (``runet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and printed over):

1. report the card (name and power limit from nvidia-smi);
2. build the CUDA kernels from ``runet_tpu_torch/kernels/csrc`` (one nvcc
   per source, started together);
3. serve: load the committed coarse and fine_kits weights and run
   ``predict_cases`` over three KiTS-scale phantoms (512x512x160 at
   0.78125x0.78125x3 mm, seeds 0-2), then ``predict_case`` on a 192x192x64
   phantom gated on Dice (kidney_composite > 0.96, tumor > 0.82). Every
   kernel's launch counter is set to 0 just before this phase and must be
   above 0 after it;
4. reference: the fine U-Net on the card against the same weights on the
   CPU (plain PyTorch path) at a 64³ input;
5. kernel vs plain: each kernel on random inputs at the shapes the serve
   phase gave it (recorded by forward hooks), against its plain version on
   the same inputs, with timings of kernel, plain version and the cuDNN
   yardstick (bf16 ``F.conv3d`` + ``torch.sum`` moments; never called by
   the port).

Tolerance of kernel vs plain: both accumulate in f32 and round to bf16 in
different orders, so y may differ by one bf16 ulp (2^-7 relative) or, near
zero, by 1e-3 of the tensor's largest magnitude; sq-means agree to 1e-3
relative and means to 1e-3 of the channel rms.

The line before the last is the ``kernels`` JSON object, the last line
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

CASE_SHAPE = (512, 512, 160)
CASE_SPACING = (0.78125, 0.78125, 3.0)
QUALITY_SHAPE = (192, 192, 64)
QUALITY_SEED = 7
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth


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


def phase_build():
    from runet_tpu_torch.kernels import build, fused_block, strided_conv

    t0 = time.monotonic()
    logs = build.build([fused_block.SOURCE, strided_conv.SOURCE])
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] kernels ready in {time.monotonic() - t0:.1f} s")


def phase_serve(dev, watch):
    """Drive the main path; returns per-kernel launch counts and the input
    shapes the watched conv modules saw."""
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

    shapes = {}
    hooks = []
    for key, (which, path) in watch.items():
        mod = {"c": cm, "f": fm}[which].get_submodule(path)
        hooks.append(mod.register_forward_pre_hook(
            lambda _m, args, _k=key: shapes.__setitem__(_k, tuple(args[0].shape))))

    fused_block.launches = 0
    strided_conv.launches = 0
    torch.cuda.synchronize()
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
    counts = {fused_block.SOURCE: fused_block.launches, strided_conv.SOURCE: strided_conv.launches}
    for h in hooks:
        h.remove()

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
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return counts, shapes, (cm, fm)


def phase_reference(fm, dev):
    """The fine U-Net on the card vs the same weights on the CPU plain path."""
    import copy

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


def phase_kernels(dev, shapes, counts, models):
    from runet_tpu_torch.kernels import fused_block, strided_conv
    from runet_tpu_torch.kernels.conv_common import pack_weight

    cm, fm = models
    cases = [
        # (kernel module, watched key, model, conv module path)
        (fused_block, "coarse_l0_1to24", cm, "enc0.ConvNormAct_0"),
        (fused_block, "coarse_l0_48to24", cm, "dec0.ConvNormAct_0"),
        (fused_block, "fine_roi_l0_32to32", fm, "enc0.ConvNormAct_1"),
        (fused_block, "fine_roi_l0_64to32", fm, "dec0.ConvNormAct_0"),
        (strided_conv, "coarse_s2_24to48", cm, "enc1.ConvNormAct_0"),
        (strided_conv, "fine_roi_s2_32to64", fm, "enc1.ConvNormAct_0"),
    ]
    replaces = {
        fused_block: "runet_tpu/kernels/fused_block.py:639",
        strided_conv: "runet_tpu/kernels/strided_conv.py:80",
    }
    plain_fn = {fused_block: fused_block.conv3x3_stats_plain,
                strided_conv: strided_conv.conv3x3_s2_stats_plain}
    wrap_fn = {fused_block: fused_block.conv_in_stats_dchw_batch,
               strided_conv: strided_conv.conv_s2_stats_dchw_batch}
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for mod, key, model, path in cases:
        conv = model.get_submodule(path)
        shape = shapes[key]
        k = conv.kernel.detach()
        cin, cout = k.shape[3], k.shape[4]
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        packed = pack_weight(k)
        stride = 2 if mod is strided_conv else 1
        got = wrap_fn[mod](x, k, packed)
        want = plain_fn[mod](x, k)
        torch.cuda.synchronize()
        max_err, rel_mom = _check(got, want)
        ms = cuda_ms(lambda: wrap_fn[mod](x, k, packed), reps=10)
        plain_ms = cuda_ms(lambda: plain_fn[mod](x, k), reps=3)
        # Library yardstick: cuDNN bf16 conv in its own NCDHW layout + sums.
        xc = x.permute(0, 2, 1, 3, 4).contiguous()
        wc = k.permute(4, 3, 0, 1, 2).contiguous()
        if stride == 2:
            def lib():
                y = torch.nn.functional.conv3d(torch.nn.functional.pad(xc, (0, 1, 0, 1, 0, 1)),
                                               wc, stride=2)
                yf = y.float()
                return y, yf.sum((2, 3, 4)), (yf * yf).sum((2, 3, 4))
        else:
            def lib():
                y = torch.nn.functional.conv3d(xc, wc, padding=1)
                yf = y.float()
                return y, yf.sum((2, 3, 4)), (yf * yf).sum((2, 3, 4))
        library_ms = cuda_ms(lib, reps=10)
        B, D, C, H, W = shape
        n_out = B * (D // stride) * (H // stride) * (W // stride)
        flops = 2.0 * 27 * cin * cout * n_out
        nbytes = 2.0 * B * D * C * H * W + 2.0 * 27 * cin * cout + 2.0 * n_out * cout \
            + 8.0 * B * cout
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        case = {"case": key, "shape_bdchw": list(shape), "cout": int(cout),
                "max_abs_err": max_err, "moments_rel_err": rel_mom, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "tflops": flops / ms / 1e9}
        log(f"[kernels] {json.dumps(case)}")
        out.setdefault(mod, []).append(case)
        del x, got, want, xc

    kernels = []
    for mod, cs in out.items():
        ops = sum(c["bound_ms"] for c in cs if c["bound_by"] == "operations")
        kernels.append({
            "name": mod.SOURCE,
            "route": "cuda",
            "source": f"runet_tpu_torch/kernels/csrc/{mod.SOURCE}.cu",
            "replaces": replaces[mod],
            "launches": counts[mod.SOURCE],
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "moments_rel_err": max(c["moments_rel_err"] for c in cs),
            "ms": sum(c["ms"] for c in cs),
            "plain_ms": sum(c["plain_ms"] for c in cs),
            "bound_ms": sum(c["bound_ms"] for c in cs),
            "bound_by": "operations" if ops >= sum(c["bound_ms"] for c in cs) / 2 else "bytes",
            "library_ms": sum(c["library_ms"] for c in cs),
            "timed_over": [c["case"] for c in cs],
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
    # The serve phase records the input shapes of these conv modules ("c"
    # coarse, "f" fine) through forward pre-hooks.
    watch_paths = {
        "coarse_l0_1to24": ("c", "enc0.ConvNormAct_0"),
        "coarse_l0_48to24": ("c", "dec0.ConvNormAct_0"),
        "fine_roi_l0_32to32": ("f", "enc0.ConvNormAct_1"),
        "fine_roi_l0_64to32": ("f", "dec0.ConvNormAct_0"),
        "coarse_s2_24to48": ("c", "enc1.ConvNormAct_0"),
        "fine_roi_s2_32to64": ("f", "enc1.ConvNormAct_0"),
    }
    counts, shapes, models = phase_serve(dev, watch_paths)
    phase_reference(models[1], dev)
    kernels = phase_kernels(dev, shapes, counts, models)
    log(f"[done] total {time.monotonic() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
