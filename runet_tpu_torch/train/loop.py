"""Training loop on one device.

Counterpart of ``runet_tpu/train/loop.py``: one step (augment → forward →
backward → optimizer update) per batch from the prefetching ``PatchLoader``,
with the JAX package's event schedule after each step (log, patch
validation, full-volume validation, checkpoints) and resume from the latest
checkpoint.

One device only: a multi-device request (``mesh``),
``steps_per_dispatch > 1`` and elastic augmentation raise
``NotImplementedError``.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from runet_tpu_torch import resolve_device
from runet_tpu_torch.config import Config
from runet_tpu_torch.data.dataset import PreparedCase, prepare_dataset
from runet_tpu_torch.data.pipeline import PatchLoader
from runet_tpu_torch.data.sampler import sample_batch
from runet_tpu_torch.models.unet3d import create_train_model, init_params
from runet_tpu_torch.train.checkpoint import CheckpointManager
from runet_tpu_torch.train.metrics import MetricsLogger
from runet_tpu_torch.train.state import create_train_state, make_eval_step, make_train_step


VAL_PATCHES = 8


def validate_patches(eval_step, cases: list[PreparedCase], patch_size, num_classes: int,
                     device=None):
    """Cheap patch validation: mean per-class hard Dice over VAL_PATCHES
    foreground patches (a fixed seed, so every validation sees the same
    patches) on ``device`` (CUDA unless named); returns (mean foreground
    Dice, per-class means)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    dices = []
    for _ in range(VAL_PATCHES):
        images, labels = sample_batch(rng, cases, 1, patch_size, fg_prob=1.0)
        d = eval_step(torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device))
        dices.append(d.cpu().numpy())
    mean = np.stack(dices).mean(axis=0)
    fg_mean = float(mean[1:].mean()) if num_classes > 1 else float(mean.mean())
    return fg_mean, mean


def validate_full(model, cases: list[PreparedCase], infer_cfg, num_classes: int,
                  device=None) -> float:
    """Full sliding-window validation on ``device`` (CUDA unless named):
    mean foreground Dice over whole validation volumes on the preprocessed
    grid (the low-variance metric that keep-best selection keys on)."""
    device = resolve_device(device)
    from runet_tpu_torch.eval.evaluate import evaluate_prediction
    from runet_tpu_torch.infer.sliding_window import sliding_window_predict

    def apply_fn(_params, windows):
        return model(windows)

    scores = []
    with torch.no_grad():
        for case in cases:
            vol = torch.from_numpy(np.ascontiguousarray(case.image, np.float32)).to(device)
            pred = sliding_window_predict(
                apply_fn, None, vol, tuple(infer_cfg.patch_size), num_classes,
                overlap=infer_cfg.overlap, sigma_scale=infer_cfg.sigma_scale,
                use_gaussian=infer_cfg.use_gaussian, window_batch=infer_cfg.window_batch,
                single_pass_ratio=infer_cfg.single_pass_ratio,
                expand_windows=infer_cfg.expand_windows,
            )
            # Same label-range clamp as training (a 2-class net on multi-class GT).
            gt = np.minimum(np.asarray(case.labels), num_classes - 1)
            scores.append(evaluate_prediction(pred.cpu().numpy(), gt, num_classes)["dice_fg_mean"])
    return float(np.mean(scores))


def _step_seed(seed: int, step: int) -> int:
    """The augmentation generators' seed for one global step: the draws of a
    step do not depend on where a run was resumed."""
    return (seed * 1_000_003 + step) % (2**63)


def train(
    cfg: Config,
    data_root: str | Path | None = None,
    out_dir: str | Path = "runs/run0",
    cases: list[PreparedCase] | None = None,
    val_cases: list[PreparedCase] | None = None,
    max_steps: int | None = None,
    mesh=None,
    resume: bool = False,
    log_every: int = 50,
    cache_dir: str | Path | None = None,
    device=None,
):
    """Train a model per config on ``device`` (CUDA unless named); returns
    (state, last aux dict of 0-d tensors)."""
    out_dir = Path(out_dir)
    steps = max_steps if max_steps is not None else cfg.train.steps
    if cfg.train.val_full_every > 0:
        # Full validation only fires inside the val_every branch.
        if cfg.train.val_every <= 0:
            raise ValueError(f"val_full_every={cfg.train.val_full_every} needs val_every>0")
        if cfg.train.val_full_every % cfg.train.val_every:
            raise ValueError(
                f"val_full_every={cfg.train.val_full_every} must be a multiple "
                f"of val_every={cfg.train.val_every}"
            )
    if mesh is not None:
        raise NotImplementedError("multi-device data parallelism is not ported yet")
    if cfg.train.steps_per_dispatch > 1:
        raise NotImplementedError("steps_per_dispatch > 1 is not ported yet")
    if cfg.train.elastic:
        raise NotImplementedError("elastic augmentation is not ported yet")
    dev = resolve_device(device)

    if cases is None:
        if data_root is None:
            raise ValueError("need data_root or cases")
        cases = prepare_dataset(data_root, cfg.preprocess, cache_dir=cache_dir, device=dev)
    if not cases:
        raise ValueError("no cases found")
    if val_cases is None:
        if len(cases) >= 5:
            n_val = max(1, len(cases) // 10)
            val_cases, cases = cases[-n_val:], cases[:-n_val]
        else:
            val_cases = cases  # tiny/smoke runs validate on train cases

    batch = cfg.train.batch_size
    model = create_train_model(cfg.model, dev)
    init_params(model, torch.Generator().manual_seed(cfg.train.seed))
    state = create_train_state(model, cfg.train)

    ckpt = CheckpointManager(out_dir / "ckpt", keep=cfg.train.keep_checkpoints)
    start_step = 0
    if resume and ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore(map_location=dev))
        start_step = state.step

    logger = MetricsLogger(out_dir)
    logger.write_config(cfg.to_json())

    loss_kw = {"tversky_alpha": cfg.train.tversky_alpha, "tversky_beta": cfg.train.tversky_beta}
    train_step = make_train_step(model, augment=cfg.train.augment, loss_kwargs=loss_kw)
    eval_step = make_eval_step(model)
    loader = PatchLoader(cases, batch_size=batch, patch_size=cfg.train.patch_size,
                         fg_prob=cfg.train.fg_prob, seed=cfg.train.seed, device=dev)
    generators = (torch.Generator(), torch.Generator(device=dev))

    def run_single(images, labels, global_step):
        if not cfg.train.augment:
            return train_step(state, images, labels)
        s = _step_seed(cfg.train.seed, global_step)
        generators[0].manual_seed(s)
        generators[1].manual_seed(s)
        return train_step(state, images, labels, generators)

    aux = {}
    t_last = time.monotonic()
    steps_since_log = 0

    def post_step(done, aux):
        """Events after global step count ``done`` completed."""
        nonlocal t_last, steps_since_log
        if done % log_every == 0 or done == steps:
            aux_host = {k: float(v) for k, v in aux.items()}
            dt = time.monotonic() - t_last
            logger.log(done, imgs_per_s=batch * steps_since_log / dt, **aux_host)
            t_last = time.monotonic()
            steps_since_log = 0

        # val_every <= 0 disables validation entirely.
        if cfg.train.val_every > 0 and (done % cfg.train.val_every == 0 or done == steps):
            val_dice, per_class = validate_patches(
                eval_step, val_cases, cfg.train.patch_size, cfg.model.num_classes, device=dev)
            logger.log(done, val_dice=val_dice,
                       **{f"val_dice_c{k}": float(v) for k, v in enumerate(per_class)})
            use_full = cfg.train.val_full_every > 0
            if use_full and (done % cfg.train.val_full_every == 0 or done == steps):
                # Keep-best keys on the low-variance full-volume Dice.
                full_dice = validate_full(model, val_cases, cfg.infer, cfg.model.num_classes,
                                          device=dev)
                logger.log(done, val_full_dice=full_dice)
                ckpt.save(done, state.state_dict(), metrics={"val_dice": full_dice})
            elif use_full:
                # Patch validations between full ones: latest-N retention
                # only, never on the best-K ladder.
                ckpt.save(done, state.state_dict(), metrics=None)
            else:
                ckpt.save(done, state.state_dict(), metrics={"val_dice": val_dice})
        elif done % cfg.train.ckpt_every == 0:
            ckpt.save(done, state.state_dict(), metrics=None)

    try:
        step = start_step
        while step < steps:
            images, labels = next(loader)
            aux = run_single(images, labels, step)
            step += 1
            steps_since_log += 1
            post_step(step, aux)
    finally:
        loader.close()
        logger.close()

    return state, aux
