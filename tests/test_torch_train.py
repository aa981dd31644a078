"""The port's training stack against the JAX package on the CPU: losses and
their gradients, LR schedules, the optimizer (on identical gradients, numpy
in on both sides), one train step, and the loop end to end.

Tolerances: losses and their logit gradients are f32 math in both (rtol
1e-5, atol 1e-7); schedules are f32 in optax and f32 numpy here (rtol
1e-6); optimizer updates on identical gradients rtol 1e-6 (atol 1e-9 for
values that cross zero). Adam-updated parameters are never compared across
frameworks after a real backward: Adam's first step is about lr·sign(g), so
a tiny gradient whose sign differs moves a weight by 2·lr.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from runet_tpu.config import ModelConfig as JModelConfig
from runet_tpu.config import TrainConfig as JTrainConfig
from runet_tpu.models.unet3d import UNet3D as JUNet3D
from runet_tpu.models.unet3d import init_params as jax_init_params
from runet_tpu.train import losses as jl
from runet_tpu.train.state import create_train_state as jax_create_train_state
from runet_tpu.train.state import make_lr_schedule as jax_make_lr_schedule
from runet_tpu.train.state import make_optimizer as jax_make_optimizer
from runet_tpu.train.state import make_train_step as jax_make_train_step
from runet_tpu_torch.config import Config, ModelConfig, PreprocessConfig, TrainConfig
from runet_tpu_torch.data.phantom import write_phantom_dataset
from runet_tpu_torch.models.unet3d import create_train_model, init_params
from runet_tpu_torch.params import load_state
from runet_tpu_torch.train import losses as tl
from runet_tpu_torch.train.checkpoint import CheckpointManager
from runet_tpu_torch.train.loop import train, validate_full, validate_patches
from runet_tpu_torch.train.state import (
    create_train_state,
    make_eval_step,
    make_lr_schedule,
    make_multi_train_step,
    make_optimizer,
    make_train_step,
)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def _logits_labels(seed, shape=(2, 6, 5, 4), k=3):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape + (k,)) * 2).astype(np.float32)
    labels = rng.integers(0, k, shape).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("kw", [
    {},
    {"tversky_alpha": 0.3, "tversky_beta": 0.7},
    {"include_background": True, "ce_weight": 0.5, "dice_weight": 2.0},
])
def test_dice_ce_loss_and_grads_match_jax(kw):
    logits, labels = _logits_labels(0)
    (jloss, jaux), jgrad = jax.value_and_grad(
        lambda x: jl.dice_ce_loss(x, jnp.asarray(labels), **kw), has_aux=True)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss, aux = tl.dice_ce_loss(x, torch.from_numpy(labels).long(), **kw)
    loss.backward()
    for k in ("loss", "dice_loss", "ce_loss"):
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)


def test_soft_dice_and_ce_match_jax():
    logits, labels = _logits_labels(1, k=4)
    x, y = torch.from_numpy(logits), torch.from_numpy(labels).long()
    for inc in (False, True):
        np.testing.assert_allclose(
            float(tl.soft_dice_loss(x, y, include_background=inc)),
            float(jl.soft_dice_loss(jnp.asarray(logits), jnp.asarray(labels),
                                    include_background=inc)), rtol=1e-5)
    np.testing.assert_allclose(float(tl.cross_entropy_loss(x, y)),
                               float(jl.cross_entropy_loss(jnp.asarray(logits),
                                                           jnp.asarray(labels))), rtol=1e-5)


def test_hard_and_kits_dice_match_jax():
    rng = np.random.default_rng(2)
    pred = rng.integers(0, 5, (8, 7, 6)).astype(np.int32)
    gt = rng.integers(0, 5, (8, 7, 6)).astype(np.int32)
    gt[gt == 4] = 3  # class 4 absent from gt only
    pred[pred == 3] = 0  # class 3 absent from pred only
    np.testing.assert_allclose(
        tl.hard_dice_per_class(torch.from_numpy(pred), torch.from_numpy(gt), 6).numpy(),
        np.asarray(jl.hard_dice_per_class(jnp.asarray(pred), jnp.asarray(gt), 6)), rtol=1e-6)
    got = tl.kits_composite_dice(torch.from_numpy(pred), torch.from_numpy(gt))
    want = jl.kits_composite_dice(jnp.asarray(pred), jnp.asarray(gt))
    for k in ("kidney_composite", "tumor"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(lr_schedule="poly", warmup_steps=10, steps=100),
    dict(lr_schedule="poly", warmup_steps=0, steps=50, poly_power=0.9),
    dict(lr_schedule="cosine", warmup_steps=5, steps=60),
    dict(lr_schedule="cosine", warmup_steps=0, steps=40),
    dict(lr_schedule="const", warmup_steps=7, steps=30),
])
def test_lr_schedules_match_optax(kw):
    tcfg = dict(lr=3e-4, **kw)
    got = make_lr_schedule(TrainConfig(**tcfg))
    want = jax_make_lr_schedule(JTrainConfig(**tcfg))
    for count in [0, 1, 2, 4, 5, 6, 9, 10, 11, 25, 39, 40, 41, 59, 60, 99, 100, 150]:
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"count {count}")


def _param_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("kw", [
    dict(optimizer="adamw", weight_decay=1e-2, warmup_steps=2, lr=1e-2),
    dict(optimizer="sgd", weight_decay=1e-2, warmup_steps=0, lr=1e-2, lr_schedule="cosine"),
    dict(optimizer="adamw", weight_decay=1e-5, warmup_steps=0, lr=1e-3, grad_scale=20.0),
    dict(optimizer="sgd", weight_decay=0.0, warmup_steps=1, lr=1e-2, grad_scale=20.0),
    dict(optimizer="adamw", weight_decay=1e-3, warmup_steps=1, lr=1e-2, grad_accum=2),
    dict(optimizer="sgd", weight_decay=1e-3, warmup_steps=0, lr=1e-2, grad_accum=2),
])
def test_optimizer_matches_optax_on_identical_grads(kw):
    """Several updates from the same gradients (numpy in on both sides);
    grad_scale = 20 makes the global norm exceed 12, so the clip is
    active."""
    kw = dict(kw)
    scale = kw.pop("grad_scale", 1.0)
    tcfg = dict(steps=20, **kw)
    params = _param_tree(0)
    names = sorted(params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tx = jax_make_optimizer(JTrainConfig(**tcfg))
    jstate = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in names]
    opt = make_optimizer(TrainConfig(**tcfg), tp)
    for step in range(6):
        grads = {k: v * scale for k, v in _param_tree(100 + step).items()}
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step(tp, [torch.from_numpy(grads[k]) for k in names])
        for k, t in zip(names, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-9,
                                       err_msg=f"step {step} param {k}")


def test_train_step_loss_and_grad_norm_match_jax():
    """One train step on identical weights and data (augmentation off):
    the port's aux loss and pre-clip grad_norm against JAX's step, with the
    compact-dtype inputs and the label clamp (labels up to 3, K = 2)."""
    small = dict(num_classes=2, base_features=8, num_levels=2, compute_dtype="float32")
    jmodel = JUNet3D(JModelConfig(**small))
    params = jax_init_params(jmodel, jax.random.key(0), (16, 16, 16))
    flat = _flat(jax.device_get(params))  # the JAX step donates its state
    tcfg = dict(warmup_steps=0, lr_schedule="const", lr=1e-3)
    jstate = jax_create_train_state(jmodel, params, JTrainConfig(**tcfg))
    rng = np.random.default_rng(3)
    images = rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float16)
    labels = rng.integers(0, 4, (2, 16, 16, 16)).astype(np.uint8)
    _, jaux = jax_make_train_step(jmodel)(jstate, jnp.asarray(images), jnp.asarray(labels))

    model = load_state(create_train_model(ModelConfig(**small), device="cpu"), flat)
    state = create_train_state(model, TrainConfig(**tcfg))
    aux = make_train_step(model)(state, torch.from_numpy(images), torch.from_numpy(labels))
    assert state.step == 1 and state.optimizer.count == 1
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(aux["grad_norm"]), float(jaux["grad_norm"]), rtol=1e-4)


def test_overfit_single_patch():
    """Loss → ~0 when overfitting one patch (as the JAX package's test)."""
    cfg = ModelConfig(num_classes=2, base_features=8, num_levels=2, compute_dtype="float32")
    tcfg = TrainConfig(lr=3e-3, warmup_steps=0, lr_schedule="const", weight_decay=0.0)
    model = init_params(create_train_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    state = create_train_state(model, tcfg)
    step = make_train_step(model)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(1, 16, 16, 16, 1)).astype(np.float32))
    labels = np.zeros((1, 16, 16, 16), np.int64)
    labels[0, 4:12, 4:12, 4:12] = 1
    labels = torch.from_numpy(labels)
    losses = [float(step(state, images, labels)["loss"]) for _ in range(120)]
    assert losses[-1] < 0.15, f"did not overfit: {losses[::20]}"
    assert losses[-1] < losses[0] * 0.2
    dice = make_eval_step(model)(images, labels)
    assert float(dice[1]) > 0.9


def tiny_config(**tr):
    train_kw = dict(patch_size=(16, 16, 16), batch_size=2, steps=30, lr=1e-2, warmup_steps=5,
                    val_every=30, ckpt_every=30, augment=True, weight_decay=0.0)
    train_kw.update(tr)
    return Config(
        name="tiny",
        model=ModelConfig(num_classes=3, base_features=8, num_levels=2, compute_dtype="float32"),
        preprocess=PreprocessConfig(spacing=(2.0, 2.0, 2.0), hu_stats=None),
        train=TrainConfig(**train_kw),
    )


def test_train_loop_end_to_end_and_resume(tmp_path):
    write_phantom_dataset(tmp_path / "data", num_cases=2, shape=(48, 48, 32))
    cfg = tiny_config()
    state, aux = train(cfg, data_root=tmp_path / "data", out_dir=tmp_path / "run",
                       max_steps=12, log_every=6, device="cpu")
    assert state.step == 12
    assert np.isfinite(float(aux["loss"])) and np.isfinite(float(aux["grad_norm"]))
    lines = [json.loads(l) for l in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [l["step"] for l in lines if "imgs_per_s" in l] == [6, 12]
    assert any("val_dice" in l for l in lines)
    rt = Config.from_json((tmp_path / "run" / "config.json").read_text())
    assert rt.train.patch_size == (16, 16, 16)
    ckpt = CheckpointManager(tmp_path / "run" / "ckpt")
    assert ckpt.latest_step() == 12
    saved = ckpt.restore()
    assert saved["step"] == 12 and saved["optimizer"]["count"] == 12

    state2, _ = train(cfg, data_root=tmp_path / "data", out_dir=tmp_path / "run",
                      max_steps=16, resume=True, log_every=4, device="cpu")
    assert state2.step == 16 and state2.optimizer.count == 16
    assert ckpt.latest_step() == 16
    lines = [json.loads(l) for l in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [l["step"] for l in lines if "imgs_per_s" in l] == [6, 12, 16]


def test_keep_best_tracks_full_volume_dice(tmp_path, monkeypatch):
    """With val_full_every set, keep-best keys on the full-volume Dice, not
    the patch estimate; patch-only saves are latest-N only."""
    import runet_tpu_torch.train.loop as loop_mod

    write_phantom_dataset(tmp_path / "data", num_cases=2, shape=(48, 48, 32))
    patch_vals = iter([0.1, 0.2, 0.3, 0.4, 0.5, 0.6])
    full_vals = iter([0.9, 0.5, 0.4])
    monkeypatch.setattr(loop_mod, "validate_patches",
                        lambda *a, **k: (next(patch_vals), np.zeros(3)))
    monkeypatch.setattr(loop_mod, "validate_full", lambda *a, **k: next(full_vals))
    cfg = tiny_config(val_every=2, val_full_every=2, ckpt_every=100, augment=False)
    train(cfg, data_root=tmp_path / "data", out_dir=tmp_path / "run", max_steps=6,
          log_every=6, device="cpu")
    ckpt = CheckpointManager(tmp_path / "run" / "ckpt")
    assert ckpt.best_step() == 2
    assert ckpt.best_steps(2) == [2, 4]
    assert ckpt.all_steps() == [2, 4, 6]


def test_checkpoint_retention_keeps_latest_and_best(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2, latest_keep=2)
    for step, m in [(1, 0.5), (2, None), (3, 0.9), (4, 0.1), (5, None), (6, None)]:
        ckpt.save(step, {"step": step}, metrics=None if m is None else {"val_dice": m})
    assert ckpt.all_steps() == [1, 3, 5, 6]
    assert ckpt.best_step() == 3 and ckpt.latest_step() == 6
    assert ckpt.restore(3)["step"] == 3
    assert sorted(p.name for p in tmp_path.glob("step_*.pt")) == [
        f"step_{s:08d}.pt" for s in (1, 3, 5, 6)]


def test_validate_full_and_config_errors(tmp_path):
    from runet_tpu_torch.config import InferConfig
    from runet_tpu_torch.data.dataset import prepare_dataset

    write_phantom_dataset(tmp_path / "data", num_cases=1, shape=(40, 40, 24))
    cfg = tiny_config()
    cases = prepare_dataset(tmp_path / "data", cfg.preprocess, device="cpu")
    model = init_params(create_train_model(cfg.model, device="cpu"),
                        torch.Generator().manual_seed(0))
    icfg = InferConfig(patch_size=(16, 16, 16), single_pass_ratio=8.0)
    score = validate_full(model, cases, icfg, cfg.model.num_classes, device="cpu")
    assert 0.0 <= score <= 1.0
    with pytest.raises(ValueError, match="multiple"):
        train(tiny_config(val_every=4, val_full_every=6), cases=cases, device="cpu",
              out_dir=tmp_path / "r1")
    # A chunk stops only at multiples of steps_per_dispatch: every interval
    # must divide by it.
    with pytest.raises(ValueError, match="divisible"):
        train(tiny_config(steps_per_dispatch=4), cases=cases, device="cpu",
              out_dir=tmp_path / "r2", log_every=6)
    # A data-parallel mesh is a torch.distributed DeviceMesh
    # (parallel.comm.make_mesh); anything else is refused.
    with pytest.raises(TypeError, match="DeviceMesh"):
        train(tiny_config(), cases=cases, device="cpu", out_dir=tmp_path / "r3", mesh=object())
    assert create_train_model(ModelConfig(remat=True, base_features=4, num_levels=2),
                              device="cpu").remat


def _multi_step_setup(deep):
    cfg = ModelConfig(num_classes=3, base_features=8, num_levels=3, compute_dtype="float32",
                      deep_supervision=deep)
    tcfg = TrainConfig(lr=1e-2, warmup_steps=0, lr_schedule="const")
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.standard_normal((2, 2, 16, 16, 16, 1)).astype(np.float16))
    labels = torch.from_numpy(rng.integers(0, 3, (2, 2, 16, 16, 16)).astype(np.uint8))

    def fresh():
        model = init_params(create_train_model(cfg, device="cpu"),
                            torch.Generator().manual_seed(1))
        return model, create_train_state(model, tcfg)

    return fresh, images, labels


@pytest.mark.parametrize("augment,elastic,deep", [(False, False, False), (True, True, True)])
def test_multi_train_step_equals_single_steps(augment, elastic, deep):
    """steps_per_dispatch = 2: K micro-steps in one call leave the
    parameters of K single steps bit for bit (the same draws, draw for draw,
    from the per-step seeds) and return the chunk's mean aux scalars."""
    fresh, images, labels = _multi_step_setup(deep)
    seeds = [11, 12]
    gens = (torch.Generator(), torch.Generator())
    m1, s1 = fresh()
    step = make_train_step(m1, augment=augment, elastic=elastic)
    singles = [step(s1, images[i], labels[i], gens if augment else None,
                    seeds[i] if augment else None) for i in range(2)]
    m2, s2 = fresh()
    multi = make_multi_train_step(m2, 2, augment=augment, elastic=elastic)
    aux = multi(s2, images, labels, *((gens, seeds) if augment else ()))
    assert s2.step == 2 and s2.optimizer.count == 2
    for (n, a), b in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(a, b), n
    assert ("ds_aux_loss" in aux) == deep
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), np.mean([float(a[k]) for a in singles]),
                                   rtol=1e-6)
    with pytest.raises(ValueError):
        multi(s2, images[:1], labels[:1])


def test_train_loop_with_every_train_switch(tmp_path, monkeypatch):
    """``train()`` with deep supervision, elastic warps, remat and
    steps_per_dispatch = 2 on the CPU: chunked steps, the tail and a
    K-misaligned resume fall back to single steps on slices of a superbatch,
    events land on their intervals, ``ds_aux_loss`` is logged."""
    import dataclasses

    import runet_tpu_torch.train.loop as loop_mod

    # Validation is held elsewhere; here it only has to fire (and save the
    # checkpoint of the last step).
    monkeypatch.setattr(loop_mod, "validate_patches", lambda *a, **k: (0.5, np.zeros(3)))
    write_phantom_dataset(tmp_path / "data", num_cases=2, shape=(48, 48, 32))
    cfg = tiny_config(steps_per_dispatch=2, elastic=True, val_every=4, ckpt_every=2)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, deep_supervision=True, remat=True, num_levels=3, fused_kernel="v1"))
    state, aux = train(cfg, data_root=tmp_path / "data", out_dir=tmp_path / "run",
                       max_steps=5, log_every=2, device="cpu")
    assert state.step == 5 and np.isfinite(float(aux["loss"]))
    lines = [json.loads(l) for l in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    logged = [l for l in lines if "imgs_per_s" in l]
    assert [l["step"] for l in logged] == [2, 4, 5]
    assert all("ds_aux_loss" in l and np.isfinite(l["ds_aux_loss"]) for l in logged)
    ckpt = CheckpointManager(tmp_path / "run" / "ckpt")
    assert ckpt.latest_step() == 5
    assert {"ds1.kernel", "ds1.bias"} <= set(ckpt.restore()["params"])
    # Resume at 5 (not a multiple of 2): one single step, then a full chunk.
    state2, _ = train(cfg, data_root=tmp_path / "data", out_dir=tmp_path / "run",
                      max_steps=8, resume=True, log_every=2, device="cpu")
    assert state2.step == 8 and state2.optimizer.count == 8


def test_train_entry_points_default_to_cuda(tmp_path):
    """Without a device argument every training entry point asks for CUDA
    and raises where there is none (never a quiet CPU run)."""
    from runet_tpu_torch.data.dataset import index_cases, prepare_case, prepare_dataset
    from runet_tpu_torch.data.pipeline import PatchLoader

    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is valid")
    write_phantom_dataset(tmp_path / "data", num_cases=1, shape=(40, 40, 24))
    cfg = tiny_config()
    cases = prepare_dataset(tmp_path / "data", cfg.preprocess, device="cpu")
    model = create_train_model(cfg.model, device="cpu")
    calls = [
        lambda: train(cfg, cases=cases, out_dir=tmp_path / "run", max_steps=1),
        lambda: create_train_model(cfg.model),
        lambda: prepare_case(index_cases(tmp_path / "data")[0], cfg.preprocess),
        lambda: validate_patches(make_eval_step(model), cases, (16, 16, 16), 3),
        lambda: validate_full(model, cases, cfg.infer, 3),
        lambda: PatchLoader(cases, batch_size=1, patch_size=(16, 16, 16)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
