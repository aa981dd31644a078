"""The port's backward against JAX on the CPU: the weight-gradient kernels'
plain versions against the Pallas dw kernels (interpret mode), the autograd
Functions against the custom_vjps, and the whole train model against
``jax.grad`` through ``create_train_model``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, with their reasons:

- dw (f32 sums of exact bf16 products, summed in different orders): within
  1e-5 of the same sum over |x|·|g|.
- Functions in f32: both compute the same f32 convolutions in different
  orders; gradients within 1e-4 of their tensor's largest magnitude.
- Functions in bf16: both round y, the folded cotangent, dx and dw to bf16
  at the same places, but their f32 sums differ in order, so a value may
  land one bf16 ulp apart (2^-7 relative) and that propagates once through
  the fold; within 2^-7 relative plus 2^-7 of the tensor's largest
  magnitude.
- Whole model in f32: loss within 1e-5 relative; every parameter gradient
  within 1e-4 of its tensor's largest magnitude.

The last test holds ``chip_smoke.py``'s gradient reference gate to its
purpose on the CPU: it passes a correct bf16 backward summed in another
order and fails a backward with a fault in it.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from runet_tpu.config import ModelConfig as JModelConfig
from runet_tpu.kernels.fused_block import conv3x3_dchw_dw, conv3x3_dchw_m
from runet_tpu.kernels.strided_conv import conv3x3_s2_dw as jax_s2_dw
from runet_tpu.kernels.strided_conv import conv_s2_stats_dchw_batch as jax_s2_batch
from runet_tpu.models.unet3d import create_train_model as jax_create_train_model
from runet_tpu.models.unet3d import init_params as jax_init_params
from runet_tpu.train.losses import dice_ce_loss as jax_dice_ce_loss
from runet_tpu_torch.config import ModelConfig
from runet_tpu_torch.kernels import fused_block, strided_conv
from runet_tpu_torch.models.unet3d import create_train_model, init_params
from runet_tpu_torch.params import load_state, torch_to_flax
from runet_tpu_torch.train.losses import dice_ce_loss


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def _bf16(a):
    """numpy f32 → (torch bf16, jax bf16) holding the same values."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def test_conv3x3_dw_plain_matches_pallas_dw():
    D, C, H, Cout, W = 2, 16, 8, 16, 64
    rng = np.random.default_rng(0)
    xt, xj = _bf16(rng.standard_normal((1, D, C, H, W)))
    gt, gj = _bf16(rng.standard_normal((1, D, Cout, H, W)))
    xp = jnp.pad(xj[0], ((1, 1), (0, 0), (1, 1), (0, 0)))
    want = _np(conv3x3_dchw_dw(xp, gj[0], interpret=True))
    got = fused_block.conv3x3_dw(xt, gt).numpy()
    bound = fused_block.conv3x3_dw_plain(xt.abs(), gt.abs()).numpy()
    assert got.shape == (3, 3, 3, C, Cout)
    assert (np.abs(got - want) <= 1e-5 * bound).all(), np.abs(got - want).max()


def test_conv3x3_s2_dw_plain_matches_pallas_dw():
    D, C, H, Cout, W = 4, 16, 4, 16, 128
    rng = np.random.default_rng(1)
    xt, xj = _bf16(rng.standard_normal((1, D, C, H, W)))
    gt, gj = _bf16(rng.standard_normal((1, D // 2, Cout, H // 2, W // 2)))
    xp = jnp.pad(xj[0], ((0, 1), (0, 0), (0, 1), (0, 0)))
    want = _np(jax_s2_dw(xp, gj[0], interpret=True))
    got = strided_conv.conv3x3_s2_dw(xt, gt).numpy()
    bound = strided_conv.conv3x3_s2_dw_plain(xt.abs(), gt.abs()).numpy()
    assert got.shape == (3, 3, 3, C, Cout)
    assert (np.abs(got - want) <= 1e-5 * bound).all(), np.abs(got - want).max()


def _assert_grad_close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    if dtype == "float32":
        tol = 1e-4 * scale
    else:
        tol = 2.0 ** -7 * np.abs(want) + 2.0 ** -7 * scale
    assert (np.abs(got - want) <= tol).all(), (np.abs(got - want).max(), scale)


def _cotangent_coefs(seed, yshape, cout):
    rng = np.random.default_rng(seed)
    cy = rng.standard_normal(yshape).astype(np.float32) * 0.1
    cs = rng.standard_normal(cout).astype(np.float32) * 1e-3
    cq = rng.standard_normal(cout).astype(np.float32) * 1e-3
    return cy, cs, cq


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_stats_function_matches_custom_vjp(dtype):
    """x and w gradients through y AND both moments, against jax.grad of
    conv3x3_dchw_m (the v2m custom_vjp, Pallas in interpret mode)."""
    D, C, H, W, Cout = 2, 16, 8, 64, 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, D, C, H, W)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, C, Cout)) / np.sqrt(27 * C)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    xj = jnp.asarray(xt.detach().float().numpy(), jdt)
    wj = jnp.asarray(wt.detach().float().numpy(), jdt)
    cy, cs, cq = _cotangent_coefs(3, (D, Cout, H, W), Cout)

    def jloss(xx, ww):
        y, s, q = conv3x3_dchw_m(jnp.pad(xx[0], ((1, 1), (0, 0), (1, 1), (0, 0))), ww, True)
        return (jnp.sum(y.astype(jnp.float32) * cy) + jnp.sum(s * cs) + jnp.sum(q * cq))

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(xj, wj)
    y, s, q = fused_block.ConvStats.apply(xt, wt, None)
    loss = ((y.float() * torch.from_numpy(cy)[None]).sum() + (s * torch.from_numpy(cs)).sum()
            + (q * torch.from_numpy(cq)).sum())
    loss.backward()
    assert xt.grad.dtype == tdt and wt.grad.dtype == tdt
    _assert_grad_close(xt.grad.float().numpy(), _np(jgx), dtype)
    _assert_grad_close(wt.grad.float().numpy(), _np(jgw), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_s2_function_matches_custom_vjp(dtype):
    """The stride-2 Function (transposed-conv dx, kernel dw) against
    jax.grad of conv_s2_stats_dchw_batch (Pallas in interpret mode)."""
    D, C, H, W, Cout = 4, 16, 4, 128, 16
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, D, C, H, W)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, C, Cout)) / np.sqrt(27 * C)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    xj = jnp.asarray(xt.detach().float().numpy(), jdt)
    wj = jnp.asarray(wt.detach().float().numpy(), jdt)
    cy, cs, cq = _cotangent_coefs(5, (1, D // 2, Cout, H // 2, W // 2), Cout)

    def jloss(xx, ww):
        y, m, q = jax_s2_batch(xx, ww, interpret=True)
        return jnp.sum(y.astype(jnp.float32) * cy) + jnp.sum(m * cs) + jnp.sum(q * cq)

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(xj, wj)
    y, m, q = strided_conv.conv_s2_stats_dchw_batch(xt, wt)
    loss = ((y.float() * torch.from_numpy(cy)).sum() + (m * torch.from_numpy(cs)).sum()
            + (q * torch.from_numpy(cq)).sum())
    loss.backward()
    _assert_grad_close(xt.grad.float().numpy(), _np(jgx), dtype)
    _assert_grad_close(wt.grad.float().numpy(), _np(jgw), dtype)


def test_enc0_function_skips_dx():
    """x without requires_grad (the image into enc0): no dx is computed,
    and w still gets its gradient."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((1, 2, 1, 4, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 1, 8)).astype(np.float32)).requires_grad_()
    n0 = fused_block.launches
    y, m, q = fused_block.conv_in_stats_dchw_batch(x, w)
    (y.sum() + q.sum()).backward()
    assert w.grad is not None and x.grad is None
    assert fused_block.launches == n0  # CPU tensors never launch


SMALL = dict(num_classes=3, base_features=8, max_features=16, num_levels=3,
             compute_dtype="float32")


def test_train_model_loss_and_grads_match_jax():
    """The port's train model against jax.grad of dice_ce_loss through
    create_train_model, same weights (carried by params.py), B = 2, 16³,
    f32 (JAX runs its XLA path on the CPU)."""
    jcfg = JModelConfig(**SMALL)
    jmodel = jax_create_train_model(jcfg)
    params = jax_init_params(jmodel, jax.random.key(0), (16, 16, 16))
    rng = np.random.default_rng(7)
    images = rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 16, 16, 16)).astype(np.int32)

    def jloss(p):
        return jax_dice_ce_loss(jmodel.apply({"params": p}, jnp.asarray(images)),
                                jnp.asarray(labels))[0]

    jl, jg = jax.value_and_grad(jloss)(params)
    jg = _flat(jax.device_get(jg))

    model = create_train_model(ModelConfig(**SMALL), device="cpu")
    load_state(model, _flat(jax.device_get(params)))
    loss, _ = dice_ce_loss(model(torch.from_numpy(images)), torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert len(grads) == len(jg)
    for name, g in grads.items():
        want = jg[name.replace(".", "/")]
        got = g.numpy().reshape(want.shape)
        tol = 1e-4 * np.abs(want).max()
        assert np.abs(got - want).max() <= tol, (name, np.abs(got - want).max(), tol)


def test_torch_to_flax_roundtrips_jax_init():
    """params.py carries a JAX init into the train model and back key for
    key, shape for shape, value for value."""
    jcfg = JModelConfig(**SMALL)
    flat = _flat(jax.device_get(jax_init_params(jax_create_train_model(jcfg),
                                                jax.random.key(1), (16, 16, 16))))
    model = load_state(create_train_model(ModelConfig(**SMALL), device="cpu"), flat)
    back = torch_to_flax(model)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape and back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v)
    assert all(p.requires_grad and p.dtype == torch.float32 for p in model.parameters())


def test_init_params_statistics():
    """flax lecun_normal: std sqrt(1/fan_in), truncated at 2σ of the
    underlying normal (|w| <= 2·sqrt(1/fan_in)/0.8796); zero head bias,
    unit/zero norm affine — and the same statistics as JAX's init."""
    cfg = ModelConfig(num_classes=3, base_features=32, max_features=64, num_levels=2)
    model = init_params(create_train_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    jflat = _flat(jax.device_get(jax_init_params(jax_create_train_model(
        JModelConfig(num_classes=3, base_features=32, max_features=64, num_levels=2)),
        jax.random.key(0), (16, 16, 16))))
    flat = torch_to_flax(model)
    assert sorted(flat) == sorted(jflat)
    for name, w in flat.items():
        if name.endswith("kernel"):
            fan_in = int(np.prod(w.shape[:-1]))
            std = fan_in ** -0.5
            assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-7, name
            assert abs(w.std() / std - 1) < 0.1, (name, w.std(), std)
            assert abs(jflat[name].std() / std - 1) < 0.1, name
            assert abs(w.mean()) < 0.1 * std, name
        elif name.endswith("scale"):
            np.testing.assert_array_equal(w, 1.0)
        else:
            np.testing.assert_array_equal(w, 0.0)
    # The same seed gives the same weights.
    again = torch_to_flax(init_params(create_train_model(cfg, device="cpu"),
                                      torch.Generator().manual_seed(0)))
    for k in flat:
        np.testing.assert_array_equal(flat[k], again[k])


def _small_bf16_grads():
    """(names, gradients) of the small train model in bf16 on the CPU, the
    same weights and batch on every call."""
    model = init_params(create_train_model(ModelConfig(**dict(SMALL, compute_dtype="bfloat16")),
                                           device="cpu"), torch.Generator().manual_seed(2))
    rng = np.random.default_rng(9)
    images = torch.from_numpy(rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 3, (2, 16, 16, 16)))
    loss, _ = dice_ce_loss(model(images), labels)
    names = [n for n, _ in model.named_parameters()]
    return names, torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("case", ["another_summation_order", "dx_taps_not_flipped",
                                  "fold_without_factor_2", "dw_taps_rotated",
                                  "s2_dw_taps_rotated"])
def test_chip_gradient_gate_separates_faults_from_rounding(case, monkeypatch):
    """chip_smoke's gradient reference gate (per-tensor cosine, norms)
    accepts the bf16 CPU path with its convs summed in another order
    (oneDNN off) and rejects each fault in the backward."""
    names, want = _small_bf16_grads()
    ctx = contextlib.nullcontext()
    if case == "another_summation_order":
        ctx = torch.backends.mkldnn.flags(enabled=False)
    elif case == "dx_taps_not_flipped":
        monkeypatch.setattr(torch, "flip", lambda t, dims: t)
    elif case == "fold_without_factor_2":
        fold = fused_block.fold_moment_cotangents
        half = lambda gy, gs, gq, y: fold(gy, gs, 0.5 * gq, y)  # noqa: E731
        monkeypatch.setattr(fused_block, "fold_moment_cotangents", half)
        monkeypatch.setattr(strided_conv, "fold_moment_cotangents", half)
    elif case == "dw_taps_rotated":
        plain = fused_block.conv3x3_dw_plain
        monkeypatch.setattr(fused_block, "conv3x3_dw_plain",
                            lambda x, g: torch.roll(plain(x, g), 1, dims=2))
    else:
        plain = strided_conv.conv3x3_s2_dw_plain
        monkeypatch.setattr(strided_conv, "conv3x3_s2_dw_plain",
                            lambda x, g: torch.roll(plain(x, g), 1, dims=0))
    with ctx:
        _, got = _small_bf16_grads()
    verdict = chip_smoke.grad_agreement(names, got, want)
    assert verdict["ok"] == (case == "another_summation_order"), (
        min(verdict["cos"].values()), verdict["norm_rel"])
