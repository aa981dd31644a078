"""The ``fused_kernel="v2"`` and ``"v1"`` kernels' plain versions and autograd
Functions, and the model's switches (``fused_kernel``, ``upsample_mode``,
``deep_supervision``, ``remat``), against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
Pallas kernels run in interpret mode (``interpret=True`` or
``fb.FORCE_INTERPRET``), as the JAX package's own tests run them; the v1
kernel in bf16 is the exception, since XLA's CPU backend has no bf16 x bf16
→ f32 dot for its K = 27·C contraction: there the kernel is replaced by the
JAX package's plain reference of the same contract
(``reference_conv3x3_dhcw``) while the custom_vjp around it stays.
Tolerances:

- conv outputs in f32: 2e-5 absolute (two f32 summation orders of ~27·C
  unit-variance products scaled by 1/sqrt(27·C)); sums and square sums 1e-4
  relative to the channel's Σ|y| or Σy².
- conv outputs in bf16: one bf16 ulp (2^-7 relative), or 1e-3 of the
  tensor's largest magnitude near zero.
- Functions' gradients: as ``tests/test_torch_grad.py`` holds the v2m one
  (f32: 1e-4 of the tensor's largest magnitude; bf16: 2^-7 relative plus 2^-7
  of it).
- whole models in f32: logits 5e-4 absolute (the bound the JAX package holds
  its fused model to against XLA), deep-supervision loss 1e-5 relative,
  gradients 1e-4 of each tensor's largest magnitude (2e-3 for the 2-level
  fused-kernel models, whose JAX side sums in Pallas tile order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import runet_tpu.kernels.fused_block as jfb
from runet_tpu.config import ModelConfig as JModelConfig
from runet_tpu.models.unet3d import UNet3D as JUNet3D
from runet_tpu.models.unet3d import create_train_model as jax_create_train_model
from runet_tpu.models.unet3d import init_params as jax_init_params
from runet_tpu.train.losses import deep_supervised_loss as jax_ds_loss
from runet_tpu.train.losses import dice_ce_loss as jax_dice_ce_loss
from runet_tpu_torch.config import ModelConfig
from runet_tpu_torch.kernels import fused_block
from runet_tpu_torch.models.unet3d import UNet3D, create_train_model, init_params
from runet_tpu_torch.params import load_state, torch_to_flax
from runet_tpu_torch.train.losses import deep_supervised_loss, dice_ce_loss


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _pair(a, dtype):
    """numpy f32 → (torch, jax) tensors of ``dtype`` holding the same values."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy(), getattr(jnp, dtype))


def _jax_pad(xj, version):
    """One sample in the kernel's layout → the D/H zero-padded slab the
    Pallas impls take."""
    pads = ((1, 1), (1, 1), (0, 0), (0, 0)) if version == "v1" else ((1, 1), (0, 0), (1, 1), (0, 0))
    return jnp.pad(xj, pads)


def _layout(a, version):
    """(B, D, C, H, W) numpy → the layout of ``version``."""
    return np.ascontiguousarray(a.transpose(0, 1, 3, 2, 4)) if version == "v1" else a


@pytest.fixture
def v1_reference_in_bf16(monkeypatch, request):
    """For the (v1, bfloat16) case only: the v1 Pallas kernel gives way to
    the JAX package's plain reference (see the module docstring)."""
    params = request.node.callspec.params
    if params.get("version") == "v1" and params.get("dtype") == "bfloat16":
        monkeypatch.setattr(jfb, "_conv3x3_dhcw_impl",
                            lambda xp, w, interpret=False: jfb.reference_conv3x3_dhcw(xp, w))


JAX_VJP = {"v2": jfb.conv3x3_dchw, "v1": jfb.conv3x3_dhcw}
PLAIN = {"v2": fused_block.conv3x3_stats_v2_plain, "v1": fused_block.conv3x3_stats_dhcw_plain}
FUNCTION = {"v2": fused_block.ConvStatsV2, "v1": fused_block.ConvStatsV1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("version", ["v2", "v1"])
def test_variant_plain_matches_pallas_kernel(version, dtype, v1_reference_in_bf16):
    D, C, H, W, Cout = 2, 16, 8, 128, 16
    rng = np.random.default_rng(0)
    x = _layout(rng.standard_normal((1, D, C, H, W)).astype(np.float32), version)
    w = (rng.standard_normal((3, 3, 3, C, Cout)) / np.sqrt(27 * C)).astype(np.float32)
    (xt, xj), (wt, wj) = _pair(x, dtype), _pair(w, dtype)
    # Looked up at call time, so the fixture's replacement is seen.
    impl = jfb._conv3x3_dhcw_impl if version == "v1" else jfb._conv3x3_dchw_impl
    yj, sj, qj = impl(_jax_pad(xj[0], version), wj, interpret=True)
    y, m, q = PLAIN[version](xt, wt)
    n = D * H * W
    want = _np(yj)
    got = y[0].float().numpy()
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    else:
        tol = 2.0 ** -7 * np.abs(want) + 1e-3 * np.abs(want).max()
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    ch_axes = (0, 1, 3) if version == "v1" else (0, 2, 3)
    rtol = 1e-4 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(m[0].numpy() * n, _np(sj), rtol=0,
                               atol=rtol * np.abs(want).sum(axis=ch_axes).max())
    np.testing.assert_allclose(q[0].numpy() * n, _np(qj), rtol=rtol)


def _assert_grad_close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    tol = 1e-4 * scale if dtype == "float32" else 2.0 ** -7 * np.abs(want) + 2.0 ** -7 * scale
    assert (np.abs(got - want) <= tol).all(), (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("version", ["v2", "v1"])
def test_variant_function_matches_custom_vjp(version, dtype, v1_reference_in_bf16):
    """x and w gradients through y AND both moments, against jax.grad of the
    version's custom_vjp (Pallas forward and dx in interpret mode)."""
    D, C, H, W, Cout = 2, 16, 8, 128, 16
    rng = np.random.default_rng(2)
    x = _layout(rng.standard_normal((1, D, C, H, W)).astype(np.float32), version)
    w = (rng.standard_normal((3, 3, 3, C, Cout)) / np.sqrt(27 * C)).astype(np.float32)
    (xt, xj), (wt, wj) = _pair(x, dtype), _pair(w, dtype)
    xt.requires_grad_()
    wt.requires_grad_()
    cy = _layout(rng.standard_normal((1, D, Cout, H, W)).astype(np.float32) * 0.1, version)[0]
    cs = rng.standard_normal(Cout).astype(np.float32) * 1e-3
    cq = rng.standard_normal(Cout).astype(np.float32) * 1e-3

    def jloss(xx, ww):
        y, s, q = JAX_VJP[version](_jax_pad(xx[0], version), ww, True)
        return jnp.sum(y.astype(jnp.float32) * cy) + jnp.sum(s * cs) + jnp.sum(q * cq)

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(xj, wj)
    y, s, q = FUNCTION[version].apply(xt, wt, None)
    loss = ((y.float() * torch.from_numpy(cy)[None]).sum() + (s * torch.from_numpy(cs)).sum()
            + (q * torch.from_numpy(cq)).sum())
    loss.backward()
    assert xt.grad.dtype == xt.dtype and wt.grad.dtype == wt.dtype
    _assert_grad_close(xt.grad.float().numpy(), _np(jgx), dtype)
    _assert_grad_close(wt.grad.float().numpy(), _np(jgw), dtype)


@pytest.mark.parametrize("cin,cout", [(1, 16), (20, 24)])
def test_conv_in_stats_dhcw_batch_matches_jax(cin, cout):
    """The batched v1 wrapper (any Cin/Cout, B = 2) against the JAX one,
    which pads channels to 16 for its kernel."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, 8, cin, 128)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    yj, mj, qj = jfb.conv_in_stats_dhcw_batch(jnp.asarray(x), jnp.asarray(w), interpret=True)
    y, m, q = fused_block.conv_in_stats_dhcw_batch(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(y.numpy(), _np(yj), atol=2e-5, rtol=0)
    np.testing.assert_allclose(m.numpy(), _np(mj), atol=1e-5)
    np.testing.assert_allclose(q.numpy(), _np(qj), rtol=1e-4)


def test_conv_in_stats_dchw_batch_v2_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 2, 20, 8, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 20, 24)) / np.sqrt(27 * 20)).astype(np.float32)
    yj, mj, qj = jfb.conv_in_stats_dchw_batch(jnp.asarray(x), jnp.asarray(w), interpret=True,
                                              version="v2")
    y, m, q = fused_block.conv_in_stats_dchw_batch(torch.from_numpy(x), torch.from_numpy(w),
                                                   version="v2")
    np.testing.assert_allclose(y.numpy(), _np(yj), atol=2e-5, rtol=0)
    np.testing.assert_allclose(m.numpy(), _np(mj), atol=1e-5)
    np.testing.assert_allclose(q.numpy(), _np(qj), rtol=1e-4)


def test_variants_reject_unknown_values_and_never_launch_on_cpu():
    x, k = torch.zeros((1, 2, 4, 4, 8)), torch.zeros((3, 3, 3, 4, 8))
    with pytest.raises(ValueError):
        fused_block.conv_in_stats_dchw_batch(x, k, version="v3")
    with pytest.raises(ValueError):
        fused_block.conv_in_stats_dchw_batch(x, k, version="v1")  # another layout: own wrapper
    with pytest.raises(ValueError):
        UNet3D(ModelConfig(fused_kernel="v3", base_features=4, num_levels=2), device="cpu")
    before = (fused_block.launches, fused_block.v2_launches, fused_block.v1_launches)
    fused_block.conv_in_stats_dchw_batch(x, k, version="v2")
    fused_block.conv_in_stats_dhcw_batch(x.permute(0, 1, 3, 2, 4), k)
    assert (fused_block.launches, fused_block.v2_launches, fused_block.v1_launches) == before


# ---- model switches ----


def _jcfg(cfg: ModelConfig, **over) -> JModelConfig:
    return JModelConfig(**{**dataclasses.asdict(cfg), **over})


def _model_grads(model):
    return {n.replace(".", "/"): p.grad.numpy() for n, p in model.named_parameters()}


def _assert_model_grads_close(grads, jgrads, rel):
    assert sorted(grads) == sorted(jgrads)
    for name, want in jgrads.items():
        got = grads[name].reshape(want.shape)
        tol = rel * np.abs(want).max()
        assert np.abs(got - want).max() <= tol, (name, np.abs(got - want).max(), tol)


@pytest.mark.parametrize("version", ["v1", "v2", "v2m"])
def test_unet_fused_kernel_values_match_jax_forward_and_grad(version):
    """The 2-level base-16 U-Net at (1, 4, 8, 128, 1), the geometry the JAX
    package's own fused-model test uses, under each ``fused_kernel`` value:
    JAX runs its Pallas kernels in interpret mode where its gates admit
    them, the port its plain versions with the same routing (v1: permutes
    around each block)."""
    cfg = ModelConfig(num_classes=2, base_features=16, num_levels=2, compute_dtype="float32",
                      fused_kernel=version)
    jmodel = JUNet3D(_jcfg(cfg))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 4, 8, 128, 1)).astype(np.float32)
    labels = rng.integers(0, 2, (1, 4, 8, 128)).astype(np.int32)
    model = init_params(create_train_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    params = _unflatten(torch_to_flax(model))

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        return jax_dice_ce_loss(logits, jnp.asarray(labels))[0], logits

    jfb.FORCE_INTERPRET = True
    try:
        (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    finally:
        jfb.FORCE_INTERPRET = False
    logits = model(torch.from_numpy(x))
    loss, _ = dice_ce_loss(logits, torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    _assert_model_grads_close(_model_grads(model), _flat(jax.device_get(jg)), 2e-3)


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


SMALL = dict(num_classes=3, base_features=8, max_features=16, num_levels=4,
             compute_dtype="float32")


def _jax_init(cfg: ModelConfig, key=0, patch=(16, 16, 16)):
    jmodel = jax_create_train_model(_jcfg(cfg))
    return jmodel, jax_init_params(jmodel, jax.random.key(key), patch)


def test_convtranspose_model_matches_jax_and_roundtrips():
    cfg = ModelConfig(**{**SMALL, "num_levels": 3}, upsample_mode="convtranspose")
    jmodel, params = _jax_init(cfg)
    flat = _flat(jax.device_get(params))
    assert "dec0/ConvTranspose_0/kernel" in flat and "dec0/Conv_0/kernel" not in flat
    model = load_state(create_train_model(cfg, device="cpu"), flat)
    back = torch_to_flax(model)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 16, 16, 16)).astype(np.int32)

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        return jax_dice_ce_loss(logits, jnp.asarray(labels))[0], logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    logits = model(torch.from_numpy(x))
    loss, _ = dice_ce_loss(logits, torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    _assert_model_grads_close(_model_grads(model), _flat(jax.device_get(jg)), 1e-4)


def test_convtranspose_init_uses_flax_fan_in():
    cfg = ModelConfig(base_features=16, max_features=64, num_levels=3,
                      upsample_mode="convtranspose")
    model = init_params(create_train_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    k = model.dec1.ConvTranspose_0.kernel
    assert tuple(k.shape) == (2, 2, 2, 64, 32)
    np.testing.assert_allclose(float(k.detach().std()), (8 * 64) ** -0.5, rtol=0.05)


def test_deep_supervision_outputs_loss_and_grads_match_jax():
    cfg = ModelConfig(**SMALL, deep_supervision=True)
    jmodel, params = _jax_init(cfg)
    flat = _flat(jax.device_get(params))
    assert {"ds1/kernel", "ds1/bias", "ds2/kernel", "ds2/bias"} <= set(flat)
    model = load_state(create_train_model(cfg, device="cpu"), flat)
    back = torch_to_flax(model)
    for k, v in flat.items():
        assert back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 16, 16, 16)).astype(np.int32)

    def jloss(p):
        logits, aux_logits = jmodel.apply({"params": p}, jnp.asarray(x), deep_outputs=True)
        loss, aux = jax_ds_loss(logits, aux_logits, jnp.asarray(labels))
        return loss, (logits, aux_logits, aux)

    (jl, (jlogits, jaux_logits, jaux)), jg = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    logits, aux_logits = model(torch.from_numpy(x), deep_outputs=True)
    assert [tuple(a.shape) for a in aux_logits] == [(2, 8, 8, 8, 3), (2, 4, 4, 4, 3)]
    for a, ja in zip(aux_logits, jaux_logits):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(ja), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=2e-4, rtol=2e-4)
    loss, aux = deep_supervised_loss(logits, aux_logits, torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert sorted(aux) == sorted(jaux)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k].detach()), float(v), rtol=1e-5, atol=1e-7)
    _assert_model_grads_close(_model_grads(model), _flat(jax.device_get(jg)), 1e-4)
    # The default call does not run the aux heads and returns logits alone.
    plain = model(torch.from_numpy(x))
    assert torch.equal(plain, logits)


def test_deep_supervision_heads_follow_depth():
    two = UNet3D(ModelConfig(base_features=4, num_levels=2, deep_supervision=True), device="cpu")
    three = UNet3D(ModelConfig(base_features=4, num_levels=3, deep_supervision=True), device="cpu")
    assert not hasattr(two, "ds1") and hasattr(three, "ds1") and not hasattr(three, "ds2")
    logits, aux = three(torch.zeros((1, 8, 8, 8, 1)), deep_outputs=True)
    assert len(aux) == 1 and tuple(aux[0].shape) == (1, 4, 4, 4, 3)


@pytest.mark.parametrize("version", ["v2m", "v1"])
def test_remat_gradients_equal_plain_bit_for_bit(version):
    """``remat`` recomputes each block in the backward: the same arithmetic
    in the same order, so on the CPU every gradient equals the non-remat
    one exactly, and the parameter names do not change."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 3, (2, 16, 16, 16)))
    grads = []
    for remat in (False, True):
        cfg = ModelConfig(**{**SMALL, "num_levels": 3}, remat=remat, deep_supervision=True,
                          fused_kernel=version)
        model = init_params(create_train_model(cfg, device="cpu"),
                            torch.Generator().manual_seed(3))
        logits, aux = model(x, deep_outputs=True)
        deep_supervised_loss(logits, aux, labels)[0].backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert list(grads[0]) == list(grads[1])
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


def test_remat_is_off_outside_training():
    cfg = ModelConfig(base_features=4, num_levels=2, remat=True)
    assert not UNet3D(cfg, device="cpu").remat
    assert create_train_model(cfg, device="cpu").remat
