"""The port's attic kernels (plain versions, as they run on the CPU) against
the JAX package's attic Pallas kernels run in interpret mode.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: in f32 both compute the same sums in different orders
(the norm to 1e-5, the conv to 1e-4 absolute at unit-scale inputs, the
gradients to 1e-3, as the JAX package's own parity tests hold its kernels
to XLA); in bf16 an output may differ by one bf16 ulp of the tensor's
largest magnitude (both round an f32 result to bf16, from sums taken in
different orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import runet_tpu.kernels.attic.conv3d as jax_conv3d
from runet_tpu.kernels.attic.conv_v3_deep import conv3x3_v3 as jax_conv3x3_v3
from runet_tpu.kernels.attic.fused_norm import fused_instance_norm_lrelu as jax_fused_norm
from runet_tpu_torch.kernels.attic import conv3d, conv_v3_deep, fused_norm


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _norm_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = rng.normal(1.5, 2.0, size=shape).astype(np.float32)
    scale = rng.normal(1.0, 0.1, size=(C,)).astype(np.float32)
    bias = rng.normal(0.0, 0.1, size=(C,)).astype(np.float32)
    return x, scale, bias


def _to(x, dtype):
    """(torch tensor in dtype, the same values as a JAX array in dtype)."""
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy(), getattr(jnp, dtype))


# ---- fused_norm ----


@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 32), (1, 4, 4, 32, 128), (1, 3, 5, 7, 20)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_norm_plain_matches_pallas(shape, dtype):
    x, scale, bias = _norm_inputs(shape)
    xt, xj = _to(x, dtype)
    got = fused_norm.fused_instance_norm_lrelu(xt, torch.from_numpy(scale),
                                               torch.from_numpy(bias))
    want = _np(jax_fused_norm(xj, jnp.asarray(scale), jnp.asarray(bias), interpret=True))
    assert got.shape == xt.shape and got.dtype == xt.dtype
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        ulp = 2.0 ** -8 * np.abs(want).max()
        assert np.abs(got - want).max() <= ulp, np.abs(got - want).max()


def test_fused_norm_plain_matches_two_pass_reference():
    x, scale, bias = _norm_inputs((2, 4, 6, 5, 24), seed=3)
    args = (torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(fused_norm.fused_instance_norm_lrelu(*args).numpy(),
                               fused_norm.reference_instance_norm_lrelu(*args).numpy(),
                               atol=1e-4)


def test_fused_norm_clamps_the_variance_of_a_constant_channel():
    """A constant channel: E[x²]−µ² may come out below 0 in f32. The port
    clamps it at 0 (as models/norm.py does), so the channel normalizes to
    the bias and the output is finite; the JAX kernel does not clamp
    (``attic/fused_norm.py:91``), a deviation on purpose."""
    x, scale, bias = _norm_inputs((1, 4, 4, 8, 16), seed=4)
    x[..., 3] = 0.1  # its f32 single-pass variance is negative
    xt = torch.from_numpy(x)
    sums, sqs = fused_norm.instance_norm_stats_plain(xt)
    n = 4 * 4 * 8
    assert float(sqs[0, 3] / n - (sums[0, 3] / n) ** 2) < 0
    got = fused_norm.fused_instance_norm_lrelu(xt, torch.from_numpy(scale),
                                               torch.from_numpy(bias)).numpy()
    assert np.isfinite(got).all()
    b = bias[3]
    np.testing.assert_allclose(got[..., 3], b if b >= 0 else b * 1e-2, atol=1e-6)


def test_fused_norm_parts_and_shapes():
    x, scale, bias = _norm_inputs((2, 3, 4, 5, 12), seed=5)
    xt = torch.from_numpy(x)
    s, q = fused_norm.instance_norm_stats(xt)
    s3, q3 = fused_norm.instance_norm_stats(xt.reshape(2, -1, 12))
    assert s.shape == (2, 12) and torch.equal(s, s3) and torch.equal(q, q3)
    np.testing.assert_allclose(s.numpy(), x.reshape(2, -1, 12).sum(1), rtol=1e-5)
    y = fused_norm.instance_norm_lrelu_apply(xt, s / 60, torch.ones(2, 12),
                                             torch.from_numpy(scale), torch.from_numpy(bias))
    assert y.shape == xt.shape
    with pytest.raises(ValueError):
        fused_norm.instance_norm_lrelu_apply(xt, s, torch.ones(2, 11), torch.from_numpy(scale),
                                             torch.from_numpy(bias))


# ---- conv3d ----


@pytest.mark.parametrize("shape,cout", [((4, 16, 128, 16), 24), ((2, 8, 128, 8), 8),
                                        ((2, 8, 17, 16), 24)])
def test_attic_conv_plain_matches_pallas(shape, cout):
    """The Pallas kernel takes W % 128 == 0 only: a narrower W (17, the
    CUDA kernel's narrowest 8 x 32 tile) runs it on x zero-padded on the
    right to 128 columns, which puts at column W the zero that SAME padding
    puts there, and keeps the first W output columns."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, shape[-1], cout)) * 0.1).astype(np.float32)
    W = shape[2]
    xp = np.pad(x, [(0, 0), (0, 0), (0, -W % 128), (0, 0)])
    want = _np(jax_conv3d.conv3x3x3_same(jnp.asarray(xp), jnp.asarray(w),
                                         interpret=True))[:, :, :W]
    got = conv3d.conv3x3x3_same(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(conv3d.reference_conv3x3x3(torch.from_numpy(x),
                                                          torch.from_numpy(w)).numpy(),
                               want, atol=1e-4)


def test_attic_conv_function_grads_match_pallas_vjp(monkeypatch):
    """dx and dw of ``AtticConv`` against ``jax.grad`` of the custom_vjp
    ``pallas_conv3x3`` with its kernel routed through interpret mode (as
    tests/test_pallas_conv.py routes it), loss Σy²."""
    orig = jax_conv3d.conv3x3x3_same
    monkeypatch.setattr(jax_conv3d, "conv3x3x3_same",
                        lambda x, w, interpret=True: orig(x, w, interpret=True))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 128, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 8, 8)) * 0.1).astype(np.float32)
    gx, gw = jax.grad(lambda a, b: jnp.sum(jax_conv3d.pallas_conv3x3(a, b) ** 2),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (conv3d.attic_conv3x3(xt, wt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), _np(gx), atol=1e-3)
    np.testing.assert_allclose(wt.grad.numpy(), _np(gw), atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attic_conv_function_at_an_odd_shape_matches_autograd(dtype):
    """The Function at a shape with no multiple of 8 anywhere, against
    autograd through the plain version itself (in f32, exactly the same
    arithmetic; in bf16 the Function rounds dx once more, to x's dtype)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 7, 5)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 5, 11)) * 0.2).astype(np.float32)
    r = torch.from_numpy(rng.normal(size=(3, 5, 7, 11)).astype(np.float32))
    grads = []
    for fn in (conv3d.attic_conv3x3, conv3d.conv3x3x3_same_plain):
        xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
        wt = torch.from_numpy(w).to(getattr(torch, dtype)).requires_grad_()
        (fn(xt, wt).float() * r).sum().backward()
        grads.append((xt.grad.float(), wt.grad.float()))
    for got, want in zip(*grads):
        if dtype == "float32":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert ((got - want).abs() <= 2.0 ** -7 * want.abs().max()).all()


def test_conv3d_tile_table():
    """The CUDA kernel's block tile switches at W = 16, and above it takes 64
    output channels where the packed Cout is a multiple of 64."""
    assert [conv3d.conv3d_tile(w, 32) for w in (1, 16, 17, 128)] == [
        (16, 16, 32), (16, 16, 32), (8, 32, 32), (8, 32, 32)]
    assert [conv3d.conv3d_tile(w, 64) for w in (8, 16, 17, 128)] == [
        (16, 16, 32), (16, 16, 32), (8, 32, 64), (8, 32, 64)]
    assert [conv3d.conv3d_tile(40, cp) for cp in (32, 64, 96, 128, 256, 320)] == [
        (8, 32, 32), (8, 32, 64), (8, 32, 32), (8, 32, 64), (8, 32, 64), (8, 32, 64)]


def test_attic_conv_gate_matches_jax_and_cpu_is_not_applicable():
    shapes = [(1, 128, 128, 128, 32), (1, 128, 128, 96, 32), (1, 127, 128, 128, 32),
              (1, 128, 128, 128, 4), (128, 128, 128, 32)]
    for s in shapes:
        assert conv3d.conv_shape_ok(s, s[-1]) == jax_conv3d.pallas_conv_shape_ok(s, s[-1])
    assert not conv3d.conv_applicable(torch.zeros((2, 8, 128, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        conv3d.conv3x3x3_same(torch.zeros((1, 2, 8, 8, 8)), torch.zeros((3, 3, 3, 8, 8)))


# ---- conv_v3_deep ----


@pytest.mark.parametrize("shape,td,cout", [
    ((8, 6, 10, 16), 4, 16),
    ((4, 5, 7, 32), 2, 32),
    ((2, 13, 16, 16), 2, 16),   # W = 16: the widest volume of the 16 x 16 tile; ragged H
    ((2, 5, 17, 16), 2, 40),    # W = 17: the 8 x 32 tile; Cout != C
])
def test_v3_plain_matches_pallas(shape, td, cout):
    rng = np.random.default_rng(2)
    D, H, W, C = shape
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, C, cout)) * 0.1).astype(np.float32)
    yj, sj, qj = jax_conv3x3_v3(jnp.asarray(x), jnp.asarray(w), interpret=True, TD=td, BM=64)
    y, s, q = conv_v3_deep.conv3x3_v3(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(y.numpy(), _np(yj), atol=2e-5)
    np.testing.assert_allclose(s.numpy(), _np(sj), rtol=1e-4)
    np.testing.assert_allclose(q.numpy(), _np(qj), rtol=1e-4)


def test_v3_tile_table():
    """The CUDA kernel's block tile switches at W = 16, and its moment
    partials are one per block of that tile."""
    assert [conv_v3_deep.v3_tile(w) for w in (8, 16, 17, 32, 128)] == [
        (16, 16, 32), (16, 16, 32), (8, 32, 64), (8, 32, 64), (8, 32, 64)]
    assert [conv_v3_deep.v3_nblk(4, 13, w) for w in (8, 16, 17, 32, 128)] == [4, 4, 8, 8, 32]
    assert conv_v3_deep.v3_nblk(32, 32, 32) == 128 and conv_v3_deep.v3_nblk(16, 16, 16) == 16


def test_v3_bf16_sums_are_of_the_rounded_output():
    """bf16: y within one bf16 ulp of the Pallas kernel's, and the port's
    Σy, Σy² equal the f32 sums of its OWN rounded y (not of the f32
    accumulator); the Pallas kernel's sums agree to rtol 1e-3 (one-ulp
    differences in y)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 5, 7, 32)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 32, 24)) / np.sqrt(27 * 32)).astype(np.float32)
    xt, xj = _to(x, "bfloat16")
    wt, wj = _to(w, "bfloat16")
    yj, sj, qj = jax_conv3x3_v3(xj, wj, interpret=True, TD=2, BM=64)
    y, s, q = conv_v3_deep.conv3x3_v3(xt, wt)
    assert y.dtype == torch.bfloat16
    yf = y.float()
    torch.testing.assert_close(s, yf.sum((0, 1, 2)), rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(q, (yf * yf).sum((0, 1, 2)), rtol=1e-6, atol=1e-5)
    unrounded = conv3d.conv_ndhwc_f32(xt, wt)
    assert not torch.equal(unrounded, yf)
    assert np.abs(yf.numpy() - _np(yj)).max() <= 2.0 ** -8 * np.abs(_np(yj)).max()
    np.testing.assert_allclose(s.numpy(), _np(sj), rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(q.numpy(), _np(qj), rtol=1e-3)
    yr, sr, qr = conv_v3_deep.reference_conv3x3_ndhwc(xt, wt)
    assert yr.dtype == torch.bfloat16 and sr.shape == (24,)
