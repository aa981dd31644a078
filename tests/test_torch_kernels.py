"""The port's conv+moment kernels (plain versions, as they run on the CPU)
against the JAX package's Pallas kernels run in interpret mode.

Inputs are bf16 values made with numpy from a seed and handed to both
packages. Tolerances: y within one bf16 ulp (both round an f32 sum to bf16,
in different summation orders; near zero, 1e-3 of the largest magnitude);
moments rtol 1e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from runet_tpu.kernels.fused_block import _conv3x3_dchw_m_impl
from runet_tpu.kernels.fused_block import conv_in_stats_dchw_batch as jax_conv_stats
from runet_tpu.kernels.strided_conv import _conv3x3_s2_impl
from runet_tpu_torch.kernels import fused_block, strided_conv
from runet_tpu_torch.kernels.conv_common import COUT_TILE, pack_weight


def _bf16_inputs(shape, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    kt = torch.from_numpy(k).to(torch.bfloat16)
    # The exact bf16 values, for JAX.
    return xt, kt, jnp.asarray(xt.float().numpy(), jnp.bfloat16), jnp.asarray(kt.float().numpy(), jnp.bfloat16)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_y_within_ulp(y, yr):
    y, yr = np.asarray(y, np.float64), np.asarray(yr, np.float64)
    assert y.shape == yr.shape
    tol = 2.0 ** -7 * np.abs(yr) + 1e-3 * np.abs(yr).max()
    assert (np.abs(y - yr) <= tol).all(), np.abs(y - yr).max()


def test_conv3x3_stats_matches_pallas_v2m():
    D, C, H, W, Cout = 4, 16, 8, 64, 32
    xt, kt, xj, kj = _bf16_inputs((1, D, C, H, W), C, Cout, 0)
    xp = jnp.pad(xj[0], ((1, 1), (0, 0), (1, 1), (0, 0)))
    yj, sj, qj = _conv3x3_dchw_m_impl(xp, kj, interpret=True)
    y, mean, sq = fused_block.conv_in_stats_dchw_batch(xt, kt)
    n = D * H * W
    assert_y_within_ulp(y[0].float().numpy(), _np(yj))
    np.testing.assert_allclose(sq[0].numpy(), _np(qj) / n, rtol=1e-3)
    np.testing.assert_allclose(mean[0].numpy(), _np(sj) / n, rtol=1e-3,
                               atol=1e-3 * np.sqrt(_np(qj).max() / n))


@pytest.mark.parametrize("cin,cout", [(1, 16), (20, 24)])
def test_conv_in_stats_batch_matches_jax_v2m(cin, cout):
    """Cin = 1 (enc0) and Cin != Cout, through the JAX batch wrapper with
    its channel padding."""
    xt, kt, xj, kj = _bf16_inputs((1, 4, cin, 8, 64), cin, cout, 1)
    yj, mj, qj = jax_conv_stats(xj, kj, interpret=True, version="v2m")
    y, m, q = fused_block.conv_in_stats_dchw_batch(xt, kt)
    assert_y_within_ulp(y.float().numpy(), _np(yj))
    np.testing.assert_allclose(q.numpy(), _np(qj), rtol=1e-3)
    np.testing.assert_allclose(m.numpy(), _np(mj), rtol=1e-3, atol=1e-3 * np.sqrt(_np(qj).max()))


def test_conv3x3_s2_stats_matches_pallas():
    D, C, H, W, Cout = 4, 16, 4, 128, 32
    xt, kt, xj, kj = _bf16_inputs((1, D, C, H, W), C, Cout, 2)
    xp = jnp.pad(xj[0], ((0, 1), (0, 0), (0, 1), (0, 0)))
    yj, sj, qj = _conv3x3_s2_impl(xp, kj, interpret=True)
    y, mean, sq = strided_conv.conv_s2_stats_dchw_batch(xt, kt)
    n = (D // 2) * (H // 2) * (W // 2)
    assert y.shape == (1, D // 2, Cout, H // 2, W // 2)
    assert_y_within_ulp(y[0].float().numpy(), _np(yj))
    np.testing.assert_allclose(sq[0].numpy(), _np(qj) / n, rtol=1e-3)
    np.testing.assert_allclose(mean[0].numpy(), _np(sj) / n, rtol=1e-3,
                               atol=1e-3 * np.sqrt(_np(qj).max() / n))


def test_conv3x3_s2_batch_equals_loop_over_samples():
    xt, kt, _, _ = _bf16_inputs((2, 4, 8, 6, 10), 8, 24, 3)
    y, m, q = strided_conv.conv_s2_stats_dchw_batch(xt, kt)
    for b in range(2):
        yb, mb, qb = strided_conv.conv_s2_stats_dchw_batch(xt[b:b + 1], kt)
        assert torch.equal(y[b:b + 1], yb)
        torch.testing.assert_close(m[b:b + 1], mb, rtol=0, atol=0)
        torch.testing.assert_close(q[b:b + 1], qb, rtol=0, atol=0)


def test_stride2_pads_high_side_only():
    """Output (d, h, w) reads input rows 2d..2d+2: the SAME pad of a stride-2
    conv on even extents is (0, 1), not torch's symmetric padding=1."""
    x = torch.zeros((1, 4, 1, 4, 4))
    x[0, 0, 0, 0, 0] = 1.0  # first input voxel
    k = torch.zeros((3, 3, 3, 1, 1))
    k[0, 0, 0, 0, 0] = 1.0  # tap (0, 0, 0) reads input (2d, 2h, 2w)
    y, _, _ = strided_conv.conv_s2_stats_dchw_batch(x, k)
    assert y[0, 0, 0, 0, 0] == 1.0 and y.sum() == 1.0
    with pytest.raises(ValueError):
        strided_conv.conv_s2_stats_dchw_batch(torch.zeros((1, 3, 1, 4, 4)), k)


def test_pack_weight_layout():
    rng = np.random.default_rng(4)
    k = torch.from_numpy(rng.standard_normal((3, 3, 3, 5, 40)).astype(np.float32))
    p = pack_weight(k)
    assert p.dtype == torch.bfloat16
    assert p.shape == (27, 2 * COUT_TILE, 16)
    for kd, kh, kw, ci, co in [(0, 0, 0, 0, 0), (2, 1, 0, 4, 39), (1, 2, 2, 3, 17)]:
        assert p[(kd * 3 + kh) * 3 + kw, co, ci] == k[kd, kh, kw, ci, co].to(torch.bfloat16)
    assert p[:, 40:].abs().sum() == 0 and p[:, :, 5:].abs().sum() == 0


def test_cpu_wrappers_take_plain_path_without_launch():
    xt, kt, _, _ = _bf16_inputs((1, 4, 4, 4, 4), 4, 8, 5)
    n1, n2 = fused_block.launches, strided_conv.launches
    a = fused_block.conv_in_stats_dchw_batch(xt, kt)
    b = fused_block.conv3x3_stats_plain(xt, kt)
    strided_conv.conv_s2_stats_dchw_batch(xt, kt)
    assert (fused_block.launches, strided_conv.launches) == (n1, n2)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_plain_conv_f32_matches_torch_conv():
    """In f32 the plain version is an exact SAME conv (no bf16 rounding)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 5, 3, 6, 7)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 3, 3, 3, 4)).astype(np.float32))
    y, m, q = fused_block.conv_in_stats_dchw_batch(x, k)
    ref = torch.nn.functional.conv3d(x.permute(0, 2, 1, 3, 4), k.permute(4, 3, 0, 1, 2),
                                     padding=1).permute(0, 2, 1, 3, 4)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(m, ref.mean(dim=(1, 3, 4)), rtol=1e-4, atol=1e-5)
