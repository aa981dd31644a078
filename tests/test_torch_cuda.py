"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (Hopper, sm_90a) and skips
without one. It imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the kernel and the plain version both accumulate in f32 and
round to bf16, in different orders, so an output may differ by one bf16 ulp
(relative 2^-7), and a value near zero by the f32 accumulation error,
bounded here by 1e-3 of the tensor's largest magnitude. The moments come
from those rounded outputs: sq-means agree to 1e-3 relative, means to 1e-3
of the channel's rms.
"""

import numpy as np
import pytest
import torch

from runet_tpu_torch.kernels import fused_block, strided_conv
from runet_tpu_torch.kernels.conv_common import pack_weight

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(shape, cin, cout, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    k = torch.from_numpy((rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin))
                         .astype(np.float32))
    return x.to(device, torch.bfloat16), k.to(device, torch.bfloat16)


def assert_conv_stats_close(got, want):
    y, m, q = (t.float() for t in got)
    yr, mr, qr = (t.float() for t in want)
    assert y.shape == yr.shape and m.shape == mr.shape
    tol = 2.0 ** -7 * yr.abs() + 1e-3 * yr.abs().max()
    bad = ((y - yr).abs() > tol).sum().item()
    assert bad == 0, f"{bad} outputs beyond tolerance; max err {(y - yr).abs().max().item()}"
    torch.testing.assert_close(q, qr, rtol=1e-3, atol=1e-6)
    rms = qr.clamp_min(0).sqrt()
    assert ((m - mr).abs() <= 1e-3 * rms + 1e-6).all(), (m - mr).abs().max()


@pytest.mark.parametrize("B,D,C,H,W,Cout", [
    (1, 4, 16, 8, 64, 32),
    (1, 6, 1, 10, 40, 24),    # Cin = 1 (enc0), Cout not a tile multiple
    (2, 5, 48, 7, 19, 24),    # ragged tiles, decoder concat width, B = 2
    (1, 3, 70, 3, 5, 40),     # tiny deep-level extents
])
def test_conv3x3_stats_kernel_matches_plain(cuda, B, D, C, H, W, Cout):
    x, k = _inputs((B, D, C, H, W), C, Cout, 0, cuda)
    got = fused_block.conv_in_stats_dchw_batch(x, k, pack_weight(k))
    want = fused_block.conv3x3_stats_plain(x, k)
    torch.cuda.synchronize()
    assert_conv_stats_close(got, want)


def test_conv3x3_stats_kernel_is_deterministic(cuda):
    x, k = _inputs((1, 8, 32, 16, 64), 32, 32, 1, cuda)
    a = fused_block.conv_in_stats_dchw_batch(x, k)
    b = fused_block.conv_in_stats_dchw_batch(x, k)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("B,D,C,H,W,Cout", [
    (1, 4, 16, 4, 128, 32),
    (2, 8, 24, 6, 34, 48),    # B = 2, ragged tiles
    (1, 2, 1, 2, 2, 24),      # Cin = 1, minimal extents
])
def test_conv3x3_s2_stats_kernel_matches_plain(cuda, B, D, C, H, W, Cout):
    x, k = _inputs((B, D, C, H, W), C, Cout, 2, cuda)
    got = strided_conv.conv_s2_stats_dchw_batch(x, k, pack_weight(k))
    want = strided_conv.conv3x3_s2_stats_plain(x, k)
    torch.cuda.synchronize()
    assert_conv_stats_close(got, want)


def test_kernel_wrappers_count_launches(cuda):
    x, k = _inputs((1, 4, 16, 4, 8), 16, 16, 3, cuda)
    n1, n2 = fused_block.launches, strided_conv.launches
    fused_block.conv_in_stats_dchw_batch(x, k)
    strided_conv.conv_s2_stats_dchw_batch(x, k)
    fused_block.conv3x3_stats_plain(x, k)
    assert (fused_block.launches, strided_conv.launches) == (n1 + 1, n2 + 1)


def test_kernel_wrappers_reject_f32_on_cuda(cuda):
    x, k = _inputs((1, 4, 16, 4, 8), 16, 16, 4, cuda)
    with pytest.raises(TypeError):
        fused_block.conv_in_stats_dchw_batch(x.float(), k)
