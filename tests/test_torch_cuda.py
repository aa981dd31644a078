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


# ---- weight-gradient kernels ----
#
# Tolerance: the kernel and the plain version both sum exact bf16 products
# in f32, in different orders, so they differ by the f32 rounding of those
# sums: bounded here by 1e-4 of the same sum over |x|·|g| (a missing or
# misplaced tap would be off by the order of that sum itself).


def _dw_inputs(xshape, gshape, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(xshape).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(gshape).astype(np.float32))
    return x.to(device, torch.bfloat16), g.to(device, torch.bfloat16)


def assert_dw_close(dw, want, bound):
    assert dw.shape == want.shape and dw.dtype == torch.float32
    err = (dw - want).abs()
    assert (err <= 1e-4 * bound + 1e-6).all(), (err / (bound + 1e-6)).max()


@pytest.mark.parametrize("B,D,C,H,W,Cout", [
    (1, 4, 16, 8, 64, 32),
    (1, 6, 1, 10, 40, 32),    # Cin = 1 (enc0)
    (2, 5, 48, 7, 19, 24),    # B = 2, Cin != Cout, ragged tiles
    (1, 3, 70, 3, 5, 40),     # tiny deep-level extents
])
def test_conv3x3_dw_kernel_matches_plain(cuda, B, D, C, H, W, Cout):
    x, g = _dw_inputs((B, D, C, H, W), (B, D, Cout, H, W), 5, cuda)
    dw = fused_block.conv3x3_dw(x, g)
    want = fused_block.conv3x3_dw_plain(x, g)
    bound = fused_block.conv3x3_dw_plain(x.abs(), g.abs())
    torch.cuda.synchronize()
    assert_dw_close(dw, want, bound)


@pytest.mark.parametrize("B,D,C,H,W,Cout", [
    (1, 4, 16, 4, 128, 32),
    (2, 8, 24, 6, 34, 48),    # B = 2, ragged tiles
    (1, 2, 1, 2, 2, 24),      # Cin = 1, minimal extents
])
def test_conv3x3_s2_dw_kernel_matches_plain(cuda, B, D, C, H, W, Cout):
    x, g = _dw_inputs((B, D, C, H, W), (B, D // 2, Cout, H // 2, W // 2), 6, cuda)
    dw = strided_conv.conv3x3_s2_dw(x, g)
    want = strided_conv.conv3x3_s2_dw_plain(x, g)
    bound = strided_conv.conv3x3_s2_dw_plain(x.abs(), g.abs())
    torch.cuda.synchronize()
    assert_dw_close(dw, want, bound)


def test_dw_kernels_are_deterministic(cuda):
    x, g = _dw_inputs((2, 8, 32, 16, 64), (2, 8, 32, 16, 64), 7, cuda)
    assert torch.equal(fused_block.conv3x3_dw(x, g), fused_block.conv3x3_dw(x, g))
    g2 = g[:, :4, :, :8, :32].contiguous()
    assert torch.equal(strided_conv.conv3x3_s2_dw(x, g2), strided_conv.conv3x3_s2_dw(x, g2))


def test_dw_wrappers_count_launches(cuda):
    x, g = _dw_inputs((1, 4, 16, 4, 8), (1, 4, 16, 4, 8), 8, cuda)
    n1, n2 = fused_block.dw_launches, strided_conv.dw_launches
    fused_block.conv3x3_dw(x, g)
    strided_conv.conv3x3_s2_dw(x, g[:, :2, :, :2, :4].contiguous())
    fused_block.conv3x3_dw_plain(x, g)
    assert (fused_block.dw_launches, strided_conv.dw_launches) == (n1 + 1, n2 + 1)


def test_dw_wrappers_reject_f32_on_cuda(cuda):
    x, g = _dw_inputs((1, 4, 16, 4, 8), (1, 4, 16, 4, 8), 9, cuda)
    with pytest.raises(TypeError):
        fused_block.conv3x3_dw(x.float(), g.float())
    with pytest.raises(TypeError):
        strided_conv.conv3x3_s2_dw(x.float(), g[:, :2, :, :2, :4].float())


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_backward_on_card_matches_cpu(cuda, stride):
    """The autograd Functions' dx and dw on the card (kernels) against the
    same Functions on the CPU (plain versions), same bf16 inputs. dx is a
    bf16 conv output: one bf16 ulp, or 1e-3 of its largest magnitude near
    zero. dw is rounded to bf16 once on both: 2^-7 relative plus 1e-3 of
    its largest magnitude."""
    conv = fused_block.conv_in_stats_dchw_batch if stride == 1 \
        else strided_conv.conv_s2_stats_dchw_batch
    x, k = _inputs((2, 4, 24, 8, 16), 24, 40, 10, cuda)
    rng = np.random.default_rng(11)
    coef = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xd = x.detach().to(dev).requires_grad_()
        kd = k.detach().to(dev).requires_grad_()
        y, m, q = conv(xd, kd)
        c = coef.to(dev)
        loss = (y.float() ** 2).sum() * 1e-3 + (m * c).sum() + (q * c * c).sum()
        loss.backward()
        grads.append((xd.grad.float().cpu(), kd.grad.float().cpu()))
    for got, want in zip(grads[0], grads[1]):
        tol = 2.0 ** -7 * want.abs() + 1e-3 * want.abs().max()
        assert ((got - want).abs() <= tol).all(), (got - want).abs().max()


def test_train_step_repacks_weights_after_update(cuda):
    """After an optimizer step the CUDA forward uses the updated weights:
    the model's logits equal those of a copy whose packed layouts are built
    anew, and differ from the logits before the step."""
    import copy

    from runet_tpu_torch.config import ModelConfig, TrainConfig
    from runet_tpu_torch.models.unet3d import create_train_model, init_params
    from runet_tpu_torch.train.state import create_train_state, make_train_step

    cfg = ModelConfig(num_classes=2, base_features=16, max_features=32, num_levels=3)
    model = init_params(create_train_model(cfg, cuda), torch.Generator().manual_seed(0))
    state = create_train_state(model, TrainConfig(lr=1e-2, warmup_steps=0, lr_schedule="const"))
    rng = np.random.default_rng(12)
    images = torch.from_numpy(rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 2, (2, 16, 16, 16))).to(cuda)
    with torch.no_grad():
        before = model(images)
    make_train_step(model)(state, images, labels)
    fresh = copy.deepcopy(model)
    for m in fresh.modules():
        if hasattr(m, "_packed"):
            m._packed = None
    with torch.no_grad():
        after, want = model(images), fresh(images)
    assert torch.equal(after, want)
    assert not torch.equal(after, before)


def test_patch_loader_copies_pinned_batches_to_the_card(cuda, tmp_path):
    from runet_tpu_torch.config import PreprocessConfig
    from runet_tpu_torch.data.dataset import prepare_dataset
    from runet_tpu_torch.data.phantom import write_phantom_dataset
    from runet_tpu_torch.data.pipeline import PatchLoader
    from runet_tpu_torch.data.sampler import sample_batch

    write_phantom_dataset(tmp_path, num_cases=1, shape=(24, 24, 16))
    cases = prepare_dataset(tmp_path, PreprocessConfig(spacing=(1.5, 1.5, 2.5)), device=cuda)
    loader = PatchLoader(cases, batch_size=2, patch_size=(8, 8, 8), seed=4, device=cuda)
    try:
        ref = np.random.default_rng(4)
        for _ in range(3):
            images, labels = next(loader)
            assert images.is_cuda and labels.is_cuda
            ri, rl = sample_batch(ref, cases, 2, (8, 8, 8), 0.5, np.float16, np.uint8)
            np.testing.assert_array_equal(images.cpu().numpy(), ri)
            np.testing.assert_array_equal(labels.cpu().numpy(), rl)
    finally:
        loader.close()
