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


def assert_y_close(y, yr):
    """Within one bf16 ulp, or 1e-3 of the largest magnitude near zero."""
    y, yr = y.float(), yr.float()
    assert y.shape == yr.shape
    tol = 2.0 ** -7 * yr.abs() + 1e-3 * yr.abs().max()
    bad = ((y - yr).abs() > tol).sum().item()
    assert bad == 0, f"{bad} outputs beyond tolerance; max err {(y - yr).abs().max().item()}"


def assert_conv_stats_close(got, want):
    y, m, q = (t.float() for t in got)
    yr, mr, qr = (t.float() for t in want)
    assert m.shape == mr.shape
    assert_y_close(y, yr)
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


def _to_layout(t, version):
    """(B, D, C, H, W) → the layout the kernel of ``version`` takes."""
    return t.permute(0, 1, 3, 2, 4).contiguous() if version == "v1" else t


def _variant(version):
    """(differentiable wrapper, plain version) of a fused_kernel value."""
    if version == "v1":
        return fused_block.conv_in_stats_dhcw_batch, fused_block.conv3x3_stats_dhcw_plain
    plain = fused_block.conv3x3_stats_v2_plain if version == "v2" \
        else fused_block.conv3x3_stats_plain
    return (lambda x, k, p=None: fused_block.conv_in_stats_dchw_batch(x, k, p, version)), plain


@pytest.mark.parametrize("version", ["v2", "v1"])
@pytest.mark.parametrize("B,D,C,H,W,Cout", [
    (1, 4, 16, 8, 64, 32),
    (1, 6, 1, 10, 40, 24),    # Cin = 1 (enc0), Cout not a tile multiple
    (2, 5, 48, 7, 19, 24),    # ragged tiles, decoder concat width, B = 2
    (1, 3, 70, 3, 5, 40),     # tiny deep-level extents
    (1, 8, 320, 8, 8, 320),   # the bottleneck: one block's tile is most of the volume
])
def test_conv3x3_stats_variant_kernels_match_plain(cuda, version, B, D, C, H, W, Cout):
    x, k = _inputs((B, D, C, H, W), C, Cout, 0, cuda)
    x = _to_layout(x, version)
    conv, plain = _variant(version)
    got = conv(x, k, pack_weight(k))
    want = plain(x, k)
    torch.cuda.synchronize()
    assert_conv_stats_close(got, want)


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_conv3x3_stats_variant_kernels_are_deterministic_and_counted(cuda, version):
    x, k = _inputs((1, 8, 32, 16, 64), 32, 32, 1, cuda)
    x = _to_layout(x, version)
    conv, plain = _variant(version)
    names = ("launches", "v2_launches", "v1_launches")
    before = [getattr(fused_block, n) for n in names]
    a = conv(x, k)
    b = conv(x, k)
    plain(x, k)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    after = [getattr(fused_block, n) for n in names]
    own = names.index(f"{version}_launches")
    assert [q - p for p, q in zip(before, after)] == [2 if i == own else 0 for i in range(3)]
    with pytest.raises(TypeError):
        conv(x.float(), k)


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_conv_variant_backward_on_card_matches_cpu(cuda, version):
    """ConvStatsV2 / ConvStatsV1 on the card (dx through their own kernel)
    against the same Functions on the CPU; tolerances as in
    test_conv_backward_on_card_matches_cpu."""
    conv, _ = _variant(version)
    x, k = _inputs((2, 4, 24, 8, 16), 24, 40, 10, cuda)
    x = _to_layout(x, version)
    coef = torch.from_numpy(np.random.default_rng(11).standard_normal(40).astype(np.float32))
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


# ---- attic kernels: the NDHWC convs and the instance-norm passes ----
#
# Tolerances: the conv kernels as the stride-1 kernels above (one bf16 ulp,
# 1e-3 of the largest magnitude near zero; moments from the rounded
# outputs). The stats kernel sums in f32 in another order than the plain
# version: within 1e-5 of the same sum over |x| (and over x²). The apply
# kernel rounds each f32 operation once in the plain version's order, so
# it equals the plain version bit for bit.


def _ndhwc_inputs(shape, cout, seed, device):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin))
                         .astype(np.float32))
    return x.to(device, torch.bfloat16), w.to(device, torch.bfloat16)


@pytest.mark.parametrize("D,H,W,C,Cout", [
    (7, 13, 29, 5, 11),       # no multiple of 8 anywhere: element loads
    (4, 8, 64, 16, 32),       # vector loads, whole tiles
    (3, 9, 40, 24, 40),       # Cin % 16 = 8: a half-empty chunk; Cout ragged
    (2, 5, 7, 70, 33),        # tiny extents, Cin % 8 != 0 past 64 channels
])
def test_attic_conv_kernel_matches_plain(cuda, D, H, W, C, Cout):
    from runet_tpu_torch.kernels.attic import conv3d

    x, w = _ndhwc_inputs((D, H, W, C), Cout, 20, cuda)
    got = conv3d.conv3x3x3_same(x, w)
    want = conv3d.conv3x3x3_same_plain(x, w)
    torch.cuda.synchronize()
    assert_y_close(got, want)


def test_attic_conv_kernel_reads_an_unaligned_view(cuda):
    """x whose storage starts 2 bytes off a 16-byte boundary (C % 8 == 0):
    the kernel takes the element-load path and still matches."""
    from runet_tpu_torch.kernels.attic import conv3d

    x, w = _ndhwc_inputs((4, 6, 20, 16), 24, 21, cuda)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xu = flat[1:].view(x.shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    assert_y_close(conv3d.conv3x3x3_same(xu, w), conv3d.conv3x3x3_same_plain(x, w))


@pytest.mark.parametrize("D,H,W,C,Cout", [
    (6, 9, 11, 24, 40),       # odd extents, ragged tiles
    (8, 16, 16, 128, 128),    # a deep level (fine_l2's widths)
    (4, 5, 7, 256, 64),       # fine_l3's input width
])
def test_attic_v3_kernel_matches_plain(cuda, D, H, W, C, Cout):
    from runet_tpu_torch.kernels.attic import conv_v3_deep

    x, w = _ndhwc_inputs((D, H, W, C), Cout, 22, cuda)
    y, s, q = conv_v3_deep.conv3x3_v3(x, w)
    yr, sr, qr = conv_v3_deep.conv3x3_v3_plain(x, w)
    torch.cuda.synchronize()
    n = D * H * W
    assert_conv_stats_close((y, s / n, q / n), (yr, sr / n, qr / n))


def test_attic_conv_kernels_are_counted_deterministic_and_bf16_only(cuda):
    from runet_tpu_torch.kernels.attic import conv3d, conv_v3_deep

    x, w = _ndhwc_inputs((4, 8, 40, 16), 32, 23, cuda)
    n3, nv = conv3d.launches, conv_v3_deep.launches
    a, b = conv3d.conv3x3x3_same(x, w), conv3d.conv3x3x3_same(x, w)
    va, vb = conv_v3_deep.conv3x3_v3(x, w), conv_v3_deep.conv3x3_v3(x, w)
    conv3d.conv3x3x3_same_plain(x, w)
    conv_v3_deep.conv3x3_v3_plain(x, w)
    assert torch.equal(a, b) and all(torch.equal(u, v) for u, v in zip(va, vb))
    assert (conv3d.launches, conv_v3_deep.launches) == (n3 + 2, nv + 2)
    with pytest.raises(TypeError):
        conv3d.conv3x3x3_same(x.float(), w)
    with pytest.raises(TypeError):
        conv_v3_deep.conv3x3_v3(x.float(), w)
    assert conv3d.conv_applicable(x) and not conv3d.conv_applicable(x.float())


def test_attic_conv_function_grads_match_f32_autograd(cuda):
    """AtticConv's dx (the kernel on flipped, swapped weights) and dw (f32
    correlation) against autograd through F.conv3d in true f32 on the same
    bf16 values, with a linear loss whose cotangent is bf16-exact: within
    one bf16 ulp (both outputs are rounded to bf16 once) and 1e-3 of the
    largest magnitude near zero."""
    from runet_tpu_torch.kernels.attic import conv3d
    from runet_tpu_torch.kernels.conv_common import no_tf32_conv

    x, w = _ndhwc_inputs((5, 7, 9, 12), 10, 24, cuda)
    r = torch.from_numpy(np.random.default_rng(25).standard_normal((5, 7, 9, 10))
                         .astype(np.float32)).to(cuda, torch.bfloat16).float()
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    (conv3d.attic_conv3x3(xk, wk).float() * r).sum().backward()
    xr, wr = x.float().requires_grad_(), w.float().requires_grad_()
    with no_tf32_conv():
        y = torch.nn.functional.conv3d(xr.permute(3, 0, 1, 2)[None],
                                       wr.permute(4, 3, 0, 1, 2), padding=1)
    (y[0].permute(1, 2, 3, 0) * r).sum().backward()
    assert xk.grad.dtype == torch.bfloat16 and wk.grad.dtype == torch.bfloat16
    assert_y_close(xk.grad, xr.grad)
    assert_y_close(wk.grad, wr.grad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (1, 3, 5, 7, 20),         # C = 20: 4-wide vectors; odd extents
    (1, 8, 8, 8, 320),        # C = 320: 40 vector columns
    (2, 4, 4, 32, 128),
    (2, 3, 2, 5, 7),          # C = 7: element loads
])
def test_attic_norm_kernels_match_plain(cuda, shape, dtype):
    from runet_tpu_torch.kernels.attic import fused_norm as fn

    rng = np.random.default_rng(26)
    C = shape[-1]
    x = torch.from_numpy(rng.normal(1.5, 2.0, size=shape).astype(np.float32)).to(cuda, dtype)
    scale = torch.from_numpy(rng.normal(1.0, 0.1, size=C).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.normal(0.0, 0.1, size=C).astype(np.float32)).to(cuda)
    s, q = fn.instance_norm_stats(x)
    sr, qr = fn.instance_norm_stats_plain(x)
    sa, _ = fn.instance_norm_stats_plain(x.abs())
    torch.cuda.synchronize()
    assert ((s - sr).abs() <= 1e-5 * sa + 1e-6).all(), (s - sr).abs().max()
    assert ((q - qr).abs() <= 1e-5 * qr + 1e-6).all(), (q - qr).abs().max()
    n = x[0, ..., 0].numel()
    mean = sr / n
    rstd = torch.rsqrt(torch.clamp_min(qr / n - mean * mean, 0.0) + 1e-5)
    assert torch.equal(fn.instance_norm_lrelu_apply(x, mean, rstd, scale, bias),
                       fn.instance_norm_lrelu_apply_plain(x, mean, rstd, scale, bias))
    got = fn.fused_instance_norm_lrelu(x, scale, bias)
    want = fn.fused_instance_norm_lrelu_plain(x, scale, bias)
    assert got.shape == x.shape and got.dtype == dtype
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22  # one ulp, relative
    tol = ulp * want.float().abs() + 1e-5 * want.float().abs().max()
    assert ((got.float() - want.float()).abs() <= tol).all()


def test_attic_norm_kernels_are_counted_and_reject_f16(cuda):
    from runet_tpu_torch.kernels.attic import fused_norm as fn

    x = torch.randn((2, 4, 4, 4, 32), device=cuda)
    scale, bias = torch.ones(32, device=cuda), torch.zeros(32, device=cuda)
    ns, na = fn.stats_launches, fn.apply_launches
    a = fn.fused_instance_norm_lrelu(x, scale, bias)
    b = fn.fused_instance_norm_lrelu(x, scale, bias)
    fn.fused_instance_norm_lrelu_plain(x, scale, bias)
    assert torch.equal(a, b)
    assert (fn.stats_launches, fn.apply_launches) == (ns + 2, na + 2)
    with pytest.raises(TypeError):
        fn.fused_instance_norm_lrelu(x.half(), scale, bias)


def test_scanned_ms_captures_kernel_steps(cuda):
    """A conv-kernel step and a norm-kernel step are captured into a CUDA
    graph; a step that changes the shape is refused."""
    from runet_tpu_torch.kernels.attic import conv3d, fused_norm
    from runet_tpu_torch.utils import latency

    x, w = _ndhwc_inputs((8, 16, 32, 32), 32, 27, cuda)
    scale, bias = torch.ones(32, device=cuda), torch.zeros(32, device=cuda)
    with torch.no_grad():
        for step in (lambda t: conv3d.conv3x3x3_same(t, w),
                     lambda t: fused_norm.fused_instance_norm_lrelu(t, scale, bias)):
            assert latency.scanned_ms(step, x, iters=3, reps=2) > 0
        assert latency.chained_ms(lambda t: conv3d.conv3x3x3_same(t, w), (x,), n=3) > 0
        assert latency.pipelined_ms(lambda t: conv3d.conv3x3x3_same(t, w), (x,), n=3) > 0
        with pytest.raises(ValueError):
            latency.scanned_ms(lambda t: t[:1], x, iters=2)
