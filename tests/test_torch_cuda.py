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


# The v2m kernel stages its halo in (line, 8-column chunk, channel quad)
# units: four 16-byte loads per unit where W % 8 == 0 and x is 16-byte
# aligned (element loads otherwise), transposed to channel-innermost in
# registers, and the columns w0 - 1 and w0 + 32 as single elements.
_V2M_STAGING_SHAPES = [
    (1, 4, 16, 8, 8, 32),     # W = 8: chunks 1-3 lie past W
    (1, 3, 24, 8, 20, 32),    # W = 20: element loads, one partial chunk
    (1, 3, 16, 8, 33, 32),    # W = 33: a second tile of one column
    (1, 2, 1, 8, 96, 32),     # W = 96: halo columns across two seams; Cin 1, quads 1-3 past C
    (1, 3, 16, 13, 32, 32),   # H = 13: the TH = 8 tail
    (2, 3, 40, 8, 24, 48),    # B = 2, Cin 40: a ragged last quad and chunk; Cout 48
]


@pytest.mark.parametrize("B,D,C,H,W,Cout", [
    (1, 4, 16, 8, 64, 32),
    (1, 6, 1, 10, 40, 24),    # Cin = 1 (enc0), Cout not a tile multiple
    (2, 5, 48, 7, 19, 24),    # ragged tiles, decoder concat width, B = 2
    (1, 3, 70, 3, 5, 40),     # tiny deep-level extents
    *_V2M_STAGING_SHAPES,
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


# The v1 kernel builds its im2col tile from (input line, 8-column chunk)
# units: one 16-byte load per unit where W % 8 == 0 and x is 16-byte aligned
# (eight element loads otherwise), the columns w0 - 1 and w0 + 32 as single
# elements, and the kw = 0 / 2 copies by shuffles across chunks.
_V1_STAGING_SHAPES = [
    (1, 4, 16, 5, 8, 32),     # W = 8: chunks 1-3 lie past W; H odd (the TH = 2 tail)
    (2, 3, 24, 6, 20, 48),    # W = 20: element loads; B = 2, Cin 24, Cout 48
    (1, 3, 40, 4, 33, 32),    # W = 33: a second tile of one column; Cin 40
    (1, 2, 1, 7, 96, 32),     # W = 96: three tiles, halo columns across the seams; Cin 1
    (2, 2, 32, 3, 64, 48),    # W = 64, B = 2, H odd, Cout 48
]

# The v1 kernel's tile is 4 rows, and each block writes its moments into
# one partial slot per 2-row half that lies in the output: H = 1, 2, 5 and 9
# leave a 4-row tail tile with one slot, H = 3 and 6 one with two (the
# second half-empty at H = 3).
_V1_TILE_SHAPES = [
    (1, 3, 16, 1, 32, 32),    # H = 1: one tile, one slot, rows 1-3 padding
    (1, 2, 40, 2, 64, 64),    # H = 2: ragged Cin 40, Cout 64
    (2, 3, 24, 3, 40, 48),    # H = 3: two slots, row 3 padding; W = 40, B = 2
    (1, 2, 32, 5, 32, 64),    # H = 5: an odd slot count, a one-slot tail; Cout 64
    (1, 2, 16, 6, 48, 32),    # H = 6: a tail tile of rows 4-5 only
    (1, 2, 320, 9, 16, 320),  # H = 9: three tiles, Cin and Cout 320, W = 16
]

# The v2 kernel stages its slab and the two W-shifted copies from the same
# (input line, 8-column chunk) units, each stored once into every copy.
_V2_STAGING_SHAPES = [
    (1, 4, 16, 8, 8, 32),     # W = 8: chunks 1-3 lie past W
    (1, 3, 24, 8, 20, 32),    # W = 20: element loads, one partial chunk
    (1, 3, 16, 8, 33, 32),    # W = 33: a second tile of one column
    (1, 2, 1, 8, 96, 32),     # W = 96: three tiles, halo columns across two seams; Cin 1
    (1, 3, 16, 13, 32, 32),   # H = 13: the TH = 8 tail
    (2, 3, 40, 8, 24, 48),    # B = 2, Cin 40: a ragged last channel chunk; Cout 48
]


@pytest.mark.parametrize("version", ["v2", "v1"])
@pytest.mark.parametrize("B,D,C,H,W,Cout", [
    (1, 4, 16, 8, 64, 32),
    (1, 6, 1, 10, 40, 24),    # Cin = 1 (enc0), Cout not a tile multiple
    (2, 5, 48, 7, 19, 24),    # ragged tiles, decoder concat width, B = 2
    (1, 3, 70, 3, 5, 40),     # tiny deep-level extents
    (1, 8, 320, 8, 8, 320),   # the bottleneck: one block's tile is most of the volume
    *_V1_STAGING_SHAPES,
    *_V2_STAGING_SHAPES,
    *_V1_TILE_SHAPES,
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


def _at_odd_offset(t):
    """A contiguous copy of t that starts one element past a 16-byte
    boundary, so the kernel cannot take 16-byte loads from it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


# The stride-2 forward kernel copies each input line of a block as 8-column
# chunks (one 16-byte cp.async per channel and chunk where W % 8 == 0 and x
# is 16-byte aligned, element loads otherwise), the right halo chunk apart,
# and transposes them in shared memory to channel-innermost, even and odd
# columns apart.
_S2_STATS_STAGING_SHAPES = [
    (1, 4, 16, 6, 8, 32),     # Wo = 4: only chunk 0 of each line is real
    (1, 4, 32, 10, 16, 64),   # Wo = 8: chunks 2-7 lie past W; ragged H (Ho = 5)
    (2, 4, 24, 8, 32, 48),    # Wo = 16, B = 2: quads 2-3 of K-tile 1 past C; Cout = 48
    (1, 2, 1, 6, 64, 32),     # Wo = 32: the 65th column is the high pad; Cin = 1
    (1, 2, 18, 4, 128, 32),   # Wo = 64: two column tiles; channels 18-19 of a quad past C
    (1, 4, 16, 4, 6, 24),     # W = 6: element loads
    (1, 2, 24, 6, 20, 40),    # W = 20: element loads, one partial chunk
]


@pytest.mark.parametrize("B,D,C,H,W,Cout", [
    (1, 4, 16, 4, 128, 32),
    (2, 8, 24, 6, 34, 48),    # B = 2, ragged tiles
    (1, 2, 1, 2, 2, 24),      # Cin = 1, minimal extents
    *_S2_STATS_STAGING_SHAPES,
])
def test_conv3x3_s2_stats_kernel_matches_plain(cuda, B, D, C, H, W, Cout):
    x, k = _inputs((B, D, C, H, W), C, Cout, 2, cuda)
    got = strided_conv.conv_s2_stats_dchw_batch(x, k, pack_weight(k))
    want = strided_conv.conv3x3_s2_stats_plain(x, k)
    torch.cuda.synchronize()
    assert_conv_stats_close(got, want)


@pytest.mark.parametrize("B,D,C,H,W,Cout", _S2_STATS_STAGING_SHAPES)
def test_conv3x3_s2_stats_element_loads_equal_vector_loads(cuda, B, D, C, H, W, Cout):
    """x at an odd element offset takes the element-load staging; the same
    values reach the same shared cells, so y and the moments keep their bits."""
    x, k = _inputs((B, D, C, H, W), C, Cout, 18, cuda)
    aligned = strided_conv.conv_s2_stats_dchw_batch(x, k)
    got = strided_conv.conv_s2_stats_dchw_batch(_at_odd_offset(x), k)
    torch.cuda.synchronize()
    for u, v in zip(got, aligned):
        assert torch.equal(u, v)
    assert_conv_stats_close(got, strided_conv.conv3x3_s2_stats_plain(x, k))


def test_conv3x3_s2_stats_kernel_is_deterministic_across_tile_seams(cuda):
    x, k = _inputs((2, 2, 16, 6, 128), 16, 32, 19, cuda)
    a = strided_conv.conv_s2_stats_dchw_batch(x, k)
    b = strided_conv.conv_s2_stats_dchw_batch(x, k)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def _own_sums(x, k, version):
    """The kernel's own (y, sums, sqs), before the means are taken."""
    return fused_block._conv3x3_sums(x, k, None, version)


@pytest.mark.parametrize("version,B,D,C,H,W,Cout",
                         [("v1", *s) for s in _V1_STAGING_SHAPES + _V1_TILE_SHAPES]
                         + [("v2", *s) for s in _V2_STAGING_SHAPES]
                         + [("v2m", *s) for s in _V2M_STAGING_SHAPES])
def test_conv3x3_stats_variant_element_loads_equal_vector_loads(cuda, version, B, D, C, H, W,
                                                                Cout):
    """x at an odd element offset takes the element-load staging; the same
    values reach the same shared cells, so y, sums and sqs keep their bits."""
    x, k = _inputs((B, D, C, H, W), C, Cout, 21, cuda)
    x = _to_layout(x, version)
    aligned = _own_sums(x, k, version)
    got = _own_sums(_at_odd_offset(x), k, version)
    torch.cuda.synchronize()
    for u, v in zip(got, aligned):
        assert torch.equal(u, v)


@pytest.mark.parametrize("version", ["v2m", "v2", "v1"])
def test_conv3x3_stats_variant_kernels_are_deterministic_across_tile_seams(cuda, version):
    x, k = _inputs((2, 3, 24, 5, 96), 24, 48, 22, cuda)
    x = _to_layout(x, version)
    a, b = _own_sums(x, k, version), _own_sums(x, k, version)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


# The v2m kernel's tile follows W and Cout_pad: 8 rows x 32 columns x 64
# channels where W > 16 and Cout_pad % 64 == 0, 8 x 32 x 32 where W > 16
# otherwise, 16 x 16 x 32 where W <= 16; (D, C, H, W, Cout) at B = 1.
_V2M_TILE_SHAPES = [
    (4, 24, 13, 128, 32),     # 8 x 32 x 32, 16-byte copies; H = 13: a ragged row tile
    (3, 40, 9, 33, 80),       # 8 x 32 x 32 at Cout_pad 96; W = 33: element loads, a
                              # one-column second tile; Cin % 16 = 8
    (4, 128, 12, 32, 128),    # 8 x 32 x 64 (fine_l2's widths)
    (4, 64, 13, 17, 64),      # 8 x 32 x 64 at W = 17: element loads, 15 padded columns
    (2, 256, 16, 16, 256),    # 16 x 16 (fine_l3's widths)
    (4, 64, 12, 16, 64),      # 16 x 16, H = 12: the tile's second moment slot is partial
    (3, 320, 8, 8, 320),      # 16 x 16 at H = 8: no second moment slot; W = 8
    (5, 128, 13, 12, 96),     # 16 x 16 at W = 12 (element loads), Cout_pad 96
    (1, 16, 1, 1, 32),        # one voxel
]


def _stats_digests(shape, device, version="v2m"):
    """sha256 of y's bytes, and of sums' then sqs' bytes, of the kernel of
    ``version`` from numpy inputs (seed 33) at (D, C, H, W, Cout), B = 1."""
    import hashlib

    D, C, H, W, Cout = shape
    x, k = _inputs((1, D, C, H, W), C, Cout, 33, device)
    y, s, q = _own_sums(x, k, version)
    y_bytes = y.cpu().view(torch.int16).numpy().tobytes()
    m_bytes = s.cpu().numpy().tobytes() + q.cpu().numpy().tobytes()
    return hashlib.sha256(y_bytes).hexdigest(), hashlib.sha256(m_bytes).hexdigest()


# Digests (``_stats_digests``) recorded from the kernel that staged 8 x 32 x 32
# tiles synchronously, before the tiles followed W and Cout_pad and the kd
# planes went through a cp.async ring, on an NVIDIA H100 80GB HBM3: y, sums
# and sqs at every shape.
_V2M_DIGESTS = {
    (4, 24, 13, 128, 32): (
        "1c0fef7f262e56a5ee5d3ce82bb475563eba2369d4fb37b36784f5b978c60b6e",
        "63c3fcd0075d5c630244b716cc4ad4ea40f473317773695b9e2d59abbb235c5f"),
    (3, 40, 9, 33, 80): (
        "e001846676dd525f9998e73bb8d049a72ad050d098ebe43fdc836c4c4ec085fc",
        "a4cda5d1d7eb7926127f5f2ee9a680104859da11582bd7e77cb0db1da9799d14"),
    (4, 128, 12, 32, 128): (
        "2c11e6520838b2d9fa06759b60c863f1e863390effe8b77093e1c6b49a849a78",
        "a551c3e11b8e626ecd01c61d44e2f58c6bbab24d64787e4655b85e4bb314c73a"),
    (4, 64, 13, 17, 64): (
        "4c7adb0d1999ebb254d29402b3bbe169f042299335257d8fd70ce8fe6c729254",
        "ad4c70dfa98a37d577f9bd2af8f4d011859e1d75bec38dd79b9d55eee9300ddf"),
    (2, 256, 16, 16, 256): (
        "0762c0644a5c9e02e14a9dfe73939b2563b1f606a9734c93f889c8755dc2cf0e",
        "2bf1b5faabf01f028b57de8ca989d5ed912bd53b97b01aa37a81f2df6abf9783"),
    (4, 64, 12, 16, 64): (
        "b03ea9347fb5850b0be1b016de974d6084bc2f393d37c4a2040750e4a73759c8",
        "f76bc7ffe726540b58851eda5fcacac9e4ac65688a5076966be57da5811bf800"),
    (3, 320, 8, 8, 320): (
        "e0d3c978de14d8af3bd0a1f30f0295e44722b29effdb51c19a20f0c35cd8b4c4",
        "c60563323119b21948ef644e89eb5bb40f04a07a610ae96397507d95841db266"),
    (5, 128, 13, 12, 96): (
        "1943340d46e529964ba1d42cdac3b7f72fcac8f15f000a1dc103319d96baed18",
        "7fe24ad372bc2a82f276ed3aa99ba883d576f1e86fc1f8bdec3e3e58f168e7af"),
    (1, 16, 1, 1, 32): (
        "7e54204c62ce1a97442e1f9017bc335f5d510a900f1cd61b67a81116f95bd336",
        "d101c2d6c26cb744306c2e5e4dd185355c8c2c58d5547e0e9693efc7b10400ea"),
}


@pytest.mark.parametrize("shape", _V2M_TILE_SHAPES)
def test_conv3x3_stats_keeps_its_recorded_bits(cuda, shape):
    assert _stats_digests(shape, cuda) == _V2M_DIGESTS[shape]


@pytest.mark.parametrize("shape", _V2M_TILE_SHAPES)
def test_conv3x3_stats_tiles_match_plain_and_keep_bits_at_an_odd_offset(cuda, shape):
    """Each tile against the plain version, and x one element past a
    16-byte boundary (the element-load instance) bit-equal to the aligned
    run: y, sums and sqs."""
    D, C, H, W, Cout = shape
    x, k = _inputs((1, D, C, H, W), C, Cout, 34, cuda)
    packed = pack_weight(k)
    aligned = _own_sums(x, k, "v2m")
    got = _own_sums(_at_odd_offset(x), k, "v2m")
    torch.cuda.synchronize()
    for u, v in zip(got, aligned):
        assert torch.equal(u, v)
    assert_conv_stats_close(fused_block.conv_in_stats_dchw_batch(x, k, packed),
                            fused_block.conv3x3_stats_plain(x, k))


def test_conv3x3_stats_nblk_keeps_the_8_by_32_slots(cuda):
    """One moment slot per (d, 8-row tile, 32-column tile) whatever the tile
    (``launch_conv_stats`` sizes the scratch from the library's count)."""
    from runet_tpu_torch.kernels.conv_common import _CONV_STATS_API, _library

    lib = _library(fused_block.SOURCE, _CONV_STATS_API)
    for D, H, W in ((4, 13, 8), (4, 13, 16), (4, 13, 17), (4, 12, 128), (3, 8, 8), (1, 1, 1),
                    (32, 32, 32), (16, 16, 16), (3, 35, 70)):
        assert lib.conv3x3_stats_nblk(D, H, W) == D * -(-H // 8) * -(-W // 32), (D, H, W)


# The v2 kernel's tile follows W: 8 rows x 32 columns x 32 channels where
# W > 16, 16 x 16 x 32 where W <= 16; (D, C, H, W, Cout) at B = 1.
_V2_TILE_SHAPES = [
    (4, 24, 13, 128, 32),     # 8 x 32, 16-byte copies; H = 13: a ragged row tile
    (3, 40, 9, 33, 80),       # 8 x 32 at Cout_pad 96; W = 33: element loads, a
                              # one-column second tile; Cin % 16 = 8
    (4, 128, 12, 32, 128),    # 8 x 32, four output-channel tiles (fine_l2's widths)
    (4, 64, 13, 17, 64),      # 8 x 32 at W = 17: element loads, 15 padded columns
    (2, 1, 10, 40, 24),       # 8 x 32, Cin 1 (K padded to 16), Cout 24
    (2, 256, 16, 16, 256),    # 16 x 16 at W = 16 (fine_l3's widths)
    (4, 64, 12, 16, 64),      # 16 x 16, H = 12: the tile's second moment slot is partial
    (3, 320, 8, 8, 320),      # 16 x 16 at H = 8: no second moment slot; W = 8
    (5, 128, 13, 12, 80),     # 16 x 16 at W = 12 (element loads), Cout_pad 96
    (1, 16, 1, 1, 32),        # one voxel
]


# Digests (``_stats_digests``) recorded from the kernel that staged a
# 32-column slab and its two W-shifted copies synchronously, before the
# kernel took row 1's tiles and three transposed kd planes, on an NVIDIA
# H100 80GB HBM3: y, sums and sqs at every shape.
_V2_DIGESTS = {
    (4, 24, 13, 128, 32): (
        "88758a8ad31fcf7b06cb3d0d6072803908d419bf495f6a770c6e5ed06483f2fb",
        "c9fba1a1a412edfb94eab5870db60f5620e5cdac028a7fc7783112437d4dbe4d"),
    (3, 40, 9, 33, 80): (
        "855ffa1cf4334b5b123e8f9d6cc6cc4054f05368845bdfcbdbd71d1154ca1652",
        "d81aedbab50c4258b8c4b3abcc92a62950fdf06f80798d44cecafab793a3f665"),
    (4, 128, 12, 32, 128): (
        "5635bb52e6641a3b8d94487ab42e32106e56f7d3718a712a4107202c4e108996",
        "361bd3fbe7396761a80b398db5286ad1ff8e432fa4ab2bbbf16a609b64390b79"),
    (4, 64, 13, 17, 64): (
        "a9fd495d8f8a65001ee7e1a266e7509d40fff6cfc80cd11e52cf6fa336842d98",
        "5c972a017b13afbc176ecd3cc9840dc2008c1fb422883e2c00e3f8e0e39b178f"),
    (2, 1, 10, 40, 24): (
        "c79ed6f0efc287100ec3dcf009a0c130c524e397b7a7db0d28e42efdf79b0125",
        "02cfb858376d7fa8c0f3c85d7c8d90d088dd428855067fd4f67930443d20e2b0"),
    (2, 256, 16, 16, 256): (
        "2ddf51959fefe47c8f461a2842c807acf4febc002bbe550ba6230f83c2267d84",
        "c27e6456b3df37e3c03824cc661139ff3746a979146497b71e98e0f7201b8592"),
    (4, 64, 12, 16, 64): (
        "148282362de4e7ba25ee2f5c0314b625ac110ffad0a3b17697a606ec9efa8914",
        "ddeda695367cb94615e526f3a4cedae53ae68790b026a8e15539e07b51a5e938"),
    (3, 320, 8, 8, 320): (
        "9be42b437ea4c192786431065c2326e8fac655191b8b7bbcb2f0ba57fa9dd36c",
        "d8d343816b8fd9234d90fafcdd4188063247e7dba931a6329a44bb443b1e7ddc"),
    (5, 128, 13, 12, 80): (
        "420ee3dc374616c157f05e47064063afe5b9dbb81b644e802acd985caf26bb91",
        "c679573b1537db27e88c32ee9173b16dc1c3549d8079e7ea6de67aa6cbf1fc2a"),
    (1, 16, 1, 1, 32): (
        "7e54204c62ce1a97442e1f9017bc335f5d510a900f1cd61b67a81116f95bd336",
        "d101c2d6c26cb744306c2e5e4dd185355c8c2c58d5547e0e9693efc7b10400ea"),
}


@pytest.mark.parametrize("shape", _V2_TILE_SHAPES)
def test_conv3x3_stats_v2_keeps_its_recorded_bits(cuda, shape):
    assert _stats_digests(shape, cuda, "v2") == _V2_DIGESTS[shape]


@pytest.mark.parametrize("shape", _V2_TILE_SHAPES)
def test_conv3x3_stats_v2_tiles_match_plain_and_keep_bits_at_an_odd_offset(cuda, shape):
    """Each tile and instance against the plain version, and x one element
    past a 16-byte boundary (the element-load instance) bit-equal to the
    aligned run: y, sums and sqs."""
    D, C, H, W, Cout = shape
    x, k = _inputs((1, D, C, H, W), C, Cout, 34, cuda)
    aligned = _own_sums(x, k, "v2")
    got = _own_sums(_at_odd_offset(x), k, "v2")
    torch.cuda.synchronize()
    for u, v in zip(got, aligned):
        assert torch.equal(u, v)
    conv, plain = _variant("v2")
    assert_conv_stats_close(conv(x, k, pack_weight(k)), plain(x, k))


def test_conv3x3_stats_v2_nblk_and_cout_tile_are_unchanged(cuda):
    """One moment slot per (d, 8-row tile, 32-column tile) whatever the
    tile, and weights packed to a multiple of 32 output channels
    (``launch_conv_stats`` sizes the scratch and the packing from them)."""
    from runet_tpu_torch.kernels.conv_common import _CONV_STATS_API, _library

    lib = _library(fused_block.V2_SOURCE, _CONV_STATS_API)
    assert lib.conv3x3_stats_v2_cout_tile() == 32
    for D, H, W in ((4, 13, 8), (4, 13, 16), (4, 13, 17), (4, 12, 128), (3, 8, 8), (1, 1, 1),
                    (32, 32, 32), (16, 16, 16), (3, 35, 70)):
        assert lib.conv3x3_stats_v2_nblk(D, H, W) == D * -(-H // 8) * -(-W // 32), (D, H, W)


# The stride-2 kernel's tile follows Wo and Cout_pad: 4 output rows x 32
# columns where Wo > 16, 8 x 16 where Wo <= 16, by 64 output channels where
# Cout_pad % 64 == 0, else 32; x takes cp.async copies where W % 8 == 0.
# (D, C, H, W, Cout) of the INPUT at B = 1.
_S2_TILE_SHAPES = [
    (4, 32, 10, 32, 64),      # 8 x 16 x 64 at Wo = 16, 16-byte copies; Ho = 5: a partial
                              # second moment slot
    (4, 24, 8, 36, 48),       # 4 x 32 x 64 at Wo = 18 (Cout_pad 64): element loads, 14
                              # padded columns; Cin 24
    (2, 64, 18, 16, 96),      # 8 x 16 x 32 (Cout_pad 96); Ho = 9: the last tile has no
                              # second slot; D = 2: kd = 2 reads only the pad
    (2, 256, 16, 16, 320),    # 8 x 16 x 64, five Cout tiles; Ho = 8: both slots whole
    (4, 32, 16, 128, 64),     # 4 x 32 x 64, two column tiles (level 0's widths)
    (4, 1, 12, 72, 32),       # 4 x 32 x 32, Cin 1; Wo = 36: a second column tile of 4
    (2, 40, 10, 66, 96),      # 4 x 32 x 32 at Cout_pad 96, element loads; Wo = 33: one
                              # column past the first tile
    (4, 256, 12, 20, 320),    # 8 x 16 x 64 at W = 20 (element loads; the renal down
                              # conv's widths)
    (2, 16, 2, 2, 32),        # one output voxel
]


def _s2_digests(shape, device):
    """sha256 of y's bytes, and of sums' then sqs' bytes, of the stride-2
    kernel from numpy inputs (seed 33) at INPUT (D, C, H, W) -> Cout, B = 1."""
    import hashlib

    D, C, H, W, Cout = shape
    x, k = _inputs((1, D, C, H, W), C, Cout, 33, device)
    y, s, q = strided_conv._conv3x3_s2_sums(x, k, None)
    y_bytes = y.cpu().view(torch.int16).numpy().tobytes()
    m_bytes = s.cpu().numpy().tobytes() + q.cpu().numpy().tobytes()
    return hashlib.sha256(y_bytes).hexdigest(), hashlib.sha256(m_bytes).hexdigest()


# Digests (``_s2_digests``) recorded from the kernel that staged 4 x 32 x 32
# tiles synchronously, three kd planes and 27 taps a K-tile, before the
# tiles followed Wo and Cout_pad and the kd planes went through a cp.async
# ring, on an NVIDIA H100 80GB HBM3: y, sums and sqs at every shape.
_S2_DIGESTS = {
    (4, 32, 10, 32, 64): (
        "6d2d64dcdac531c3fedd8a97c0ac28e6a32f3762ddf21eb15dc9a116299efb1e",
        "c4cdcb522afedd5edaa2f3e5d3fe257da2cb283e97a7c91be0a243679f3dd448"),
    (4, 24, 8, 36, 48): (
        "ce296eee5599aff519d5fe4285b2ad65bec7fa354f896a0340abeff19a284450",
        "03c1d7b82f66a7bf65350e69e04332acb683ddaa8ca77f9b0113740212906495"),
    (2, 64, 18, 16, 96): (
        "96923d5f2fcedb56677a55776f3928257108a02dbbea9feff49c8b8e66178a58",
        "b175be7cde3a1373a9b823c167f6069188183a85e4bd098d10f9e80ec43673cc"),
    (2, 256, 16, 16, 320): (
        "e1b23c92ce26e055cc0e796d9cc6915bbac9b918fcd89e31c7ff91dc57ccf661",
        "83c1ea1644d397f51d5925a0c52c28ac26508971b1a322e163693472c1e032d1"),
    (4, 32, 16, 128, 64): (
        "68447f7312e71b087750723f87dd9e081126bc19da2d8b481ef62a15c585e1dc",
        "de4566e9fbbacb3c5e0751031bbea9cd66979494064597ff318429e3315cfc01"),
    (4, 1, 12, 72, 32): (
        "ecf118506a205e94e9a12354f7ea6e6b637f1e4d376119b8bf230f0aee4bb37f",
        "8a77b9b19a84b079d926a3990bcdf6bc63e45f9c9aae866fd2f3159f3f4580d1"),
    (2, 40, 10, 66, 96): (
        "76f7d0f6e3792b2ed2ad54b4f6c007401395c717663f3421183dd8643389f5fc",
        "98d24b33c39f2444373504e8dc7c8c15ae082f3810604a4e8a524ef66e4df25a"),
    (4, 256, 12, 20, 320): (
        "820c5e184e3b498afdafd0ffcae92aacb8362d8a31739f17ecc66e5e212b11f6",
        "260cddd1117fc0c74c24ccc387ffb94a9e67d40b9e231f309e04e90d7af52b31"),
    (2, 16, 2, 2, 32): (
        "051483e9c3e214c4cfb8ea092c7cc6fdb4ca5daa961ad5380b421f24e550a35b",
        "ed84a44402dccbcfd3e10c8974d22ffb364534991a4ac172d34d450b7f692637"),
}


@pytest.mark.parametrize("shape", _S2_TILE_SHAPES)
def test_conv3x3_s2_stats_keeps_its_recorded_bits(cuda, shape):
    assert _s2_digests(shape, cuda) == _S2_DIGESTS[shape]


@pytest.mark.parametrize("shape", _S2_TILE_SHAPES)
def test_conv3x3_s2_stats_tiles_match_plain_and_keep_bits_at_an_odd_offset(cuda, shape):
    """Each tile and instance against the plain version, and x one element
    past a 16-byte boundary (the element-load instance) bit-equal to the
    aligned run: y, sums and sqs."""
    D, C, H, W, Cout = shape
    x, k = _inputs((1, D, C, H, W), C, Cout, 34, cuda)
    packed = pack_weight(k)
    aligned = strided_conv._conv3x3_s2_sums(x, k, packed)
    got = strided_conv._conv3x3_s2_sums(_at_odd_offset(x), k, packed)
    torch.cuda.synchronize()
    for u, v in zip(got, aligned):
        assert torch.equal(u, v)
    assert_conv_stats_close(strided_conv.conv_s2_stats_dchw_batch(x, k, packed),
                            strided_conv.conv3x3_s2_stats_plain(x, k))


def test_conv3x3_s2_stats_nblk_and_cout_tile_are_unchanged(cuda):
    """One moment slot per (d, 4-row tile, 32-column tile) of the OUTPUT
    whatever the tile, and weights packed to a multiple of 32 output
    channels (``launch_conv_stats`` sizes the scratch and the packing from
    them)."""
    from runet_tpu_torch.kernels.conv_common import _CONV_STATS_API, _library

    lib = _library(strided_conv.SOURCE, _CONV_STATS_API)
    assert lib.conv3x3_s2_stats_cout_tile() == 32
    for Do, Ho, Wo in ((2, 5, 16), (1, 9, 8), (2, 4, 18), (1, 8, 8), (1, 1, 1), (2, 6, 10),
                       (64, 64, 64), (8, 8, 8), (3, 35, 70)):
        assert lib.conv3x3_s2_stats_nblk(Do, Ho, Wo) == Do * -(-Ho // 4) * -(-Wo // 32), \
            (Do, Ho, Wo)


def test_conv3x3_stats_v1_is_deterministic_across_4_row_tile_seams(cuda):
    """H = 9: three 4-row tiles, five 2-row moment slots, the last tile
    with one; three column tiles."""
    x, k = _inputs((2, 3, 24, 9, 96), 24, 48, 23, cuda)
    x = _to_layout(x, "v1")
    a, b = _own_sums(x, k, "v1"), _own_sums(x, k, "v1")
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert_conv_stats_close(fused_block.conv_in_stats_dhcw_batch(x, k),
                            fused_block.conv3x3_stats_dhcw_plain(x, k))


def test_conv3x3_stats_v1_rejects_unaligned_packed_weights(cuda):
    """The v1 kernel copies its weights with 16-byte cp.async: packed
    weights two bytes past a 16-byte boundary make the launch, and so the
    wrapper, fail rather than run another path."""
    x, k = _inputs((1, 2, 16, 4, 32), 16, 32, 24, cuda)
    x = _to_layout(x, "v1")
    packed = _at_odd_offset(pack_weight(k))
    assert packed.data_ptr() % 16 == 2
    n = fused_block.v1_launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_block.conv_in_stats_dhcw_batch(x, k, packed)
    assert fused_block.v1_launches == n


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


# The stride-1 kernel stages each row of a K-tile as four 16-byte chunks,
# with one 16-byte load per chunk where W % 8 == 0 and the tensor is
# 16-byte aligned, and eight element loads per chunk otherwise.
_DW_STAGING_SHAPES = [
    (1, 4, 32, 8, 8, 64),     # W = 8: chunks 1-3 of every row lie past W
    (1, 5, 64, 16, 16, 32),   # W = 16: chunks 2-3 lie past W
    (2, 3, 16, 9, 64, 32),    # W = 64, B = 2: the halo columns cross the tile seam
]


# The stride-1 kernel stages each K-tile (8 rows x 32 columns) as two
# 4-row halves through a two-stage ring, and skips the k-step over columns
# 16-31 of a tile where they lie past W. Shapes at the ring's seams (split
# counts as on an H100 SXM, 132 SMs):
_DW_RING_SHAPES = [
    (1, 2, 16, 8, 32, 32),      # two splits of one K-tile each
    (2, 9, 176, 8, 32, 256),    # six splits of three K-tiles (six half-tiles) each
    (1, 3, 17, 4, 24, 8),       # W = 24: columns 16-23 real; H = 4: lower halves past H
    (1, 4, 1, 5, 40, 33),       # W = 40: tile 0 runs both k-steps, tile 1 one; H = 5
    (2, 3, 48, 12, 16, 40),     # W = 16: one k-step; H = 12: the second tile half real
    (1, 3, 24, 12, 8, 33),      # W = 8: one k-step; Cout = 33
]


@pytest.mark.parametrize("B,D,C,H,W,Cout", _DW_STAGING_SHAPES + _DW_RING_SHAPES)
def test_conv3x3_dw_staging_paths_match_plain(cuda, B, D, C, H, W, Cout):
    x, g = _dw_inputs((B, D, C, H, W), (B, D, Cout, H, W), 12, cuda)
    dw = fused_block.conv3x3_dw(x, g)
    want = fused_block.conv3x3_dw_plain(x, g)
    bound = fused_block.conv3x3_dw_plain(x.abs(), g.abs())
    torch.cuda.synchronize()
    assert_dw_close(dw, want, bound)


@pytest.mark.parametrize("unaligned", ["x", "g"])
@pytest.mark.parametrize("B,D,C,H,W,Cout", _DW_STAGING_SHAPES + _DW_RING_SHAPES)
def test_conv3x3_dw_element_loads_equal_vector_loads(cuda, unaligned, B, D, C, H, W, Cout):
    """x or g at an odd element offset takes the element-load staging; the
    same values reach the same fragments, so dw has the same bits."""
    x, g = _dw_inputs((B, D, C, H, W), (B, D, Cout, H, W), 13, cuda)
    aligned = fused_block.conv3x3_dw(x, g)
    if unaligned == "x":
        x = _at_odd_offset(x)
    else:
        g = _at_odd_offset(g)
    dw = fused_block.conv3x3_dw(x, g)
    torch.cuda.synchronize()
    assert torch.equal(dw, aligned)
    assert_dw_close(dw, fused_block.conv3x3_dw_plain(x, g),
                    fused_block.conv3x3_dw_plain(x.abs(), g.abs()))


def test_dw_ring_shapes_split_as_their_comments_say(cuda):
    from runet_tpu_torch.kernels.conv_common import _CONV_DW_API, _library

    if torch.cuda.get_device_properties(cuda).multi_processor_count != 132:
        pytest.skip("the split counts are those of a 132-SM card")
    lib = _library(fused_block.DW_SOURCE, _CONV_DW_API)

    def tiles_per_split(B, D, C, H, W, Cout):
        n = int(lib.conv3x3_dw_splits(B, D, H, W, C, Cout, 132))
        k = B * D * -(-H // 8) * -(-W // 32)
        return [k * (s + 1) // n - k * s // n for s in range(n)]

    assert tiles_per_split(*_DW_RING_SHAPES[0]) == [1, 1]
    assert tiles_per_split(*_DW_RING_SHAPES[1]) == [3] * 6


# sha256 of dw's bytes from numpy inputs (seed 21) at six shapes: three
# main-path level shapes at D = 4 (levels 0, 2 and 3 of fine_kits, B 2) and
# three ring seams, recorded from the kernel that staged whole K-tiles
# synchronously, before the two-stage ring, on an NVIDIA H100 80GB HBM3 (132
# SMs). The split count, and so the order of the f32 sums, follows the SM
# count.
_DW_DIGESTS = {
    (2, 4, 32, 128, 128, 32):
        "70456dcedc85ddfdc40326d3e38dc6e4942f86bdb6416ba6e840b73a8c6692fc",
    (2, 4, 128, 32, 32, 128):
        "5fea9da3868a3c4335b096a518ba6ffd44be089d8bcc801d9d6cec8acfbc71db",
    (2, 4, 256, 16, 16, 256):
        "9fe4d9a133d5e1911a764597dcb8aba19c7b82be577bd6be35655fed24103500",
    (2, 9, 176, 8, 32, 256):
        "9095232b08cd068b0196b5e4ac9f05aeeb10ce892033970e8df35b0ab317e23b",
    (1, 3, 17, 4, 24, 8):
        "176726aab152b4815057636efe7922b199117d19fd74a2a0a47efdb8eb280df3",
    (1, 4, 1, 5, 40, 33):
        "1257caf7499751466e883723b72fd5d90eb78475bb29f8c3fcdf197f0c142f62",
}


def _dw_digest(shape, device):
    import hashlib

    B, D, C, H, W, Cout = shape
    x, g = _dw_inputs((B, D, C, H, W), (B, D, Cout, H, W), 21, device)
    dw = fused_block.conv3x3_dw(x, g)
    return hashlib.sha256(dw.cpu().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("shape", list(_DW_DIGESTS))
def test_conv3x3_dw_keeps_its_recorded_bits(cuda, shape):
    if torch.cuda.get_device_properties(cuda).multi_processor_count != 132:
        pytest.skip("the digests were recorded on a 132-SM card")
    assert _dw_digest(shape, cuda) == _DW_DIGESTS[shape]


def test_conv3x3_dw_kernel_is_deterministic_across_tile_seams(cuda):
    x, g = _dw_inputs((2, 3, 16, 9, 64), (2, 3, 32, 9, 64), 14, cuda)
    assert torch.equal(fused_block.conv3x3_dw(x, g), fused_block.conv3x3_dw(x, g))


# The stride-2 kernel stages each input line of a K-tile (65 columns) raw:
# by TMA tensor copies where x and g are 16-byte aligned, W % 8 == 0 and Wo
# % 8 == 0 (zero past the extents by the copy), else through a cp.async ring
# of eight 16-byte chunks and the word of columns 64-65 per x line (eight
# element loads per chunk and one for the 65th column where x has no
# 16-byte loads) and four chunks per g row.
_S2_DW_STAGING_SHAPES = [
    (1, 4, 16, 6, 8, 32),     # Wo = 4: only chunk 0 of each x line is real
    (1, 4, 32, 10, 16, 64),   # Wo = 8: chunks 2-7 lie past W; ragged H (Ho = 5)
    (2, 4, 24, 8, 32, 40),    # Wo = 16, B = 2, Cin and Cout off the tile sizes
    (1, 2, 1, 6, 64, 32),     # Wo = 32: the 65th column is the high pad; Cin = 1
    (1, 4, 16, 4, 6, 24),     # W = 6: element loads for x and g
    (1, 2, 48, 6, 18, 32),    # W = 18, Wo = 9
    (2, 2, 16, 6, 128, 32),   # Wo = 64: the 65th column of tile 0 is tile 1's first
]


@pytest.mark.parametrize("B,D,C,H,W,Cout", [
    (1, 4, 16, 4, 128, 32),
    (2, 8, 24, 6, 34, 48),    # B = 2, ragged tiles
    (1, 2, 1, 2, 2, 24),      # Cin = 1, minimal extents
    *_S2_DW_STAGING_SHAPES,
])
def test_conv3x3_s2_dw_kernel_matches_plain(cuda, B, D, C, H, W, Cout):
    x, g = _dw_inputs((B, D, C, H, W), (B, D // 2, Cout, H // 2, W // 2), 6, cuda)
    dw = strided_conv.conv3x3_s2_dw(x, g)
    want = strided_conv.conv3x3_s2_dw_plain(x, g)
    bound = strided_conv.conv3x3_s2_dw_plain(x.abs(), g.abs())
    torch.cuda.synchronize()
    assert_dw_close(dw, want, bound)


# The stride-2 kernel's blocks own 16 input x 64 output channels and stage
# each whole K-tile (4 output rows x 32 output columns of one (b, d)) in one
# of two stages, and skip the k-step over output columns 16-31 of a tile
# where they lie past Wo. Shapes at the ring's seams (split counts as on an
# H100 SXM, 132 SMs), x (B, D, C, H, W) -> Cout:
_S2_DW_RING_SHAPES = [
    (1, 4, 16, 8, 64, 32),      # two splits of one K-tile each; Cout 32: the second half idle
    (3, 4, 256, 8, 64, 320),    # four splits of 1, 2, 1, 2 K-tiles; split 1 crosses d and b
    (1, 4, 48, 12, 64, 96),     # Cout 96: an odd number of 32-channel tiles; Ho = 6
    (2, 4, 256, 8, 80, 320),    # Wo = 40: splits of two K-tiles, both k-steps, then one
]


@pytest.mark.parametrize("B,D,C,H,W,Cout", _S2_DW_RING_SHAPES)
def test_conv3x3_s2_dw_ring_shapes_match_plain(cuda, B, D, C, H, W, Cout):
    x, g = _dw_inputs((B, D, C, H, W), (B, D // 2, Cout, H // 2, W // 2), 18, cuda)
    dw = strided_conv.conv3x3_s2_dw(x, g)
    want = strided_conv.conv3x3_s2_dw_plain(x, g)
    bound = strided_conv.conv3x3_s2_dw_plain(x.abs(), g.abs())
    torch.cuda.synchronize()
    assert_dw_close(dw, want, bound)


@pytest.mark.parametrize("unaligned", ["x", "g"])
@pytest.mark.parametrize("B,D,C,H,W,Cout", _S2_DW_STAGING_SHAPES + _S2_DW_RING_SHAPES)
def test_conv3x3_s2_dw_element_loads_equal_vector_loads(cuda, unaligned, B, D, C, H, W, Cout):
    """x or g at an odd element offset takes the element-load staging; the
    same values reach the same fragments, so dw has the same bits."""
    x, g = _dw_inputs((B, D, C, H, W), (B, D // 2, Cout, H // 2, W // 2), 16, cuda)
    aligned = strided_conv.conv3x3_s2_dw(x, g)
    if unaligned == "x":
        x = _at_odd_offset(x)
    else:
        g = _at_odd_offset(g)
    dw = strided_conv.conv3x3_s2_dw(x, g)
    torch.cuda.synchronize()
    assert torch.equal(dw, aligned)
    assert_dw_close(dw, strided_conv.conv3x3_s2_dw_plain(x, g),
                    strided_conv.conv3x3_s2_dw_plain(x.abs(), g.abs()))


def test_s2_dw_ring_shapes_split_as_their_comments_say(cuda):
    from runet_tpu_torch.kernels.conv_common import _CONV_DW_API, _library

    if torch.cuda.get_device_properties(cuda).multi_processor_count != 132:
        pytest.skip("the split counts are those of a 132-SM card")
    lib = _library(strided_conv.DW_SOURCE, _CONV_DW_API)

    def tiles_per_split(B, D, C, H, W, Cout):
        n = int(lib.conv3x3_s2_dw_splits(B, D, H, W, C, Cout, 132))
        k = B * (D // 2) * -(-(H // 2) // 4) * -(-(W // 2) // 32)
        return [k * (s + 1) // n - k * s // n for s in range(n)]

    assert tiles_per_split(*_S2_DW_RING_SHAPES[0]) == [1, 1]
    assert tiles_per_split(*_S2_DW_RING_SHAPES[1]) == [1, 2, 1, 2]
    assert tiles_per_split(*_S2_DW_RING_SHAPES[2]) == [1, 1, 1, 1]
    assert tiles_per_split(*_S2_DW_RING_SHAPES[3]) == [2, 2, 2, 2]


# sha256 of dw's bytes from numpy inputs (seed 21), x (B, D, C, H, W) ->
# Cout: the four main-path levels of fine_kits' down convs at D = 8 (Do =
# 4), Cout 96, Wo = 9 (element loads for x and g) and two ring seams,
# recorded from the kernel of 9-warp blocks of 32 output channels that
# staged whole K-tiles synchronously, on an NVIDIA H100 80GB HBM3 (132 SMs).
# The split count, and so the order of the f32 sums, follows the SM count.
_S2_DW_DIGESTS = {
    (2, 8, 32, 128, 128, 64):
        "84bf7cca442c64e65d48303f4be23015852e20398127bb9c05196f0c3822c6f6",
    (2, 8, 64, 64, 64, 128):
        "6037ed9eae99695883d8a29194213ceaee940de6764dc85bd27f6f82711e9f88",
    (2, 8, 128, 32, 32, 256):
        "4ae14ddf1f861a63a4d377750d42aaec66d9fe10df330456dd80467ff39087db",
    (2, 8, 256, 16, 16, 320):
        "98fa020f1299094c53ea49088aa60b14c52a581612ff2ea7e3cc9cdfe1a4da6e",
    (1, 4, 48, 12, 64, 96):
        "bfabd3918b07438d188180b78c2fd2f6b1cc35ed2cfaa48ae13566d7d7506628",
    (1, 4, 24, 10, 18, 32):
        "0e7a9dec1a398f91746f4e25eff51de5da6870f10c17f2881791f7e47a1b13aa",
    (1, 4, 16, 8, 64, 32):  # splits of one K-tile
        "e8d9085d0f5c5882a6a88eee2bf22c5583b5cbc8ecaf09e900c45547ca39fc8a",
    (3, 4, 256, 8, 64, 320):  # a split across a d and a b boundary
        "da9e062fd3016018c5b3d31d80ae48af68c4d0f11e8374da645208ecd559df9a",
}


def _s2_dw_digest(shape, device):
    import hashlib

    B, D, C, H, W, Cout = shape
    x, g = _dw_inputs((B, D, C, H, W), (B, D // 2, Cout, H // 2, W // 2), 21, device)
    dw = strided_conv.conv3x3_s2_dw(x, g)
    return hashlib.sha256(dw.cpu().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("shape", list(_S2_DW_DIGESTS))
def test_conv3x3_s2_dw_keeps_its_recorded_bits(cuda, shape):
    if torch.cuda.get_device_properties(cuda).multi_processor_count != 132:
        pytest.skip("the digests were recorded on a 132-SM card")
    assert _s2_dw_digest(shape, cuda) == _S2_DW_DIGESTS[shape]


def test_conv3x3_s2_dw_kernel_is_deterministic_across_tile_seams(cuda):
    x, g = _dw_inputs((2, 2, 16, 6, 128), (2, 1, 32, 3, 64), 17, cuda)
    assert torch.equal(strided_conv.conv3x3_s2_dw(x, g), strided_conv.conv3x3_s2_dw(x, g))


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


# The attic conv's tile follows W and the packed Cout: 16 rows x 16 columns
# x 32 channels where W <= 16, else 8 x 32 x 64 where Cout_pad % 64 == 0 and
# 8 x 32 x 32 where it is 32 (``conv3d.conv3d_tile``); each (16-channel
# chunk, kd plane) phase comes by TMA copies where C % 8 == 0 and x is
# 16-byte aligned (the halo plane by element loads otherwise).
_ATTIC_CONV_SHAPES = [
    (7, 13, 29, 5, 11),       # no multiple of 8 anywhere: element loads
    (4, 8, 64, 16, 32),       # TMA copies, whole tiles
    (3, 9, 40, 24, 40),       # Cin % 16 = 8: a half-empty chunk; Cout ragged
    (2, 5, 7, 70, 33),        # tiny extents, Cin % 8 != 0 past 64 channels
    (4, 12, 16, 64, 64),      # W = 16: the widest volume of the 16 x 16 tile
    (4, 12, 17, 64, 64),      # W = 17: the narrowest of the 8 x 32 tiles (64 channels)
    (5, 13, 16, 128, 96),     # H = 13: a ragged 16-row tile
    (3, 9, 33, 32, 80),       # Cout 80: Cout_pad 96 takes the 32-channel tile; W = 33
    (4, 10, 40, 32, 64),      # Cout 64 at W > 16: the 64-channel tile; a ragged column tile
    (2, 9, 48, 56, 64),       # Cin % 16 = 8 in the 64-channel tile
    (1, 1, 1, 16, 32),        # one voxel: every tap but the centre reads zero fill
]


@pytest.mark.parametrize("D,H,W,C,Cout", _ATTIC_CONV_SHAPES)
def test_attic_conv_kernel_matches_plain(cuda, D, H, W, C, Cout):
    from runet_tpu_torch.kernels.attic import conv3d

    x, w = _ndhwc_inputs((D, H, W, C), Cout, 20, cuda)
    got = conv3d.conv3x3x3_same(x, w)
    want = conv3d.conv3x3x3_same_plain(x, w)
    torch.cuda.synchronize()
    assert_y_close(got, want)


@pytest.mark.parametrize("D,H,W,C,Cout", _ATTIC_CONV_SHAPES)
def test_attic_conv_element_loads_equal_tma_loads(cuda, D, H, W, C, Cout):
    """x one element past a 16-byte boundary takes the element-load
    instance, which fills the cells the TMA copies fill: y keeps its bits."""
    from runet_tpu_torch.kernels.attic import conv3d

    x, w = _ndhwc_inputs((D, H, W, C), Cout, 33, cuda)
    packed = pack_weight(w)
    assert torch.equal(conv3d.conv3x3x3_same(_at_odd_offset(x), w, packed),
                       conv3d.conv3x3x3_same(x, w, packed))


def _attic_digest(shape, device):
    """sha256 of y's bytes from numpy inputs (seed 32) at (D, H, W, C, Cout)."""
    import hashlib

    from runet_tpu_torch.kernels.attic import conv3d

    D, H, W, C, Cout = shape
    x, w = _ndhwc_inputs((D, H, W, C), Cout, 32, device)
    return hashlib.sha256(conv3d.conv3x3x3_same(x, w).cpu().view(torch.int16).numpy()
                          .tobytes()).hexdigest()


# Digests (``_attic_digest``) recorded from the kernel that staged each
# 16-channel chunk's three kd planes and 27 taps synchronously in 8 x 32 x
# 32 tiles, before the tiles followed W and Cout_pad and TMA filled a ring
# of kd planes, on an NVIDIA H100 80GB HBM3.
_ATTIC_DIGESTS = {
    (7, 13, 29, 5, 11):
        "1e5c43f3d24b061fcf290ad409e8cf4e1b86a1a11bfacafbcd03bfc943e1211a",
    (4, 8, 64, 16, 32):
        "b65ef2e6f86165898fd33aa8633ab2c0052cf1202af137abc76b96b800ac6bac",
    (3, 9, 40, 24, 40):
        "76df1104adfc2fe3f7fb560c5401c0352d522c8e50b728532e358f584d04d711",
    (2, 5, 7, 70, 33):
        "2573802e9f20c88fc11f02478fed1e98160e5fbaac92ee2e08f49314d745ede2",
    (4, 12, 16, 64, 64):
        "b957d55edcd68a18983fcfc323368732e0a2315a23d5aebe6fcdbad3c037a986",
    (4, 12, 17, 64, 64):
        "96445a634de9d9a4a105eba17f359dacce8e988420f79cb5849d998bcec877fd",
    (5, 13, 16, 128, 96):
        "d2f4bc938bb88cd1bbce3ac7e3cd6cff96151463d816d67bf8d5f4d6ea2e8f94",
    (3, 9, 33, 32, 80):
        "7e3f936d8c0f01e8dbacaf1068cfffc5a51b90484535f6ccbf6a4f389b2ff707",
    (4, 10, 40, 32, 64):
        "648ae4dbf4c38607cba9f003a19cef1a6a1e43c2d885c4c324db301020d975ad",
    (2, 9, 48, 56, 64):
        "1d6658420848b7f5a8b36a895f3658ef41cf5f90048e1b855906b522ae86d25e",
    (1, 1, 1, 16, 32):
        "67fc65a32238877c8fe4cdf072d94c5c83effb5414d0c86cd2c500de1d58000c",
}


@pytest.mark.parametrize("shape", _ATTIC_CONV_SHAPES)
def test_conv3x3x3_same_keeps_its_recorded_bits(cuda, shape):
    assert _attic_digest(shape, cuda) == _ATTIC_DIGESTS[shape]


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


# The v3 kernel's tile follows W: 16 rows x 16 columns x 32 channels where
# W <= 16, 8 x 32 x 64 where W > 16; each (16-channel chunk, kd plane) phase
# is staged through a two-stage cp.async ring (16-byte copies where C % 8 ==
# 0 and x is 16-byte aligned, element loads otherwise).
_V3_SHAPES = [
    (6, 9, 11, 24, 40),       # odd extents, ragged tiles
    (8, 16, 16, 128, 128),    # a deep level (fine_l2's widths)
    (4, 5, 7, 256, 64),       # fine_l3's input width
    (4, 12, 16, 64, 64),      # W = 16: the widest volume of the 16 x 16 tile
    (4, 12, 17, 64, 64),      # W = 17: the narrowest of the 8 x 32 tile
    (5, 13, 16, 128, 96),     # H = 13: a ragged 16-row tile
    (3, 9, 33, 40, 80),       # Cout 80: Cout_pad 96 half fills the second 64-channel
                              # tile; W = 33: a one-column second tile; Cin % 16 = 8
    (32, 32, 32, 128, 128),   # the kernel bench's fine_l2 (B = 1)
    (16, 16, 16, 256, 256),   # the kernel bench's fine_l3 (B = 1)
]


@pytest.mark.parametrize("D,H,W,C,Cout", _V3_SHAPES)
def test_attic_v3_kernel_matches_plain(cuda, D, H, W, C, Cout):
    from runet_tpu_torch.kernels.attic import conv_v3_deep

    x, w = _ndhwc_inputs((D, H, W, C), Cout, 22, cuda)
    y, s, q = conv_v3_deep.conv3x3_v3(x, w)
    yr, sr, qr = conv_v3_deep.conv3x3_v3_plain(x, w)
    torch.cuda.synchronize()
    n = D * H * W
    assert_conv_stats_close((y, s / n, q / n), (yr, sr / n, qr / n))


@pytest.mark.parametrize("D,H,W,C,Cout", _V3_SHAPES)
def test_attic_v3_element_loads_equal_vector_loads(cuda, D, H, W, C, Cout):
    """x one element past a 16-byte boundary takes the element-load
    instance, which fills the same shared cells: y, sums and sqs keep their
    bits."""
    from runet_tpu_torch.kernels.attic import conv_v3_deep

    x, w = _ndhwc_inputs((D, H, W, C), Cout, 29, cuda)
    packed = pack_weight(w)
    xo = _at_odd_offset(x)
    got, want = conv_v3_deep.conv3x3_v3(xo, w, packed), conv_v3_deep.conv3x3_v3(x, w, packed)
    for u, v in zip(got, want):
        assert torch.equal(u, v)


@pytest.mark.parametrize("D,H,W,C,Cout", _V3_SHAPES)
def test_attic_v3_y_equals_the_attic_conv_bit_for_bit(cuda, D, H, W, C, Cout):
    """Every accumulator takes its k-steps in the attic conv's order (16-channel
    chunks, then kd, kh, kw), so the two kernels' y are equal; the v3 sums
    are those of its own rounded y, to 1e-5 of Σ|y| and of Σy² per channel."""
    from runet_tpu_torch.kernels.attic import conv3d, conv_v3_deep

    x, w = _ndhwc_inputs((D, H, W, C), Cout, 30, cuda)
    packed = pack_weight(w)
    y, s, q = conv_v3_deep.conv3x3_v3(x, w, packed)
    assert torch.equal(y, conv3d.conv3x3x3_same(x, w, packed))
    yf = y.float()
    assert ((s - yf.sum((0, 1, 2))).abs() <= 1e-5 * yf.abs().sum((0, 1, 2))).all()
    qr = (yf * yf).sum((0, 1, 2))
    assert ((q - qr).abs() <= 1e-5 * qr).all()


def test_attic_v3_is_deterministic_across_tile_seams(cuda):
    """Several row, column and 64- or 32-channel tiles of both geometries:
    two runs give the same bits."""
    from runet_tpu_torch.kernels.attic import conv_v3_deep

    for shape, cout in (((3, 20, 70, 32), 160), ((3, 35, 12, 48), 96)):
        x, w = _ndhwc_inputs(shape, cout, 31, cuda)
        a, b = conv_v3_deep.conv3x3_v3(x, w), conv_v3_deep.conv3x3_v3(x, w)
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_v3_nblk_matches_the_library(cuda):
    """The Python tile table gives the library's count of moment partials
    (``launch_conv_stats`` sizes the scratch from the library's)."""
    from runet_tpu_torch.kernels.attic import conv_v3_deep
    from runet_tpu_torch.kernels.conv_common import _CONV_STATS_API, _library

    lib = _library(conv_v3_deep.SOURCE, _CONV_STATS_API)
    nblk = getattr(lib, f"{conv_v3_deep.SOURCE}_nblk")
    for D, H, W in ((4, 13, 8), (4, 13, 16), (4, 13, 17), (4, 13, 32), (4, 13, 128),
                    (32, 32, 32), (16, 16, 16), (1, 1, 1), (3, 35, 70)):
        assert nblk(D, H, W) == conv_v3_deep.v3_nblk(D, H, W), (D, H, W)


def _v3_digests(shape, device):
    """sha256 of y's bytes, and of sums' then sqs' bytes, from numpy inputs
    (seed 28) at (D, H, W, C, Cout)."""
    import hashlib

    from runet_tpu_torch.kernels.attic import conv_v3_deep

    D, H, W, C, Cout = shape
    x, w = _ndhwc_inputs((D, H, W, C), Cout, 28, device)
    y, s, q = conv_v3_deep.conv3x3_v3(x, w)
    y_bytes = y.cpu().view(torch.int16).numpy().tobytes()
    m_bytes = s.cpu().numpy().tobytes() + q.cpu().numpy().tobytes()
    return hashlib.sha256(y_bytes).hexdigest(), hashlib.sha256(m_bytes).hexdigest()


# Digests (``_v3_digests``) recorded from the kernel that staged 32-column x
# 32-channel tiles synchronously, before the tiles followed W and the kd
# planes went through a cp.async ring, on an NVIDIA H100 80GB HBM3: y at
# every shape, the moments where W > 16 (at W <= 16 the 16-row tile folds two
# rows per warp into each partial, another f32 order).
_V3_DIGESTS = {
    (6, 9, 11, 24, 40): (
        "d76caa23a01727ae5574160d3f22d2976b3daeb2e77c9f7e9bcfc43c2e90c69c",
        None),
    (8, 16, 16, 128, 128): (
        "d8a00d3f0ecd4de060dbf18502dec641a1f17b3c6238300df1393df4d0743ef0",
        None),
    (4, 5, 7, 256, 64): (
        "d19cd4e8702ae1a0cfaf759aa7c902f13fd0fc52ed9a300a20650a77d93f1b4d",
        None),
    (4, 12, 16, 64, 64): (
        "2bf4aafb85f2c305ce25d859cf26a0114408f990b5c984395c62ae50353ceebd",
        None),
    (4, 12, 17, 64, 64): (
        "ad36ccb592feb5b6f077103bab140f6b52bda04f350388461a4a37ce5ccbd7e4",
        "369cea58173abae35999c6ec9d9221821c363eb22f5320a1d6b4634f9dfd2b50"),
    (5, 13, 16, 128, 96): (
        "f0f227d651abf400f1eeb5ccc6cac938bd41a1f18442a9eab0c34ee1d424b1ff",
        None),
    (3, 9, 33, 40, 80): (
        "269dfb7d5a4ce11d89078ee458fff3c3e033506cce13a190ebf46ce58fb3a002",
        "6826cba1cd9ad866a4faf96684d0826a015e9899f62ecb13c152750b9f174833"),
    (32, 32, 32, 128, 128): (
        "d690b2e8e17a6118ed6776c78e561d01f04e8a599e0c9d5915da591b85760e9f",
        "1a0c791c57e5b5326e504d56a33aad35bfbd1af3adbb59de3545c63aa6b48907"),
    (16, 16, 16, 256, 256): (
        "24f8b6579ea3e27be36a650b576c2c2d44e586baced88e768bd5f05dd2ad0c87",
        None),
}


@pytest.mark.parametrize("shape", _V3_SHAPES)
def test_conv3x3_v3_keeps_its_recorded_bits(cuda, shape):
    y_digest, m_digest = _v3_digests(shape, cuda)
    want_y, want_m = _V3_DIGESTS[shape]
    assert y_digest == want_y
    if want_m is not None:
        assert m_digest == want_m


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


# The fused norm + LeakyReLU pass (kernels/norm_act.py): the activations the
# served nets hand it, (B, D, C, H, W) after each 3x3x3 conv. The coarse
# net's 128^3 grid at base 24 (4 levels), the fine nets' 160 and 192 x 160 x
# 256 ROIs at 32-320 (5 levels).
NORM_ACT_SERVED_SHAPES = [
    *[(1, 128 >> lvl, 24 << lvl, 128 >> lvl, 128 >> lvl) for lvl in range(4)],
    *[(1, d >> lvl, c, 160 >> lvl, 256 >> lvl) for d in (160, 192)
      for lvl, c in enumerate((32, 64, 128, 256, 320))],
]


def _norm_act_inputs(shape, layout, dtype, device, seed=0):
    """y (``layout``), its f32 (mean, sqmean) over each (sample, channel)
    and a non-trivial affine; channel 0's sqmean is set just under mean² so
    its variance clamps at 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    y = (1.5 + 2.0 * torch.randn(shape, generator=gen, device=device)).to(dtype)
    ax = 3 if layout == "dhcw" else 2
    dims = tuple(a for a in range(1, 5) if a != ax)
    mean = y.float().mean(dim=dims)
    sq = (y.float() * y.float()).mean(dim=dims)
    sq[:, 0] = mean[:, 0] * mean[:, 0] * (1 - 2.0 ** -20)
    C = shape[ax]
    scale = 1.0 + 0.2 * torch.randn(C, generator=gen, device=device)
    bias = 0.3 * torch.randn(C, generator=gen, device=device)
    return y, mean, sq, scale, bias


def _norm_act_pair(y, mean, sq, scale, bias, layout):
    from runet_tpu_torch.kernels import norm_act

    got = norm_act.norm_lrelu(y, mean, sq, scale, bias, 1e-5, 1e-2, layout)
    want = norm_act.norm_lrelu_plain(y, mean, sq, scale, bias, 1e-5, 1e-2, layout)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("shape", NORM_ACT_SERVED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_norm_act_kernel_equals_plain_at_served_shapes(cuda, shape):
    with torch.inference_mode():
        got, want = _norm_act_pair(*_norm_act_inputs(shape, "dchw", torch.bfloat16, cuda),
                                   "dchw")
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("layout,dtype,shape", [
    ("dhcw", torch.bfloat16, (1, 40, 40, 128, 64)),   # v1 blocks: planes of W
    ("dhcw", torch.bfloat16, (1, 10, 10, 320, 16)),
    ("dhcw", torch.bfloat16, (2, 3, 5, 7, 20)),       # P = 20: 8-byte vectors
    ("dchw", torch.bfloat16, (2, 3, 7, 3, 5)),        # P = 15: element loads
    ("dchw", torch.bfloat16, (2, 5, 24, 12, 20)),     # P = 240, B = 2
    ("dchw", torch.float32, (2, 4, 32, 12, 20)),      # f32: 4-wide vectors
    ("dhcw", torch.float32, (1, 3, 5, 6, 7)),
])
def test_norm_act_kernel_equals_plain_at_odd_shapes(cuda, layout, dtype, shape):
    got, want = _norm_act_pair(*_norm_act_inputs(shape, layout, dtype, cuda), layout)
    assert got.dtype == dtype and torch.equal(got, want)


def test_norm_act_kernel_reads_an_unaligned_view(cuda):
    """y 2 bytes off a 16-byte boundary: element loads, the same bits."""
    y, mean, sq, scale, bias = _norm_act_inputs((1, 4, 32, 16, 64), "dchw", torch.bfloat16,
                                                cuda)
    flat = torch.empty(y.numel() + 1, dtype=y.dtype, device=cuda)
    odd = flat[1:].view(y.shape)
    odd.copy_(y)
    got, want = _norm_act_pair(odd, mean, sq, scale, bias, "dchw")
    assert odd.data_ptr() % 16 and torch.equal(got, want)


def test_norm_act_kernel_is_counted_and_rejects_bad_input(cuda):
    from runet_tpu_torch.kernels import norm_act

    y, mean, sq, scale, bias = _norm_act_inputs((1, 4, 16, 8, 8), "dchw", torch.bfloat16, cuda)
    n = norm_act.launches
    norm_act.norm_lrelu(y, mean, sq, scale, bias)
    assert norm_act.launches == n + 1
    with pytest.raises(ValueError, match="contiguous"):
        norm_act.norm_lrelu(y.transpose(3, 4), mean, sq, scale, bias)
    with pytest.raises(TypeError):
        norm_act.norm_lrelu(y.half(), mean, sq, scale, bias)
    with pytest.raises(TypeError):
        norm_act.norm_lrelu(y, mean.bfloat16(), sq, scale, bias)
    with pytest.raises(ValueError):
        norm_act.norm_lrelu(y, mean[:, :8].contiguous(), sq, scale, bias)
    assert norm_act.launches == n + 1


def test_norm_act_kernel_is_captured_in_a_cuda_graph(cuda):
    from runet_tpu_torch.kernels import norm_act

    y, mean, sq, scale, bias = _norm_act_inputs((1, 10, 320, 10, 16), "dchw", torch.bfloat16,
                                                cuda)
    static = y.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        norm_act.norm_lrelu(static, mean, sq, scale, bias)  # builds and loads the library
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = norm_act.norm_lrelu(static, mean, sq, scale, bias)
    for seed in (1, 2):
        fresh = _norm_act_inputs(y.shape, "dchw", torch.bfloat16, cuda, seed)[0]
        static.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, norm_act.norm_lrelu_plain(fresh, mean, sq, scale, bias))


@pytest.mark.parametrize("fused_kernel", ["v2m", "v2", "v1"])
def test_conv_norm_act_routes_serving_to_the_pass_and_training_past_it(cuda, monkeypatch,
                                                                     fused_kernel):
    """Under inference_mode every ConvNormAct takes the pass (one launch and
    one ``norm_act.fused`` each) and the logits equal the plain chain's bit
    for bit; a train step's forward and backward take none."""
    from runet_tpu_torch.config import ModelConfig
    from runet_tpu_torch.kernels import norm_act
    from runet_tpu_torch.models import unet3d
    from runet_tpu_torch.utils import timing

    cfg = ModelConfig(num_classes=3, base_features=16, num_levels=3, fused_kernel=fused_kernel)
    gen = torch.Generator().manual_seed(0)
    model = unet3d.init_params(unet3d.create_train_model(cfg, device=cuda), gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "InstanceNorm" in name:
                p.uniform_(0.5, 1.5) if name.endswith("scale") else p.uniform_(-0.2, 0.2)
    blocks = sum(isinstance(m, unet3d.ConvNormAct) for m in model.modules())
    x = torch.randn((1, 16, 24, 32, 1), generator=gen).to(cuda)
    n = norm_act.launches
    with torch.enable_grad(), timing.span("test.train") as s:
        model(x).float().square().mean().backward()
    assert s.counters == {"norm_act.plain": blocks} and norm_act.launches == n
    with torch.inference_mode(), timing.span("test.serve") as s:
        fused = model(x)
    assert s.counters == {"norm_act.fused": blocks} and norm_act.launches == n + blocks
    monkeypatch.setattr(unet3d, "_fused_norm_act", lambda y, norm: False)
    with torch.inference_mode():
        plain = model(x)
    assert torch.equal(fused, plain)


@pytest.mark.parametrize("preset,tta", [("fine_kits", False), ("renal_anatomy", True)],
                         ids=["kits", "renal_anatomy_tta"])
def test_served_label_maps_equal_the_plain_chain(cuda, monkeypatch, preset, tta):
    """A KiTS-scale phantom through the cascade (the fine stage with 8-flip
    TTA for renal_anatomy): the label map's digest with the pass equals the
    one with every block on the plain chain."""
    import dataclasses
    import hashlib

    from runet_tpu_torch.data.phantom import make_phantom
    from runet_tpu_torch.infer.cascade import ModelBundle, predict_case
    from runet_tpu_torch.models import unet3d
    from runet_tpu_torch.params import load_model

    spacing = (0.78125, 0.78125, 3.0)
    cm, ccfg = load_model("coarse", device=cuda)
    fm, fcfg = load_model(preset, device=cuda)
    coarse, fine = ModelBundle.from_model(cm, ccfg), ModelBundle.from_model(fm, fcfg)
    if tta:
        fine = dataclasses.replace(fine, infer=dataclasses.replace(fine.infer, tta=True))
    img, _ = make_phantom((512, 512, 160), spacing, num_classes=fcfg.model.num_classes, seed=3)
    digests = []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(unet3d, "_fused_norm_act", lambda y, norm: False)
        pred = predict_case(coarse, fine, img, spacing, fcfg.cascade, device=cuda)
        assert pred.max() > 0
        digests.append(hashlib.sha256(pred.tobytes()).hexdigest())
    assert digests[0] == digests[1]
