"""The port's counterparts of the JAX package's public preprocessing,
tiling, blending, upsampling and norm-oracle functions against the JAX
functions on the same numpy inputs: ``gaussian_importance_map`` and
``depth_to_space_3d`` exactly, ``pad_volume`` values and padded shape
exactly, ``resample_to_shape`` to 1e-5, ``preprocess_case`` to 1e-4 and
``instance_norm_reference`` to 1e-5; and each against the port's own code
that computes the same thing inline (the cascade's staging, the dataset,
the sliding window, the model's pixel shuffle and InstanceNorm)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from runet_tpu.infer.gaussian import gaussian_importance_map as jax_gaussian
from runet_tpu.infer.sliding_window import pad_volume as jax_pad_volume
from runet_tpu.models.norm import instance_norm_reference as jax_instance_norm_reference
from runet_tpu.models.unet3d import depth_to_space_3d as jax_depth_to_space_3d
from runet_tpu.preprocess.normalize import preprocess_case as jax_preprocess_case
from runet_tpu.preprocess.resample import resample_to_shape as jax_resample_to_shape
from runet_tpu_torch.config import PreprocessConfig
from runet_tpu_torch.data.phantom import make_phantom
from runet_tpu_torch.infer import cascade as tc
from runet_tpu_torch.infer.gaussian import gaussian_importance_map, gaussian_importance_map_device
from runet_tpu_torch.infer.sliding_window import pad_volume, sliding_window_predict
from runet_tpu_torch.models.norm import InstanceNorm, instance_norm_reference
from runet_tpu_torch.models.unet3d import depth_to_space_3d, depth_to_space_dchw
from runet_tpu_torch.preprocess.normalize import preprocess_case
from runet_tpu_torch.preprocess.resample import (
    output_shape_for_spacing,
    resample_to_shape,
    resample_to_spacing,
)


# -- gaussian_importance_map ------------------------------------------------

@pytest.mark.parametrize("patch,sigma", [((16, 16, 16), 0.125), ((7, 12, 9), 0.125),
                                         ((5, 8, 3), 0.25)])
def test_gaussian_importance_map_equals_jax(patch, sigma):
    got = gaussian_importance_map(patch, sigma)
    want = jax_gaussian(patch, sigma)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert gaussian_importance_map(patch, sigma) is got  # cached


def test_gaussian_properties():
    g = gaussian_importance_map((16, 16, 16))
    assert g.shape == (16, 16, 16)
    assert g.max() == pytest.approx(1.0)
    assert (g > 0).all()
    np.testing.assert_allclose(g, g[::-1], atol=1e-6)
    np.testing.assert_allclose(g, g.transpose(1, 0, 2), atol=1e-6)
    assert g[7:9, 7:9, 7:9].max() == g.max()


@pytest.mark.parametrize("patch", [(16, 16, 16), (7, 12, 9)])
def test_host_map_and_device_map_agree(patch):
    """Both maps come from the same 1-D factors (``_axes``); the device map
    multiplies them in f32, so the two agree to f32 rounding."""
    host = gaussian_importance_map(patch)
    dev = gaussian_importance_map_device(patch, 0.125, "cpu").numpy()
    np.testing.assert_allclose(dev, host, rtol=1e-6, atol=0)


# -- pad_volume -------------------------------------------------------------

@pytest.mark.parametrize("shape,patch", [
    ((10, 7, 5), (8, 8, 8)),          # 3-D, two axes under the patch
    ((20, 18, 17), (16, 16, 16)),     # 3-D, every axis over: no padding
    ((6, 5, 4, 2), (8, 8, 8)),        # 4-D, every axis under
    ((20, 6, 9, 3), (16, 8, 8)),      # 4-D, one axis over, two under
])
def test_pad_volume_equals_jax(shape, patch):
    vol = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want, want_shape = jax_pad_volume(vol, patch, -3.5)
    x = torch.from_numpy(vol)
    got, got_shape = pad_volume(x, patch, -3.5)
    assert got_shape == tuple(want_shape) == tuple(max(s, p) for s, p in zip(shape, patch))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if got_shape == shape[:3]:
        assert got is x
    # A 0-d tensor pad value (the sliding window's default, the minimum).
    got_t, _ = pad_volume(x, patch, x.min())
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(jax_pad_volume(vol, patch,
                                                                           float(vol.min()))[0]))


def test_sliding_window_pads_through_pad_volume():
    """A volume under the patch: the window pass over ``pad_volume``'s
    output, cropped back, is the sliding window's own result on the
    unpadded volume (it pads with the same helper)."""
    k = 3

    def apply_fn(params, windows):
        x = windows[..., 0]
        return torch.stack([torch.sin(x * (i + 1)) for i in range(k)], dim=-1)

    vol = torch.from_numpy(np.random.default_rng(1).normal(size=(11, 9, 13)).astype(np.float32))
    patch = (16, 16, 16)
    padded, shape = pad_volume(vol, patch, vol.min())
    labels_p, probs_p = sliding_window_predict(apply_fn, None, padded, patch, k,
                                               return_probs=True)
    labels, probs = sliding_window_predict(apply_fn, None, vol, patch, k, return_probs=True)
    assert shape == patch
    assert torch.equal(labels_p[:11, :9, :13], labels)
    assert torch.equal(probs_p[:11, :9, :13], probs)


# -- resample_to_shape ------------------------------------------------------

@pytest.mark.parametrize("method,scale", [("linear", (0.5, 0.5, 0.5)),
                                          ("linear", (2.0, 1.7, 0.33)),
                                          ("linear", (1.0, 1.0, 1.0)),
                                          ("nearest", (1.9, 0.6, 1.3))])
def test_resample_to_shape_equals_jax(method, scale):
    rng = np.random.default_rng(1)
    if method == "linear":
        x = rng.normal(size=(17, 13, 11)).astype(np.float32)
    else:
        x = rng.integers(0, 5, size=(19, 10, 14)).astype(np.int32)
    out_shape = tuple(max(1, int(round(n / s))) for n, s in zip(x.shape, scale))
    src = (1.0, 1.0, 1.0)
    want = np.asarray(jax_resample_to_shape(x, out_shape, src, scale, method))
    got = resample_to_shape(torch.from_numpy(x), out_shape, src, scale, method)
    assert tuple(got.shape) == out_shape
    assert got.numpy().dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_roundtrip_native_iso_native_error_bound():
    g = np.mgrid[0:32, 0:32, 0:16].astype(np.float32)
    x = np.sin(g[0] / 5) + np.cos(g[1] / 7) + g[2] / 16.0
    native_spacing, iso_spacing = (0.8, 0.8, 2.0), (1.0, 1.0, 1.0)
    iso = resample_to_spacing(torch.from_numpy(x), native_spacing, iso_spacing)
    back = resample_to_shape(iso, x.shape, iso_spacing, native_spacing)
    assert tuple(back.shape) == x.shape
    assert np.abs(back.numpy() - x).mean() < 0.05
    want = np.asarray(jax_resample_to_shape(np.asarray(iso.numpy()), x.shape, iso_spacing,
                                            native_spacing))
    np.testing.assert_allclose(back.numpy(), want, rtol=0, atol=1e-5)


# -- preprocess_case --------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"hu_stats": None},
                                {"hu_window": (-200.0, 250.0), "hu_stats": (10.0, 50.0)}])
def test_preprocess_case_equals_jax(kw):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 200, size=(20, 20, 10)).astype(np.float32)
    want = np.asarray(jax_preprocess_case(x, (1.0, 1.0, 2.0), (1.0, 1.0, 1.0), **kw))
    got = preprocess_case(torch.from_numpy(x), (1.0, 1.0, 2.0), (1.0, 1.0, 1.0), **kw)
    assert tuple(got.shape) == (20, 20, 20) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def cascade_staging_bound(pp: PreprocessConfig, in_shape, src, dst) -> float:
    """Largest |cascade staging - preprocess_case| on a volume of integer HU
    values: the cascade's interpolation positions are f32 (``j·scale`` is
    off by up to one f32 ulp of the largest position, and so is each weight)
    where ``preprocess_case``'s are f64, each weight error scaled by a jump
    of at most 2000 HU between neighbours; a uint8 upload adds half a
    quantization step. In normalized units (over ``hu_stats``' std)."""
    out = output_shape_for_spacing(in_shape, src, dst)
    max_pos = max(o * d / s for o, s, d in zip(out, src, dst))
    weight_err = 3 * 2.0 * max_pos * 2.0 ** -24
    hu = 2000.0 * weight_err
    if pp.transfer_quant:
        lo, hi = pp.hu_window
        hu += (hi - lo) / 255.0 / 2.0
    return hu / pp.hu_stats[1] + 1e-5


@pytest.mark.parametrize("quant", [False, True])
def test_preprocess_case_agrees_with_the_cascade_staging(quant):
    """The cascade stages the same pipeline on the device with runtime f32
    positions (``resample_dynamic``) from an f16 or uint8 upload; on an
    integer-HU phantom the two agree within ``cascade_staging_bound``. The
    uint8 upload clips to the HU window before the resample, which does not
    commute with the interpolation at the window's edges, so that case is
    held on the phantom clipped to the window."""
    src, dst = (0.78125, 0.78125, 3.0), (0.8, 0.8, 0.8)
    img, _ = make_phantom((48, 40, 12), src, num_classes=3, seed=0)
    pp = PreprocessConfig(spacing=dst, transfer_quant=quant)
    img = np.clip(np.rint(img), *pp.hu_window) if quant else np.rint(img)
    want = preprocess_case(torch.from_numpy(img), src, dst, pp.hu_window, pp.hu_stats)
    out_shape = output_shape_for_spacing(img.shape, src, dst)
    scale = np.asarray([d / s for s, d in zip(src, dst)], np.float32)
    got = tc._stage_resample_in(tc._upload(img, pp, "cpu"), out_shape, scale, pp)
    assert tuple(got.shape) == tuple(want.shape)
    err = (got - want).abs().max().item()
    assert err <= cascade_staging_bound(pp, img.shape, src, dst), err


def test_prepare_case_is_preprocess_case(tmp_path):
    """The dataset's image is ``preprocess_case`` of the loaded volume."""
    from runet_tpu_torch.data.dataset import index_cases, prepare_case
    from runet_tpu_torch.data.phantom import write_phantom_dataset
    from runet_tpu_torch.io.nifti import load_volume

    write_phantom_dataset(tmp_path, num_cases=1, shape=(24, 20, 10), spacing=(1.0, 1.0, 2.5))
    rec = index_cases(tmp_path)[0]
    pp = PreprocessConfig(spacing=(1.5, 1.5, 1.5))
    case = prepare_case(rec, pp, device="cpu")
    vol = load_volume(rec.image_path)
    want = preprocess_case(torch.from_numpy(np.array(vol.data, np.float32)), vol.spacing,
                           pp.spacing, pp.hu_window, pp.hu_stats)
    assert np.array_equal(case.image, want.numpy())


# -- depth_to_space_3d ------------------------------------------------------

@pytest.mark.parametrize("shape,r", [((1, 2, 2, 2, 24), 2), ((2, 3, 4, 5, 16), 2),
                                     ((1, 2, 3, 2, 54), 3)])
def test_depth_to_space_3d_equals_jax_and_the_dchw_shuffle(shape, r):
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    got = depth_to_space_3d(torch.from_numpy(x), r)
    want = np.array(jax_depth_to_space_3d(jnp.asarray(x), r))
    assert torch.equal(got, torch.from_numpy(want))
    dchw = depth_to_space_dchw(torch.from_numpy(x).permute(0, 1, 4, 2, 3), r)
    assert torch.equal(got, dchw.permute(0, 1, 3, 4, 2))


def test_depth_to_space_layout():
    # Voxel (d, h, w) block (a, b, c) channel f lands at (2d+a, 2h+b, 2w+c, f).
    B, D, H, W, F = 1, 2, 2, 2, 3
    x = np.arange(B * D * H * W * 8 * F, dtype=np.float32).reshape(B, D, H, W, 8 * F)
    y = depth_to_space_3d(torch.from_numpy(x), 2).numpy()
    assert y.shape == (1, 4, 4, 4, 3)
    for d in range(D):
        for a in range(2):
            for b in range(2):
                for c in range(2):
                    block = (a * 2 + b) * 2 + c
                    np.testing.assert_array_equal(y[0, 2 * d + a, b, c],
                                                  x[0, d, 0, 0, block * F:(block + 1) * F])


# -- instance_norm_reference ------------------------------------------------

@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_reference_equals_jax(affine):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 3, 4, 5, 6)) * 3 + 1.5).astype(np.float32)
    scale = bias = None
    if affine:
        scale = rng.normal(size=(6,)).astype(np.float32)
        bias = rng.normal(size=(6,)).astype(np.float32)
    want = np.asarray(jax_instance_norm_reference(
        jnp.asarray(x), None if scale is None else jnp.asarray(scale),
        None if bias is None else jnp.asarray(bias)))
    got = instance_norm_reference(
        torch.from_numpy(x), None if scale is None else torch.from_numpy(scale),
        None if bias is None else torch.from_numpy(bias))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if not affine:
        assert np.abs(got.numpy().mean(axis=(1, 2, 3))).max() < 1e-5


def test_instance_norm_reference_against_the_model_norm():
    """The model's InstanceNorm in f32 (single-pass E[x²]-µ², clamped) on
    NDHWC against the two-pass oracle, scale and bias set."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=(2, 6, 5, 4, 8)) * 2 + 0.5).astype(np.float32))
    norm = InstanceNorm(8, dtype=torch.float32)
    scale = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
    with torch.no_grad():
        norm.scale.copy_(scale)
        norm.bias.copy_(bias)
        got = norm(x, channel_axis=-1)
    want = instance_norm_reference(x, scale, bias)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
