"""The port's preprocessing, packing and host helpers against the JAX
package on the same numpy inputs: resampling and normalization to 1e-5,
label resampling, dequantization, packing and the window tables exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from runet_tpu.data.phantom import make_phantom as jax_make_phantom
from runet_tpu.infer import cascade as jc
from runet_tpu.infer import gaussian as jg
from runet_tpu.infer import packing as jp
from runet_tpu.infer import sliding_window as jsw
from runet_tpu.preprocess.normalize import normalize as jax_normalize
from runet_tpu.preprocess.resample import (
    output_shape_for_spacing as jax_out_shape,
    resample_dynamic as jax_resample_dynamic,
    resample_labels_onehot_dynamic as jax_resample_labels,
)
from runet_tpu_torch.config import PreprocessConfig
from runet_tpu_torch.data.phantom import make_phantom
from runet_tpu_torch.infer import cascade as tc
from runet_tpu_torch.infer import gaussian as tg
from runet_tpu_torch.infer import packing as tp
from runet_tpu_torch.infer import sliding_window as tsw
from runet_tpu_torch.preprocess.normalize import normalize
from runet_tpu_torch.preprocess.resample import (
    output_shape_for_spacing,
    resample_dynamic,
    resample_labels_onehot_dynamic,
)


@pytest.mark.parametrize("in_shape,out_shape,scale", [
    ((20, 18, 11), (16, 16, 14), (1.25, 1.1, 0.75)),
    ((9, 7, 5), (9, 7, 5), (1.0, 1.0, 1.0)),
    ((31, 12, 8), (50, 6, 9), (0.6, 2.0, 0.9)),
])
def test_resample_dynamic_matches_jax(in_shape, out_shape, scale):
    x = np.random.default_rng(0).normal(size=in_shape).astype(np.float32) * 100
    sc = np.asarray(scale, np.float32)
    want = np.asarray(jax_resample_dynamic(jnp.asarray(x), out_shape, sc))
    got = resample_dynamic(torch.from_numpy(x), out_shape, sc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * 100)


def test_resample_dynamic_f16_input_matches_jax():
    x = (np.random.default_rng(1).normal(size=(12, 10, 8)) * 300).astype(np.float16)
    sc = np.asarray([0.7, 1.3, 2.0], np.float32)
    want = np.asarray(jax_resample_dynamic(jnp.asarray(x), (16, 8, 4), sc))
    got = resample_dynamic(torch.from_numpy(x), (16, 8, 4), sc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("num_classes", [3, 5])
def test_resample_labels_onehot_matches_jax_exactly(num_classes):
    _, seg = make_phantom((40, 36, 20), num_classes=num_classes, seed=2)
    sc = np.asarray([0.8, 1.27, 0.375], np.float32)
    out = (33, 46, 48)
    want = np.asarray(jax_resample_labels(jnp.asarray(seg.astype(np.int32)), out, sc, num_classes))
    got = resample_labels_onehot_dynamic(torch.from_numpy(seg.astype(np.int32)), out, sc,
                                         num_classes).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_classes", [3, 5])
def test_static_resample_labels_onehot_matches_jax_exactly(num_classes):
    from runet_tpu.preprocess.resample import resample_labels_onehot as jax_static
    from runet_tpu_torch.preprocess.resample import resample_labels_onehot

    _, seg = make_phantom((40, 36, 20), num_classes=num_classes, seed=3)
    for out, sc in [((33, 46, 48), (0.8, 1.27, 0.375)), ((40, 18, 20), (1.0, 2.0, 1.0))]:
        want = np.asarray(jax_static(jnp.asarray(seg.astype(np.int32)), out, sc, num_classes))
        got = resample_labels_onehot(torch.from_numpy(seg.astype(np.int32)), out, sc,
                                     num_classes)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("order", [0, 1])
def test_numpy_reference_resample_matches_jax_and_the_resampler(order):
    from runet_tpu.preprocess.resample import numpy_reference_resample as jax_ref
    from runet_tpu_torch.preprocess.resample import numpy_reference_resample, resample

    x = np.random.default_rng(4).normal(size=(12, 10, 8)).astype(np.float32)
    out, sc = (16, 8, 5), (0.7, 1.3, 1.6)
    ref = numpy_reference_resample(x, out, sc, order=order)
    np.testing.assert_array_equal(ref, jax_ref(x, out, sc, order=order))
    # The oracle shares the resampler's coordinate convention.
    got = resample(torch.from_numpy(x), out, sc, "linear" if order else "nearest").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("stats", [(100.93, 76.9), None])
def test_normalize_matches_jax(stats):
    x = np.random.default_rng(3).normal(size=(10, 9, 8)).astype(np.float32) * 400
    want = np.asarray(jax_normalize(jnp.asarray(x), (-79.0, 304.0), stats))
    got = normalize(torch.from_numpy(x), (-79.0, 304.0), stats).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_output_shape_for_spacing_matches_jax():
    for shape, src, dst in [((512, 512, 160), (0.78125, 0.78125, 3.0), (4.0, 4.0, 4.0)),
                            ((97, 13, 5), (0.5, 1.0, 5.0), (0.8, 0.8, 0.8))]:
        assert output_shape_for_spacing(shape, src, dst) == jax_out_shape(shape, src, dst)


@pytest.mark.parametrize("quant,quant4,z", [(False, False, 9), (True, False, 9),
                                            (True, True, 9), (True, True, 8)])
def test_transfer_and_dequant_match_jax(quant, quant4, z):
    img = np.random.default_rng(4).normal(size=(6, 5, z)).astype(np.float32) * 300
    img[0, 0, :3] = [-79.0 + 383.0 / 510, 304.0, -1000.0]  # half-step ties, clip edges
    pp = PreprocessConfig(transfer_quant=quant, transfer_quant4=quant4)
    up = tc._to_transfer_dtype(img, pp)
    np.testing.assert_array_equal(up, jc._to_transfer_dtype(img, pp))
    if quant4:
        want = np.asarray(jc._dequant4(jnp.asarray(up), pp.hu_window, z))
        got = tc._dequant4(torch.from_numpy(up), pp.hu_window, z).numpy()
    else:
        want = np.asarray(jc._dequant(jnp.asarray(up), pp.hu_window), np.float32)
        got = tc._dequant(torch.from_numpy(up), pp.hu_window).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("z", [1, 7, 8, 13])
def test_packers_match_jax(z):
    rng = np.random.default_rng(z)
    for pack_t, pack_j, unpack, hi in [
        (tp.pack_nibbles, jp.pack_nibbles, tp.unpack_nibbles, 16),
        (tp.pack_crumbs, jp.pack_crumbs, tp.unpack_crumbs, 4),
        (tp.pack_bits, jp.pack_bits, tp.unpack_bits, 2),
    ]:
        lab = rng.integers(0, hi, size=(3, 4, z)).astype(np.uint8)
        got = pack_t(torch.from_numpy(lab)).numpy()
        np.testing.assert_array_equal(got, np.asarray(pack_j(jnp.asarray(lab))))
        np.testing.assert_array_equal(unpack(got, z), lab)
    for k in (2, 3, 4, 5, 16, 17):
        assert tp.pack_width(k) == jp.pack_width(k)


def test_gaussian_maps_match_jax():
    for patch in [(16, 12, 8), (32, 32, 32)]:
        np.testing.assert_allclose(
            tg.gaussian_importance_map_device(patch, 0.125, "cpu").numpy(),
            np.asarray(jg.gaussian_importance_map_device(patch, 0.125)), rtol=1e-6)


def test_window_tables_match_jax():
    for shape, patch, ov, wb in [((70, 40, 33), (32, 32, 32), 0.5, 1),
                                 ((200, 128, 90), (64, 64, 32), 0.25, 3)]:
        np.testing.assert_array_equal(tsw.make_start_table(shape, patch, ov, wb),
                                      jsw.make_start_table(shape, patch, ov, wb))
        assert tsw.expand_window_size(shape, patch, 8.0) == jsw.expand_window_size(shape, patch, 8.0)


def test_phantom_copy_is_identical():
    for kw in [dict(seed=0), dict(seed=3, num_classes=5, tumor_lobes=2)]:
        a = make_phantom((24, 20, 16), **kw)
        b = jax_make_phantom((24, 20, 16), **kw)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
