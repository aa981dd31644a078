"""The port's data path against the JAX package on the CPU: augmentation
(apply halves with fixed parameters; draws by their distributions), the
patch sampler, NIfTI I/O, static resampling, case preparation and the
prefetching loader.

Tolerances: geometric transforms and nearest resampling are exact; linear
resampling and zoom are f32 matrix products with at most two nonzeros per
row, summed in possibly another order (atol 1e-5 on unit-scale data, 1e-3
on HU-scale data); a per-volume z-score reduces its mean and std in another
order (rtol 2e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from runet_tpu.config import PreprocessConfig as JPreprocessConfig
from runet_tpu.data import augment as ja
from runet_tpu.data import dataset as jd
from runet_tpu.data import sampler as js
from runet_tpu.data.phantom import write_phantom_dataset as jax_write_phantom_dataset
from runet_tpu.io import nifti as jn
from runet_tpu.preprocess import resample as jr
from runet_tpu_torch.config import PreprocessConfig
from runet_tpu_torch.data import augment as ta
from runet_tpu_torch.data import dataset as td
from runet_tpu_torch.data import sampler as tsamp
from runet_tpu_torch.data.phantom import write_phantom_dataset
from runet_tpu_torch.data.pipeline import PatchLoader
from runet_tpu_torch.io import nifti as tn
from runet_tpu_torch.preprocess import resample as tr


def _img_lab(seed, shape=(12, 12, 10), c=1):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal(shape + (c,)).astype(np.float32)
    lab = rng.integers(0, 3, shape).astype(np.int32)
    return img, lab


def test_flip_and_rot90_match_jnp():
    img, lab = _img_lab(0)
    for flips in [(True, False, False), (False, True, True), (True, True, True)]:
        gi, gl = ta.apply_flip(torch.from_numpy(img), torch.from_numpy(lab), flips)
        wi, wl = jnp.asarray(img), jnp.asarray(lab)
        for axis, do in enumerate(flips):
            if do:
                wi, wl = jnp.flip(wi, axis), jnp.flip(wl, axis)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    for k in range(4):
        gi, gl = ta.apply_rot90(torch.from_numpy(img), torch.from_numpy(lab), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(jnp.rot90(jnp.asarray(img), k, (0, 1))))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(jnp.rot90(jnp.asarray(lab), k, (0, 1))))


@pytest.mark.parametrize("n", [16, 13])
def test_zoom_bank_matches_jax(n):
    lin, nst = ta.zoom_matrix_bank(n)
    jlin, jnst = ja._zoom_matrix_bank(n, ja.ZOOM_FACTORS)
    np.testing.assert_array_equal(lin, jlin)
    np.testing.assert_array_equal(nst, jnst)


@pytest.mark.parametrize("index", range(len(ta.ZOOM_FACTORS)))
def test_zoom_matches_jax(index):
    img, lab = _img_lab(1, shape=(12, 10, 8), c=2)
    gi, gl = ta.apply_zoom(torch.from_numpy(img), torch.from_numpy(lab), index)
    wi, wl = jnp.asarray(img), jnp.asarray(lab).astype(jnp.float32)
    for axis in range(3):
        lin, nst = ja._zoom_matrix_bank(img.shape[axis], ja.ZOOM_FACTORS)
        wi = ja._zoom_axis(wi, axis, jnp.asarray(lin[index]))
        wl = ja._zoom_axis(wl, axis, jnp.asarray(nst[index]))
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-5)
    np.testing.assert_array_equal(gl.numpy(), np.round(np.asarray(wl)).astype(np.int32))
    assert gl.dtype == torch.int32


def test_augment_one_order_matches_jax_composition():
    """flip → rot90 → zoom → intensity with fixed parameters and the same
    noise field, against the same JAX pieces in augment_one's order."""
    img, lab = _img_lab(2, shape=(10, 10, 8))
    noise = np.random.default_rng(3).standard_normal(img.shape).astype(np.float32)
    p = ta.AugmentParams(flips=(True, False, True), rot90=3, zoom=5, scale=1.07, shift=-0.04)
    gi, gl = ta.augment_one(torch.from_numpy(img), torch.from_numpy(lab), p,
                            torch.from_numpy(noise))
    wi, wl = jnp.flip(jnp.flip(jnp.asarray(img), 0), 2), jnp.flip(jnp.flip(jnp.asarray(lab), 0), 2)
    wi, wl = jnp.rot90(wi, 3, (0, 1)), jnp.rot90(wl, 3, (0, 1))
    wlf = wl.astype(jnp.float32)
    for axis in range(3):
        lin, nst = ja._zoom_matrix_bank(img.shape[axis], ja.ZOOM_FACTORS)
        wi = ja._zoom_axis(wi, axis, jnp.asarray(lin[5]))
        wlf = ja._zoom_axis(wlf, axis, jnp.asarray(nst[5]))
    wi = wi * 1.07 + (-0.04) + jnp.asarray(noise) * 0.05
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-5)
    np.testing.assert_array_equal(gl.numpy(), np.round(np.asarray(wlf)).astype(np.int32))


def test_augment_draws_by_counts():
    """The draws follow JAX's distributions: a fair coin per flip axis,
    a uniform quarter turn (square planes only), a uniform zoom index,
    scale ~ U(0.9, 1.1), shift ~ U(-0.1, 0.1)."""
    gen = torch.Generator().manual_seed(0)
    n = 4000
    draws = [ta.draw_params(gen, (8, 8, 4)) for _ in range(n)]
    flips = np.array([d.flips for d in draws], np.float64)
    assert np.all(np.abs(flips.mean(0) - 0.5) < 0.03)
    rots = np.bincount([d.rot90 for d in draws], minlength=4) / n
    assert np.all(np.abs(rots - 0.25) < 0.03)
    zooms = np.bincount([d.zoom for d in draws], minlength=7) / n
    assert np.all(np.abs(zooms - 1 / 7) < 0.025)
    scale = np.array([d.scale for d in draws])
    shift = np.array([d.shift for d in draws])
    assert 0.9 <= scale.min() and scale.max() <= 1.1 and abs(scale.mean() - 1.0) < 0.005
    assert -0.1 <= shift.min() and shift.max() <= 0.1 and abs(shift.mean()) < 0.005
    assert all(d.rot90 == 0 for d in (ta.draw_params(gen, (8, 6, 4)) for _ in range(50)))
    # augment_batch: per-sample draws, shapes and label values preserved.
    img, lab = _img_lab(4, shape=(8, 8, 6))
    images = torch.from_numpy(np.stack([img, img]))
    labels = torch.from_numpy(np.stack([lab, lab]))
    oi, ol = ta.augment_batch(images, labels, torch.Generator().manual_seed(1),
                              torch.Generator().manual_seed(2))
    assert oi.shape == images.shape and ol.shape == labels.shape
    assert set(np.unique(ol.numpy())) <= {0, 1, 2}


def _cases(tmp_path, n=2, shape=(40, 36, 24)):
    write_phantom_dataset(tmp_path / "data", num_cases=n, shape=shape)
    pp = dict(spacing=(1.5, 1.5, 2.5), hu_stats=None)
    return (td.prepare_dataset(tmp_path / "data", PreprocessConfig(**pp), device="cpu"),
            jd.prepare_dataset(tmp_path / "data", JPreprocessConfig(**pp)))


def test_prepare_case_and_sampler_match_jax(tmp_path):
    tcases, jcases = _cases(tmp_path)
    assert [c.case_id for c in tcases] == [c.case_id for c in jcases]
    for t, j in zip(tcases, jcases):
        assert t.image.shape == j.image.shape and t.native_shape == j.native_shape
        # Per-volume z-score: mean and std reduced in another order.
        np.testing.assert_allclose(t.image, j.image, rtol=2e-5, atol=1e-5)
        np.testing.assert_array_equal(t.labels, j.labels)
        assert sorted(t.fg_coords) == sorted(j.fg_coords)
        for k in t.fg_coords:
            np.testing.assert_array_equal(t.fg_coords[k], j.fg_coords[k])
    # Same seed, same cases → the same patches, patch for patch (including
    # the padded crop of a patch larger than the volume).
    for patch, fg in [((16, 16, 16), 0.5), ((48, 16, 32), 1.0)]:
        rt, rj = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(4):
            ti, tl = tsamp.sample_batch(rt, tcases, 2, patch, fg, np.float16, np.uint8)
            ji, jl = js.sample_batch(rj, jcases, 2, patch, fg, np.float16, np.uint8)
            np.testing.assert_array_equal(tl, jl)
            # The two images differ in the last f32 bits, so an f16 patch
            # value may round one f16 ulp (2^-10 relative) apart.
            np.testing.assert_allclose(ti.astype(np.float32), ji.astype(np.float32),
                                       rtol=2.0 ** -10, atol=1e-3)


def test_prepare_case_cached_and_folds(tmp_path):
    tcases, _ = _cases(tmp_path, n=3, shape=(24, 24, 16))
    pp = PreprocessConfig(spacing=(1.5, 1.5, 2.5), hu_stats=None)
    recs = td.index_cases(tmp_path / "data")
    assert [r.case_id for r in recs] == [r.case_id for r in jd.index_cases(tmp_path / "data")]
    first = td.prepare_case_cached(recs[0], pp, tmp_path / "cache", device="cpu")
    again = td.prepare_case_cached(recs[0], pp, tmp_path / "cache", device="cpu")
    assert isinstance(again.image, np.memmap)
    np.testing.assert_array_equal(np.asarray(again.image), tcases[0].image)
    np.testing.assert_array_equal(np.asarray(first.labels), tcases[0].labels)
    trn, val = td.split_folds(list(range(7)), 3, 1)
    assert (trn, val) == jd.split_folds(list(range(7)), 3, 1)
    with pytest.raises(ValueError):
        td.split_folds([1, 2], 3, 0)


def test_nifti_bytes_roundtrip_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    for data in [rng.standard_normal((5, 4, 3)).astype(np.float32),
                 rng.integers(0, 5, (6, 3, 2)).astype(np.uint8)]:
        b = tn.volume_to_bytes(data, spacing=(0.7, 0.8, 2.5))
        assert b == jn.volume_to_bytes(data, spacing=(0.7, 0.8, 2.5))
        vol = tn.volume_from_bytes(b)
        np.testing.assert_array_equal(vol.data, data)
        assert vol.spacing == pytest.approx((0.7, 0.8, 2.5))
        np.testing.assert_array_equal(vol.affine, jn.volume_from_bytes(b).affine)
    tn.save_volume(tmp_path / "v.nii", data, spacing=(1.0, 2.0, 3.0))
    np.testing.assert_array_equal(jn.load_volume(tmp_path / "v.nii").data, data)


@pytest.mark.parametrize("in_shape,out_shape,scale", [
    ((20, 16, 12), (13, 16, 30), (1.5, 1.0, 0.4)),
    ((9, 9, 9), (9, 9, 9), (1.0, 1.0, 1.0)),
    ((17, 11, 6), (8, 22, 6), (2.1, 0.5, 1.0)),
])
def test_static_resample_matches_jax(in_shape, out_shape, scale):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(in_shape) * 100).astype(np.float32)
    lab = rng.integers(0, 4, in_shape).astype(np.int32)
    got = tr.resample(torch.from_numpy(x), out_shape, scale, "linear").numpy()
    want = np.asarray(jr.resample(jnp.asarray(x), out_shape, scale, "linear"))
    np.testing.assert_allclose(got, want, atol=1e-3)
    gl = tr.resample(torch.from_numpy(lab), out_shape, scale, "nearest")
    assert gl.dtype == torch.int32
    np.testing.assert_array_equal(
        gl.numpy(), np.asarray(jr.resample(jnp.asarray(lab), out_shape, scale, "nearest")))
    src, dst = (0.8, 0.8, 2.5), (1.6, 0.7, 1.0)
    np.testing.assert_allclose(
        tr.resample_to_spacing(torch.from_numpy(x), src, dst).numpy(),
        np.asarray(jr.resample_to_spacing(jnp.asarray(x), src, dst)), atol=1e-3)


def test_phantom_dataset_files_match_jax(tmp_path):
    write_phantom_dataset(tmp_path / "t", num_cases=1, shape=(16, 12, 8))
    jax_write_phantom_dataset(tmp_path / "j", num_cases=1, shape=(16, 12, 8))
    for name in ("imaging.nii.gz", "segmentation.nii.gz"):
        a = tn.load_volume(tmp_path / "t" / "case_00000" / name)
        b = jn.load_volume(tmp_path / "j" / "case_00000" / name)
        np.testing.assert_array_equal(a.data, b.data)
        assert a.spacing == b.spacing


def test_patch_loader_batches_and_dead_worker(tmp_path):
    tcases, _ = _cases(tmp_path, n=1, shape=(24, 24, 16))
    loader = PatchLoader(tcases, batch_size=2, patch_size=(8, 8, 8), seed=3, device="cpu")
    try:
        ref = np.random.default_rng(3)
        for _ in range(3):
            images, labels = next(loader)
            ri, rl = tsamp.sample_batch(ref, tcases, 2, (8, 8, 8), 0.5, np.float16, np.uint8)
            assert images.dtype == torch.float16 and labels.dtype == torch.uint8
            np.testing.assert_array_equal(images.numpy(), ri)
            np.testing.assert_array_equal(labels.numpy(), rl)
    finally:
        loader.close()
    assert not loader._thread.is_alive()

    class Broken:
        image = property(lambda self: (_ for _ in ()).throw(OSError("bad case file")))

    bad = PatchLoader([Broken()], batch_size=1, patch_size=(4, 4, 4), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="worker"):
            next(bad)
    finally:
        bad.close()
    assert not bad._thread.is_alive()
