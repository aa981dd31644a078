"""The port's serving cascade against ``runet_tpu.infer.cascade`` on the
same (64, 64, 48) phantom: with oracle "models" that decode the input value
as the class (labels must be equal voxel for voxel), and with a small U-Net
whose JAX-initialized weights are carried across (labels agree on >= 99.9%
of voxels)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runet_tpu.config import CascadeConfig as JCascade, InferConfig as JInfer
from runet_tpu.config import ModelConfig as JModel, PreprocessConfig as JPre
from runet_tpu.infer import cascade as jc
from runet_tpu.infer import postprocess as jpost
from runet_tpu.models.unet3d import create_model, init_params
from runet_tpu_torch.config import CascadeConfig, InferConfig, ModelConfig, PreprocessConfig
from runet_tpu_torch.data.phantom import make_phantom
from runet_tpu_torch.infer import cascade as tc
from runet_tpu_torch.infer import postprocess as tpost
from runet_tpu_torch.models.unet3d import UNet3D
from runet_tpu_torch.params import load_state

SPACING = (1.0, 1.0, 1.5)


def _pp(spacing, **kw):
    return dict(spacing=spacing, hu_window=(0.0, 100.0), hu_stats=(0.0, 1.0), **kw)


def _jax_class_oracle(k):
    def apply_fn(params, windows):
        x = jnp.clip(jnp.round(windows[..., 0]).astype(jnp.int32), 0, k - 1)
        return 20.0 * jax.nn.one_hot(x, k)
    return apply_fn


def _jax_binary_oracle():
    def apply_fn(params, windows):
        x = windows[..., 0]
        return jnp.stack([10.0 * (0.5 - x), 10.0 * (x - 0.5)], axis=-1)
    return apply_fn


def _torch_class_oracle(k):
    def apply_fn(params, windows):
        x = torch.clamp(torch.round(windows[..., 0]).long(), 0, k - 1)
        return 20.0 * torch.nn.functional.one_hot(x, k).float()
    return apply_fn


def _torch_binary_oracle():
    def apply_fn(params, windows):
        x = windows[..., 0]
        return torch.stack([10.0 * (0.5 - x), 10.0 * (x - 0.5)], dim=-1)
    return apply_fn


def _bundles(patch=(32, 32, 32), c_sp=(2.0, 2.0, 2.0), f_sp=(1.0, 1.0, 1.0), **infer):
    jcoarse = jc.ModelBundle(_jax_binary_oracle(), {}, 2, JPre(**_pp(c_sp)),
                             JInfer(patch_size=patch, **infer))
    jfine = jc.ModelBundle(_jax_class_oracle(3), {}, 3, JPre(**_pp(f_sp)),
                           JInfer(patch_size=patch, **infer))
    tcoarse = tc.ModelBundle(_torch_binary_oracle(), None, 2, PreprocessConfig(**_pp(c_sp)),
                             InferConfig(patch_size=patch, **infer))
    tfine = tc.ModelBundle(_torch_class_oracle(3), None, 3, PreprocessConfig(**_pp(f_sp)),
                           InferConfig(patch_size=patch, **infer))
    return jcoarse, jfine, tcoarse, tfine


def _label_image():
    _, seg = make_phantom((64, 64, 48), spacing=SPACING, num_classes=3, seed=0)
    return seg.astype(np.float32), seg


CASCADE = dict(roi_margin_mm=6.0, roi_bucket=16, max_components=2)


def test_predict_case_oracle_equals_jax():
    img, seg = _label_image()
    jcoarse, jfine, tcoarse, tfine = _bundles()
    want = jc.predict_case(jcoarse, jfine, img, SPACING, JCascade(**CASCADE))
    got = tc.predict_case(tcoarse, tfine, img, SPACING, CascadeConfig(**CASCADE), device="cpu")
    assert got.dtype == np.uint8 and got.shape == seg.shape
    np.testing.assert_array_equal(got, want)
    assert ((got > 0) == (seg > 0)).mean() > 0.97


@pytest.mark.parametrize("infer", [dict(), dict(single_pass_ratio=0.0),
                                   dict(single_pass_ratio=2.0, overlap=0.25)])
def test_predict_volume_oracle_equals_jax(infer):
    """Single pass, patch windows, and super-windows."""
    img, _ = _label_image()
    _, jfine, _, tfine = _bundles(**infer)
    want = jc.predict_volume(jfine, img, SPACING)
    got = tc.predict_volume(tfine, img, SPACING, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_predict_volume_probs_match_jax():
    img, _ = _label_image()
    _, jfine, _, tfine = _bundles(single_pass_ratio=0.0)
    wn, wp, wsp = jc.predict_volume(jfine, img, SPACING, return_probs=True)
    gn, gp, gsp = tc.predict_volume(tfine, img, SPACING, return_probs=True, device="cpu")
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_allclose(gp.astype(np.float32), wp.astype(np.float32), atol=1e-3)
    assert gsp == wsp


def test_predict_case_transfer_quant_paths_equal_jax():
    """uint8 fine uploads and 4-bit coarse uploads, on a real-HU phantom."""
    img, _ = make_phantom((64, 64, 48), spacing=SPACING, num_classes=3, seed=1)
    hu = dict(hu_window=(-79.0, 304.0), hu_stats=None)
    jcoarse = jc.ModelBundle(_jax_binary_oracle(), {}, 2,
                             JPre(spacing=(2.0,) * 3, transfer_quant=True, transfer_quant4=True,
                                  **hu), JInfer(patch_size=(32,) * 3))
    tcoarse = tc.ModelBundle(_torch_binary_oracle(), None, 2,
                             PreprocessConfig(spacing=(2.0,) * 3, transfer_quant=True,
                                              transfer_quant4=True, **hu),
                             InferConfig(patch_size=(32,) * 3))
    jfine = jc.ModelBundle(_jax_class_oracle(3), {}, 3,
                           JPre(spacing=(1.0,) * 3, transfer_quant=True, **hu),
                           JInfer(patch_size=(32,) * 3))
    tfine = tc.ModelBundle(_torch_class_oracle(3), None, 3,
                           PreprocessConfig(spacing=(1.0,) * 3, transfer_quant=True, **hu),
                           InferConfig(patch_size=(32,) * 3))
    want = jc.predict_case(jcoarse, jfine, img, SPACING, JCascade(**CASCADE))
    got = tc.predict_case(tcoarse, tfine, img, SPACING, CascadeConfig(**CASCADE), device="cpu")
    np.testing.assert_array_equal(got, want)


def test_predict_case_small_unet_matches_jax():
    """Both stages as small U-Nets (base 4, max 8, 3 levels, f32) with
    JAX-initialized weights carried across.

    The phantom is mostly constant (clipped air, flat tissue), so an
    untrained net's InstanceNorm sees channels whose variance E[x²]−µ² is a
    small difference of large f32 numbers; with fixed HU stats (mean far
    from the data's) that cancellation alone moves logits by ~1e-3 in either
    package and flips ~0.15% of near-tie voxels. The per-volume z-score
    (``hu_stats=None``, a supported preset option) centres the input, and
    the two packages then agree on >= 99.9% of voxels."""
    img, seg = make_phantom((64, 64, 48), spacing=SPACING, num_classes=3, seed=0)
    hu = dict(hu_window=(-79.0, 304.0), hu_stats=None)
    mc = dict(base_features=4, max_features=8, num_levels=3, compute_dtype="float32")
    stages = {}
    for name, k, sp, seed in [("coarse", 2, (2.0,) * 3, 0), ("fine", 3, (1.0,) * 3, 1)]:
        jm = create_model(JModel(num_classes=k, **mc))
        params = jax.device_get(init_params(jm, jax.random.key(seed), (16, 16, 16)))
        flat = {"/".join(p): np.asarray(v, np.float32) for p, v in
                __import__("flax").traverse_util.flatten_dict(params).items()}
        tm = load_state(UNet3D(ModelConfig(num_classes=k, **mc), device="cpu"), flat).eval()
        stages[name] = (
            jc.ModelBundle(lambda p, w, _m=jm: _m.apply({"params": p}, w), params, k,
                           JPre(spacing=sp, **hu), JInfer(patch_size=(32,) * 3)),
            tc.ModelBundle(lambda _p, w, _m=tm: _m(w), None, k, PreprocessConfig(spacing=sp, **hu),
                           InferConfig(patch_size=(32,) * 3)),
        )
    want = jc.predict_case(stages["coarse"][0], stages["fine"][0], img, SPACING, JCascade(**CASCADE))
    got = tc.predict_case(stages["coarse"][1], stages["fine"][1], img, SPACING,
                          CascadeConfig(**CASCADE), device="cpu")
    assert got.shape == seg.shape
    assert (got == want).mean() >= 0.999, (got == want).mean()


def test_predict_cases_equal_sequential():
    img, _ = _label_image()
    img2 = np.flip(img, axis=0).copy()
    _, _, tcoarse, tfine = _bundles()
    cas = CascadeConfig(**CASCADE)
    seq = [tc.predict_case(tcoarse, tfine, i, SPACING, cas, device="cpu") for i in (img, img2, img)]
    got = list(tc.predict_cases(tcoarse, tfine, [(img, SPACING), (img2, SPACING), (img, SPACING)],
                                cas, workers=2, device="cpu"))
    assert len(got) == 3
    for g, s in zip(got, seq):
        np.testing.assert_array_equal(g, s)


def test_empty_coarse_mask_gives_background():
    img = np.zeros((40, 40, 30), np.float32)
    _, _, tcoarse, tfine = _bundles(patch=(16, 16, 16))
    pred = tc.predict_case(tcoarse, tfine, img, (1.0, 1.0, 1.0), device="cpu")
    assert pred.shape == img.shape and (pred == 0).all()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is valid")
    img, _ = _label_image()
    _, _, tcoarse, tfine = _bundles()
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.predict_case(tcoarse, tfine, img, SPACING)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.predict_volume(tfine, img, SPACING)


def test_unported_options_raise():
    """The options this test once expected ``NotImplementedError`` from
    (``roi_batch > 1``, ``InferConfig.tta``) now run: each gives the JAX
    package's labels on the oracle cascade. Nothing on the single-device
    serving path is left to raise."""
    img, _ = _label_image()
    jcoarse, jfine, tcoarse, tfine = _bundles()
    want = jc.predict_case(jcoarse, jfine, img, SPACING, JCascade(roi_batch=2, **CASCADE))
    got = tc.predict_case(tcoarse, tfine, img, SPACING, CascadeConfig(roi_batch=2, **CASCADE),
                          device="cpu")
    np.testing.assert_array_equal(got, want)
    jtta = dataclasses.replace(jfine, infer=JInfer(patch_size=(32,) * 3, tta=True))
    ttta = dataclasses.replace(tfine, infer=InferConfig(patch_size=(32,) * 3, tta=True))
    np.testing.assert_array_equal(tc.predict_volume(ttta, img, SPACING, device="cpu"),
                                  jc.predict_volume(jtta, img, SPACING))


def _small_unet_bundles():
    """Both stages as small U-Nets (the modules and their caches are shared
    by every case that runs through the bundles)."""
    hu = dict(hu_window=(-79.0, 304.0), hu_stats=None)
    mc = dict(base_features=4, max_features=8, num_levels=3, compute_dtype="float32")
    out = []
    for k, sp, seed in [(2, (2.0,) * 3, 0), (3, (1.0,) * 3, 1)]:
        from runet_tpu_torch.models.unet3d import init_params as t_init

        tm = t_init(UNet3D(ModelConfig(num_classes=k, **mc), device="cpu"),
                    torch.Generator().manual_seed(seed)).eval()
        out.append(tc.ModelBundle(lambda _p, w, _m=tm: _m(w), None, k,
                                  PreprocessConfig(spacing=sp, **hu),
                                  InferConfig(patch_size=(32,) * 3)))
    return out


def test_predict_cases_workers_equal_serial_on_mixed_shapes():
    """Two worker threads share the bundles' modules (with their packed
    weight caches) and the cached resample matrices. Six cases of mixed
    shapes and spacings, pipelined three times over, must equal serial
    ``predict_case`` voxel for voxel every time: a race on shared state
    would show as a differing or failing case. The interpreter's switch
    interval is shortened so the threads interleave far more often than
    they would by default."""
    import sys

    cas = CascadeConfig(**CASCADE)
    cases = []
    for i, (shape, sp) in enumerate([((64, 64, 48), (1.0, 1.0, 1.5)), ((48, 56, 40), (1.2, 1.0, 1.5)),
                                     ((72, 48, 32), (1.0, 1.3, 2.0)), ((56, 56, 56), (1.1, 1.1, 1.1)),
                                     ((64, 40, 48), (0.9, 1.4, 1.5)), ((40, 72, 36), (1.5, 1.0, 1.8))]):
        img, _ = make_phantom(shape, spacing=sp, num_classes=3, seed=i)
        cases.append((img, sp))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for coarse, fine in (_bundles()[2:], _small_unet_bundles()):
            serial = [tc.predict_case(coarse, fine, img, sp, cas, device="cpu")
                      for img, sp in cases]
            for _ in range(3):
                got = list(tc.predict_cases(coarse, fine, cases, cas, workers=2, device="cpu"))
                assert len(got) == len(serial)
                for g, w in zip(got, serial):
                    np.testing.assert_array_equal(g, w)
    finally:
        sys.setswitchinterval(interval)


def test_postprocess_matches_jax():
    rng = np.random.default_rng(5)
    seg = (rng.random((30, 28, 26)) > 0.93).astype(np.uint8) * rng.integers(1, 3, (30, 28, 26)).astype(np.uint8)
    seg[5:15, 5:15, 5:15] = 1
    seg[18:25, 18:27, 3:9] = 2
    for mv in (0, 3):
        np.testing.assert_array_equal(tpost.keep_largest_components(seg, max_components=2, min_voxels=mv),
                                      jpost.keep_largest_components(seg, max_components=2, min_voxels=mv))
    boxes = [(np.array([2, 2, 2]), np.array([17, 16, 18])), (np.array([16, 16, 0]), np.array([30, 28, 12]))]
    np.testing.assert_array_equal(tpost.keep_largest_components_in_boxes(seg, boxes),
                                  jpost.keep_largest_components_in_boxes(seg, boxes))
    for (a, b), (c, d) in zip(tpost.component_bounding_boxes(seg > 0, 3, 8),
                              jpost.component_bounding_boxes(seg > 0, 3, 8)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
