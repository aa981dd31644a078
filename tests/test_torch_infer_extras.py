"""Mirror-flip TTA, checkpoint ensembling, ``roi_batch`` and warm-up of the
port against ``runet_tpu.infer`` on the CPU.

The "models" are analytic ``apply_fn``s written once in each framework (not
flip-symmetric, so a missing un-flip shows), fed the same numpy inputs:
log-probabilities agree to 1e-5 (both take an f32 softmax of the same
values and average the same terms, in orders that differ), labels are equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runet_tpu.config import CascadeConfig as JCascade, InferConfig as JInfer
from runet_tpu.config import PreprocessConfig as JPre
from runet_tpu.infer import cascade as jc
from runet_tpu.infer import ensemble as jens
from runet_tpu.infer import tta as jtta
from runet_tpu_torch.config import CascadeConfig, InferConfig, PreprocessConfig
from runet_tpu_torch.data.phantom import make_phantom
from runet_tpu_torch.infer import cascade as tc
from runet_tpu_torch.infer import ensemble as tens
from runet_tpu_torch.infer import tta as ttta
from runet_tpu_torch.infer import warmup as twarm

K = 4
COEF = np.random.default_rng(0).standard_normal((3, K)).astype(np.float32)


def _jax_model(params, windows):
    """logits_k = a_k·x + b_k·x shifted along Y + c_k·x shifted along Z,
    scaled by ``params['gain']``."""
    x = windows[..., 0]
    feats = jnp.stack([x, jnp.roll(x, 1, axis=2), jnp.roll(x, 2, axis=3)], axis=-1)
    return params["gain"] * (feats @ jnp.asarray(COEF))


def _torch_model(params, windows):
    x = windows[..., 0]
    feats = torch.stack([x, torch.roll(x, 1, 2), torch.roll(x, 2, 3)], dim=-1)
    return params["gain"] * (feats @ torch.from_numpy(COEF))


def test_flip_combinations_match_jax():
    for axes in [(), (0,), (0, 2), (0, 1, 2)]:
        assert ttta.flip_combinations(axes) == jtta.flip_combinations(axes)
    assert len(ttta.flip_combinations((0, 1, 2))) == 8


@pytest.mark.parametrize("axes", [(0, 1, 2), (1,)])
def test_tta_log_probs_match_jax(axes):
    x = np.random.default_rng(1).standard_normal((2, 6, 5, 7, 1)).astype(np.float32)
    want = jtta.make_tta_apply(_jax_model, axes)({"gain": 1.5}, jnp.asarray(x))
    got = ttta.make_tta_apply(_torch_model, axes)({"gain": 1.5}, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # softmax(log p) reproduces the averaged probabilities.
    np.testing.assert_allclose(torch.softmax(got, -1).sum(-1).numpy(), 1.0, atol=1e-5)
    # The flips matter: the wrapped model differs from the bare one.
    bare = torch.log_softmax(_torch_model({"gain": 1.5}, torch.from_numpy(x)), -1)
    assert (got - bare).abs().max() > 1e-2


def test_effective_apply_fn_follows_the_infer_config():
    pp = PreprocessConfig()
    off = tc.ModelBundle(_torch_model, {"gain": 1.0}, K, pp, InferConfig())
    on = dataclasses.replace(off, infer=InferConfig(tta=True, tta_axes=(0, 2)))
    assert ttta.effective_apply_fn(off) is _torch_model
    fn = ttta.effective_apply_fn(on)
    assert fn is not _torch_model and fn is ttta.effective_apply_fn(on)  # cached per bundle


def test_ensemble_log_probs_match_jax():
    x = np.random.default_rng(2).standard_normal((1, 6, 5, 7, 1)).astype(np.float32)
    gains = [0.5, 1.0, 2.5]
    pre, jpre = PreprocessConfig(), JPre()
    jb = [jc.ModelBundle(_jax_model, {"gain": jnp.float32(g)}, K, jpre, JInfer()) for g in gains]
    tb = [tc.ModelBundle(_torch_model, {"gain": g}, K, pre, InferConfig()) for g in gains]
    je, te = jens.ensemble_bundle(jb), tens.ensemble_bundle(tb)
    want = je.apply_fn(je.params, jnp.asarray(x))
    got = te.apply_fn(te.params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert te.num_classes == K and te.infer == tb[0].infer
    # TTA composes with an ensemble bundle.
    te_tta = dataclasses.replace(te, infer=InferConfig(tta=True))
    je_tta = dataclasses.replace(je, infer=JInfer(tta=True))
    np.testing.assert_allclose(
        ttta.effective_apply_fn(te_tta)(te.params, torch.from_numpy(x)).numpy(),
        np.asarray(jtta.effective_apply_fn(je_tta)(je.params, jnp.asarray(x))), atol=1e-5, rtol=0)


def test_ensemble_rejects_bad_member_sets():
    b = tc.ModelBundle(_torch_model, {"gain": 1.0}, K, PreprocessConfig(), InferConfig())
    with pytest.raises(ValueError):
        tens.ensemble_bundle([b])
    with pytest.raises(ValueError):
        tens.ensemble_bundle([b, dataclasses.replace(b, num_classes=3)])


def test_ensemble_of_a_model_with_itself_gives_its_labels():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 6, 5, 7, 1))
                         .astype(np.float32))
    b = tc.ModelBundle(_torch_model, {"gain": 1.0}, K, PreprocessConfig(), InferConfig())
    e = tens.ensemble_bundle([b, b])
    assert torch.equal(e.apply_fn(e.params, x).argmax(-1), _torch_model(b.params, x).argmax(-1))


# ---- roi_batch and warm-up on the oracle cascade ----

SPACING = (1.0, 1.0, 1.5)
CASCADE = dict(roi_margin_mm=6.0, roi_bucket=16, max_components=2)


def _pp(spacing):
    return dict(spacing=spacing, hu_window=(0.0, 100.0), hu_stats=(0.0, 1.0))


def _oracles(tta=False):
    def j_class(params, w):
        x = jnp.clip(jnp.round(w[..., 0]).astype(jnp.int32), 0, 2)
        return 20.0 * jax.nn.one_hot(x, 3)

    def j_bin(params, w):
        return jnp.stack([10.0 * (0.5 - w[..., 0]), 10.0 * (w[..., 0] - 0.5)], axis=-1)

    def t_class(params, w):
        x = torch.clamp(torch.round(w[..., 0]).long(), 0, 2)
        return 20.0 * torch.nn.functional.one_hot(x, 3).float()

    def t_bin(params, w):
        return torch.stack([10.0 * (0.5 - w[..., 0]), 10.0 * (w[..., 0] - 0.5)], dim=-1)

    p = (32, 32, 32)
    return (jc.ModelBundle(j_bin, {}, 2, JPre(**_pp((2.0,) * 3)), JInfer(patch_size=p, tta=tta)),
            jc.ModelBundle(j_class, {}, 3, JPre(**_pp((1.0,) * 3)), JInfer(patch_size=p, tta=tta)),
            tc.ModelBundle(t_bin, None, 2, PreprocessConfig(**_pp((2.0,) * 3)),
                           InferConfig(patch_size=p, tta=tta)),
            tc.ModelBundle(t_class, None, 3, PreprocessConfig(**_pp((1.0,) * 3)),
                           InferConfig(patch_size=p, tta=tta)))


def _label_image():
    _, seg = make_phantom((64, 64, 48), spacing=SPACING, num_classes=3, seed=0)
    return seg.astype(np.float32)


def test_roi_batch_labels_equal_jax_and_unbatched(monkeypatch):
    img = _label_image()
    jcoarse, jfine, tcoarse, tfine = _oracles()
    calls = []
    real = tc._roi_program_batch
    monkeypatch.setattr(tc, "_roi_program_batch",
                        lambda *a, **k: (calls.append(a[2].shape[0]), real(*a, **k))[1])
    want = jc.predict_case(jcoarse, jfine, img, SPACING, JCascade(roi_batch=2, **CASCADE))
    got = tc.predict_case(tcoarse, tfine, img, SPACING, CascadeConfig(roi_batch=2, **CASCADE),
                          device="cpu")
    one = tc.predict_case(tcoarse, tfine, img, SPACING, CascadeConfig(**CASCADE), device="cpu")
    assert calls == [2]  # the two kidneys share a bucket: one batched forward
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, one)


def test_roi_batch_leftovers_run_unbatched(monkeypatch):
    """A group still short of ``roi_batch`` at the end goes through the
    B = 1 program; the labels do not change."""
    img = _label_image()
    _, _, tcoarse, tfine = _oracles()
    calls = []
    real = tc._roi_program_batch
    monkeypatch.setattr(tc, "_roi_program_batch",
                        lambda *a, **k: (calls.append(a[2].shape[0]), real(*a, **k))[1])
    got = tc.predict_case(tcoarse, tfine, img, SPACING, CascadeConfig(roi_batch=3, **CASCADE),
                          device="cpu")
    one = tc.predict_case(tcoarse, tfine, img, SPACING, CascadeConfig(**CASCADE), device="cpu")
    assert calls == []
    np.testing.assert_array_equal(got, one)


def test_predict_case_with_tta_equals_jax():
    img = _label_image()
    jcoarse, jfine, tcoarse, tfine = _oracles(tta=True)
    want = jc.predict_case(jcoarse, jfine, img, SPACING, JCascade(**CASCADE))
    got = tc.predict_case(tcoarse, tfine, img, SPACING, CascadeConfig(**CASCADE), device="cpu")
    np.testing.assert_array_equal(got, want)


def test_warmup_cases_and_buckets_return_per_item_seconds(monkeypatch):
    img = _label_image()
    _, _, tcoarse, tfine = _oracles()
    cas = CascadeConfig(roi_batch=2, **CASCADE)
    out = twarm.warmup_cases(tcoarse, tfine, [(img, SPACING), (img[:48], SPACING)], cas,
                             device="cpu")
    assert sorted(out) == ["case0_s", "case1_s", "total_s"]
    assert all(v >= 0 for v in out.values()) and out["total_s"] >= out["case0_s"]
    shapes = []
    real = tc._roi_program
    monkeypatch.setattr(tc, "_roi_program",
                        lambda *a, **k: (shapes.append((tuple(a[2].shape), a[3])), real(*a, **k))[1])
    out = twarm.warmup_roi_buckets(tfine, [(32, 32, 48)], SPACING, cas, device="cpu")
    assert sorted(out) == ["roi_32x32x48_b1_s", "roi_32x32x48_b2_s", "total_s"]
    # The dummy crop takes serving's crop-extent bucketing: ceil((p-1)·s)+1
    # rounded up to crop_bucket = 16, with s = fine/native spacing (z: 33 → 48).
    assert shapes == [((32, 32, 48), (32, 32, 48))]
    if not torch.cuda.is_available():  # the default device is CUDA, never a quiet CPU run
        with pytest.raises(RuntimeError, match="CUDA"):
            twarm.warmup_cases(tcoarse, tfine, [(img, SPACING)], cas)
