"""The port's UNet3D against ``runet_tpu.models.unet3d`` on the same weights.

Weights come from the committed artifacts (carried by
``params.flax_to_torch``) or from a JAX init; inputs are numpy from a seed.
Tolerances: in f32, rtol/atol 2e-4 (as the torch oracle test) for the
4-level coarse net. The 5-level fine_kits net gets atol 1e-3: one f32 3x3x3
conv already differs from a float64 reference by 2.5e-6 (XLA) and 6.5e-6
(torch) at a max of 5.2, and that noise compounds through its 18
conv+InstanceNorm layers (the 2³ bottleneck normalizes over 8 voxels) to a
measured 3.4e-4 on the logits, with no jump at any block. In bf16 the two
frameworks round at different places, so logits are held to 0.1 of their
largest magnitude and argmax must agree on >= 99.5% of voxels.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import bench
from runet_tpu.config import get_config as jax_get_config
from runet_tpu.models.unet3d import create_model, depth_to_space_dchw, init_params
from runet_tpu_torch.config import PRESETS, ModelConfig, get_config
from runet_tpu_torch.models.unet3d import UNet3D
from runet_tpu_torch.models.unet3d import depth_to_space_dchw as t_depth_to_space
from runet_tpu_torch.models.norm import InstanceNorm
from runet_tpu_torch.params import ARTIFACT_DIR, flax_to_torch, load_model, load_npz, load_state


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def _jax_logits(cfg_model, flat, x):
    from flax.traverse_util import unflatten_dict

    params = unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})
    return np.asarray(create_model(cfg_model).apply({"params": params}, x), np.float32)


def _torch_logits(cfg_model, flat, x):
    model = load_state(UNet3D(cfg_model, device="cpu"), flat).eval()
    with torch.inference_mode():
        return model(torch.from_numpy(x)).float().numpy()


def test_presets_match_jax_presets():
    for name in PRESETS:
        assert get_config(name).to_json() == jax_get_config(name).to_json()


@pytest.mark.parametrize("preset", ["coarse", "fine_kits", "renal_anatomy"])
def test_artifacts_load_and_map_every_key(preset):
    flat = load_npz(ARTIFACT_DIR / f"bench_params_{preset}.npz")
    sd = flax_to_torch(flat)
    assert len(sd) == len(flat)
    model, cfg = load_model(preset, device="cpu")
    own = model.state_dict()
    assert set(own) == set(sd)
    for k, v in sd.items():
        assert torch.equal(own[k].float(), v.to(own[k].dtype).float()), k
    conv = model.get_parameter("enc0.ConvNormAct_0.kernel")
    assert conv.dtype == torch.bfloat16 and tuple(conv.shape) == (3, 3, 3, 1, cfg.model.base_features)
    assert model.get_parameter("Conv_0.kernel").dtype == torch.float32


@pytest.mark.parametrize("preset,atol", [("coarse", 2e-4), ("fine_kits", 1e-3)])
def test_committed_weights_f32_logits_match_jax(preset, atol):
    cfg = dataclasses.replace(jax_get_config(preset).model, compute_dtype="float32")
    flat = load_npz(ARTIFACT_DIR / f"bench_params_{preset}.npz")
    x = np.random.default_rng(0).normal(size=(1, 32, 32, 32, 1)).astype(np.float32)
    want = _jax_logits(cfg, flat, x)
    got = _torch_logits(ModelConfig(**dataclasses.asdict(cfg)), flat, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=atol)


@pytest.mark.parametrize("preset", ["coarse", "fine_kits"])
def test_committed_weights_bf16_logits_match_jax(preset):
    cfg = jax_get_config(preset).model
    flat = load_npz(ARTIFACT_DIR / f"bench_params_{preset}.npz")
    # A phantom-like input (normalized HU) rather than noise: the argmax
    # then has real margins, as in serving.
    from runet_tpu_torch.data.phantom import make_phantom

    img, _ = make_phantom((32, 32, 32), num_classes=3, seed=3)
    x = ((np.clip(img, -79, 304) - 100.93) / 76.9).astype(np.float32)[None, ..., None]
    want = _jax_logits(cfg, flat, x)
    got = _torch_logits(ModelConfig(**dataclasses.asdict(cfg)), flat, x)
    assert np.abs(got - want).max() <= 0.1 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.995


def test_small_unet_jax_init_matches():
    cfg = ModelConfig(num_classes=3, base_features=4, max_features=8, num_levels=3,
                      compute_dtype="float32")
    jcfg = jax_get_config("fine_kits").model.__class__(**dataclasses.asdict(cfg))
    params = jax.device_get(init_params(create_model(jcfg), jax.random.key(0), (16, 16, 16)))
    flat = _flat(params)
    x = np.random.default_rng(1).normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    np.testing.assert_allclose(_torch_logits(cfg, flat, x), _jax_logits(jcfg, flat, x),
                               rtol=2e-4, atol=2e-4)


def test_depth_to_space_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 3, 16, 4, 5)).astype(np.float32)
    want = np.asarray(depth_to_space_dchw(x, 2))
    got = t_depth_to_space(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, want)


def test_instance_norm_moments_path_equals_direct_and_clamps():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 3, 4, 5, 6)).astype(np.float32))
    norm = InstanceNorm(4, dtype=torch.float32)
    xf = x.float()
    dims = (1, 3, 4)
    moments = (xf.mean(dim=dims), (xf * xf).mean(dim=dims))
    torch.testing.assert_close(norm(x, moments), norm(x), rtol=1e-5, atol=1e-5)
    # A constant channel whose E[x²]−µ² rounds negative must not NaN.
    c = torch.full((1, 2, 1, 3, 3), 1e4)
    assert torch.isfinite(norm.__class__(1, dtype=torch.float32)(c)).all()


def test_unet_rejects_indivisible_input():
    model = UNet3D(ModelConfig(base_features=4, max_features=8, num_levels=3), device="cpu")
    with pytest.raises(ValueError):
        model(torch.zeros((1, 6, 8, 8, 1)))


def test_unet_rejects_spatial_axis():
    """With ``spatial_axis`` set every norm all-reduces its moments over the
    process group bound to that mesh axis (as the reference's ``pmean``); a
    forward with no group bound raises instead of normalising each shard on
    its own, and the model without the axis runs."""
    model = UNet3D(ModelConfig(base_features=4, num_levels=2, spatial_axis="space"), device="cpu")
    assert {m.axis_name for m in model.modules() if isinstance(m, InstanceNorm)} == {"space"}
    with pytest.raises(RuntimeError, match="no process group is bound to mesh axis 'space'"):
        model(torch.zeros((1, 8, 8, 8, 1)))
    dense = UNet3D(ModelConfig(base_features=4, num_levels=2), device="cpu")
    assert dense.cfg.spatial_axis is None
    assert dense(torch.zeros((1, 8, 8, 8, 1))).shape == (1, 8, 8, 8, 3)


def test_bench_loader_agrees_on_artifact_values():
    """The port's npz reader gives the values bench.py loads (f16 → f32)."""
    flat = load_npz(ARTIFACT_DIR / "bench_params_coarse.npz")
    tree = bench._load_params("coarse")
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(flat[k], v)
