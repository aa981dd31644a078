"""The port's spatial-partition (halo exchange) inference against the JAX
package's ``runet_tpu/parallel/spatial.py`` on the CPU.

JAX shards the volume over 4 fake CPU devices in this process; the port
runs 4 gloo ranks (``parallel/launch.spawn``, rank bodies in
``tests/torch_mp_workers.py``), each returning its local logits, which are
concatenated here. Same volumes from numpy seeds and the same weights (the
JAX init carried over by ``params.flax_to_torch``), f32 compute, at the
geometry of ``tests/test_spatial.py``. Tolerances: the norm-free stack's
logits within 1e-5 of JAX's away from the global edges (one receptive
field, 17 voxels; every shard boundary lies inside), the synced-norm
U-Net's logits within 1e-4 of JAX's and its labels equal, the padded
50-slice case's labels equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runet_tpu.config import ModelConfig as JModelConfig
from runet_tpu.models.unet3d import UNet3D as JUNet3D
from runet_tpu.models.unet3d import init_params as jax_init_params
from runet_tpu.parallel import comm as jcomm
from runet_tpu.parallel.spatial import spatial_shard_forward as jax_forward
from runet_tpu.parallel.spatial import spatial_shard_predict as jax_predict
from runet_tpu_torch.config import ModelConfig
from runet_tpu_torch.models.unet3d import UNet3D
from runet_tpu_torch.params import load_state, torch_to_flax
from runet_tpu_torch.parallel import comm
from runet_tpu_torch.parallel.launch import spawn
from runet_tpu_torch.parallel.spatial import spatial_shard_forward, spatial_shard_predict
from tests import torch_mp_workers as workers

RF = 17  # receptive field of the norm-free stack


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def _jax_mesh(n=4):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), (jcomm.SPACE_AXIS,))


def _stack():
    """``tests/test_spatial.py``'s norm-free conv stack."""
    from flax import linen as nn

    class Stack(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.Conv(8, (3, 3, 3), padding="SAME")(x)
            x = nn.leaky_relu(x, 0.01)
            x = nn.Conv(8, (3, 3, 3), strides=(2, 2, 2), padding="SAME")(x)
            x = nn.leaky_relu(x, 0.01)
            x = nn.ConvTranspose(8, (2, 2, 2), strides=(2, 2, 2))(x)
            return nn.Conv(3, (1, 1, 1))(x)

    return Stack()


def _unet(seed_vol, shape, **kw):
    cfg = dict(compute_dtype="float32", spatial_axis=jcomm.SPACE_AXIS, **kw)
    sp_model = JUNet3D(JModelConfig(**cfg))
    params = jax_init_params(JUNet3D(JModelConfig(**dict(cfg, spatial_axis=None))),
                             jax.random.key(0), (16, 16, 16))
    vol = np.random.default_rng(seed_vol).normal(size=shape).astype(np.float32)
    return sp_model, params, vol, cfg


@pytest.fixture(scope="module")
def cases():
    """The JAX results and the port's four ranks' results on the same
    inputs."""
    model = _stack()
    stack_vol = np.random.default_rng(0).normal(size=(64, 16, 16, 1)).astype(np.float32)
    stack_params = model.init(jax.random.key(0), jnp.asarray(stack_vol)[None])
    mesh = _jax_mesh(4)
    jax_stack = np.asarray(jax_forward(lambda p, x: model.apply(p, x), stack_params,
                                       jnp.asarray(stack_vol), mesh, halo=16))

    unet, uparams, uvol, ucfg = _unet(1, (64, 16, 16, 1), num_classes=3, base_features=8,
                                      num_levels=2)
    apply_fn = lambda p, x: unet.apply({"params": p}, x)  # noqa: E731
    jax_logits = np.asarray(jax_forward(apply_fn, uparams, jnp.asarray(uvol), mesh, halo=8))
    jax_labels = np.asarray(jax_predict(apply_fn, uparams, uvol, mesh, halo=8, divisor=2))

    pad, pparams, pvol, pcfg = _unet(2, (50, 16, 16), num_classes=2, base_features=4,
                                     num_levels=2)
    jax_pad = np.asarray(jax_predict(lambda p, x: pad.apply({"params": p}, x), pparams, pvol,
                                     mesh, halo=8, divisor=2))

    ranks = spawn(workers.spatial_suite, 4, args=(
        _flat(jax.device_get(stack_params["params"])), stack_vol,
        _flat(jax.device_get(uparams)), ucfg, uvol,
        _flat(jax.device_get(pparams)), pcfg, pvol))
    return {"jax_stack": jax_stack, "jax_logits": jax_logits, "jax_labels": jax_labels,
            "jax_pad": jax_pad, "ranks": ranks}


def test_norm_free_conv_stack_matches_jax(cases):
    """Every shard boundary (X = 16, 32, 48) lies in the compared interior,
    so the halo exchange is covered in full."""
    got = np.concatenate([r["stack"] for r in cases["ranks"]])
    want = cases["jax_stack"]
    assert got.shape == want.shape == (64, 16, 16, 3)
    np.testing.assert_allclose(got[RF:-RF], want[RF:-RF], atol=1e-5, rtol=0)


def test_unet_with_synced_instance_norm_matches_jax(cases):
    """The norms average their moments over the 4 ranks as JAX's ``pmean``
    does: logits within 1e-4, gathered labels equal on every rank."""
    got = np.concatenate([r["unet_logits"] for r in cases["ranks"]])
    np.testing.assert_allclose(got, cases["jax_logits"], atol=1e-4, rtol=0)
    for r in cases["ranks"]:
        assert r["unet_labels"].dtype == np.uint8
        np.testing.assert_array_equal(r["unet_labels"], cases["jax_labels"])
        assert r["staged"] == 0  # CPU tensors: nothing staged


def test_spatial_predict_pads_indivisible(cases):
    for r in cases["ranks"]:
        assert r["pad_labels"].shape == (50, 16, 16)
        np.testing.assert_array_equal(r["pad_labels"], cases["jax_pad"])


def test_spatial_forward_rejects_halo_zero_and_bad_rank():
    vol = torch.zeros((8, 4, 4, 1))
    with pytest.raises(ValueError, match="halo"):
        spatial_shard_forward(lambda p, x: x, None, vol, mesh=None, halo=0)
    with pytest.raises(ValueError, match=r"expected \(X, Y, Z, C\)"):
        spatial_shard_forward(lambda p, x: x, None, vol[..., 0], mesh=None, halo=1)
    with pytest.raises(ValueError, match=r"expected \(X, Y, Z, C\)"):
        spatial_shard_predict(lambda p, x: x, None, torch.zeros((8, 4)), mesh=None, halo=1)


def test_synced_norm_needs_a_bound_group():
    """A model with ``spatial_axis`` set runs only where a process group is
    bound to the axis."""
    cfg = ModelConfig(num_classes=2, base_features=4, num_levels=2, compute_dtype="float32",
                      spatial_axis=comm.SPACE_AXIS)
    model = UNet3D(cfg, device="cpu").eval()
    with pytest.raises(RuntimeError, match="no process group is bound to mesh axis 'space'"):
        model(torch.zeros((1, 8, 8, 8, 1)))
    dense = load_state(UNet3D(dataclasses.replace(cfg, spatial_axis=None), device="cpu"),
                       torch_to_flax(model))
    assert dense(torch.zeros((1, 8, 8, 8, 1))).shape == (1, 8, 8, 8, 2)
