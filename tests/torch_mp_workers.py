"""Rank bodies of the port's multi-rank tests (``test_torch_parallel.py``,
``test_torch_spatial.py``), run by ``runet_tpu_torch.parallel.launch.spawn``
in processes of their own over gloo on the CPU.

This module imports no JAX and nothing of ``runet_tpu``, and pytest does
not collect it, so a spawned child imports neither JAX nor the conftest.
Every body takes numpy inputs made by the test from a seed and returns
numpy results for the test to hold against the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from runet_tpu_torch.config import ModelConfig, TrainConfig
from runet_tpu_torch.models.unet3d import UNet3D, create_train_model
from runet_tpu_torch.params import load_state, torch_to_flax
from runet_tpu_torch.parallel import comm
from runet_tpu_torch.parallel.dp import make_dp_multi_train_step, make_dp_train_step
from runet_tpu_torch.train.state import create_train_state


def _fresh(flat, mcfg: dict, tcfg: dict):
    model = load_state(create_train_model(ModelConfig(**mcfg), device="cpu"), flat)
    return model, create_train_state(model, TrainConfig(**tcfg))


def _aux(aux) -> dict:
    return {k: float(v) for k, v in aux.items()}


def _dp_step(mesh, flat, mcfg, tcfg, images, labels, seed=None):
    """One data-parallel step from ``flat`` on the global batch; returns
    (flat params after it, aux)."""
    model, state = _fresh(flat, mcfg, tcfg)
    im, lb = comm.shard_batch(mesh, (images, labels))
    step = make_dp_train_step(model, mesh, augment=seed is not None)
    if seed is None:
        aux = step(state, im, lb)
    else:
        aux = step(state, im, lb, (torch.Generator(), torch.Generator()), seed)
    return torch_to_flax(model), _aux(aux)


def _mesh_info(mesh) -> dict:
    return {"names": tuple(mesh.mesh_dim_names), "shape": tuple(mesh.shape),
            "data_axes": comm.data_axes(mesh), "data_size": comm.data_size(mesh),
            "data_index": comm.data_index(mesh)}


def dp_suite(rank, world, flat, mcfg, tcfg, images, labels, superbatch, data_root, out_dir):
    """The two-rank suite: mesh helpers, one plain and one augmented DP
    step, a K = 2 chunk against two steps, ``shard_batch``,
    ``replicate``, and ``train`` over the whole world (no mesh given) with
    a resume."""
    torch.set_num_threads(1)
    out = {"init_again": comm.init_distributed(), "world": comm.world_size()}
    mesh = comm.make_mesh()
    out["mesh"] = _mesh_info(mesh)
    out["plain"] = _dp_step(mesh, flat, mcfg, tcfg, images, labels)
    out["augmented"] = _dp_step(mesh, flat, mcfg, tcfg, images, labels, seed=11)

    ims, lbs = superbatch
    seeds = [21, 22]
    model_a, state_a = _fresh(flat, mcfg, tcfg)
    step = make_dp_train_step(model_a, mesh, augment=True)
    gens = (torch.Generator(), torch.Generator())
    singles = []
    for i in range(2):
        im, lb = comm.shard_batch(mesh, (ims[i], lbs[i]))
        singles.append(_aux(step(state_a, im, lb, gens, seeds[i])))
    model_b, state_b = _fresh(flat, mcfg, tcfg)
    im, lb = comm.shard_batch(mesh, (ims, lbs), batch_axis=1)
    multi = make_dp_multi_train_step(model_b, mesh, 2, augment=True)
    out["chunk_aux"] = _aux(multi(state_b, im, lb, gens, seeds))
    out["single_aux"] = singles
    out["chunk_equal"] = all(torch.equal(a, b) for a, b in
                             zip(model_a.parameters(), model_b.parameters()))

    out["shard"] = comm.shard_batch(mesh, {"x": np.arange(8 * 3).reshape(8, 3)})["x"].numpy()
    model, _ = _fresh(flat, mcfg, tcfg)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(float(rank))
    comm.replicate(mesh, model)
    out["replicated"] = torch_to_flax(model)

    from runet_tpu_torch.config import Config, PreprocessConfig
    from runet_tpu_torch.train.loop import train

    cfg = Config(model=ModelConfig(num_classes=3, base_features=4, num_levels=2,
                                   compute_dtype="float32"),
                 preprocess=PreprocessConfig(spacing=(1.5, 1.5, 1.5), hu_stats=None),
                 train=TrainConfig(patch_size=(16, 16, 16), batch_size=2, steps=3, lr=3e-3,
                                   val_every=2, ckpt_every=2, augment=True))
    state, aux = train(cfg, data_root=data_root, out_dir=out_dir, max_steps=2, log_every=1,
                       device="cpu")
    state, aux = train(cfg, data_root=data_root, out_dir=out_dir, max_steps=3, log_every=1,
                       device="cpu", resume=True)
    out["train"] = {"step": state.step, "loss": float(aux["loss"]),
                    "params": torch_to_flax(state.model)}
    return out


def dp_four(rank, world, flat, mcfg, tcfg, images, labels):
    """Four ranks: the hybrid mesh helpers, one DP step on the 1-D mesh and
    one on the (2, 2) hybrid mesh."""
    torch.set_num_threads(1)
    out = {}
    hybrid = comm.make_hybrid_mesh(2, 2)
    out["hybrid"] = _mesh_info(hybrid)
    out["hybrid_default"] = tuple(comm.make_hybrid_mesh().shape)
    try:
        comm.make_hybrid_mesh(3, 3)
        out["bad_hybrid"] = None
    except ValueError as e:
        out["bad_hybrid"] = str(e)
    out["data"] = _dp_step(comm.make_mesh(), flat, mcfg, tcfg, images, labels)
    out["hybrid_step"] = _dp_step(hybrid, flat, mcfg, tcfg, images, labels)
    return out


def fail_on_rank_one(rank, world):
    """Rank 1 raises; rank 0 returns."""
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank


# ---- spatial ----------------------------------------------------------------

def _stack_apply(p: dict):
    """The JAX package's norm-free test stack (conv → LeakyReLU → stride-2
    conv → LeakyReLU → 2x2x2 transposed conv → 1x1x1 conv, flax SAME
    padding, biases) on flax's weights, NDHWC in and out."""
    w = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in p.items()}

    def conv(x, name, stride=1):
        k = w[f"{name}/kernel"].permute(4, 3, 0, 1, 2)
        if stride == 2:  # flax SAME, stride 2, even input: pad 0 before, 1 after
            x = F.pad(x, (0, 1, 0, 1, 0, 1))
            return F.conv3d(x, k, w[f"{name}/bias"], stride=2)
        return F.conv3d(x, k, w[f"{name}/bias"], padding=k.shape[-1] // 2)

    def apply_fn(_params, x):
        x = x.permute(0, 4, 1, 2, 3)
        x = F.leaky_relu(conv(x, "Conv_0"), 0.01)
        x = F.leaky_relu(conv(x, "Conv_1", stride=2), 0.01)
        # flax's transposed conv takes unflipped taps; torch's is the conv
        # gradient (flipped).
        kt = torch.flip(w["ConvTranspose_0/kernel"], (0, 1, 2)).permute(3, 4, 0, 1, 2)
        x = F.conv_transpose3d(x, kt, w["ConvTranspose_0/bias"], stride=2)
        return conv(x, "Conv_2").permute(0, 2, 3, 4, 1)

    return apply_fn


def spatial_suite(rank, world, stack_params, stack_vol, unet_flat, unet_cfg, unet_vol,
                  pad_flat, pad_cfg, pad_vol):
    """Four ranks on a ``space`` mesh: the norm-free stack's local logits
    (halo 16), the synced-norm U-Net's local logits and gathered labels
    (halo 8, divisor 2), and the padded 50-slice case's labels."""
    from runet_tpu_torch.parallel.spatial import spatial_shard_forward, spatial_shard_predict

    torch.set_num_threads(1)
    mesh = comm.make_mesh(world, (comm.SPACE_AXIS,))
    out = {"stack": spatial_shard_forward(_stack_apply(stack_params), None, stack_vol, mesh,
                                          halo=16).numpy()}
    unet = load_state(UNet3D(ModelConfig(**unet_cfg), device="cpu"), unet_flat).eval()
    apply_fn = lambda _p, x: unet(x)  # noqa: E731
    out["unet_logits"] = spatial_shard_forward(apply_fn, None, unet_vol, mesh, halo=8).numpy()
    out["unet_labels"] = spatial_shard_predict(apply_fn, None, unet_vol, mesh, halo=8,
                                               divisor=2).numpy()
    pad = load_state(UNet3D(ModelConfig(**pad_cfg), device="cpu"), pad_flat).eval()
    out["pad_labels"] = spatial_shard_predict(lambda _p, x: pad(x), None, pad_vol, mesh, halo=8,
                                              divisor=2).numpy()
    out["staged"] = comm.staged_calls()
    return out
