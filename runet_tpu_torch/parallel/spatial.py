"""Spatial-partition inference: halo-exchange sharding of one volume.

Counterpart of ``runet_tpu/parallel/spatial.py``, the conv-net analogue of
context parallelism: the volume's leading spatial axis is split over the
ranks of one mesh axis (``space``); each rank exchanges a halo with its
neighbours (``comm.exchange_halos``: NCCL point to point, or gloo through
pinned host memory), runs the fully convolutional net on its halo-extended
block with the norms' moments averaged over the axis
(``ModelConfig.spatial_axis``), and crops the halo from its output.

Exactness, as in the JAX package: with a halo that is (a) at least the
model's half receptive field and (b) a multiple of its total downsampling
factor, every voxel further than one receptive field from the GLOBAL volume
edge matches the unsharded forward for bias- and norm-free nets; within it
the zero halo differs from SAME padding once a layer maps zeros to
nonzeros. With InstanceNorm, halo voxels enter each rank's moments, a
small perturbation at halo << block.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from runet_tpu_torch.parallel import comm
from runet_tpu_torch.parallel.comm import SPACE_AXIS


def _as_tensor(volume) -> torch.Tensor:
    if isinstance(volume, np.ndarray):
        volume = torch.from_numpy(np.ascontiguousarray(volume))
    return volume.to(comm.device())


def spatial_shard_forward(apply_fn, params, volume, mesh, halo: int,
                          axis_name: str = SPACE_AXIS) -> torch.Tensor:
    """Run one fully convolutional forward over a spatially sharded volume.

    volume: the global (X, Y, Z, C) volume (array or tensor), X divisible by
    the size of the mesh's ``axis_name``; halo: a multiple of the model's
    total downsampling factor. Each rank takes its X block, exchanges
    halos, runs ``apply_fn(params, block[None])`` with the axis bound to the
    mesh dimension's process group, and returns ITS (X / n, Y, Z, K) logits
    (the block without the halo)."""
    if volume.ndim != 4:
        raise ValueError(f"expected (X, Y, Z, C), got {tuple(volume.shape)}")
    if halo < 1:
        # halo=0 would send whole blocks (x[-0:] is x) and crop to nothing.
        raise ValueError(f"halo must be >= 1, got {halo}")
    n = comm.axis_size(mesh, axis_name)
    if volume.shape[0] % n != 0:
        raise ValueError(f"X={volume.shape[0]} not divisible by {n} devices")
    block = volume.shape[0] // n
    i = comm.axis_index(mesh, axis_name)
    x_local = _as_tensor(volume[i * block:(i + 1) * block])
    with comm.bind_axis(axis_name, mesh.get_group(axis_name)), torch.no_grad():
        x = comm.exchange_halos(x_local, halo, axis_name)
        logits = apply_fn(params, x[None])[0]
    return logits[halo:-halo]


def spatial_shard_predict(apply_fn, params, volume, mesh, halo: int,
                          axis_name: str = SPACE_AXIS, divisor: int = 32) -> torch.Tensor:
    """Whole-volume single-pass prediction across the mesh: X is padded with
    zeros to a multiple of n · ``divisor`` (the model's total downsampling
    factor, so each block is a multiple of it), the ranks' uint8 labels
    are all-gathered, and every rank returns the (X, Y, Z) labels on its
    device."""
    vol = _as_tensor(volume)
    if vol.ndim == 3:
        vol = vol[..., None]
    if vol.ndim != 4:
        raise ValueError(f"expected (X, Y, Z, C), got {tuple(vol.shape)}")
    n = comm.axis_size(mesh, axis_name)
    X = vol.shape[0]
    unit = n * divisor
    Xp = -(-X // unit) * unit
    if Xp != X:
        vol = F.pad(vol, (0, 0, 0, 0, 0, 0, 0, Xp - X))
    logits = spatial_shard_forward(apply_fn, params, vol, mesh, halo, axis_name)
    labels = torch.argmax(logits.float(), dim=-1).to(torch.uint8)
    with comm.bind_axis(axis_name, mesh.get_group(axis_name)):
        return comm.all_gather_cat(labels, axis_name)[:X]
