"""Data-parallel train step with explicit collectives.

Counterpart of ``runet_tpu/parallel/dp.py``: each rank runs the forward and
backward of ``train/state.py``'s step on its shard of the global batch;
between the gradient and the update the gradients and the aux scalars go
through ONE all-reduce (one flat f32 buffer, divided by the data-parallel
size: JAX's ``pmean``), hierarchical on the hybrid mesh (the ``ici`` rows
first, then the ``dcn`` columns). The clip (``clip_by_global_norm(12)``)
reads the reduced gradient and every rank applies the same update, so the
parameters stay replicated; ``grad_norm`` is the reduced norm.

The collectives are explicit rather than ``DistributedDataParallel``: the
step takes its gradients with ``torch.autograd.grad``, which DDP's reducer
does not see, and JAX's step is an explicit ``pmean`` too. The hand-written
kernels run inside each rank's step at its local shapes, as they do on one
device.

Augmentation: a rank passes its first global sample index to the step, and
the step seeds each sample's draws from (step seed, global sample index)
(``data/augment.py::sample_seed``), so a data-parallel step draws what the
one-device step draws on the same global batch, draw for draw (JAX's
``split_key_data``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from runet_tpu_torch.parallel.comm import data_axes, data_index, data_size
from runet_tpu_torch.train.state import make_multi_train_step, make_train_step


def make_reduce_grads(mesh):
    """``reduce_grads(grads, aux) -> (grads, aux)``: the mean over the
    mesh's data-parallel ranks of every gradient and aux scalar, in one f32
    buffer and one all-reduce per data axis."""
    groups = [mesh.get_group(a) for a in reversed(data_axes(mesh))]
    n = data_size(mesh)

    def reduce_grads(grads, aux):
        names = sorted(aux)
        sizes = [g.numel() for g in grads]
        flat = torch.cat([g.float().reshape(-1) for g in grads]
                         + [torch.stack([aux[k].float() for k in names])])
        for group in groups:
            dist.all_reduce(flat, group=group)
        flat /= n
        parts = torch.split(flat, sizes + [len(names)])
        # Back into the gradients' own tensors: the update then runs on the
        # same allocations as the one-device step (views into the buffer
        # would start unaligned, and a vectorized elementwise kernel may
        # round their head and tail elements another way).
        for g, part in zip(grads, parts):
            g.copy_(part.view_as(g))
        return grads, dict(zip(names, parts[-1].unbind(0)))

    return reduce_grads


def make_dp_train_step(model, mesh, augment: bool = False, elastic: bool = False,
                       loss_kwargs: dict | None = None):
    """``step(state, images, labels, generators=None, seed=None) -> aux`` on
    this rank's shard (B_local, ...) of the global batch; the same contract
    as ``make_train_step``'s step, with gradients and aux averaged over the
    data-parallel ranks before the update."""
    step = make_train_step(model, augment, elastic, loss_kwargs, make_reduce_grads(mesh))
    index = data_index(mesh)

    def dp_step(state, images, labels, generators=None, seed=None):
        return step(state, images, labels, generators, seed, index * images.shape[0])

    return dp_step


def make_dp_multi_train_step(model, mesh, k: int, augment: bool = False,
                             elastic: bool = False, loss_kwargs: dict | None = None):
    """K data-parallel steps per call (the ``steps_per_dispatch`` chunk):
    ``multi(state, images (K, B_local, ...), labels, generators=None,
    seeds=None) -> aux`` with the aux scalars as chunk means; the chunk
    equals K ``make_dp_train_step`` steps draw for draw."""
    multi = make_multi_train_step(model, k, augment, elastic, loss_kwargs,
                                  make_reduce_grads(mesh))
    index = data_index(mesh)

    def dp_multi(state, images, labels, generators=None, seeds=None):
        return multi(state, images, labels, generators, seeds, index * images.shape[1])

    return dp_multi
