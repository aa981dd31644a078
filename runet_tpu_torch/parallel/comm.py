"""Process group, meshes and collectives: the port's distributed backend.

Counterpart of ``runet_tpu/parallel/comm.py``. JAX drives many devices from
one process; ``torch.distributed`` runs one process per rank, each on one
device, so every helper here acts on THIS rank's share:

- ``init_distributed``: the process group (NCCL when ranks sit on CUDA,
  gloo on the CPU), idempotent, and a no-op for a single process.
- ``make_mesh`` / ``make_hybrid_mesh``: a ``DeviceMesh`` over the ranks
  with named dimensions (``data``; ``dcn`` x ``ici`` for multi-host data
  parallelism, where ``dcn`` crosses hosts and ``ici`` stays on one;
  ``space`` for spatial partitioning). ``data_axes`` keeps JAX's contract.
- ``shard_batch``: this rank's slice of a global batch on its device;
  ``replicate``: rank 0's parameters and buffers broadcast to every rank.
- An axis registry (``bind_axis``, ``axis_group``) from a mesh dimension's
  name to its process group, read by ``InstanceNorm`` when
  ``ModelConfig.spatial_axis`` names the axis its moments are averaged over.
- ``axis_mean``, ``exchange_halos`` and ``all_gather_cat``: the collectives
  of the norm, the halo exchange and the label gather of spatial inference.

gloo moves no CUDA tensor point to point and gathers none; its all-reduce
and broadcast take them. Under gloo, the halo slabs and the gathered
labels of a rank on CUDA are staged through pinned host memory, and each
staged call is counted (``staged_calls``). NCCL moves everything device to
device.
"""

from __future__ import annotations

import math
import os
import threading
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"
DCN_AXIS = "dcn"  # across hosts (data-center network)
ICI_AXIS = "ici"  # within a host (the devices' interconnect)

_device: torch.device | None = None
_axis_groups: dict[str, object] = {}
_staged = 0
_staged_lock = threading.Lock()


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device=None,
) -> bool:
    """Idempotent ``dist.init_process_group`` wrapper.

    Returns True when a process group exists (made now or before), False
    for the single-process case: no arguments and neither ``MASTER_ADDR``
    nor ``WORLD_SIZE`` in the environment. ``coordinator_address`` is
    ``host:port`` (TCP) or an init-method URL (``file://...``); without it
    the standard environment variables are read (``env://``). ``device``:
    this rank's device (default ``cuda:<LOCAL_RANK % device count>`` where
    CUDA is present, else the CPU). ``backend`` defaults to NCCL on CUDA
    and gloo on the CPU; a request for NCCL that cannot be met raises and
    never falls back to gloo."""
    global _device
    if dist.is_available() and dist.is_initialized():
        return True
    if (coordinator_address is None and num_processes is None
            and "MASTER_ADDR" not in os.environ and "WORLD_SIZE" not in os.environ):
        return False
    if not dist.is_available():
        raise RuntimeError("init_distributed: this torch build has no torch.distributed")
    if device is None:
        if torch.cuda.is_available():
            local = int(os.environ.get("LOCAL_RANK", process_id or os.environ.get("RANK", 0)))
            device = torch.device("cuda", local % torch.cuda.device_count())
        else:
            device = torch.device("cpu")
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and not (dev.type == "cuda" and torch.cuda.is_available()
                                  and dist.is_nccl_available()):
        raise RuntimeError(f"init_distributed: NCCL needs a CUDA device and a torch build with "
                           f"NCCL; got device {dev} (cuda available: "
                           f"{torch.cuda.is_available()}, nccl available: "
                           f"{dist.is_nccl_available()})")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, **kw)
    _device = dev
    return True


def device() -> torch.device:
    """This rank's device (``init_distributed``'s); CUDA where present
    otherwise, the CPU without it."""
    if _device is not None:
        return _device
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def barrier() -> None:
    """Wait for every rank of the world (a no-op for one process)."""
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[device().index])
        else:
            dist.barrier()


def make_mesh(num_devices: int | None = None, axis_names: tuple[str, ...] = (DATA_AXIS,),
              shape: tuple[int, ...] | None = None):
    """A ``DeviceMesh`` over ranks ``0 .. num_devices - 1`` (default: the
    whole world) in row-major order, dimensions named ``axis_names``; a
    collective, so every rank of the world calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: call init_distributed first "
                           "(one process per device)")
    n = world_size() if num_devices is None else int(num_devices)
    if n > world_size():
        raise ValueError(f"mesh of {n} devices > world of {world_size()} ranks")
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return DeviceMesh(device().type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def make_hybrid_mesh(n_dcn: int | None = None, n_ici: int | None = None):
    """(dcn x ici) mesh for multi-host data parallelism. Ranks are numbered
    host by host, so each ``ici`` row is one host's devices and only the
    ``dcn`` axis crosses hosts. Defaults: ``n_ici`` the ranks per host
    (``LOCAL_WORLD_SIZE``, else the whole world), ``n_dcn`` the rest; on
    one host a (1, n) mesh."""
    n = world_size()
    if n_ici is None:
        n_ici = n // n_dcn if n_dcn else int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n_dcn is None:
        n_dcn = n // n_ici
    if n_dcn * n_ici != n:
        raise ValueError(f"mesh ({n_dcn}, {n_ici}) != {n} devices")
    return make_mesh(n, (DCN_AXIS, ICI_AXIS), (n_dcn, n_ici))


def data_axes(mesh) -> tuple[str, ...]:
    """Mesh axes a data-parallel batch shards over: (data,) on the 1-D
    mesh, (dcn, ici) on the hybrid mesh."""
    names = tuple(mesh.mesh_dim_names or ())
    if DATA_AXIS in names:
        return (DATA_AXIS,)
    if DCN_AXIS in names and ICI_AXIS in names:
        return (DCN_AXIS, ICI_AXIS)
    raise ValueError(f"mesh axes {names} have no data-parallel axis")


def _dim(mesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise ValueError(f"mesh axes {names} have no axis {name!r}")
    return names.index(name)


def axis_size(mesh, name: str) -> int:
    return int(mesh.shape[_dim(mesh, name)])


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along the mesh dimension ``name``."""
    return int(mesh.get_coordinate()[_dim(mesh, name)])


def data_size(mesh) -> int:
    """Ranks the batch is split over."""
    return math.prod(axis_size(mesh, a) for a in data_axes(mesh))


def data_index(mesh) -> int:
    """This rank's position in the global batch, in shards (row-major over
    the data axes, as JAX lays a batch over them)."""
    idx = 0
    for a in data_axes(mesh):
        idx = idx * axis_size(mesh, a) + axis_index(mesh, a)
    return idx


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(mesh, tree, batch_axis: int = 0):
    """This rank's slice of each global-batch array in ``tree`` (tensors or
    numpy arrays, in tuples, lists or dicts), on this rank's device.
    ``batch_axis=1`` serves (K, B, ...) superbatches of the K-step chunk."""
    n, i = data_size(mesh), data_index(mesh)

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        b = t.shape[batch_axis]
        if b % n:
            raise ValueError(f"global batch {b} not divisible by {n} data-parallel ranks")
        k = b // n
        return t.narrow(batch_axis, i * k, k).to(device()).contiguous()

    return _tree_map(put, tree)


def _broadcast_flat(tensors, src: int, group) -> None:
    """Broadcast ``tensors`` from global rank ``src`` in one call per dtype."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src, group=group)
        for t, part in zip(ts, torch.split(flat, [t.numel() for t in ts])):
            t.copy_(part.view_as(t))


@torch.no_grad()
def replicate(mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast the parameters and buffers of the mesh's first rank to
    every rank of the mesh, in place (last dimension first, then each
    earlier one, each from coordinate 0 of this rank's slice); returns the
    module."""
    tensors = list(module.parameters()) + list(module.buffers())
    coord = list(mesh.get_coordinate())
    for d in reversed(range(len(coord))):
        if mesh.shape[d] == 1:
            continue
        at = list(coord)
        at[d] = 0
        _broadcast_flat(tensors, int(mesh.mesh[tuple(at)]), mesh.get_group(d))
    return module


# ---- axis registry --------------------------------------------------------

@contextmanager
def bind_axis(name: str, group):
    """Bind mesh axis ``name`` to the process group ``group`` inside the
    block (the norms of a model with ``spatial_axis=name`` average their
    moments over it)."""
    prev = _axis_groups.get(name)
    _axis_groups[name] = group
    try:
        yield group
    finally:
        if prev is None:
            _axis_groups.pop(name, None)
        else:
            _axis_groups[name] = prev


def axis_group(name: str):
    """The process group bound to mesh axis ``name``."""
    group = _axis_groups.get(name)
    if group is None:
        raise RuntimeError(
            f"no process group is bound to mesh axis {name!r}: a model with "
            f"ModelConfig.spatial_axis={name!r} runs inside "
            "parallel.spatial.spatial_shard_forward (or comm.bind_axis)")
    return group


# ---- collectives ----------------------------------------------------------

def staged_calls() -> int:
    """Collectives staged through pinned host memory (gloo, CUDA tensors)
    since the last ``reset_staged_calls``."""
    return _staged


def reset_staged_calls() -> None:
    global _staged
    _staged = 0


def _staging(t: torch.Tensor, group) -> bool:
    """Whether a collective of ``t`` in ``group`` goes through host memory;
    counts the call when it does."""
    global _staged
    if not (t.is_cuda and dist.get_backend(group) == "gloo"):
        return False
    with _staged_lock:
        _staged += 1
    return True


def _pinned(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def axis_mean(tensors, axis_name: str):
    """The mean over the ranks of axis ``axis_name`` of each of
    ``tensors`` (one shape), in one all-reduce; JAX's ``pmean``."""
    group = axis_group(axis_name)
    flat = torch.stack([t.float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return flat.unbind(0)


def exchange_halos(x_local: torch.Tensor, halo: int, axis_name: str) -> torch.Tensor:
    """x_local: (Xl, Y, Z, C) -> (Xl + 2*halo, Y, Z, C).

    Interior faces receive the neighbour's ``halo`` slab; the two global
    edges receive zeros (the unsharded SAME-padding semantics)."""
    group = axis_group(axis_name)
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    send_left, send_right = x_local[:halo].contiguous(), x_local[-halo:].contiguous()
    stage = n > 1 and _staging(x_local, group)
    if stage:
        send_left, send_right = _pinned(send_left), _pinned(send_right)
    from_left, from_right = torch.zeros_like(send_right), torch.zeros_like(send_left)
    ops = []
    if idx > 0:
        ops += [dist.P2POp(dist.isend, send_left, ranks[idx - 1], group),
                dist.P2POp(dist.irecv, from_left, ranks[idx - 1], group)]
    if idx < n - 1:
        ops += [dist.P2POp(dist.isend, send_right, ranks[idx + 1], group),
                dist.P2POp(dist.irecv, from_right, ranks[idx + 1], group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if stage:
        from_left, from_right = from_left.to(x_local.device), from_right.to(x_local.device)
    return torch.cat([from_left, x_local, from_right], dim=0)


def all_gather_cat(t: torch.Tensor, axis_name: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (one shape) of axis ``axis_name``, concatenated
    in rank order along ``dim``, on ``t``'s device."""
    group = axis_group(axis_name)
    stage = _staging(t, group)
    src = _pinned(t) if stage else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if stage else out
