"""One process per rank: run a function on a fresh process group and
collect every rank's result.

The JAX package drives its meshes from one process (fake CPU devices in
its tests); ``torch.distributed`` needs a process per rank. ``spawn`` starts
them with ``torch.multiprocessing``'s spawn method, so a child imports only
``fn``'s module and what it imports. The ranks meet at a ``file://`` init
method in a fresh temporary directory, so concurrent launches (tests under
``xdist``) never race for a port.
"""

from __future__ import annotations

import pickle
import queue
import shutil
import tempfile
import traceback

import torch

# Seconds a launch waits for its ranks before it ends them and raises.
TIMEOUT_S = 900.0


def _rank_device(device, rank: int) -> torch.device:
    """``device`` for one rank: a list gives each rank its own entry;
    ``"cuda"`` without an index is ``cuda:<rank % device count>``."""
    if isinstance(device, (list, tuple)):
        return torch.device(device[rank])
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % max(1, torch.cuda.device_count()))
    return dev


def _run_rank(fn, rank: int, world: int, backend, device, init_method: str, args, out) -> None:
    from runet_tpu_torch.parallel import comm

    import torch.distributed as dist

    try:
        comm.init_distributed(init_method, world, rank, backend=backend,
                              device=_rank_device(device, rank))
        # Every rank has finished connecting before any runs ``fn``: a rank
        # that returned at once would close its sockets while a peer was
        # still connecting to it (gloo), failing that peer's set-up.
        dist.barrier()
        # Pickled here with the plain pickler: a tensor goes by value, not
        # through shared memory that would die with this process.
        out.put((rank, True, pickle.dumps(fn(rank, world, *args))))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))  # the parent raises with it
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str | None = None, device="cpu", args=()) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes,
    each in the process group of ``backend`` (NCCL on CUDA, gloo on the
    CPU by default) on ``device`` (one for all ranks, one per rank as a
    list, or ``"cuda"`` for ``cuda:<rank>``). ``fn`` must be importable
    by name and its arguments and result picklable (a result's tensors are
    copied by value, CUDA ones come back on CUDA). Returns the results in
    rank order; raises with a rank's traceback if any rank fails (or
    when the ranks give no result within TIMEOUT_S), and ends the
    others."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="runet_spawn_")
    init_method = f"file://{tmp}/rendezvous"
    procs = [ctx.Process(target=_run_rank,
                         args=(fn, r, world_size, backend, device, init_method, tuple(args), out),
                         daemon=True)
             for r in range(world_size)]
    results: dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        waited = 0.0
        while len(results) < world_size:
            try:
                rank, ok, payload = out.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive() and p.exitcode]
                if dead:
                    raise RuntimeError(f"spawn: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                if waited > TIMEOUT_S:
                    missing = sorted(set(range(world_size)) - set(results))
                    raise TimeoutError(f"spawn: ranks {missing} gave no result in "
                                       f"{TIMEOUT_S:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} of {world_size} failed:\n{payload}")
            results[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world_size)]
