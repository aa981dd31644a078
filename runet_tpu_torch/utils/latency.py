"""Latency of a function or kernel on the card (counterpart of
``runet_tpu/utils/latency.py``).

PyTorch returns before the card finishes, so a host clock around one call
measures the enqueue. On CUDA these time with CUDA events and synchronize
once, at the end of the chain:

- ``chained_ms``: ``n`` calls back to back between two events: device time
  per call, host dispatch gaps included;
- ``pipelined_ms``: the same chain with an event pair around each call: the
  mean of the per-call intervals (the gaps between calls excluded);
- ``scanned_ms``: the counterpart of the JAX package's device-resident
  ``lax.scan`` chain. ``iters`` chained calls of a shape-preserving ``step``
  are captured ONCE into a CUDA graph and the graph is replayed ``reps``
  times; the minimum per-iteration time of a replay is device time with no
  host dispatch in it. The graph replays every captured kernel, so unlike
  XLA nothing is dropped as dead and ``step`` needs no token folding of
  its side outputs. Raises ``ValueError`` for a step that is not
  shape-preserving and ``CaptureError`` when the step cannot be captured
  (a host read of a device value, a synchronization); the caller may then
  time it with ``chained_ms`` and say so.

On the CPU each runs the same loop on the host clock, so tests can drive
them; a number from there is no device time.
"""

from __future__ import annotations

import time

import torch


# Untimed replays of a captured graph before ``scanned_ms`` times its
# ``reps``: a graph's kernels run WARM_REPLAYS + reps times after capture.
WARM_REPLAYS = 1


class CaptureError(RuntimeError):
    """``step`` could not be captured into a CUDA graph."""


def _device(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _host_ms(fn, args: tuple, n: int, warmup: int, per_call: bool) -> float:
    for _ in range(warmup):
        fn(*args)
    if per_call:
        total = 0.0
        for _ in range(n):
            t0 = time.perf_counter()
            fn(*args)
            total += time.perf_counter() - t0
        return total / n * 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    return (time.perf_counter() - t0) / n * 1e3


def chained_ms(fn, args: tuple, n: int = 20, warmup: int = 2) -> float:
    """Per-call ms of ``fn(*args)`` over ``n`` calls back to back, one
    synchronization at the end of the chain (dispatch gaps included)."""
    dev = _device(args)
    if dev.type != "cuda":
        return _host_ms(fn, args, n, warmup, per_call=False)
    for _ in range(warmup):
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(n):
        fn(*args)
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / n


def pipelined_ms(fn, args: tuple, n: int = 20, warmup: int = 2) -> float:
    """Mean per-call ms of ``fn(*args)``: an event pair around each of ``n``
    pipelined calls, one synchronization at the end of the chain."""
    dev = _device(args)
    if dev.type != "cuda":
        return _host_ms(fn, args, n, warmup, per_call=True)
    for _ in range(warmup):
        fn(*args)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    torch.cuda.synchronize(dev)
    for start, end in events:
        start.record()
        fn(*args)
        end.record()
    torch.cuda.synchronize(dev)
    return sum(s.elapsed_time(e) for s, e in events) / n


def _check_step(step, x0: torch.Tensor) -> None:
    y = step(x0)
    if not isinstance(y, torch.Tensor) or y.shape != x0.shape or y.dtype != x0.dtype:
        got = (tuple(y.shape), y.dtype) if isinstance(y, torch.Tensor) else type(y)
        raise ValueError(f"scanned_ms: step must map {tuple(x0.shape)} {x0.dtype} to the same "
                         f"shape and dtype, got {got}")


def scanned_ms(step, x0: torch.Tensor, iters: int = 30, reps: int = 3) -> float:
    """Minimum per-iteration ms of ``step`` (x → x, same shape and dtype)
    chained ``iters`` times inside one CUDA graph, replayed ``reps`` times
    (on the CPU: the same chain on the host clock)."""
    if x0.device.type != "cuda":
        _check_step(step, x0)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            y = x0
            for _ in range(iters):
                y = step(y)
            best = min(best, (time.perf_counter() - t0) * 1e3 / iters)
        return best
    dev = x0.device
    # Warm up on a side stream (first-call set-up such as kernel attributes,
    # library handles and workspaces must not happen during capture).
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        _check_step(step, x0)
        step(x0)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            y = x0
            for _ in range(iters):
                y = step(y)
    except RuntimeError as e:
        raise CaptureError(f"scanned_ms: the step cannot be captured: {e}") from e
    for _ in range(WARM_REPLAYS):
        graph.replay()
    torch.cuda.synchronize(dev)
    best = float("inf")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(dev)
        best = min(best, start.elapsed_time(end) / iters)
    del graph, y
    return best
