"""The program's span recorder, and phase timing over it (counterpart of
``runet_tpu/utils/timing.py``).

A span is one interval of host work: ``(name, start_ns, end_ns, span_id,
parent_id, trace_id, thread_id, counters)`` on ``time.perf_counter_ns``,
the clock of the benchmark's own spans (``benchmark/trace.py``);
``thread_id`` is the operating system's id of the thread. The
parent is the innermost span open on the same thread, unless one is
named; ``trace_id`` is the request's number (a served case, a train
step) and is inherited from the parent, so every span of one request
shares it, across threads too. The name's prefix before the first dot is
its layer (``serving``, ``case``, ``preprocess``, ``host_post``,
``train_step``, ``train_loop``); ``wait.*`` spans are the host waiting
on the device.

Recording is always on, a flight recorder: finished spans go into a
bounded ring (``RING_SPANS``), the oldest overwritten first. A span costs
two clock reads, one id and one append to a ``deque``, which is atomic
under the interpreter lock, so no lock is taken. ``spans()`` is a
snapshot of the ring, ``dropped()`` how many spans it overwrote.

PyTorch returns before the card finishes, so a phase that should include
its device work passes ``sync``: a device, tensor or list of them, whose
CUDA work is waited for with ``torch.cuda.synchronize`` before the clock
stops. CPU work needs no sync.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import NamedTuple

import torch

RING_SPANS = 1 << 17

_clock = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int | None
    trace_id: int | None
    thread_id: int
    counters: dict | None


class _Stack(list):
    """The open spans of one thread, and its id (read once: asking the
    operating system for it is a system call)."""

    __slots__ = ("tid",)


class _Open:
    """One open span (``SpanRecorder.span``): a class, not a generator, so
    entering it allocates nothing more."""

    __slots__ = ("rec", "name", "trace", "parent", "span_id", "start_ns", "end_ns",
                 "counters", "_stack")

    def __init__(self, rec: "SpanRecorder", name: str, trace, parent):
        self.rec, self.name, self.trace, self.parent = rec, name, trace, parent

    def __enter__(self) -> "_Open":
        stack = self.rec._stack()
        if stack:
            top = stack[-1]
            if self.parent is None:
                self.parent = top.span_id
            if self.trace is None:
                self.trace = top.trace
        self.span_id = next(self.rec._ids)
        self.counters = None
        self._stack = stack
        stack.append(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = _clock()
        self._stack.pop()
        self.rec._push((self.name, self.start_ns, self.end_ns, self.span_id, self.parent,
                        self.trace, self._stack.tid, self.counters))
        return False


class SpanRecorder:
    """A ring of finished spans and a stack of open ones per thread."""

    def __init__(self, capacity: int = RING_SPANS):
        self._ring: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._dropped = 0

    def _stack(self) -> _Stack:
        try:
            return self._local.stack
        except AttributeError:
            stack = self._local.stack = _Stack()
            stack.tid = threading.get_native_id()
            return stack

    def _push(self, span: tuple) -> None:
        ring = self._ring
        if len(ring) == ring.maxlen:
            self._dropped += 1  # a count that two overflowing threads may both miss
        ring.append(span)

    def span(self, name: str, trace: int | None = None, parent: int | None = None) -> _Open:
        """Context manager recording the block as ``name``; ``parent`` names
        a span of another thread (the innermost open one on this thread
        otherwise)."""
        return _Open(self, name, trace, parent)

    def new_id(self) -> int:
        """A span id taken ahead, for a span ``record``ed once it ends whose
        children (on other threads) name it as their parent."""
        return next(self._ids)

    def record(self, name: str, start_ns: int, end_ns: int, trace: int | None = None,
               parent: int | None = None, span_id: int | None = None) -> int:
        """A span known only after it ended (a queue wait, a request whose
        start and end lie on different threads or across a ``yield``);
        returns its id. Parent and trace default as ``span``'s do."""
        stack = self._stack()
        if stack:
            if parent is None:
                parent = stack[-1].span_id
            if trace is None:
                trace = stack[-1].trace
        sid = next(self._ids) if span_id is None else span_id
        self._push((name, int(start_ns), int(end_ns), sid, parent, trace, stack.tid, None))
        return sid

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` of the innermost open span on this
        thread (nothing when none is open)."""
        stack = self._stack()
        if stack:
            top = stack[-1]
            if top.counters is None:
                top.counters = {}
            top.counters[name] = top.counters.get(name, 0) + n

    def current(self) -> _Open | None:
        """The innermost open span on this thread."""
        stack = self._stack()
        return stack[-1] if stack else None

    def spans(self) -> list[Span]:
        return [Span._make(s) for s in list(self._ring)]

    def dropped(self) -> int:
        return self._dropped


RECORDER = SpanRecorder()
span = RECORDER.span
record = RECORDER.record
new_id = RECORDER.new_id
count = RECORDER.count
current = RECORDER.current
spans = RECORDER.spans
dropped = RECORDER.dropped
now_ns = _clock


def device_sync(x) -> None:
    """Wait for the CUDA work behind ``x`` (a device, tensor, or list)."""
    if isinstance(x, (list, tuple)):
        for item in x:
            device_sync(item)
        return
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Seconds per named phase: the totals of the spans opened through
    ``phase`` (in the program's ring; their ids in ``span_ids``)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.phases: dict[str, float] = {}
        self.span_ids: list[int] = []

    @contextmanager
    def phase(self, name: str, sync=None):
        if not self.enabled:
            yield
            return
        s = span(name)
        try:
            with s:
                try:
                    yield
                finally:
                    if sync is not None:
                        device_sync(sync)
        finally:
            self.span_ids.append(s.span_id)
            self.phases[name] = self.phases.get(name, 0.0) + (s.end_ns - s.start_ns) / 1e9

    def as_dict(self) -> dict[str, float]:
        return {k: round(v, 4) for k, v in self.phases.items()}
