"""The traced window: device operations from ``torch.profiler``, host spans
from the benchmark's own clock, and the reductions every per-layer metric
shares (interval unions, sums by name, idle gaps).

Only device activity is traced (CUPTI), so the host pays little for it. A
marker operation launched on an idle device right after the profiler starts
ties the device's timestamps to the host clock, so an idle gap on the device
can be named by the benchmark's span the host was in.
"""

from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    stream: int


@dataclasses.dataclass
class Spans:
    """Host spans of the benchmark's own files: (name, start_ns, end_ns) on
    ``time.perf_counter_ns``; a no-op until ``enabled``."""

    enabled: bool = False
    items: list = dataclasses.field(default_factory=list)

    def add(self, name: str, start_ns: int, end_ns: int) -> None:
        if self.enabled:
            self.items.append((name, start_ns, end_ns))


class Tracer:
    """Context manager over the traced window. After exit: ``ops`` (device
    operations in time order), ``window_s`` (host clock, profiler start to
    the synchronised end) and ``offset_ns`` (device time minus host time)."""

    def __init__(self, device):
        self.device = device
        self.ops: list[DeviceOp] = []
        self.window_s = 0.0
        self.offset_ns = 0
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter_ns()
        self._marker = torch.zeros(1, device=self.device)  # the first device op of the window
        self._marker_host_ns = time.perf_counter_ns()
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter_ns()
        self._prof.__exit__(*exc)
        self.window_s = (t1 - self._t0) / 1e9
        if exc[0] is None:
            self.ops = device_ops(self._prof)
            if self.ops:
                self.offset_ns = self.ops[0].start_ns - self._marker_host_ns
        self._prof = None
        return False


def device_ops(prof) -> list[DeviceOp]:
    """Every device-side operation (kernels, copies, sets) of a profile, in
    start order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        start, dur = int(e.start_ns()), int(e.duration_ns())
        if dur <= 0:
            continue
        out.append(DeviceOp(e.name(), start, start + dur, int(e.device_resource_id())))
    out.sort(key=lambda o: o.start_ns)
    return out


def union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_s(ops) -> float:
    return union_ns((o.start_ns, o.end_ns) for o in ops) / 1e9


def matching(ops, prefixes) -> list[DeviceOp]:
    """Operations whose name contains one of ``prefixes``."""
    return [o for o in ops if any(p in o.name for p in prefixes)]


def followers(ops, leaders, follower: str) -> list[DeviceOp]:
    """Operations named ``follower`` whose predecessor on the same stream is
    one of ``leaders`` (a kernel's second pass, launched right after it)."""
    lead_ids = {id(o) for o in leaders}
    last: dict[int, DeviceOp] = {}
    out = []
    for o in ops:
        prev = last.get(o.stream)
        if follower in o.name and prev is not None and id(prev) in lead_ids:
            out.append(o)
        last[o.stream] = o
    return out


def top_ops(ops, n: int = 10) -> list[list]:
    by: dict[str, int] = {}
    for o in ops:
        key = o.name[:120]
        by[key] = by.get(key, 0) + (o.end_ns - o.start_ns)
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(ops, spans, offset_ns: int, n: int = 10) -> list[list]:
    """The ``n`` longest gaps in which no device operation ran, each named by
    the host span in progress at its midpoint (``host`` outside any)."""
    gaps = []
    cur_e = None
    for o in ops:
        if cur_e is not None and o.start_ns > cur_e:
            gaps.append((cur_e, o.start_ns))
        cur_e = o.end_ns if cur_e is None else max(cur_e, o.end_ns)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:n]:
        mid = (s + e) // 2 - offset_ns
        name = next((nm for nm, a, b in spans if a <= mid <= b), "host")
        out.append([name, (e - s) / 1e9])
    return out
