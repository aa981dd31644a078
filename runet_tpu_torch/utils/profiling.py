"""``torch.profiler`` integration.

Counterpart of ``runet_tpu/utils/profiling.py``. ``trace(log_dir)`` records
a region with ``torch.profiler.profile`` (CPU activity, and CUDA activity
where a GPU is present) and writes a Chrome trace (``chrome://tracing``,
Perfetto) into ``log_dir``; ``annotate(name)`` adds a named span to it
(``torch.profiler.record_function``). The program's own spans that end
inside the block (``utils/timing.py``) go into the same file as complete
(``"X"``) events on their threads, category ``program_span``, their clock
tied to the profiler's by a marker span at the block's start.

Unlike the JAX package's ``trace``, which turns a profiler failure into a
no-op, a profiler error here propagates: a trace that was asked for and
not written is a failure, not a silent empty directory.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from pathlib import Path

import torch

from runet_tpu_torch.utils import timing

TIE = "runet_tpu_torch.program_spans"


@contextmanager
def trace(log_dir: str | Path):
    """Profile the block; yields the ``torch.profiler.profile`` object. On
    exit writes ``log_dir/trace_<pid>_<ms>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    first = timing.new_id()
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(TIE):
            tie_ns = timing.now_ns()
        yield prof
    end_ns = timing.now_ns()
    path = log_dir / f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"
    prof.export_chrome_trace(str(path))
    _add_program_spans(path, [s for s in timing.spans() if s.span_id > first
                             and s.end_ns <= end_ns], tie_ns)


def _add_program_spans(path: Path, spans, tie_ns: int) -> None:
    """Append ``spans`` to the Chrome trace at ``path`` as ``"X"`` events on
    their threads; ``tie_ns``: the host clock at the start of the trace's
    ``TIE`` event."""
    doc = json.loads(Path(path).read_text())
    events = doc["traceEvents"]
    tie = next((e for e in events if e.get("name") == TIE and e.get("ph") == "X"), None)
    if tie is None:
        raise RuntimeError(f"{path}: the profiler recorded no {TIE!r} event to tie the clocks")
    offset_us = float(tie["ts"]) - tie_ns / 1e3
    for s in spans:
        args = {"span_id": s.span_id, "parent_id": s.parent_id, "trace_id": s.trace_id}
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": tie["pid"],
                       "tid": s.thread_id, "ts": s.start_ns / 1e3 + offset_us,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": dict(args, **(s.counters or {}))})
    Path(path).write_text(json.dumps(doc))


@contextmanager
def annotate(name: str):
    """A named span in the trace of an enclosing ``trace`` block."""
    with torch.profiler.record_function(name):
        yield
