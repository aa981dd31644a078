"""``torch.profiler`` integration.

Counterpart of ``runet_tpu/utils/profiling.py``. ``trace(log_dir)`` records
a region with ``torch.profiler.profile`` (CPU activity, and CUDA activity
where a GPU is present) and writes a Chrome trace (``chrome://tracing``,
Perfetto) into ``log_dir``; ``annotate(name)`` adds a named span to it
(``torch.profiler.record_function``).

Unlike the JAX package's ``trace``, which turns a profiler failure into a
no-op, a profiler error here propagates: a trace that was asked for and
not written is a failure, not a silent empty directory.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from pathlib import Path

import torch


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
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


@contextmanager
def annotate(name: str):
    """A named span in the trace of an enclosing ``trace`` block."""
    with torch.profiler.record_function(name):
        yield
