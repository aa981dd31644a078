"""Phase timing (counterpart of ``runet_tpu/utils/timing.py``).

PyTorch returns before the card finishes, so a phase that should include
its device work passes ``sync``: a device, tensor or list of them, whose
CUDA work is waited for with ``torch.cuda.synchronize`` before the clock
stops. CPU work needs no sync.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


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
    """Accumulates wall-clock seconds per named phase."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.phases: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str, sync=None):
        if not self.enabled:
            yield
            return
        t0 = time.monotonic()
        try:
            yield
        finally:
            if sync is not None:
                device_sync(sync)
            self.phases[name] = self.phases.get(name, 0.0) + time.monotonic() - t0

    def as_dict(self) -> dict[str, float]:
        return {k: round(v, 4) for k, v in self.phases.items()}
