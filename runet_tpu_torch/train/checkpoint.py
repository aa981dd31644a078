"""Checkpoint and resume with ``torch.save``.

Counterpart of ``runet_tpu/train/checkpoint.py`` (Orbax there). Each save
writes ``step_<n>.pt`` (the train state: step, parameters, optimizer state)
to a temporary file and renames it into place, then updates ``index.json``
(step → metrics) the same way, so a crash never leaves a torn checkpoint.
Retention is the JAX package's dual policy:

- **best-K** on ``val_dice`` among saves that carry metrics, and
- **latest-N** regardless of metrics, so periodic crash-resume saves
  (``metrics=None``) are never deleted by the best-K ladder.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3, best_metric: str = "val_dice",
                 latest_keep: int = 2):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.best_metric = best_metric
        self.latest_keep = latest_keep

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{int(step):08d}.pt"

    def _index(self) -> dict[int, dict | None]:
        p = self.directory / "index.json"
        if not p.exists():
            return {}
        return {int(k): v for k, v in json.loads(p.read_text()).items()}

    def _write_index(self, index: dict[int, dict | None]) -> None:
        tmp = self.directory / f".index.json.{os.getpid()}.tmp"
        tmp.write_text(json.dumps({str(k): v for k, v in sorted(index.items())}))
        os.replace(tmp, self.directory / "index.json")

    def _score(self, metrics: dict | None) -> float:
        if not metrics or self.best_metric not in metrics:
            return float("-inf")
        return float(metrics[self.best_metric])

    def save(self, step: int, state: dict, metrics: dict | None = None) -> None:
        """Save a train-state dict; ``metrics=None`` marks a periodic
        (latest-N only) save."""
        step = int(step)
        tmp = self.directory / f".step_{step:08d}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        index = self._index()
        index[step] = {k: float(v) for k, v in metrics.items()} if metrics is not None else None
        keep = set(sorted(index)[-self.latest_keep:]) if self.latest_keep > 0 else set()
        if self.best_metric:
            scored = [s for s, m in index.items() if m and self.best_metric in m]
            scored.sort(key=lambda s: (self._score(index[s]), s))
            keep |= set(scored[-self.keep:] if self.keep > 0 else [])
        for s in [s for s in index if s not in keep]:
            self._path(s).unlink(missing_ok=True)
            del index[s]
        self._write_index(index)

    def restore(self, step: int | None = None, map_location=None) -> dict:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    def all_steps(self) -> list[int]:
        return sorted(self._index())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> int | None:
        """The step with the highest metric; the latest step when no save
        carries one."""
        index = self._index()
        scored = [s for s, m in index.items() if m and self.best_metric in m]
        if not scored:
            return self.latest_step()
        return max(scored, key=lambda s: (self._score(index[s]), s))

    def best_steps(self, k: int) -> list[int]:
        """Up to ``k`` retained steps, best metric first (saves without the
        metric rank last, latest first)."""
        index = self._index()
        ranked = sorted(index, key=lambda s: (self._score(index[s]), s), reverse=True)
        return ranked[:k]
