"""Structured JSONL metrics logging; a copy of ``runet_tpu/train/metrics.py``.

One JSON object per line (step, wall time, loss terms, per-class Dice,
throughput), plus the run config serialized once at run start.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, run_dir: str | Path, filename: str = "metrics.jsonl"):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.run_dir / filename
        self._f = self.path.open("a", buffering=1)
        self._t0 = time.monotonic()

    def log(self, step: int, **metrics) -> None:
        rec = {"step": int(step), "wall_s": round(time.monotonic() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                fv = float(v)
                # A diverged run's NaN loss must not make the line invalid
                # JSON (json.dumps would emit the non-RFC NaN token).
                rec[k] = fv if math.isfinite(fv) else None
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def write_config(self, config_json: str, filename: str = "config.json") -> None:
        (self.run_dir / filename).write_text(config_json)

    def close(self) -> None:
        self._f.close()
