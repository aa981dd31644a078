"""Backend health probing (counterpart of ``runet_tpu/utils/health.py``).

``probe_backend`` asks for the card's name in a SUBPROCESS with a timeout,
so a caller fails fast with a diagnosis instead of starting work that
cannot run (or hanging in a CUDA call). ``doctor_report`` is an
environment snapshot: versions, devices, one tiny dispatch, and the kernel
build directory, which is the port's counterpart of the JAX package's
persistent compilation cache (``utils/cache.py``): ``kernels/build.py``
keeps every nvcc-built library there, named by a hash of its sources, and
reuses it in later processes.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

_SNIPPET = "import torch\nprint(torch.cuda.get_device_name(0))\n"


def probe_backend(timeout_s: int = 300, tries: int = 3) -> tuple[bool, str]:
    """Returns (reachable, detail). ``detail`` is the card's name on
    success, the failure reason otherwise. Each try runs
    ``torch.cuda.get_device_name(0)`` in a fresh subprocess bounded by
    ``timeout_s``."""
    last = "no attempts"
    for i in range(tries):
        try:
            r = subprocess.run([sys.executable, "-c", _SNIPPET], timeout=timeout_s,
                               capture_output=True, text=True)
            if r.returncode == 0:
                return True, r.stdout.strip().splitlines()[-1]
            tail = (r.stderr or "").strip().splitlines()[-1:] or ["no output"]
            last = f"probe {i + 1}/{tries} exited {r.returncode}: {tail[0]}"
        except subprocess.TimeoutExpired:
            last = f"probe {i + 1}/{tries} timed out after {timeout_s}s"
        print(f"health: {last}", file=sys.stderr, flush=True)
    return False, last


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def doctor_report(probe_timeout_s: int = 300) -> dict:
    """Environment and backend health snapshot."""
    import torch

    from runet_tpu_torch.kernels.build import BUILD_DIR

    report: dict = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "env": {k: os.environ[k] for k in ("CUDA_VISIBLE_DEVICES", "CUDA_HOME")
                if k in os.environ},
    }
    ok, detail = probe_backend(timeout_s=probe_timeout_s, tries=1)
    report["backend_reachable"] = ok
    report["backend_detail"] = detail
    if ok:
        # Safe to ask in-process now; one tiny dispatch so "reachable" means
        # "runs programs", not only "answers a query".
        report["devices"] = [torch.cuda.get_device_name(i)
                             for i in range(torch.cuda.device_count())]
        t0 = time.monotonic()
        y = torch.ones((8, 128), device="cuda") * 2 + 1
        float(y[0, 0])
        report["tiny_dispatch_s"] = round(time.monotonic() - t0, 3)
    report["kernel_build"] = {
        "dir": str(BUILD_DIR),
        "entries": len(list(BUILD_DIR.glob("*.so"))) if BUILD_DIR.is_dir() else 0,
    }
    return report
