"""Build the CUDA sources under ``csrc/`` into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for ``sm_90a``
into ``runet_tpu_torch/build/lib<name>-<hash>.so`` (a directory that
.gitignore lists) and loaded with ``ctypes``. The hash covers the source and
every header in ``csrc/``, so an edited source is rebuilt and a stale library
is never loaded. The sources expose a plain C interface: no PyTorch headers,
so one build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp path, target), or
    None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name} (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build(names) -> dict[str, str]:
    """Compile every named source in parallel (one ``nvcc`` each, all started
    together). Returns the compiler's output per source built now, which
    holds ``ptxas`` register and shared-memory figures."""
    with _lock:
        jobs = {n: _start_build(n) for n in names}
        return {n: _finish_build(j) for n, j in jobs.items() if j is not None}


def load(name: str, api: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed,
    with the C signatures of ``api`` bound on first load: {function suffix:
    (argtypes, restype)} for each ``<name>_<suffix>`` (every pointer and
    the stream a ``c_void_p``, or ctypes cuts them to 32 bits)."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                for suffix, (argtypes, restype) in api.items():
                    fn = getattr(lib, f"{name}_{suffix}")
                    fn.argtypes, fn.restype = argtypes, restype
                _libs[name] = lib
    return lib
