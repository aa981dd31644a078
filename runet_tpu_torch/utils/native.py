"""ctypes loader for the port's native host tier, ``native/cc3d.cpp``.

Counterpart of ``runet_tpu/utils/native.py`` with the same public functions
and the same contract: a function that cannot reach the library returns
``None`` (or ``False``), and its caller takes the scipy/numpy path.

The source is compiled at first use with
``g++ -O3 -march=native -shared -fPIC -std=c++17`` into
``runet_tpu_torch/build/libcc3d-<hash>.so`` (a directory that .gitignore
lists). The hash covers the source, the flags and the host CPU, since
``-march=native`` code must run on the machine that built it; a stale or
foreign library is never loaded. Nothing is built at import.

``available()`` builds and loads the library and says whether that worked
(``build_error()`` holds the compiler's output when it did not).
``call_counts()`` counts, per entry point, the calls that reached the
library; ``reset_call_counts()`` sets them to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "cc3d.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
SYMBOLS = ("label_components_3d", "keep_largest_components_3d", "zero_nonkept_3d",
           "keep_largest_in_boxes_3d", "paste_nibbles_3d", "paste_crumbs_3d",
           "component_stats_3d")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i64, _i32 = ctypes.c_int64, ctypes.c_int32
_PASTE = ([_u8p, _i64, _i64, _u8p, _i64, _i64] + [_i64] * 6, None)
_SIGNATURES = {
    "label_components_3d": ([_u8p, _i32p, _i64, _i64, _i64], ctypes.c_int32),
    "keep_largest_components_3d": ([_u8p, _i32p, _i64, _i32, _i32, _i64], None),
    "zero_nonkept_3d": ([_u8p, _i32p, _i64, _u8p], None),
    "keep_largest_in_boxes_3d": ([_u8p, _i64, _i64, _i64, _i64p, _i32, _i32, _i64], _i64),
    "paste_nibbles_3d": _PASTE,
    "paste_crumbs_3d": _PASTE,
    "component_stats_3d": ([_i32p, _i64, _i64, _i64, _i32, _i64p, _i64p], None),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None
_count_lock = threading.Lock()
_calls = dict.fromkeys(SYMBOLS, 0)


def _host_cpu() -> bytes:
    """What ``-march=native`` resolves from: the machine and its CPU's model
    and feature flags (first processor of /proc/cpuinfo where there is one)."""
    ident = platform.machine() + platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    ident += line
                elif not line.strip():
                    break
    except OSError:
        pass
    return ident.encode()


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_host_cpu())
    return BUILD_DIR / f"libcc3d-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def _load() -> ctypes.CDLL | None:
    """The loaded library, built on first use; None when it cannot be built
    or loaded (the reason stays in ``build_error()``, and no retry is made)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _build_error = str(e)
            return None
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
        return _lib


def available() -> bool:
    """Build and load the library if not done yet; whether it is usable."""
    return _load() is not None


def build_error() -> str | None:
    """The compiler's or loader's message when the library could not be
    built or loaded, else None."""
    return _build_error


def call_counts() -> dict[str, int]:
    with _count_lock:
        return dict(_calls)


def reset_call_counts() -> None:
    with _count_lock:
        for k in _calls:
            _calls[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        _calls[name] += 1


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _require(ok: bool, what: str) -> None:
    """The layout the C code indexes by; checked before any pointer is
    passed (a wrong one would read or write out of bounds)."""
    if not ok:
        raise ValueError(f"native host tier: {what}")


def _c_array(a: np.ndarray, dtype, name: str) -> None:
    _require(a.dtype == dtype and a.flags.c_contiguous,
             f"{name} must be a C-contiguous {np.dtype(dtype)} array, got {a.dtype} "
             f"(C-contiguous: {a.flags.c_contiguous})")


def native_keep_largest(seg: np.ndarray, labels: np.ndarray, n_labels: int, keep_k: int,
                        min_voxels: int = 0) -> bool:
    """In-place zero of non-top-k components. Returns False if unavailable."""
    lib = _load()
    if lib is None:
        return False
    _c_array(seg, np.uint8, "seg")
    _c_array(labels, np.int32, "labels")
    _require(labels.shape == seg.shape, "labels and seg differ in shape")
    _require(labels.size == 0 or int(labels.max()) <= n_labels, "a label exceeds n_labels")
    _count("keep_largest_components_3d")
    lib.keep_largest_components_3d(_ptr(seg, ctypes.c_uint8), _ptr(labels, ctypes.c_int32),
                                   seg.size, n_labels, keep_k, min_voxels)
    return True


def native_label_components(mask: np.ndarray) -> tuple[np.ndarray, int] | None:
    """6-connected labeling via C++ union-find; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    _c_array(mask, np.uint8, "mask")
    _require(mask.ndim == 3, "mask must be 3-D")
    out = np.empty(mask.shape, np.int32)
    _count("label_components_3d")
    n = lib.label_components_3d(_ptr(mask, ctypes.c_uint8), _ptr(out, ctypes.c_int32),
                                *mask.shape)
    if n < 0:
        return None
    return out, int(n)


def native_zero_nonkept(seg: np.ndarray, labels: np.ndarray, keep_lut: np.ndarray) -> bool:
    """In-place zero of voxels whose component id is unmarked in ``keep_lut``
    (uint8, length n_labels+1, index 0 ignored). False if unavailable."""
    lib = _load()
    if lib is None:
        return False
    _c_array(seg, np.uint8, "seg")
    _c_array(labels, np.int32, "labels")
    _c_array(keep_lut, np.uint8, "keep_lut")
    _require(labels.shape == seg.shape, "labels and seg differ in shape")
    _require(labels.size == 0 or int(labels.max()) < keep_lut.size,
             "keep_lut is shorter than the largest label + 1")
    _count("zero_nonkept_3d")
    lib.zero_nonkept_3d(_ptr(seg, ctypes.c_uint8), _ptr(labels, ctypes.c_int32), seg.size,
                        _ptr(keep_lut, ctypes.c_uint8))
    return True


def native_keep_largest_in_boxes(seg: np.ndarray, boxes: np.ndarray, keep_k: int,
                                 min_voxels: int = 0) -> bool:
    """Fused in-place box-scoped keep-largest on a uint8 canvas: run-based CC
    per (disjoint) box, global size ranking across boxes, kill non-kept runs.
    ``boxes``: int64 (B, 6) rows of (x0, y0, z0, x1, y1, z1) exclusive,
    pre-clamped to the canvas. False if unavailable."""
    lib = _load()
    if lib is None:
        return False
    _c_array(seg, np.uint8, "seg")
    _require(seg.ndim == 3, "seg must be 3-D")
    boxes = np.ascontiguousarray(boxes, np.int64)
    _require(boxes.ndim == 2 and boxes.shape[1] == 6, "boxes must be (B, 6)")
    _require(bool((boxes[:, :3] >= 0).all() and (boxes[:, 3:] <= seg.shape).all()),
             "boxes must lie within the canvas")
    _count("keep_largest_in_boxes_3d")
    lib.keep_largest_in_boxes_3d(_ptr(seg, ctypes.c_uint8), *seg.shape,
                                 _ptr(boxes, ctypes.c_int64), boxes.shape[0], keep_k,
                                 min_voxels)
    return True


def _paste(name: str, per_byte: int, canvas: np.ndarray, packed: np.ndarray, lo, extent) -> bool:
    lib = _load()
    if lib is None:
        return False
    _c_array(canvas, np.uint8, "canvas")
    # A batched group's sample (``host[bidx]``) may be a strided view;
    # normalizing the small packed crop is cheap (no copy when contiguous).
    packed = np.ascontiguousarray(packed, np.uint8)
    _require(packed.ndim == 3 and canvas.ndim == 3, "canvas and packed must be 3-D")
    ex, ey, ez = (int(e) for e in extent)
    lo = [int(v) for v in lo]
    _require(ex <= packed.shape[0] and ey <= packed.shape[1]
             and -(-ez // per_byte) <= packed.shape[2], "extent exceeds the packed crop")
    _require(min(lo) >= 0 and all(l + e <= n for l, e, n in zip(lo, (ex, ey, ez), canvas.shape)),
             "the pasted region exceeds the canvas")
    _count(name)
    getattr(lib, name)(_ptr(canvas, ctypes.c_uint8), canvas.shape[1], canvas.shape[2],
                       _ptr(packed, ctypes.c_uint8), packed.shape[1], packed.shape[2],
                       *lo, ex, ey, ez)
    return True


def native_paste_nibbles(canvas: np.ndarray, packed: np.ndarray, lo, extent) -> bool:
    """Fused in-place nibble-unpack + nonzero paste: the (extent) prefix of
    the nibble-packed crop lands at ``canvas[lo : lo+extent]``; nonzero
    nibbles overwrite, zeros keep the destination. False if unavailable."""
    return _paste("paste_nibbles_3d", 2, canvas, packed, lo, extent)


def native_paste_crumbs(canvas: np.ndarray, packed: np.ndarray, lo, extent) -> bool:
    """2-bit sibling of ``native_paste_nibbles`` (``pack_crumbs`` encoding,
    4 voxels/byte LSB-first). False if unavailable."""
    return _paste("paste_crumbs_3d", 4, canvas, packed, lo, extent)


def native_component_stats(labels: np.ndarray,
                           n_labels: int) -> tuple[np.ndarray, np.ndarray] | None:
    """One-pass per-component (sizes int64[n], boxes int64[n,6] as
    x0,y0,z0,x1,y1,z1 exclusive); None if unavailable."""
    if n_labels <= 0:
        return None
    lib = _load()
    if lib is None:
        return None
    _c_array(labels, np.int32, "labels")
    _require(labels.ndim == 3, "labels must be 3-D")
    _require(labels.size == 0 or int(labels.max()) <= n_labels,
             "a label exceeds n_labels")
    sizes = np.empty(n_labels, np.int64)
    boxes = np.empty((n_labels, 6), np.int64)
    _count("component_stats_3d")
    lib.component_stats_3d(_ptr(labels, ctypes.c_int32), *labels.shape, n_labels,
                           _ptr(sizes, ctypes.c_int64), _ptr(boxes, ctypes.c_int64))
    return sizes, boxes
