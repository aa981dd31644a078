"""Separable trilinear resampling as dense interpolation-matrix products.

Counterpart of ``runet_tpu/preprocess/resample.py``: the static-scale
functions the dataset uses (matrices built on the host in f64 positions)
and the runtime-scale ones the cascade uses (positions in f32 on the
device). Output index j on axis a samples input coordinate ``j * scale[a]``
(corner-aligned, spacing-ratio scale), clamped to the valid range — edge
mode "nearest". Each 1-D pass is one (out, in) x (in, rest) matrix product
with at most two nonzeros per row.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from runet_tpu_torch.utils.timing import span


def output_shape_for_spacing(
    in_shape: tuple[int, ...],
    src_spacing: tuple[float, ...],
    dst_spacing: tuple[float, ...],
) -> tuple[int, ...]:
    """Physical-extent-preserving output shape: round(n * src/dst), min 1."""
    return tuple(
        max(1, int(round(n * s / d)))
        for n, s, d in zip(in_shape, src_spacing, dst_spacing)
    )


def matrix_from_positions(pos: np.ndarray, in_size: int, method: str) -> np.ndarray:
    """(len(pos), in_size) f32 interpolation matrix, at most two nonzeros
    per row, for input-coordinate sample positions ``pos`` already clamped
    to [0, in_size-1]. The shared builder of the static resampling below and
    of the zoom bank in ``data/augment.py``."""
    out_size = len(pos)
    W = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    if method == "linear":
        i0 = np.clip(np.floor(pos).astype(np.int64), 0, in_size - 1)
        i1 = np.minimum(i0 + 1, in_size - 1)
        w = (pos - i0).astype(np.float32)
        # i0 may equal i1 at the clamp edge: accumulate, don't overwrite.
        np.add.at(W, (rows, i0), 1.0 - w)
        np.add.at(W, (rows, i1), w)
    else:  # nearest: floor(x + 0.5) matches scipy order=0 tie-breaking
        idx = np.clip(np.floor(pos + 0.5).astype(np.int64), 0, in_size - 1)
        W[rows, idx] = 1.0
    return W


@lru_cache(maxsize=256)
def _interp_matrix(in_size: int, out_size: int, scale: float, method: str) -> np.ndarray:
    """Static-scale (out_size, in_size) matrix: positions j·scale in f64,
    clamped to the valid range."""
    pos = np.clip(np.arange(out_size, dtype=np.float64) * float(scale), 0.0, float(in_size - 1))
    return matrix_from_positions(pos, in_size, method)


def resample(x: torch.Tensor, out_shape: tuple[int, int, int], scale: tuple[float, float, float],
             method: str = "linear") -> torch.Tensor:
    """Resample a 3-D volume with a static scale: out[j] = x[clamp(j·scale)]
    per axis (``scale[a]`` = dst/src spacing). Axes whose size and scale
    leave them unchanged are skipped; a "nearest" resample of an integer
    volume keeps its dtype."""
    if x.dim() != 3:
        raise ValueError(f"expected 3D, got {tuple(x.shape)}")
    orig_dtype = x.dtype
    for axis in range(3):
        if x.shape[axis] != out_shape[axis] or scale[axis] != 1.0:
            W = torch.from_numpy(_interp_matrix(x.shape[axis], out_shape[axis],
                                                float(scale[axis]), method)).to(x.device)
            x = _apply_axis(x.float(), axis, W)
    if method == "nearest" and not orig_dtype.is_floating_point:
        x = torch.round(x).to(orig_dtype)
    return x


def resample_to_shape(x: torch.Tensor, out_shape: tuple[int, int, int], src_spacing,
                      dst_spacing, method: str = "linear") -> torch.Tensor:
    """Resample into an exact ``out_shape`` (e.g. back to the native grid)
    with the spacing ratio dst/src as the scale, on ``x``'s device."""
    scale = tuple(d / s for s, d in zip(src_spacing, dst_spacing))
    return resample(x, tuple(out_shape), scale, method)


def resample_to_spacing(x: torch.Tensor, src_spacing, dst_spacing,
                        method: str = "linear") -> torch.Tensor:
    out_shape = output_shape_for_spacing(tuple(x.shape), src_spacing, dst_spacing)
    return resample_to_shape(x, out_shape, src_spacing, dst_spacing, method)


def resample_labels_onehot(labels: torch.Tensor, out_shape: tuple[int, int, int],
                           scale: tuple[float, float, float], num_classes: int) -> torch.Tensor:
    """One-hot → trilinear → argmax label resampling with a static scale
    (the host-built f64-position matrices of ``resample``): smoother label
    boundaries than nearest, still integer output. Runs in bf16 as the JAX
    package does (bf16 weights and one-hot values, f32 accumulation, the
    result re-rounded to bf16 after each axis); axes whose size and scale
    leave them unchanged are skipped; argmax takes the FIRST maximum."""
    out = torch.nn.functional.one_hot(labels.long(), num_classes).to(torch.bfloat16)
    for axis in range(3):
        if out.shape[axis] != out_shape[axis] or scale[axis] != 1.0:
            W = torch.from_numpy(_interp_matrix(out.shape[axis], out_shape[axis],
                                                float(scale[axis]), "linear"))
            W = W.to(labels.device).to(torch.bfloat16)
            out = _apply_axis(out.float(), axis, W.float()).to(torch.bfloat16)
    return torch.argmax(out, dim=-1).to(labels.dtype)


def numpy_reference_resample(x: np.ndarray, out_shape: tuple[int, int, int],
                             scale: tuple[float, float, float], order: int = 1) -> np.ndarray:
    """scipy golden oracle with the same coordinate convention (tests only)."""
    from scipy.ndimage import map_coordinates

    grids = [np.clip(np.arange(out_shape[a]) * scale[a], 0, x.shape[a] - 1) for a in range(3)]
    coords = np.meshgrid(*grids, indexing="ij")
    return map_coordinates(x.astype(np.float32), coords, order=order, mode="nearest")


def _interp_matrix_traced(in_size: int, out_size: int, scale, method: str,
                          device=None) -> torch.Tensor:
    """(out_size, in_size) f32 interpolation matrix for one axis.

    Positions are f32 ``arange(out) * scale`` clamped to [0, in_size-1]. At
    the clamp edge i0 == i1 and the two weights land on the same column,
    summing to 1. A host ``scale`` goes to a CUDA ``device`` by a pageable
    copy, which waits for the device's queue (the ``wait.upload`` span)."""
    with span("wait.upload"):
        s = torch.as_tensor(scale, dtype=torch.float32, device=device)
    pos = torch.clamp(torch.arange(out_size, dtype=torch.float32, device=device) * s,
                      0.0, float(in_size - 1))
    cols = torch.arange(in_size, dtype=torch.int64, device=device)[None, :]
    if method == "linear":
        i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, in_size - 1)
        i1 = torch.clamp_max(i0 + 1, in_size - 1)
        w = pos - i0.to(torch.float32)
        W = (cols == i0[:, None]) * (1.0 - w)[:, None] + (cols == i1[:, None]) * w[:, None]
    else:  # nearest: floor(x + 0.5), scipy order=0 tie-breaking
        idx = torch.clamp(torch.floor(pos + 0.5).to(torch.int64), 0, in_size - 1)
        W = (cols == idx[:, None])
    return W.to(torch.float32)


def _apply_axis(x: torch.Tensor, axis: int, W: torch.Tensor) -> torch.Tensor:
    n = x.shape[axis]
    moved = torch.movedim(x, axis, 0).reshape(n, -1)
    out = W @ moved
    new_shape = (W.shape[0],) + tuple(s for a, s in enumerate(x.shape) if a != axis)
    return torch.movedim(out.reshape(new_shape), 0, axis)


def resample_dynamic(x: torch.Tensor, out_shape: tuple[int, int, int], scale,
                     method: str = "linear") -> torch.Tensor:
    """Resample a 3-D volume to ``out_shape`` (f32 result); ``scale`` is the
    per-axis dst/src spacing ratio (3,). Every axis is resampled, an
    identity axis included."""
    if x.dim() != 3:
        raise ValueError(f"expected 3D, got {tuple(x.shape)}")
    scale = torch.as_tensor(scale, dtype=torch.float32)
    x = x.float()
    for axis in range(3):
        W = _interp_matrix_traced(x.shape[axis], out_shape[axis], scale[axis], method, x.device)
        x = _apply_axis(x, axis, W)
    return x


def resample_labels_onehot_dynamic(labels: torch.Tensor, out_shape: tuple[int, int, int],
                                   scale, num_classes: int) -> torch.Tensor:
    """One-hot → trilinear → argmax label resampling.

    Runs in bf16 as the JAX package does: bf16 weights and one-hot values,
    f32 accumulation, the result re-rounded to bf16 after each axis. Ties
    are common, and argmax takes the FIRST maximum."""
    scale = torch.as_tensor(scale, dtype=torch.float32)
    out = torch.nn.functional.one_hot(labels.long(), num_classes).to(torch.bfloat16)
    for axis in range(3):
        W = _interp_matrix_traced(out.shape[axis], out_shape[axis], scale[axis], "linear",
                                  labels.device).to(torch.bfloat16)
        # bf16 x bf16 products are exact in f32: an f32 product of the
        # bf16 values is the f32-accumulated bf16 product.
        out = _apply_axis(out.float(), axis, W.float()).to(torch.bfloat16)
    return torch.argmax(out, dim=-1).to(labels.dtype)
