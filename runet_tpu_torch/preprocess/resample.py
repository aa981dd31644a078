"""Separable trilinear resampling as dense interpolation-matrix products.

Counterpart of ``runet_tpu/preprocess/resample.py`` (the runtime-scale
functions the cascade uses). Output index j on axis a samples input
coordinate ``j * scale[a]`` in f32 (corner-aligned, spacing-ratio scale),
clamped to the valid range — edge mode "nearest". Each 1-D pass is one
(out, in) x (in, rest) matrix product with at most two nonzeros per row.
"""

from __future__ import annotations

import torch


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


def _interp_matrix_traced(in_size: int, out_size: int, scale, method: str,
                          device=None) -> torch.Tensor:
    """(out_size, in_size) f32 interpolation matrix for one axis.

    Positions are f32 ``arange(out) * scale`` clamped to [0, in_size-1]. At
    the clamp edge i0 == i1 and the two weights land on the same column,
    summing to 1."""
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
