"""Device-side label packing for small fetches, host-side unpacking.

Counterpart of ``runet_tpu/infer/packing.py``. All pack along the LAST axis
(Z, contiguous on both ends):

- ``pack_nibbles`` / ``unpack_nibbles``: labels < 16 → 2 voxels/byte
- ``pack_crumbs`` / ``unpack_crumbs``: labels < 4 → 4 voxels/byte
- ``pack_bits`` / ``unpack_bits``: binary mask → 8 voxels/byte

``pack_width(num_classes)`` picks the widest lossless packing for a label
alphabet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _pad_last(t: torch.Tensor, to: int) -> torch.Tensor:
    z = t.shape[-1]
    return F.pad(t, (0, to - z)) if to > z else t


def packed_nibble_len(n: int) -> int:
    return -(-n // 2)


def pack_nibbles(labels: torch.Tensor) -> torch.Tensor:
    """uint8 (..., Z) with values < 16 → uint8 (..., ceil(Z/2)); low
    nibble = even z. Odd Z is zero-padded."""
    l = _pad_last(labels.to(torch.uint8), packed_nibble_len(labels.shape[-1]) * 2)
    return l[..., 0::2] | (l[..., 1::2] << 4)


def unpack_nibbles(packed: np.ndarray, n: int) -> np.ndarray:
    """Host inverse of ``pack_nibbles``: uint8 (..., ceil(n/2)) → (..., n)."""
    packed = np.asarray(packed)
    out = np.empty(packed.shape[:-1] + (packed.shape[-1] * 2,), np.uint8)
    out[..., 0::2] = packed & 0x0F
    out[..., 1::2] = packed >> 4
    return out[..., :n]


def packed_crumb_len(n: int) -> int:
    return -(-n // 4)


def pack_crumbs(labels: torch.Tensor) -> torch.Tensor:
    """uint8 (..., Z) with values < 4 → uint8 (..., ceil(Z/4)), LSB-first."""
    l = _pad_last(labels.to(torch.uint8), packed_crumb_len(labels.shape[-1]) * 4)
    return l[..., 0::4] | (l[..., 1::4] << 2) | (l[..., 2::4] << 4) | (l[..., 3::4] << 6)


def unpack_crumbs(packed: np.ndarray, n: int) -> np.ndarray:
    """Host inverse of ``pack_crumbs``: uint8 (..., ceil(n/4)) → (..., n)."""
    packed = np.asarray(packed)
    out = np.empty(packed.shape[:-1] + (packed.shape[-1] * 4,), np.uint8)
    out[..., 0::4] = packed & 0x03
    out[..., 1::4] = (packed >> 2) & 0x03
    out[..., 2::4] = (packed >> 4) & 0x03
    out[..., 3::4] = packed >> 6
    return out[..., :n]


def pack_width(num_classes: int) -> int:
    """Lossless bits per voxel for ``num_classes`` labels: 2 (K ≤ 4),
    4 (K ≤ 16) or 8 (no packing)."""
    if num_classes <= 4:
        return 2
    if num_classes <= 16:
        return 4
    return 8


def packed_bit_len(n: int) -> int:
    return -(-n // 8)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool/uint8 (..., Z) → uint8 (..., ceil(Z/8)), LSB-first per byte."""
    m = _pad_last(mask.to(torch.uint8), packed_bit_len(mask.shape[-1]) * 8)
    m = m.reshape(m.shape[:-1] + (-1, 8))
    out = m[..., 0]
    for i in range(1, 8):
        out = out | (m[..., i] << i)
    return out


def unpack_bits(packed: np.ndarray, n: int) -> np.ndarray:
    """Host inverse of ``pack_bits`` → uint8 0/1 (..., n)."""
    bits = np.unpackbits(np.asarray(packed), axis=-1, bitorder="little")
    return bits[..., :n]
