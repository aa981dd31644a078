"""Minimal self-contained NIfTI-1 reader/writer (no nibabel/SimpleITK); a
copy of ``runet_tpu/io/nifti.py`` (numpy only) so the port imports nothing
of the JAX package.

Covers the subset of NIfTI-1 the KiTS19 layout needs: ``.nii`` /
``.nii.gz`` single-file volumes, voxel spacing, and the sform/qform affine.
Data is returned in (x, y, z) index order (NIfTI arrays are stored
Fortran-ordered, fastest-varying axis first).
"""

from __future__ import annotations

import dataclasses
import gzip
import struct
from pathlib import Path

import numpy as np

HEADER_SIZE = 348
MAGIC_SINGLE = b"n+1\x00"

# NIfTI-1 datatype codes <-> numpy dtypes.
_DTYPE_FROM_CODE = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
}
_CODE_FROM_DTYPE = {np.dtype(v): k for k, v in _DTYPE_FROM_CODE.items()}


@dataclasses.dataclass
class Volume:
    """A loaded medical volume.

    data: (X, Y, Z) array, raw values after scl_slope/scl_inter scaling.
    spacing: per-axis voxel size in mm, aligned with data axes.
    affine: 4x4 voxel-index -> world (RAS mm) transform.
    """

    data: np.ndarray
    spacing: tuple[float, float, float]
    affine: np.ndarray

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape)


def _quaternion_affine(hdr: dict) -> np.ndarray:
    """Build the qform rotation affine from quaternion parameters."""
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    qfac = -1.0 if hdr["pixdim"][0] < 0 else 1.0
    spacing = np.array(hdr["pixdim"][1:4])
    spacing[2] *= qfac
    aff = np.eye(4)
    aff[:3, :3] = R * spacing[None, :]
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def _parse_header(raw: bytes) -> dict:
    if len(raw) < HEADER_SIZE:
        raise ValueError(f"truncated NIfTI header: {len(raw)} bytes")
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    endian = "<"
    if sizeof_hdr != 348:
        (sizeof_hdr_be,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr_be == 348:
            endian = ">"
        else:
            raise ValueError(f"not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    hdr = {}
    hdr["endian"] = endian
    hdr["dim"] = struct.unpack_from(endian + "8h", raw, 40)
    hdr["datatype"] = struct.unpack_from(endian + "h", raw, 70)[0]
    hdr["bitpix"] = struct.unpack_from(endian + "h", raw, 72)[0]
    hdr["pixdim"] = struct.unpack_from(endian + "8f", raw, 76)
    hdr["vox_offset"] = struct.unpack_from(endian + "f", raw, 108)[0]
    hdr["scl_slope"] = struct.unpack_from(endian + "f", raw, 112)[0]
    hdr["scl_inter"] = struct.unpack_from(endian + "f", raw, 116)[0]
    hdr["qform_code"] = struct.unpack_from(endian + "h", raw, 252)[0]
    hdr["sform_code"] = struct.unpack_from(endian + "h", raw, 254)[0]
    hdr["quatern_b"] = struct.unpack_from(endian + "f", raw, 256)[0]
    hdr["quatern_c"] = struct.unpack_from(endian + "f", raw, 260)[0]
    hdr["quatern_d"] = struct.unpack_from(endian + "f", raw, 264)[0]
    hdr["qoffset_x"] = struct.unpack_from(endian + "f", raw, 268)[0]
    hdr["qoffset_y"] = struct.unpack_from(endian + "f", raw, 272)[0]
    hdr["qoffset_z"] = struct.unpack_from(endian + "f", raw, 276)[0]
    hdr["srow_x"] = struct.unpack_from(endian + "4f", raw, 280)
    hdr["srow_y"] = struct.unpack_from(endian + "4f", raw, 296)
    hdr["srow_z"] = struct.unpack_from(endian + "4f", raw, 312)
    hdr["magic"] = raw[344:348]
    return hdr


def _read_bytes(path: Path) -> bytes:
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    return path.read_bytes()


def load_volume(path: str | Path) -> Volume:
    """Load a .nii / .nii.gz file into a Volume."""
    path = Path(path)
    return volume_from_bytes(_read_bytes(path))


def volume_from_bytes(raw: bytes) -> Volume:
    """Parse NIfTI-1 bytes (gzipped or plain — sniffed by magic) into a
    Volume (the in-memory path: volumes that arrive as request bodies)."""
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    hdr = _parse_header(raw)

    ndim = hdr["dim"][0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"bad ndim {ndim}")
    shape = tuple(hdr["dim"][1 : 1 + ndim])
    # Drop trailing singleton dims (common 4D-with-1-volume files).
    while len(shape) > 3 and shape[-1] == 1:
        shape = shape[:-1]
    if len(shape) != 3:
        raise ValueError(f"expected 3D volume, got shape {shape}")

    code = hdr["datatype"]
    if code not in _DTYPE_FROM_CODE:
        raise ValueError(f"unsupported NIfTI datatype code {code}")
    dtype = np.dtype(_DTYPE_FROM_CODE[code]).newbyteorder(hdr["endian"])

    offset = int(hdr["vox_offset"]) if hdr["vox_offset"] >= HEADER_SIZE else HEADER_SIZE
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
    # NIfTI voxel data is Fortran-ordered: x fastest.
    data = data.reshape(shape, order="F")
    data = np.asarray(data, dtype=data.dtype.newbyteorder("="))

    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    # Non-finite slope/inter appear in malformed-but-readable headers;
    # nibabel semantics: treat as no scaling.
    if not np.isfinite(slope):
        slope = 1.0
    if not np.isfinite(inter):
        inter = 0.0
    if slope == 0.0:
        # NIfTI convention (and nibabel semantics): slope 0 means "no
        # scaling stored" — the intercept is ignored too, not applied alone.
        slope, inter = 1.0, 0.0
    if slope != 1.0 or inter != 0.0:
        data = data.astype(np.float32) * slope + inter

    if hdr["sform_code"] > 0:
        affine = np.eye(4)
        affine[0, :] = hdr["srow_x"]
        affine[1, :] = hdr["srow_y"]
        affine[2, :] = hdr["srow_z"]
    elif hdr["qform_code"] > 0:
        affine = _quaternion_affine(hdr)
    else:
        affine = np.diag([hdr["pixdim"][1], hdr["pixdim"][2], hdr["pixdim"][3], 1.0])

    spacing = tuple(float(abs(p)) for p in hdr["pixdim"][1:4])
    return Volume(data=data, spacing=spacing, affine=affine)


def save_volume(
    path: str | Path,
    data: np.ndarray,
    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0),
    affine: np.ndarray | None = None,
) -> None:
    """Write a 3D array as a single-file NIfTI-1 (.nii or .nii.gz)."""
    path = Path(path)
    payload = volume_to_bytes(
        data, spacing=spacing, affine=affine, gz=str(path).endswith(".gz")
    )
    path.write_bytes(payload)


def volume_to_bytes(
    data: np.ndarray,
    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0),
    affine: np.ndarray | None = None,
    gz: bool = True,
) -> bytes:
    """Serialize a 3D array as single-file NIfTI-1 bytes (optionally
    gzipped); the in-memory dual of ``volume_from_bytes``."""
    data = np.asarray(data)
    if data.ndim != 3:
        raise ValueError(f"expected 3D array, got {data.shape}")
    dt = np.dtype(data.dtype)
    if dt == np.dtype(np.float64):
        data, dt = data.astype(np.float32), np.dtype(np.float32)
    if dt == np.dtype(bool):
        data, dt = data.astype(np.uint8), np.dtype(np.uint8)
    if dt not in _CODE_FROM_DTYPE:
        raise ValueError(f"unsupported dtype {dt}")
    code = _CODE_FROM_DTYPE[dt]

    if affine is None:
        affine = np.diag([spacing[0], spacing[1], spacing[2], 1.0])

    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [3, data.shape[0], data.shape[1], data.shape[2], 1, 1, 1, 1]
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, dt.itemsize * 8)
    pixdim = [1.0, spacing[0], spacing[1], spacing[2], 0.0, 0.0, 0.0, 0.0]
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code = SCANNER_ANAT
    struct.pack_into("<4f", hdr, 280, *affine[0, :])
    struct.pack_into("<4f", hdr, 296, *affine[1, :])
    struct.pack_into("<4f", hdr, 312, *affine[2, :])
    hdr[344:348] = MAGIC_SINGLE

    payload = bytes(hdr) + b"\x00" * 4 + np.asarray(data, order="F").tobytes(order="F")
    if gz:
        payload = gzip.compress(payload, compresslevel=1)
    return payload
