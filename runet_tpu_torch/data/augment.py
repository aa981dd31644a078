"""Per-sample training augmentation on the device: flip, rot90, zoom,
optional elastic deformation and intensity jitter, in the JAX package's
order (``runet_tpu/data/augment.py::augment_one``).

Each transform is split in two halves: ``draw_params`` takes the random
choices from a host ``torch.Generator`` (and the noise field from a device
one), and the ``apply_*`` functions apply given choices, so tests can hold
the apply halves against JAX with fixed parameters. ``torch.Generator`` and
``jax.random`` give different numbers from the same seed; the draws are held
to the same distributions instead.

Layout: an image is (X, Y, Z, C) float, a label map (X, Y, Z) int; a batch
adds a leading B. Elastic deformation (``TrainConfig.elastic``, off in every
preset) is a coarse normal displacement field upsampled by interpolation
matrices, one trilinear warp of the image and a rounded-coordinate nearest
warp of the labels, coordinates clamped to the volume.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from runet_tpu_torch.preprocess.resample import matrix_from_positions
from runet_tpu_torch.utils.timing import count

# Isotropic zoom factors; 1.0 keeps the identity in distribution. A factor
# above 1 samples a wider input extent (content shrinks, edge-clamped).
ZOOM_FACTORS = (0.85, 0.90, 0.95, 1.0, 1.05, 1.10, 1.15)
# Elastic deformation: control points per axis and the amplitude range in
# voxels (from 0, so the identity stays in distribution).
ELASTIC_GRID = 4
ELASTIC_ALPHA = (0.0, 8.0)


@dataclasses.dataclass(frozen=True)
class AugmentParams:
    flips: tuple[bool, bool, bool]
    rot90: int  # quarter turns in the (X, Y) plane; 0 unless X == Y
    zoom: int  # index into ZOOM_FACTORS
    scale: float
    shift: float
    # (3, g, g, g) unit-normal control field and its amplitude in voxels;
    # None when elastic deformation is off.
    elastic_field: torch.Tensor | None = None
    elastic_amp: float = 0.0


@lru_cache(maxsize=64)
def zoom_matrix_bank(n: int, factors: tuple[float, ...] = ZOOM_FACTORS):
    """Stacked (K, n, n) center-aligned interpolation matrices (linear,
    nearest): row j of matrix k samples c + (j - c)·factor[k], c = (n-1)/2,
    clamped to [0, n-1]."""
    c = (n - 1) / 2.0
    rows = np.arange(n)
    lin, nst = [], []
    for f in factors:
        pos = np.clip(c + (rows - c) * float(f), 0.0, float(n - 1))
        lin.append(matrix_from_positions(pos, n, "linear"))
        nst.append(matrix_from_positions(pos, n, "nearest"))
    return np.stack(lin), np.stack(nst)


def _zoom_axis(x: torch.Tensor, axis: int, W: torch.Tensor) -> torch.Tensor:
    """out[..., j, ...] = Σ_i W[j, i]·x[..., i, ...] in f32."""
    n = x.shape[axis]
    moved = torch.movedim(x, axis, 0).reshape(n, -1).float()
    out = W @ moved
    new_shape = (W.shape[0],) + tuple(s for a, s in enumerate(x.shape) if a != axis)
    return torch.movedim(out.reshape(new_shape), 0, axis)


def apply_flip(img, lab, flips):
    for axis, do in enumerate(flips):
        if do:
            img, lab = torch.flip(img, (axis,)), torch.flip(lab, (axis,))
    return img, lab


def apply_rot90(img, lab, k: int):
    if k % 4 == 0:
        return img, lab
    if img.shape[0] != img.shape[1]:
        raise ValueError("rot90 needs a square (X, Y) plane")
    return torch.rot90(img, k, (0, 1)), torch.rot90(lab, k, (0, 1))


def apply_zoom(img, lab, index: int, factors=ZOOM_FACTORS):
    """Trilinear zoom of the image, nearest of the labels, by
    ``factors[index]`` about the center of each axis. Each axis uploads its
    two matrices by pageable copies, each counted in ``blocking_copies``."""
    lab_f = lab.float()
    for axis in range(3):
        lin, nst = zoom_matrix_bank(img.shape[axis], tuple(factors))
        count("blocking_copies", 2)
        img = _zoom_axis(img, axis, torch.from_numpy(lin[index]).to(img.device))
        lab_f = _zoom_axis(lab_f, axis, torch.from_numpy(nst[index]).to(img.device))
    # Nearest matrices have one-hot rows: the values stay exact class ids.
    return img, torch.round(lab_f).to(lab.dtype)


@lru_cache(maxsize=32)
def field_upsample_matrix(n: int, g: int) -> np.ndarray:
    """(n, g) linear-interpolation matrix from a g-point control grid whose
    endpoints sit on the volume boundary."""
    pos = np.arange(n) * (g - 1) / (n - 1)
    return matrix_from_positions(pos, g, "linear")


def _gather3(flat: torch.Tensor, idx, strides) -> torch.Tensor:
    """flat (N, C) indexed at the (X, Y, Z) integer coordinates ``idx``."""
    lin = idx[0] * strides[0] + idx[1] * strides[1] + idx[2]
    return flat[lin.reshape(-1)].reshape(*lin.shape, flat.shape[1])


def apply_elastic(img, lab, field: torch.Tensor, amp: float):
    """Warp img (X, Y, Z, C) trilinearly and lab (X, Y, Z) by nearest
    neighbour along the displacement ``field`` (3, g, g, g) times ``amp``
    voxels, upsampled to the volume by per-axis interpolation matrices.
    Sampling coordinates are clamped to the volume (edge-replicate). The
    field and the matrices go up by pageable copies (``blocking_copies``)."""
    shape = tuple(img.shape[:3])
    count("blocking_copies", 4)  # the field and three matrices, by pageable copies
    disp = field.to(img.device, torch.float32) * amp
    for axis in range(3):
        M = torch.from_numpy(field_upsample_matrix(shape[axis], field.shape[1 + axis]))
        disp = _zoom_axis(disp, axis + 1, M.to(img.device))
    coords = []
    for a in range(3):
        base = torch.arange(shape[a], dtype=torch.float32, device=img.device)
        base = base.reshape([-1 if i == a else 1 for i in range(3)])
        coords.append(torch.clamp(base + disp[a], 0.0, shape[a] - 1.0))
    strides = (shape[1] * shape[2], shape[2])
    lo = [torch.floor(c) for c in coords]
    frac = [c - l for c, l in zip(coords, lo)]
    lo = [l.long() for l in lo]
    # The upper corner of a coordinate on the last voxel has weight 0.
    hi = [torch.clamp_max(l + 1, n - 1) for l, n in zip(lo, shape)]
    flat = img.reshape(-1, img.shape[3])
    out = torch.zeros_like(img, dtype=torch.float32)
    for corner in range(8):
        pick = [(corner >> (2 - a)) & 1 for a in range(3)]
        w = 1.0
        for a in range(3):
            w = w * (frac[a] if pick[a] else 1.0 - frac[a])
        idx = [hi[a] if pick[a] else lo[a] for a in range(3)]
        out = out + w[..., None] * _gather3(flat, idx, strides).float()
    near = [torch.round(c).long() for c in coords]
    lab_w = _gather3(lab.reshape(-1, 1), near, strides)[..., 0]
    return out.to(img.dtype), lab_w


def apply_intensity(img, scale: float, shift: float, noise: torch.Tensor):
    """img·scale + shift + 0.05·noise, noise a unit normal field of img's
    shape."""
    return img * scale + shift + noise * 0.05


def draw_params(gen: torch.Generator, shape, elastic: bool = False) -> AugmentParams:
    """The random choices of one sample, from a host generator: a fair coin
    per flip axis, a uniform quarter turn when X == Y, a uniform zoom
    factor, scale ~ U(0.9, 1.1), shift ~ U(-0.1, 0.1); with ``elastic`` a
    unit-normal control field and an amplitude ~ U(0, 8) voxels, drawn last
    so the other choices do not depend on the switch."""
    u = torch.rand(5, generator=gen, dtype=torch.float64).tolist()
    flips = tuple(bool(b) for b in torch.randint(0, 2, (3,), generator=gen).tolist())
    rot = int(torch.randint(0, 4, (), generator=gen)) if shape[0] == shape[1] else 0
    index = int(torch.randint(0, len(ZOOM_FACTORS), (), generator=gen))
    field, amp = None, 0.0
    if elastic:
        g = ELASTIC_GRID
        field = torch.randn((3, g, g, g), generator=gen, dtype=torch.float32)
        lo, hi = ELASTIC_ALPHA
        amp = lo + (hi - lo) * float(torch.rand((), generator=gen, dtype=torch.float64))
    return AugmentParams(flips=flips, rot90=rot, zoom=index,
                         scale=0.9 + 0.2 * u[0], shift=-0.1 + 0.2 * u[1],
                         elastic_field=field, elastic_amp=amp)


def augment_one(img, lab, params: AugmentParams, noise: torch.Tensor):
    """img (X, Y, Z, C) float, lab (X, Y, Z) int: flip → rot90 → zoom →
    elastic (when drawn) → intensity, every channel carried through the
    same geometry."""
    img, lab = apply_flip(img, lab, params.flips)
    img, lab = apply_rot90(img, lab, params.rot90)
    img, lab = apply_zoom(img, lab, params.zoom)
    if params.elastic_field is not None:
        img, lab = apply_elastic(img, lab, params.elastic_field, params.elastic_amp)
    return apply_intensity(img, params.scale, params.shift, noise), lab


def sample_seed(seed: int, index: int) -> int:
    """The generators' seed for sample ``index`` of the global batch of a
    step seeded ``seed``: a sample's draws depend on its place in the
    global batch only, not on the rank that holds it."""
    return (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) % 2**63


def augment_batch(images, labels, host_gen: torch.Generator, device_gen: torch.Generator,
                  elastic: bool = False, seed: int | None = None, first_index: int = 0):
    """images (B, X, Y, Z, C), labels (B, X, Y, Z): one independent draw
    per sample; choices from ``host_gen``, noise from ``device_gen`` (a
    generator on the images' device). With ``seed`` both generators are
    seeded with ``sample_seed(seed, first_index + i)`` before sample i, so
    a data-parallel rank holding samples ``first_index ..`` of the global
    batch draws what one device draws for them; without it the samples
    draw one after another from the generators as they stand."""
    out_i, out_l = [], []
    for i, (img, lab) in enumerate(zip(images, labels)):
        if seed is not None:
            s = sample_seed(seed, first_index + i)
            host_gen.manual_seed(s)
            device_gen.manual_seed(s)
        p = draw_params(host_gen, img.shape, elastic)
        noise = torch.randn(img.shape, generator=device_gen, device=img.device,
                            dtype=img.dtype)
        i, l = augment_one(img, lab, p, noise)
        out_i.append(i)
        out_l.append(l)
    return torch.stack(out_i), torch.stack(out_l)
