"""Per-sample training augmentation on the device: flip, rot90, zoom and
intensity jitter, in the JAX package's order (``runet_tpu/data/augment.py::
augment_one``).

Each transform is split in two halves: ``draw_params`` takes the random
choices from a host ``torch.Generator`` (and the noise field from a device
one), and the ``apply_*`` functions apply given choices, so tests can hold
the apply halves against JAX with fixed parameters. ``torch.Generator`` and
``jax.random`` give different numbers from the same seed; the draws are held
to the same distributions instead.

Layout: an image is (X, Y, Z, C) float, a label map (X, Y, Z) int; a batch
adds a leading B. Elastic deformation is not ported yet (off in every
preset).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from runet_tpu_torch.preprocess.resample import matrix_from_positions

# Isotropic zoom factors; 1.0 keeps the identity in distribution. A factor
# above 1 samples a wider input extent (content shrinks, edge-clamped).
ZOOM_FACTORS = (0.85, 0.90, 0.95, 1.0, 1.05, 1.10, 1.15)


@dataclasses.dataclass(frozen=True)
class AugmentParams:
    flips: tuple[bool, bool, bool]
    rot90: int  # quarter turns in the (X, Y) plane; 0 unless X == Y
    zoom: int  # index into ZOOM_FACTORS
    scale: float
    shift: float


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
    ``factors[index]`` about the center of each axis."""
    lab_f = lab.float()
    for axis in range(3):
        lin, nst = zoom_matrix_bank(img.shape[axis], tuple(factors))
        img = _zoom_axis(img, axis, torch.from_numpy(lin[index]).to(img.device))
        lab_f = _zoom_axis(lab_f, axis, torch.from_numpy(nst[index]).to(img.device))
    # Nearest matrices have one-hot rows: the values stay exact class ids.
    return img, torch.round(lab_f).to(lab.dtype)


def apply_intensity(img, scale: float, shift: float, noise: torch.Tensor):
    """img·scale + shift + 0.05·noise, noise a unit normal field of img's
    shape."""
    return img * scale + shift + noise * 0.05


def draw_params(gen: torch.Generator, shape) -> AugmentParams:
    """The random choices of one sample, from a host generator: a fair coin
    per flip axis, a uniform quarter turn when X == Y, a uniform zoom
    factor, scale ~ U(0.9, 1.1), shift ~ U(-0.1, 0.1)."""
    u = torch.rand(5, generator=gen, dtype=torch.float64).tolist()
    flips = tuple(bool(b) for b in torch.randint(0, 2, (3,), generator=gen).tolist())
    rot = int(torch.randint(0, 4, (), generator=gen)) if shape[0] == shape[1] else 0
    index = int(torch.randint(0, len(ZOOM_FACTORS), (), generator=gen))
    return AugmentParams(flips=flips, rot90=rot, zoom=index,
                         scale=0.9 + 0.2 * u[0], shift=-0.1 + 0.2 * u[1])


def augment_one(img, lab, params: AugmentParams, noise: torch.Tensor):
    """img (X, Y, Z, C) float, lab (X, Y, Z) int: flip → rot90 → zoom →
    intensity, every channel carried through the same geometry."""
    img, lab = apply_flip(img, lab, params.flips)
    img, lab = apply_rot90(img, lab, params.rot90)
    img, lab = apply_zoom(img, lab, params.zoom)
    return apply_intensity(img, params.scale, params.shift, noise), lab


def augment_batch(images, labels, host_gen: torch.Generator, device_gen: torch.Generator):
    """images (B, X, Y, Z, C), labels (B, X, Y, Z): one independent draw
    per sample; choices from ``host_gen``, noise from ``device_gen`` (a
    generator on the images' device)."""
    out_i, out_l = [], []
    for img, lab in zip(images, labels):
        p = draw_params(host_gen, img.shape)
        noise = torch.randn(img.shape, generator=device_gen, device=img.device,
                            dtype=img.dtype)
        i, l = augment_one(img, lab, p, noise)
        out_i.append(i)
        out_l.append(l)
    return torch.stack(out_i), torch.stack(out_l)
