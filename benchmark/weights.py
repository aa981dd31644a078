"""The weights a cell runs with: a committed npz checked against the digest
its configuration records, or the benchmark's seeded initialisation.

Both sides of the comparison get the same tensors from here: the program
loads them, the reference reads them again on its own.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import torch

from benchmark.reference.unet import param_shapes

TRUNC_STD = 0.87962566103423978  # std of a unit normal clamped to [-2, 2]


class DigestMismatch(RuntimeError):
    pass


def checked_path(root: Path, entry: dict) -> Path:
    """The npz of a configuration's ``weights`` entry ({"file", "sha256"}),
    after its sha256 matched; stops with a message when it does not."""
    path = root / entry["file"]
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    if h.hexdigest() != entry["sha256"]:
        raise DigestMismatch(f"{entry['file']}: sha256 {h.hexdigest()} is not the "
                             f"{entry['sha256']} its configuration records")
    return path


def seeded_init(model_cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Flax-keyed f32 weights on ``device`` from one draw of a card-side
    generator: every kernel a unit normal clamped to [-2, 2] scaled to std
    fan_in^-1/2 (lecun normal; fan_in 27 Cin for a 3x3x3 conv, Cin for a
    1x1x1 one), norm scales 1, biases 0."""
    shapes = param_shapes(model_cfg)
    kernels = [k for k in shapes if k.endswith("kernel")]
    sizes = [torch.Size(shapes[k]).numel() for k in kernels]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    out = {}
    for k, part in zip(kernels, torch.split(flat, sizes)):
        s = shapes[k]
        fan_in = s[0] * s[1] * s[2] * s[3]
        out[k] = part.view(s) * (fan_in ** -0.5 / TRUNC_STD)
    for k, s in shapes.items():
        if k.endswith("scale"):
            out[k] = torch.ones(s, device=device)
        elif k.endswith("bias"):
            out[k] = torch.zeros(s, device=device)
    return out


def load_into(model: torch.nn.Module, flat: dict[str, torch.Tensor]) -> None:
    """Copy flax-keyed tensors into a ``runet_tpu_torch`` U-Net, whose
    parameters carry the same paths with dots (1x1x1 kernels as (C, out))."""
    own = dict(model.named_parameters())
    names = {k.replace("/", "."): k for k in flat}
    if set(own) != set(names):
        raise KeyError(f"parameter trees differ: {sorted(set(own) ^ set(names))[:6]}")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(flat[names[name]].reshape(p.shape))
