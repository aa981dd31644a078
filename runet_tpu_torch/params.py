"""Carry flax checkpoints into the torch model.

The JAX package saves parameters as npz files with flat ``/``-joined flax
keys (``enc0/ConvNormAct_0/kernel``) plus a ``__fingerprint__`` entry; the
committed ``artifacts/bench_params_*.npz`` store them in f16. The torch
modules reuse the flax names, so each key maps to one state_dict entry:

- ``.../ConvNormAct_i/kernel`` (3, 3, 3, Cin, Cout): kept as is;
- ``dec*/Conv_0/kernel`` (1, 1, 1, C, 8F) → (C, 8F);
- ``dec*/ConvTranspose_0/kernel`` (2, 2, 2, C, F): kept as is
  (``upsample_mode="convtranspose"``);
- head ``Conv_0/kernel`` and the deep-supervision heads ``ds{1,2}/kernel``
  (1, 1, 1, C, K) → (C, K), with their biases (K,);
- ``.../InstanceNorm_0/{scale,bias}`` (C,).

Loading into the model casts each tensor to its parameter's dtype (conv and
projection kernels to the compute dtype in the serving model, f32 masters in
the train model) once, at load. ``torch_to_flax`` goes the other way, so a
trained model can be compared key for key with JAX or saved as an npz.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from runet_tpu_torch import resolve_device
from runet_tpu_torch.config import Config, get_config
from runet_tpu_torch.models.unet3d import UNet3D

ARTIFACT_DIR = Path(__file__).resolve().parents[1] / "artifacts"


def load_npz(path) -> dict[str, np.ndarray]:
    """Flat ``/``-keyed arrays of a params npz, as f32, without the
    ``__fingerprint__`` entry."""
    with np.load(path) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files if k != "__fingerprint__"}


def flax_to_torch(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat flax params (``/``-joined keys) → a state_dict for ``UNet3D``."""
    out = {}
    for key, a in flat.items():
        parts = key.split("/")
        a = np.asarray(a)
        if parts[-1] == "kernel" and a.shape[:3] == (1, 1, 1):
            a = a.reshape(a.shape[3], a.shape[4])  # 1x1x1 projection / head
        out[".".join(parts)] = torch.from_numpy(np.array(a, np.float32))
    return out


def torch_to_flax(model: UNet3D) -> dict[str, np.ndarray]:
    """The inverse of ``flax_to_torch``: the model's parameters as flat
    ``/``-joined flax keys, f32 numpy, with the 1x1x1 projection and head
    kernels back in flax's (1, 1, 1, C, out) shape — the layout of the
    committed npz files and of JAX's ``init_params`` output."""
    return state_to_flax(model.state_dict())


def state_to_flax(state_dict: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """``torch_to_flax`` of a ``UNet3D`` state_dict, e.g. the ``params`` of a
    training checkpoint (``train/checkpoint.py``)."""
    out = {}
    for name, t in state_dict.items():
        a = t.detach().float().cpu().numpy()
        if name.endswith("kernel") and a.ndim == 2:
            a = a.reshape(1, 1, 1, *a.shape)
        out[name.replace(".", "/")] = a
    return out


def load_state(model: UNet3D, flat: dict[str, np.ndarray]) -> UNet3D:
    """Copy flat flax params into ``model`` (strict: every key must match
    in name and shape). Each tensor takes its parameter's dtype: the
    serving model's compute dtype, or the train model's f32 masters."""
    sd = flax_to_torch(flat)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"param tree mismatch: missing {missing[:5]}, unexpected {extra[:5]}")
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)} != model {tuple(own[k].shape)}")
    model.load_state_dict(sd)
    return model


def load_model(preset: str | Config, path=None, device=None) -> tuple[UNet3D, Config]:
    """Build the preset's UNet3D on ``device`` (CUDA unless named) and load
    its weights: ``path``, or the committed ``artifacts/bench_params_<name>.npz``."""
    cfg = get_config(preset) if isinstance(preset, str) else preset
    dev = resolve_device(device)
    path = Path(path) if path is not None else ARTIFACT_DIR / f"bench_params_{cfg.name}.npz"
    model = UNet3D(cfg.model, device=dev)
    load_state(model, load_npz(path))
    return model.eval(), cfg
