"""The plain 3-D U-Net: the benchmark's reference forward.

Plain PyTorch in f32 (TF32 off, ``strict_f32``), channels-first
(N, C, D, H, W), written from the architecture and not from the program:

- per resolution level two (3x3x3 conv, no bias → InstanceNorm (two-pass
  mean and biased variance over the spatial axes, eps 1e-5, affine) →
  LeakyReLU 0.01) blocks; level 0 starts with a stride-1 conv, every deeper
  level with a stride-2 conv padded as XLA's SAME pads an even extent (low
  0, high 1);
- up: a 1x1x1 projection to 8F channels, then the depth-to-space shuffle
  whose channel order is ((rd*2 + rh)*2 + rw)*F + f, concatenated before the
  skip, and two stride-1 blocks;
- a 1x1x1 head with bias.

Weights are a flat dict keyed by the flax paths of the committed npz files
(``enc0/ConvNormAct_0/kernel`` (3, 3, 3, Cin, Cout), ``dec0/Conv_0/kernel``
(1, 1, 1, C, 8F), ``Conv_0/kernel`` and ``Conv_0/bias``,
``.../InstanceNorm_0/{scale,bias}``).

``quant`` puts a rounding step in front of every convolution and
projection: the control (``reference/precision.py``) passes one that rounds
the operands to fp8, the reference passes none.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def strict_f32():
    """f32 matrix products and convolutions as f32, not TF32."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def load_npz(path) -> dict[str, np.ndarray]:
    """The flat flax-keyed weights of a committed npz file, as f32 numpy."""
    with np.load(path) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files if k != "__fingerprint__"}


def to_device(flat: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in flat.items()}


def level_features(model_cfg: dict) -> list[int]:
    return [min(model_cfg["base_features"] * 2 ** i, model_cfg["max_features"])
            for i in range(model_cfg["num_levels"])]


def param_shapes(model_cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every weight of the architecture with its flax shape, in the order the
    architecture defines them (encoder, decoder from the deepest level, head)."""
    feats = level_features(model_cfg)
    out: dict[str, tuple[int, ...]] = {}
    cin = model_cfg["in_channels"]

    def block(prefix, ci, co):
        out[f"{prefix}/kernel"] = (3, 3, 3, ci, co)
        out[f"{prefix}/InstanceNorm_0/scale"] = (co,)
        out[f"{prefix}/InstanceNorm_0/bias"] = (co,)

    for lvl, f in enumerate(feats):
        block(f"enc{lvl}/ConvNormAct_0", cin, f)
        block(f"enc{lvl}/ConvNormAct_1", f, f)
        cin = f
    for lvl in reversed(range(len(feats) - 1)):
        f = feats[lvl]
        out[f"dec{lvl}/Conv_0/kernel"] = (1, 1, 1, feats[lvl + 1], 8 * f)
        block(f"dec{lvl}/ConvNormAct_0", 2 * f, f)
        block(f"dec{lvl}/ConvNormAct_1", f, f)
    out["Conv_0/kernel"] = (1, 1, 1, feats[0], model_cfg["num_classes"])
    out["Conv_0/bias"] = (model_cfg["num_classes"],)
    return out


def _conv(x, kernel, stride, quant):
    w = kernel.permute(4, 3, 0, 1, 2)  # (3,3,3,Cin,Cout) → (Cout,Cin,3,3,3)
    if quant is not None:
        x, w = quant(x), quant(w)
    if stride == 2:
        return F.conv3d(F.pad(x, (0, 1, 0, 1, 0, 1)), w, stride=2)
    return F.conv3d(x, w, padding=1)


def _norm_act(y, scale, bias, eps, slope):
    mean = y.mean(dim=(2, 3, 4), keepdim=True)
    var = (y - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    y = (y - mean) / torch.sqrt(var + eps)
    y = y * scale.view(1, -1, 1, 1, 1) + bias.view(1, -1, 1, 1, 1)
    return F.leaky_relu(y, slope)


def _block(x, w, prefix, stride, cfg, quant):
    y = _conv(x, w[f"{prefix}/kernel"], stride, quant)
    return _norm_act(y, w[f"{prefix}/InstanceNorm_0/scale"], w[f"{prefix}/InstanceNorm_0/bias"],
                     cfg["norm_eps"], cfg["negative_slope"])


def _project(x, kernel, quant):
    k = kernel.reshape(kernel.shape[-2], kernel.shape[-1])  # (C, out)
    if quant is not None:
        x, k = quant(x), quant(k)
    return torch.einsum("ncdhw,co->nodhw", x, k)


def _depth_to_space(x):
    n, c, d, h, w = x.shape
    f = c // 8
    x = x.reshape(n, 2, 2, 2, f, d, h, w)  # channel = ((rd*2 + rh)*2 + rw)*F + f
    x = x.permute(0, 4, 5, 1, 6, 2, 7, 3)  # (n, f, d, rd, h, rh, w, rw)
    return x.reshape(n, f, 2 * d, 2 * h, 2 * w)


def forward(w: dict[str, torch.Tensor], model_cfg: dict, x: torch.Tensor, quant=None):
    """x (N, C_in, D, H, W) f32 → logits (N, K, D, H, W) f32."""
    n = model_cfg["num_levels"]
    if any(s % 2 ** (n - 1) for s in x.shape[2:]):
        raise ValueError(f"spatial dims {tuple(x.shape[2:])} not divisible by {2 ** (n - 1)}")
    skips = []
    for lvl in range(n):
        x = _block(x, w, f"enc{lvl}/ConvNormAct_0", 2 if lvl else 1, model_cfg, quant)
        x = _block(x, w, f"enc{lvl}/ConvNormAct_1", 1, model_cfg, quant)
        if lvl < n - 1:
            skips.append(x)
    for lvl in reversed(range(n - 1)):
        x = _depth_to_space(_project(x, w[f"dec{lvl}/Conv_0/kernel"], quant))
        x = torch.cat([x, skips[lvl]], dim=1)
        x = _block(x, w, f"dec{lvl}/ConvNormAct_0", 1, model_cfg, quant)
        x = _block(x, w, f"dec{lvl}/ConvNormAct_1", 1, model_cfg, quant)
    k = w["Conv_0/kernel"]
    return torch.einsum("ncdhw,co->nodhw", x, k.reshape(k.shape[-2], k.shape[-1])) \
        + w["Conv_0/bias"].view(1, -1, 1, 1, 1)
