"""The plain training step: the training cells' reference.

From the same initial weights and the same batches the program was handed,
in f32 with TF32 off:

1. per sample, the augmentation the configuration states, drawn as the
   training step defines its draws: a host and a device ``torch.Generator``
   both seeded with the sample's seed (``sample_seed``); from the host one
   five f64 uniforms (scale and shift from the first two), three fair coins
   for the flips of X, Y and Z, a quarter-turn count in the (X, Y) plane
   when X == Y, and a zoom index; from the device one a unit-normal noise
   field of the image's shape. Applied in order: flips, quarter turns, an
   isotropic zoom about each axis' centre (linear for the image, nearest
   for the labels, positions clamped), then image * scale + shift +
   0.05 * noise;
2. the U-Net forward (``reference/unet.py``);
3. Dice + cross-entropy: the mean over voxels of -log softmax at the label,
   plus 1 - the mean over samples and foreground classes of
   (2 sum(p*g) + 1e-5) / (sum p + sum g + 1e-5);
4. the gradient by autograd;
5. optax's ``clip_by_global_norm(12)`` then ``adamw`` (b1 0.9, b2 0.999,
   eps 1e-8, decoupled weight decay on every parameter), the learning rate
   read at the update count before it is incremented: a linear warm-up from
   0, then a polynomial decay.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import unet

ZOOM_FACTORS = (0.85, 0.90, 0.95, 1.0, 1.05, 1.10, 1.15)
MAX_NORM = 12.0
B1, B2, EPS = 0.9, 0.999, 1e-8


def step_seed(seed: int, step: int) -> int:
    """The augmentation seed of a global step."""
    return (seed * 1_000_003 + step) % 2**63


def sample_seed(seed: int, index: int) -> int:
    """The generators' seed for sample ``index`` of a step seeded ``seed``."""
    return (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) % 2**63


def _zoom_axis(x: torch.Tensor, axis: int, factor: float, nearest: bool) -> torch.Tensor:
    n = x.shape[axis]
    c = (n - 1) / 2.0
    pos = np.clip(c + (np.arange(n) - c) * factor, 0.0, float(n - 1))
    if nearest:
        idx = torch.from_numpy(np.clip(np.floor(pos + 0.5), 0, n - 1).astype(np.int64))
        return x.index_select(axis, idx.to(x.device))
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, n - 1)
    i1 = np.minimum(i0 + 1, n - 1)
    w = torch.from_numpy((pos - i0).astype(np.float32)).to(x.device)
    shape = [1] * x.dim()
    shape[axis] = n
    w = w.view(shape)
    a = x.index_select(axis, torch.from_numpy(i0).to(x.device))
    b = x.index_select(axis, torch.from_numpy(i1).to(x.device))
    return a * (1.0 - w) + b * w


def augment(img: torch.Tensor, lab: torch.Tensor, seed: int):
    """img (X, Y, Z, C) f32, lab (X, Y, Z) int64 → the augmented pair."""
    host = torch.Generator().manual_seed(seed)
    dev = torch.Generator(device=img.device).manual_seed(seed)
    u = torch.rand(5, generator=host, dtype=torch.float64).tolist()
    flips = torch.randint(0, 2, (3,), generator=host).tolist()
    rot = int(torch.randint(0, 4, (), generator=host)) if img.shape[0] == img.shape[1] else 0
    zoom = ZOOM_FACTORS[int(torch.randint(0, len(ZOOM_FACTORS), (), generator=host))]
    noise = torch.randn(img.shape, generator=dev, device=img.device, dtype=img.dtype)
    for axis, f in enumerate(flips):
        if f:
            img, lab = img.flip(axis), lab.flip(axis)
    if rot % 4:
        img, lab = torch.rot90(img, rot, (0, 1)), torch.rot90(lab, rot, (0, 1))
    for axis in range(3):
        img = _zoom_axis(img, axis, zoom, nearest=False)
        lab = _zoom_axis(lab, axis, zoom, nearest=True)
    return img * (0.9 + 0.2 * u[0]) + (-0.1 + 0.2 * u[1]) + noise * 0.05, lab


def dice_ce(logits: torch.Tensor, labels: torch.Tensor, smooth: float = 1e-5) -> torch.Tensor:
    """logits (B, K, X, Y, Z), labels (B, X, Y, Z)."""
    k = logits.shape[1]
    logp = F.log_softmax(logits, dim=1)
    onehot = F.one_hot(labels, k).permute(0, 4, 1, 2, 3).float()
    ce = -(logp * onehot).sum(dim=1).mean()
    p = logp.exp()
    inter = (p * onehot).sum(dim=(2, 3, 4))
    dice = (2 * inter + smooth) / (p.sum(dim=(2, 3, 4)) + onehot.sum(dim=(2, 3, 4)) + smooth)
    return (1.0 - dice[:, 1:].mean()) + ce


def learning_rate(train: dict, count: int) -> float:
    lr, warm = train["lr"], train["warmup_steps"]
    if warm > 0 and count < warm:
        return lr * count / warm
    count -= max(warm, 0)
    decay = max(train["steps"] - warm, 1)
    c = min(count, decay)
    if train["lr_schedule"] == "const":
        return lr
    if train["lr_schedule"] == "cosine":
        return lr * 0.5 * (1 + math.cos(math.pi * c / decay))
    end = lr * 1e-3
    return (lr - end) * (1 - c / decay) ** train["poly_power"] + end


def run_steps(cfg: dict, init: dict[str, torch.Tensor], batches, seeds, quant=None):
    """``len(batches)`` training steps from ``init`` (flax-keyed f32
    tensors). ``batches``: (images (B, X, Y, Z, 1), labels (B, X, Y, Z)) as
    the program received them; ``seeds``: each step's augmentation seed.
    Returns the losses, the first step's clipped gradient per leaf, and each
    leaf's change over all the steps."""
    model, train = cfg["model"], cfg["train"]
    if train["optimizer"] != "adamw" or train["grad_accum"] != 1 or train["elastic"] \
            or model["deep_supervision"] or (train["tversky_alpha"], train["tversky_beta"]) \
            != (0.5, 0.5):
        raise ValueError("the reference covers adamw, no accumulation, no elastic warp, "
                         "no deep supervision and the plain Dice")
    w = {k: v.detach().clone().float().requires_grad_(True) for k, v in init.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, first_grad = [], None
    with unet.strict_f32():
        for count, ((images, labels), seed) in enumerate(zip(batches, seeds)):
            images = images.float()
            labels = labels.long().clamp_max(model["num_classes"] - 1)
            if train["augment"]:
                pairs = [augment(i, lab, sample_seed(seed, j))
                         for j, (i, lab) in enumerate(zip(images, labels))]
                images = torch.stack([p[0] for p in pairs])
                labels = torch.stack([p[1] for p in pairs])
            logits = unet.forward(w, model, images.permute(0, 4, 1, 2, 3), quant)
            loss = dice_ce(logits, labels)
            grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
            del logits
            losses.append(float(loss.detach()))
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            if norm >= MAX_NORM:
                grads = {k: g / norm * MAX_NORM for k, g in grads.items()}
            if first_grad is None:
                first_grad = {k: float(g.norm()) for k, g in grads.items()}
            lr = learning_rate(train, count)
            t = count + 1
            with torch.no_grad():
                for k, p in w.items():
                    g = grads[k]
                    m[k].mul_(B1).add_(g, alpha=1 - B1)
                    v2[k].mul_(B2).add_(g * g, alpha=1 - B2)
                    u = (m[k] / (1 - B1 ** t)) / (torch.sqrt(v2[k] / (1 - B2 ** t)) + EPS)
                    p.sub_(lr * (u + train["weight_decay"] * p))
    change = {k: float((w[k].detach() - init[k].float()).norm()) for k in w}
    return losses, first_grad, change
