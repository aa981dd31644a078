"""Dice + cross-entropy compound loss and Dice metrics.

Counterpart of ``runet_tpu/train/losses.py``. All math in f32 on
(B, D, H, W, K) logits; the one-hot is the K-way equality compare the JAX
package uses.
"""

from __future__ import annotations

import torch


def _onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    classes = torch.arange(num_classes, device=labels.device, dtype=labels.dtype)
    return (labels[..., None] == classes).to(torch.float32)


def soft_dice_loss(logits: torch.Tensor, labels: torch.Tensor, smooth: float = 1e-5,
                   include_background: bool = False) -> torch.Tensor:
    """1 - mean soft Dice over classes and batch, per (sample, class) over
    the spatial dims with additive smoothing."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = _onehot(labels, num_classes)
    axes = tuple(range(1, labels.dim()))
    intersect = (probs * onehot).sum(dim=axes)
    denom = probs.sum(dim=axes) + onehot.sum(dim=axes)
    dice = (2.0 * intersect + smooth) / (denom + smooth)
    if not include_background:
        dice = dice[:, 1:]
    return 1.0 - dice.mean()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(logp * _onehot(labels, logits.shape[-1])).sum(dim=-1).mean()


def dice_ce_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    smooth: float = 1e-5,
    include_background: bool = False,
    ce_weight: float = 1.0,
    dice_weight: float = 1.0,
    tversky_alpha: float = 0.5,
    tversky_beta: float = 0.5,
) -> tuple[torch.Tensor, dict]:
    """Compound loss in one pass over the logits: one logsumexp feeds the
    log-probs (CE) and the probs (Dice). ``tversky_alpha``/``tversky_beta``
    weight false positives / false negatives; at 0.5/0.5 the expression is
    exactly the soft-Dice one (a static branch, as in JAX)."""
    x = logits.float()
    num_classes = x.shape[-1]
    logp = x - torch.logsumexp(x, dim=-1, keepdim=True)
    probs = torch.exp(logp)
    onehot = _onehot(labels, num_classes)
    ce = -(logp * onehot).sum(dim=-1).mean()
    axes = tuple(range(1, labels.dim()))
    intersect = (probs * onehot).sum(dim=axes)
    sum_p = probs.sum(dim=axes)
    sum_g = onehot.sum(dim=axes)
    if tversky_alpha == 0.5 and tversky_beta == 0.5:
        denom = sum_p + sum_g
    else:
        denom = (2.0 * intersect + 2.0 * tversky_alpha * (sum_p - intersect)
                 + 2.0 * tversky_beta * (sum_g - intersect))
    dice = (2.0 * intersect + smooth) / (denom + smooth)
    if not include_background:
        dice = dice[:, 1:]
    dl = 1.0 - dice.mean()
    loss = dice_weight * dl + ce_weight * ce
    return loss, {"loss": loss, "dice_loss": dl, "ce_loss": ce}


def hard_dice_per_class(pred_labels: torch.Tensor, gt_labels: torch.Tensor,
                        num_classes: int) -> torch.Tensor:
    """Per-class Dice of an argmaxed prediction, (K,) f32; a class absent
    from both prediction and ground truth scores 1."""
    dices = []
    for k in range(num_classes):
        p = (pred_labels == k).float()
        g = (gt_labels == k).float()
        inter = (p * g).sum()
        denom = p.sum() + g.sum()
        dices.append(torch.where(denom > 0, 2.0 * inter / torch.clamp_min(denom, 1e-8),
                                 torch.ones_like(denom)))
    return torch.stack(dices)


def kits_composite_dice(pred_labels: torch.Tensor, gt_labels: torch.Tensor) -> dict:
    """KiTS19-style scores: kidney composite = classes {1, 2} merged (exactly
    those two; vessels 3/4 do not count), tumor = class 2."""

    def dice(p, g):
        p, g = p.float(), g.float()
        inter = (p * g).sum()
        denom = p.sum() + g.sum()
        return torch.where(denom > 0, 2 * inter / torch.clamp_min(denom, 1e-8),
                           torch.ones_like(denom))

    kidney = dice((pred_labels == 1) | (pred_labels == 2), (gt_labels == 1) | (gt_labels == 2))
    tumor = dice(pred_labels == 2, gt_labels == 2)
    return {"kidney_composite": kidney, "tumor": tumor}
