"""Train state, optimizer and LR schedules with optax's semantics.

Counterpart of ``runet_tpu/train/state.py``. The JAX package builds its
optimizer from optax; this module writes the same arithmetic out in torch,
because ``torch.optim`` differs in the details that decide the numbers:

- ``clip_by_global_norm(12.0)`` runs first and scales by max/‖g‖ only when
  ‖g‖ ≥ max (no epsilon, unlike ``clip_grad_norm_``);
- the schedule is read at the update count BEFORE it is incremented, so
  with warmup the first update uses lr = 0;
- adamw decays every parameter (no mask), after the Adam normalisation;
- sgd adds the decayed weights ahead of Nesterov momentum;
- ``grad_accum > 1`` is optax's ``MultiSteps``: a running mean of the
  gradients, and the inner optimizer (with its count) advances only on
  every k-th step.

The train step updates the model's parameters in place (``p.add_`` under
``no_grad``, which also bumps each parameter's version, so the conv
kernels' packed CUDA layouts are rebuilt from the new weights).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from runet_tpu_torch.config import TrainConfig

Schedule = Callable[[int], float]


def _polynomial(init: float, end: float, power: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), steps))
        frac = np.float32(1.0) - c / np.float32(steps)
        return float(np.float32(init - end) * frac ** np.float32(power) + np.float32(end))

    return schedule


def _cosine(init: float, decay_steps: int) -> Schedule:
    def schedule(count: int) -> float:
        c = np.float32(min(count, decay_steps))
        decay = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(math.pi) * c
                                                            / np.float32(decay_steps)))
        return float(np.float32(init) * decay)

    return schedule


def make_lr_schedule(cfg: TrainConfig) -> Schedule:
    """const / cosine / poly (to lr·1e-3), joined to a linear warmup from 0
    at ``warmup_steps``; a function of the update count."""
    decay_steps = max(cfg.steps - cfg.warmup_steps, 1)
    if cfg.lr_schedule == "const":
        sched = lambda count: cfg.lr  # noqa: E731
    elif cfg.lr_schedule == "cosine":
        sched = _cosine(cfg.lr, decay_steps)
    elif cfg.lr_schedule == "poly":
        sched = _polynomial(cfg.lr, cfg.lr * 1e-3, cfg.poly_power, decay_steps)
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.warmup_steps <= 0:
        return sched
    warmup = _polynomial(0.0, cfg.lr, 1.0, cfg.warmup_steps)
    return lambda count: warmup(count) if count < cfg.warmup_steps \
        else sched(count - cfg.warmup_steps)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class Optimizer:
    """``clip_by_global_norm(12)`` → adamw | sgd, wrapped in ``MultiSteps``
    for ``grad_accum > 1``, over a fixed list of parameters (the order of
    ``model.parameters()``). Its state lives in f32 tensors beside them."""

    MAX_NORM = 12.0
    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, cfg: TrainConfig, params: list[torch.Tensor]):
        if cfg.optimizer not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.kind = cfg.optimizer
        self.weight_decay = cfg.weight_decay
        self.momentum = cfg.sgd_momentum
        self.schedule = make_lr_schedule(cfg)
        self.every_k = max(1, cfg.grad_accum)
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]  # noqa: E731
        self.count = 0  # inner updates applied (the schedule's count)
        self.mini_step = 0
        self.mu = zeros() if self.kind == "adamw" else None
        self.nu = zeros() if self.kind == "adamw" else None
        self.trace = zeros() if self.kind == "sgd" else None
        self.acc = zeros() if self.every_k > 1 else None

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step, "mu": self.mu,
                "nu": self.nu, "trace": self.trace, "acc": self.acc}

    def load_state_dict(self, sd: dict) -> None:
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        for name in ("mu", "nu", "trace", "acc"):
            mine, theirs = getattr(self, name), sd[name]
            if (mine is None) != (theirs is None):
                raise ValueError(f"optimizer state {name!r} does not match this optimizer")
            if mine is not None:
                for a, b in zip(mine, theirs, strict=True):
                    a.copy_(b)

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor],
             norm: torch.Tensor | None = None) -> bool:
        """Apply one optimizer step in place; returns whether the parameters
        changed (with ``grad_accum = k``, on every k-th call only). ``norm``:
        ``global_norm(grads)`` when the caller has it already (not used
        with ``grad_accum > 1``, where the clip reads the mean gradient)."""
        grads = [g.float() for g in grads]
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            emit = n == self.every_k - 1
            self.mini_step = (n + 1) % self.every_k
            if not emit:
                return False
            grads, norm = self.acc, None
        if norm is None:
            norm = global_norm(grads)
        # optax's clip, chosen on the device: no host read of the norm.
        keep = norm < self.MAX_NORM
        grads = [torch.where(keep, g, (g / norm) * self.MAX_NORM) for g in grads]
        lr = self.schedule(self.count)
        count_inc = self.count + 1
        if self.kind == "adamw":
            bc1 = float(np.float32(1.0) - np.float32(self.B1) ** np.float32(count_inc))
            bc2 = float(np.float32(1.0) - np.float32(self.B2) ** np.float32(count_inc))
            for p, g, m, v in zip(params, grads, self.mu, self.nu):
                m.mul_(self.B1).add_(g, alpha=1.0 - self.B1)
                v.mul_(self.B2).add_(g * g, alpha=1.0 - self.B2)
                u = (m / bc1) / (torch.sqrt(v / bc2) + self.EPS)
                u = u + self.weight_decay * p.float()
                p.add_((-lr * u).to(p.dtype))
        else:
            for p, g, tr in zip(params, grads, self.trace):
                u = g + self.weight_decay * p.float()
                tr.mul_(self.momentum).add_(u)
                u = u + self.momentum * tr
                p.add_((-lr * u).to(p.dtype))
        self.count = count_inc
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        return True


def make_optimizer(cfg: TrainConfig, params: list[torch.Tensor]) -> Optimizer:
    return Optimizer(cfg, list(params))


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer state and the step count."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    def state_dict(self) -> dict:
        return {"step": self.step, "params": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["params"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def create_train_state(model: torch.nn.Module, cfg: TrainConfig) -> TrainState:
    return TrainState(model, make_optimizer(cfg, model.parameters()))


def make_train_step(model, augment: bool = False, loss_kwargs: dict | None = None):
    """One step: compact-dtype upcast, labels clamped to K−1, per-sample
    augmentation, forward + backward + optimizer update.

    Returns ``train_step(state, images, labels, generators=None) -> aux``:
    images (B, X, Y, Z, C) and labels (B, X, Y, Z) on the model's device;
    ``generators`` the (host, device) ``torch.Generator`` pair the
    augmentation draws from (required with ``augment``). ``aux`` holds the
    loss terms and ``grad_norm``, the global gradient norm BEFORE clipping,
    as 0-d tensors on the device; the state is updated in place."""
    from runet_tpu_torch.data.augment import augment_batch
    from runet_tpu_torch.train.losses import dice_ce_loss

    loss_kwargs = loss_kwargs or {}
    num_classes = model.cfg.num_classes

    def train_step(state: TrainState, images, labels, generators=None):
        images = images.float()
        labels = torch.clamp_max(labels.long(), num_classes - 1)
        if augment:
            if generators is None:
                raise ValueError("augment=True needs the (host, device) generators")
            images, labels = augment_batch(images, labels, *generators)
        params = state.params
        logits = state.model(images)
        loss, aux = dice_ce_loss(logits, labels, **loss_kwargs)
        grads = torch.autograd.grad(loss, params)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["grad_norm"] = global_norm(grads)
        state.optimizer.step(params, grads, aux["grad_norm"])
        state.step += 1
        return aux

    return train_step


def make_eval_step(model):
    """``eval_step(images, labels) -> (K,)`` hard Dice per class of the
    argmaxed prediction, under ``no_grad``."""
    from runet_tpu_torch.train.losses import hard_dice_per_class

    num_classes = model.cfg.num_classes

    @torch.no_grad()
    def eval_step(images, labels):
        labels = torch.clamp_max(labels.long(), num_classes - 1)
        pred = torch.argmax(model(images.float()), dim=-1)
        return hard_dice_per_class(pred, labels, num_classes)

    return eval_step
