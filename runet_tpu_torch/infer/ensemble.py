"""Checkpoint ensembling for inference: K models fused by averaging their
softmax probabilities before the argmax.

Counterpart of ``runet_tpu/infer/ensemble.py``. An ensemble IS a
``ModelBundle``, so the sliding window, single pass, TTA and the cascade
compose with it unchanged. The JAX package stacks the K parameter trees and
scans over them; here the bundle's ``params`` is the list of the members'
own ``params`` (for a loaded ``UNet3D`` the module itself, so a serving
lane's ``bundle_on_device`` copies each member) and the members run one
after another:
member k's activations are freed before member k + 1 runs, so peak memory
is one member's forward plus one f32 probability volume.

``apply_fn`` returns ``log(mean_prob + 1e-12)``: downstream code treats
bundle outputs as logits, and softmax(log p) == p.
"""

from __future__ import annotations

import torch

from runet_tpu_torch.infer.cascade import ModelBundle


def ensemble_apply_fn(member_apply_fns, num_classes: int):
    """The bundle ``apply_fn`` over K members: ``member_apply_fns[k](params[k],
    x) -> logits`` in turn, the f32 softmaxes averaged, the log returned."""
    member_apply_fns = list(member_apply_fns)

    def apply_fn(params_list, x):
        acc = torch.zeros((*x.shape[:-1], num_classes), dtype=torch.float32, device=x.device)
        for fn, params in zip(member_apply_fns, params_list, strict=True):
            acc += torch.softmax(fn(params, x).float(), dim=-1)
        return torch.log(acc / len(member_apply_fns) + 1e-12)

    return apply_fn


def ensemble_bundle(bundles: list[ModelBundle]) -> ModelBundle:
    """Fuse K single-model bundles (the same architecture and config) into
    one; the first bundle's preprocess and infer configs are used."""
    if len(bundles) < 2:
        raise ValueError("ensemble needs >= 2 bundles")
    nc = bundles[0].num_classes
    if any(b.num_classes != nc for b in bundles):
        raise ValueError("ensemble members disagree on num_classes")
    return ModelBundle(
        apply_fn=ensemble_apply_fn([b.apply_fn for b in bundles], nc),
        params=[b.params for b in bundles],
        num_classes=nc,
        preprocess=bundles[0].preprocess,
        infer=bundles[0].infer,
    )
