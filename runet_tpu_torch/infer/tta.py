"""Test-time augmentation: mirror-flip averaged inference.

Counterpart of ``runet_tpu/infer/tta.py``. TTA is a wrapper around a
bundle's ``apply_fn``, so every consumer (single pass, windows, the
cascade's ROI stages) picks it up unchanged. ``torch.flip`` copies; the
2^k forwards run one after another on the device, each softmax folded into
one f32 accumulator.

Contract: the wrapper returns the LOG of the flip-averaged f32 softmax
(``+1e-12``), so a downstream ``softmax`` reproduces the averaged
probabilities and ``argmax`` is unaffected.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import torch


def flip_combinations(axes: tuple[int, ...]) -> tuple[tuple[int, ...], ...]:
    """All subsets of the given axes, the empty (identity) one first: k axes
    give 2^k variants."""
    out = []
    for r in range(len(axes) + 1):
        out.extend(itertools.combinations(axes, r))
    return tuple(out)


@lru_cache(maxsize=64)
def make_tta_apply(apply_fn, axes: tuple[int, ...] = (0, 1, 2)):
    """Wrap ``apply_fn(params, windows) -> logits`` with mirror-flip TTA.
    ``axes`` are volume axes (0/1/2); windows are (B, X, Y, Z, C), so the
    flips act on window axes + 1. Cached on (apply_fn, axes), so a bundle
    gets one wrapper."""
    combos = flip_combinations(tuple(int(a) + 1 for a in axes))

    def tta_fn(params, windows):
        mean = None
        for flip_axes in combos:
            w = torch.flip(windows, flip_axes) if flip_axes else windows
            probs = torch.softmax(apply_fn(params, w).float(), dim=-1)
            if flip_axes:
                probs = torch.flip(probs, flip_axes)
            mean = probs if mean is None else mean + probs
        return torch.log(mean / len(combos) + 1e-12)

    return tta_fn


def effective_apply_fn(bundle):
    """The bundle's ``apply_fn``, TTA-wrapped when its InferConfig asks."""
    if bundle.infer.tta:
        return make_tta_apply(bundle.apply_fn, tuple(bundle.infer.tta_axes))
    return bundle.apply_fn
