"""The control's precision: the nearest step below the configuration's.

The configurations state bf16 compute, so the control is the reference with
every operand of a convolution and a projection rounded to fp8 (e4m3, one
scale per tensor, its largest magnitude at 448): the step a later change
would be tempted to take. The rounding passes gradients straight through, so
the training reference runs the same backward on the rounded operands.
``bf16`` rounds to the configurations' own precision instead: it reads how
far round-off moves the coarse stage's logits.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 at a per-tensor scale, back in f32."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach() if t.requires_grad else q


def bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, the configurations' own compute precision, back
    in f32: the round-off against which a near-tie of the coarse stage is
    read (``benchmark/control.py``)."""
    q = t.detach().to(torch.bfloat16).to(torch.float32)
    return t + (q - t).detach() if t.requires_grad else q
