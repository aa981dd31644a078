"""PyTorch + CUDA port of ``runet_tpu`` for NVIDIA Hopper (H100).

Module names and layout follow ``runet_tpu`` so each counterpart is easy to
find. The 3x3x3 conv+InstanceNorm-moment kernels and weight-gradient kernels
that the JAX package wrote in Pallas are hand-written CUDA here
(``kernels/csrc``); everything the JAX package left to XLA is ordinary
torch. The package imports nothing of JAX or of ``runet_tpu``.

Entry points take a ``device`` argument that defaults to CUDA and raise when
no GPU is present; pass ``device="cpu"`` to run the plain PyTorch versions.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when CUDA is asked for (explicitly or by default) and absent —
    a run never drops quietly to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "runet_tpu_torch: CUDA device requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
