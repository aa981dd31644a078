"""Published peaks of the chips the benchmark runs on (dense rates, no
sparsity), keyed by the name ``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 and fp16 (tensor cores), 80 GB
of HBM3 at 3.35 TB/s, at the full power limit of 700 W. A card set below
it runs slower; every run records the card's power limit beside these.
"""

from __future__ import annotations

H100_SXM = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12, "power_w": 700.0}

PEAKS = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
}


def peaks_for(device_name: str) -> dict | None:
    """The peaks of a card by its name; None for a card the table lacks
    (its shares of a peak are then not reported)."""
    return PEAKS.get(device_name)
