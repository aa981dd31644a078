"""The U-Net's work, counted from shapes: operations and bytes per layer.

The yardstick of the model-level and kernel-level metrics. Counts are what
the algorithm needs, whatever implements it: a 3x3x3 convolution is
2 * 27 * Cin * Cout operations per output voxel (its zero padding and any
channel padding a kernel adds do not count), and each operand is read once
and each result written once, in the compute dtype (bf16, 2 bytes); the
per-(sample, channel) moments of a forward conv and a weight gradient are
f32. Normalisation, activation, softmax and copies are not counted as
operations.

The layers follow the architecture of ``reference/unet.py``: per level two
convs (level 0's first at stride 1, every deeper level's first at stride 2),
per decoder level a 1x1x1 projection to 8F channels at the coarser grid and
two stride-1 convs over the 2F concatenation, and a 1x1x1 head.
"""

from __future__ import annotations

import dataclasses
from math import prod

BF16 = 2
F32 = 4


@dataclasses.dataclass(frozen=True)
class Layer:
    name: str
    kind: str  # "s1" (3x3x3 stride 1), "s2" (3x3x3 stride 2), "proj", "head"
    cin: int
    cout: int
    vin: int  # input voxels per sample
    vout: int  # output voxels per sample
    batch: int

    @property
    def taps(self) -> int:
        return 27 if self.kind in ("s1", "s2") else 1

    @property
    def flops(self) -> int:
        """Forward operations; dx and dw need as many each."""
        return 2 * self.batch * self.vout * self.taps * self.cin * self.cout

    @property
    def weight_bytes(self) -> int:
        return self.taps * self.cin * self.cout * BF16

    @property
    def x_bytes(self) -> int:
        return self.batch * self.vin * self.cin * BF16

    @property
    def y_bytes(self) -> int:
        return self.batch * self.vout * self.cout * BF16

    @property
    def fwd_bytes(self) -> int:
        """x, w and y once each, and the f32 sums and sums of squares."""
        moments = 2 * self.batch * self.cout * F32 if self.kind in ("s1", "s2") else 0
        return self.x_bytes + self.weight_bytes + self.y_bytes + moments

    @property
    def dx_bytes(self) -> int:
        """g and w read once, dx written once."""
        return self.y_bytes + self.weight_bytes + self.x_bytes

    @property
    def dw_bytes(self) -> int:
        """x and g read once, the f32 weight gradient written once."""
        return self.x_bytes + self.y_bytes + self.taps * self.cin * self.cout * F32


def level_features(model: dict) -> list[int]:
    return [min(model["base_features"] * 2 ** i, model["max_features"])
            for i in range(model["num_levels"])]


def unet_layers(model: dict, grid, batch: int = 1) -> list[Layer]:
    """Every counted layer of the U-Net of ``model`` (a configuration's
    ``model`` section) on a (X, Y, Z) ``grid``, in forward order."""
    feats = level_features(model)
    n = len(feats)
    if any(s % 2 ** (n - 1) for s in grid):
        raise ValueError(f"grid {tuple(grid)} not divisible by {2 ** (n - 1)}")
    vox = [prod(s // 2 ** lvl for s in grid) for lvl in range(n)]
    out: list[Layer] = []
    cin = model["in_channels"]
    for lvl, f in enumerate(feats):
        if lvl == 0:
            out.append(Layer(f"enc{lvl}.0", "s1", cin, f, vox[0], vox[0], batch))
        else:
            out.append(Layer(f"enc{lvl}.0", "s2", cin, f, vox[lvl - 1], vox[lvl], batch))
        out.append(Layer(f"enc{lvl}.1", "s1", f, f, vox[lvl], vox[lvl], batch))
        cin = f
    for lvl in reversed(range(n - 1)):
        f = feats[lvl]
        out.append(Layer(f"dec{lvl}.proj", "proj", feats[lvl + 1], 8 * f, vox[lvl + 1],
                         vox[lvl + 1], batch))
        out.append(Layer(f"dec{lvl}.0", "s1", 2 * f, f, vox[lvl], vox[lvl], batch))
        out.append(Layer(f"dec{lvl}.1", "s1", f, f, vox[lvl], vox[lvl], batch))
    out.append(Layer("head", "head", feats[0], model["num_classes"], vox[0], vox[0], batch))
    return out


def forward_flops(model: dict, grid, batch: int = 1) -> int:
    return sum(layer.flops for layer in unet_layers(model, grid, batch))


def bound_seconds(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the chip could take: the larger of operations over
    peak bf16 rate and bytes over peak memory bandwidth."""
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])


def needs_dx(layer: Layer) -> bool:
    """The first layer's input is the image, which takes no gradient."""
    return layer.name != "enc0.0"
