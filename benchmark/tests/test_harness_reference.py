"""The plain reference against the program's plain CPU path at a small
size, and the coarse stage's near-tie box variants on a hand-made mask."""

import numpy as np
import pytest
import torch

from benchmark.reference import cascade, unet
from benchmark.weights import load_into, seeded_init

MODEL = {"in_channels": 1, "base_features": 4, "max_features": 16, "num_levels": 3,
         "num_classes": 3, "negative_slope": 0.01, "norm_eps": 1e-5}


def test_unet_forward_matches_the_programs_f32_path():
    from runet_tpu_torch.config import ModelConfig
    from runet_tpu_torch.models.unet3d import UNet3D

    w = seeded_init(MODEL, 11, "cpu")
    w["Conv_0/bias"] = torch.tensor([0.1, -0.2, 0.3])
    for k in w:
        if k.endswith("InstanceNorm_0/scale"):
            w[k] = 1.0 + 0.1 * torch.arange(w[k].numel(), dtype=torch.float32)
    model = UNet3D(ModelConfig(**{k: MODEL[k] for k in ("in_channels", "base_features",
                                                         "max_features", "num_levels",
                                                         "num_classes")},
                               compute_dtype="float32"), device="cpu", trainable=True)
    load_into(model, w)
    x = torch.randn(2, 16, 8, 12, 1, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = model(x)  # (B, X, Y, Z, K)
        got = unet.forward(w, MODEL, x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _coarse(margin: np.ndarray, boxes_for_ids=None) -> cascade.Coarse:
    c = object.__new__(cascade.Coarse)
    c.margin = margin
    c.mask = margin > 0
    c.lab, _, sizes = cascade._components(c.mask)
    order = np.argsort(sizes)[::-1]
    c.ids = [int(i) + 1 for i in order[:2]]
    c.boxes = [cascade._bbox(c.lab == i) for i in c.ids]
    return c


def test_variants_rank_the_faces_nearest_to_a_tie():
    margin = np.full((12, 12, 12), -5.0, np.float32)
    margin[3:8, 3:8, 3:8] = 5.0
    margin[3, 3:8, 3:8] = 0.01  # the x-low plane barely in
    margin[8, 5, 5] = -0.02  # one voxel just past x-high barely out
    c = _coarse(margin)
    lo, hi = c.boxes[0]
    assert lo.tolist() == [3, 3, 3] and hi.tolist() == [8, 8, 8]
    v = c.variants(2)
    assert [m for m, _ in v] == [np.float32(0.01), np.float32(0.02)]
    assert [b[0][0].tolist() for _, b in v] == [[4, 3, 3], [3, 3, 3]]
    assert [b[0][1].tolist() for _, b in v] == [[8, 8, 8], [9, 8, 8]]


class _Fake:
    """A case whose answer for a box list is its first box's x-low face;
    the x-low face can move inward at margin 5."""

    def __init__(self):
        self.coarse = _coarse(np.pad(np.full((4, 4, 4), 5.0, np.float32), 2,
                                     constant_values=-5.0))

    def labels(self, boxes):
        return np.full((2, 2, 2), int(boxes[0][0][0]), np.uint8)


@pytest.mark.parametrize("served,tie_margin,want", [
    (2, 0.0, (0.0, 0.0)),  # the reference's own boxes
    (3, 5.0, (0.0, 5.0)),  # a face moved at a margin within the tie bound
    (3, 4.9, (1.0, 0.0)),  # the same face past the tie bound: not forgiven
    (9, 5.0, (1.0, 0.0)),  # no box list gives this answer
])
def test_a_served_map_is_judged_by_the_box_lists_within_the_tie_bound(served, tie_margin, want):
    from benchmark.drivers import serve

    m, margin, _ = serve.judge(_Fake(), np.full((2, 2, 2), served, np.uint8), tie_margin)
    assert (m, margin) == want
