"""The work model at one shape, counted by hand."""

from benchmark import work
from benchmark.peaks import H100_SXM

MODEL = {"in_channels": 1, "base_features": 4, "max_features": 8, "num_levels": 3,
         "num_classes": 3}


def test_layers_and_operations_by_hand():
    layers = work.unet_layers(MODEL, (8, 8, 4), batch=2)
    assert [(l.name, l.kind, l.cin, l.cout, l.vin, l.vout) for l in layers] == [
        ("enc0.0", "s1", 1, 4, 256, 256),
        ("enc0.1", "s1", 4, 4, 256, 256),
        ("enc1.0", "s2", 4, 8, 256, 32),
        ("enc1.1", "s1", 8, 8, 32, 32),
        ("enc2.0", "s2", 8, 8, 32, 4),
        ("enc2.1", "s1", 8, 8, 4, 4),
        ("dec1.proj", "proj", 8, 64, 4, 4),
        ("dec1.0", "s1", 16, 8, 32, 32),
        ("dec1.1", "s1", 8, 8, 32, 32),
        ("dec0.proj", "proj", 8, 32, 32, 32),
        ("dec0.0", "s1", 8, 4, 256, 256),
        ("dec0.1", "s1", 4, 4, 256, 256),
        ("head", "head", 4, 3, 256, 256),
    ]
    # enc0.1: 2 samples x 256 voxels x 27 taps x 4 x 4 channels x 2 ops.
    assert layers[1].flops == 2 * 2 * 256 * 27 * 4 * 4 == 442368
    # x and y bf16 (2 x 256 x 4 x 2 bytes each), w bf16 (27 x 4 x 4 x 2),
    # f32 sums and squares (2 x 4 x 2 x 4).
    assert layers[1].fwd_bytes == 4096 + 864 + 4096 + 64
    assert layers[1].dx_bytes == 4096 + 864 + 4096
    assert layers[1].dw_bytes == 4096 + 4096 + 27 * 16 * 4
    # enc1.0 reads the level-0 grid and writes level 1's.
    assert layers[2].flops == 2 * 2 * 32 * 27 * 4 * 8
    assert layers[2].fwd_bytes == 2 * 256 * 4 * 2 + 27 * 32 * 2 + 2 * 32 * 8 * 2 + 2 * 8 * 2 * 4
    assert layers[6].flops == 2 * 2 * 4 * 8 * 64
    assert work.forward_flops(MODEL, (8, 8, 4), 2) == sum(l.flops for l in layers)
    assert not work.needs_dx(layers[0]) and work.needs_dx(layers[1])


def test_bound_takes_the_larger_of_the_two():
    assert work.bound_seconds(989e12, 0.0, H100_SXM) == 1.0
    assert work.bound_seconds(0.0, 3.35e12, H100_SXM) == 1.0
    assert work.bound_seconds(989e9, 3.35e12, H100_SXM) == 1.0
