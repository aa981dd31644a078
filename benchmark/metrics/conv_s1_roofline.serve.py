"""``conv_s1_roofline.serve``: the stride-1 3x3x3 convolutions of every case
served in the traced window, as the share of their device time that the
roofline bound accounts for. Bound per layer: max(operations / peak bf16
rate, bytes / peak bandwidth), bytes being x, w and y once each and the f32
moments (``benchmark/work.py``), at the grids of the box lists the
served maps match, the fine net's once per augmentation pass. Device time: the program's stride-1
conv + moment kernels and the moment reduction launched right after each."""

from benchmark.readers import serve_conv_s1_roofline

KERNELS = ("conv3x3_stats",)
FOLLOWER = "reduce_moments"


def read(ctx):
    return serve_conv_s1_roofline(ctx, KERNELS, FOLLOWER)
