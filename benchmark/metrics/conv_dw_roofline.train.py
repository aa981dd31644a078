"""``conv_dw_roofline.train``: the weight gradients of every 3x3x3
convolution (stride 1 and stride 2) of every step in the traced window, as
the share of their device time the roofline bound accounts for. Bound per
layer: max(operations / peak bf16 rate, bytes / peak bandwidth), bytes being
x and g read once and the f32 gradient written once (``benchmark/work.py``).
Device time: the program's weight-gradient kernels and the split reduction
launched right after each."""

from benchmark import trace
from benchmark.work import bound_seconds, unet_layers

KERNELS = ("conv3x3_dw_s1_kernel", "conv3x3_dw_s2_kernel")
FOLLOWER = "reduce_splits"


def read(ctx):
    w = ctx.window
    if ctx.peaks is None or not w.get("steps"):
        return None
    dws = trace.matching(ctx.ops, KERNELS)
    ops = dws + trace.followers(ctx.ops, dws, FOLLOWER)
    device_s = sum(o.end_ns - o.start_ns for o in ops) / 1e9
    if device_s <= 0:
        return None
    per_step = sum(bound_seconds(layer.flops, layer.dw_bytes, ctx.peaks)
                   for layer in unet_layers(w["model"], w["patch"], w["batch"])
                   if layer.kind in ("s1", "s2"))
    return 100.0 * per_step * w["steps"] / device_s
