"""``conv_s1_roofline.train``: the stride-1 3x3x3 convolutions of every step
in the traced window, forward and input gradient (dx), as the share of their
device time the roofline bound accounts for. Bound per layer and pass:
max(operations / peak bf16 rate, bytes / peak bandwidth), bytes being the
operands read once and the result written once (and the forward's f32
moments), ``benchmark/work.py``. The first layer takes no dx. Device time:
the program's stride-1 conv kernels and the moment reduction launched right
after each."""

from benchmark import trace
from benchmark.work import bound_seconds, needs_dx, unet_layers

KERNELS = ("conv3x3_stats",)
FOLLOWER = "reduce_moments"


def read(ctx):
    w = ctx.window
    if ctx.peaks is None or not w.get("steps"):
        return None
    convs = trace.matching(ctx.ops, KERNELS)
    ops = convs + trace.followers(ctx.ops, convs, FOLLOWER)
    device_s = sum(o.end_ns - o.start_ns for o in ops) / 1e9
    if device_s <= 0:
        return None
    per_step = 0.0
    for layer in unet_layers(w["model"], w["patch"], w["batch"]):
        if layer.kind != "s1":
            continue
        per_step += bound_seconds(layer.flops, layer.fwd_bytes, ctx.peaks)
        if needs_dx(layer):
            per_step += bound_seconds(layer.flops, layer.dx_bytes, ctx.peaks)
    return 100.0 * per_step * w["steps"] / device_s
