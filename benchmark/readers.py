"""The per-layer readers that more than one metric shares: a serving cell's
model share of peak, its stride-1 convolutions' share of their roofline,
and the device's idle share. Each metric's file under ``metrics/`` says
what it reads, names the kernels it times, and calls one of these."""

from benchmark import trace
from benchmark.work import bound_seconds, forward_flops, unet_layers

def serve_mfu(ctx):
    w = ctx.window
    if ctx.peaks is None or not w.get("served"):
        return None
    total = 0
    for i in w["served"]:
        g = w["grids"][i]
        total += forward_flops(w["coarse_model"], g["coarse"])
        total += w["tta_passes"] * sum(forward_flops(w["fine_model"], r) for r in g["rois"])
    return 100.0 * total / (ctx.window_s * ctx.peaks["bf16_flops"])


def serve_conv_s1_roofline(ctx, kernels, follower):
    """``kernels``: name parts of the stride-1 conv kernels; ``follower``:
    the second pass launched right after each."""
    w = ctx.window
    if ctx.peaks is None or not w.get("served"):
        return None
    convs = trace.matching(ctx.ops, kernels)
    ops = convs + trace.followers(ctx.ops, convs, follower)
    device_s = sum(o.end_ns - o.start_ns for o in ops) / 1e9
    if device_s <= 0:
        return None

    def bound(model, grid):
        return sum(bound_seconds(layer.flops, layer.fwd_bytes, ctx.peaks)
                   for layer in unet_layers(model, grid) if layer.kind == "s1")

    total = 0.0
    for i in w["served"]:
        g = w["grids"][i]
        total += bound(w["coarse_model"], g["coarse"])
        total += w["tta_passes"] * sum(bound(w["fine_model"], r) for r in g["rois"])
    return 100.0 * total / device_s


def device_idle(ctx):
    if not ctx.ops or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(ctx.ops) / ctx.window_s)
