"""``mfu.train``: three times the forward operations of every image trained
in the traced window (forward, dx and dw; no recomputation counted), over
the window and the card's peak bf16 rate."""

from benchmark.work import forward_flops


def read(ctx):
    w = ctx.window
    if ctx.peaks is None or not w.get("steps"):
        return None
    flops = 3 * forward_flops(w["model"], w["patch"], w["batch"]) * w["steps"]
    return 100.0 * flops / (ctx.window_s * ctx.peaks["bf16_flops"])
