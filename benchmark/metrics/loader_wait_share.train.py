"""``loader_wait_share.train``: the share of the window the host spent in
``next(loader)``, by the benchmark's own clock around each call."""


def read(ctx):
    w = ctx.window
    if not w.get("elapsed_s"):
        return None
    return 100.0 * w["loader_wait_s"] / w["elapsed_s"]
