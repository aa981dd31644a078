"""``idle_host_post.serve``: the card's idle time charged to the program's
``host_post.*`` spans (coarse components, the ROI paste, keep-largest), as a
share of the traced window in %. How idle time is charged:
``benchmark/program_spans.py``."""

from benchmark.program_spans import serve_idle_layer


def read(ctx):
    return serve_idle_layer(ctx, "Host post")
