"""``idle_case.serve``: the card's idle time charged to the program's
``case.*`` spans (issuing the coarse and ROI device programs, staging each
ROI) and to the self time of ``serving.run`` (the rest of a case's own host
work), as a share of the traced window in %. How idle time is charged:
``benchmark/program_spans.py``."""

from benchmark.program_spans import serve_idle_layer


def read(ctx):
    return serve_idle_layer(ctx, "Case")
