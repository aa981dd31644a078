"""``idle_preprocess.serve``: the card's idle time charged to the program's
``preprocess.*`` spans (host striding and padding of the coarse input, the
upload's quantisation), as a share of the traced window in %. How idle
time is charged: ``benchmark/program_spans.py``."""

from benchmark.program_spans import serve_idle_layer


def read(ctx):
    return serve_idle_layer(ctx, "Preprocess")
