"""``idle_augment.train``: the time the card was idle while the step thread
was inside the program's ``train_step.augment`` span, as a share of the
traced window in %. Device and host clocks are tied as
``benchmark/program_spans.py`` says."""

from benchmark.program_spans import step_idle


def read(ctx):
    return step_idle(ctx, "train_step.augment")
