"""``blocking_copies_per_step.train``: the program's ``blocking_copies``
counter (each pageable host-to-device copy and each host read of a device
value in the step path, each of which waits for the card) summed over the
``train_step.step`` span trees that lie in the traced window, per step."""

from benchmark.program_spans import per_step_counter


def read(ctx):
    return per_step_counter(ctx, "blocking_copies")
