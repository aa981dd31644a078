"""``lane_wait_share.serve``: of the time the window's cases spent in
``predict_cases`` (the program's ``serving.case`` spans, pulled from the
feed to yielded), the share they waited for a serving lane (``serving.queue``:
submitted to a lane taken), in %. The closed loop keeps ``workers + 1``
cases submitted, so one of them always waits."""

from benchmark.program_spans import lane_wait_share as read  # noqa: F401
