"""``mfu.tta``: the served model's operations over the traced window, as a
share of the card's peak bf16 rate. The operations are the work model's
(``benchmark/work.py``) at the grids the program's nets ran on, those of
the box lists its served maps match (``drivers/serve.py``): the coarse net
on its canonical grid and the fine net on each ROI's padded grid, once per
test-time augmentation pass."""

from benchmark.readers import serve_mfu as read  # noqa: F401
