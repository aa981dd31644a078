"""Debug / sanitizer mode.

Counterpart of ``runet_tpu/utils/debug.py``. The hazard that carries over
from JAX is the silent NaN/Inf (the JAX package's ``jax_debug_nans``).
``sanitize()`` is a context manager that, for a scoped block:

- turns on autograd's anomaly mode (``torch.autograd.set_detect_anomaly``),
  so a backward that produces NaN raises and names the forward op that
  made it;
- installs a global module forward hook that raises on the first module
  whose floating output holds a non-finite value, and names the module.

Both slow execution (the hook reads every output back), so production
paths leave them off; the CLI exposes it as ``--debug``.

The JAX package's other two checks have no PyTorch meaning and no stand-in
here: tracer leaks (eager PyTorch has no tracer to escape a trace) and
``audit_donation`` (PyTorch does not donate a buffer to a call).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


def _non_finite(out):
    """The first floating tensor in ``out`` (a tensor or nested tuple /
    list of them) that holds a NaN or Inf, else None."""
    if isinstance(out, torch.Tensor):
        return out if out.is_floating_point() and not bool(torch.isfinite(out).all()) else None
    if isinstance(out, (tuple, list)):
        for o in out:
            bad = _non_finite(o)
            if bad is not None:
                return bad
    return None


def _check_forward(module, _inputs, output):
    bad = _non_finite(output)
    if bad is not None:
        raise FloatingPointError(
            f"sanitize: {type(module).__name__} produced a non-finite output "
            f"(shape {tuple(bad.shape)}, {int((~torch.isfinite(bad)).sum())} NaN/Inf values)")


@contextmanager
def sanitize(debug_nans: bool = True):
    """Scoped sanitizer mode: anomaly detection and the non-finite forward
    check (``debug_nans=False`` turns both off). The previous anomaly
    setting is restored and the hook removed on exit."""
    prev_anomaly = torch.is_anomaly_enabled()
    prev_check_nan = torch.is_anomaly_check_nan_enabled()
    handle = None
    try:
        if debug_nans:
            torch.autograd.set_detect_anomaly(True)
            handle = torch.nn.modules.module.register_module_forward_hook(_check_forward)
        yield
    finally:
        if handle is not None:
            handle.remove()
        torch.autograd.set_detect_anomaly(prev_anomaly, check_nan=prev_check_nan)
