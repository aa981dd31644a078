"""Flat-file model export for serving.

Counterpart of ``runet_tpu/utils/export.py``. Checkpoints
(``train/checkpoint.py``: ``ckpt/step_*.pt`` and ``index.json``) are the
training-time format; deployment wants one self-contained artifact.
``save_params_npz`` writes one ``.npz`` in the JAX package's format: the
parameters under flat ``/``-joined flax keys in flax's shapes
(``params.torch_to_flax``), and the run config JSON under
``__config_json__`` as uint8. A file exported here loads in
``runet_tpu.utils.export.load_params_npz``, and one exported there loads in
``load_params_npz`` here. Only the ``.npz`` crosses between the packages: a
JAX run directory (Orbax checkpoints) is not readable here, nor a run
directory of this package there.

``export_program`` stands in for the JAX package's ``export_stablehlo``: it
writes the model's forward as a ``torch.export`` ``ExportedProgram``
(``torch.export.save``), parameters included. As the JAX package exports
its pure-XLA variant, it traces the plain PyTorch path on the CPU, so the
artifact holds no custom kernel and runs wherever PyTorch does. Serving
never loads it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

_CFG_KEY = "__config_json__"
_FINGERPRINT_KEY = "__fingerprint__"


def save_params_npz(path: str | Path, params: dict, config_json: str | None = None) -> Path:
    """Write flat ``/``-keyed arrays (``params.torch_to_flax`` of a model, or
    what ``load_params_npz`` returns) and an optional config JSON to one
    .npz."""
    path = Path(path)
    flat = {k: np.asarray(v) for k, v in params.items()}
    if config_json is not None:
        flat[_CFG_KEY] = np.frombuffer(config_json.encode(), dtype=np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)
    return path


def load_params_npz(path: str | Path) -> tuple[dict[str, np.ndarray], str | None]:
    """Returns (flat ``/``-keyed arrays as stored, config_json | None). A
    ``__fingerprint__`` entry (the committed ``artifacts/bench_params_*.npz``)
    is dropped, as ``params.load_npz`` drops it. The JAX package returns the
    same arrays as a nested tree."""
    cfg = None
    flat = {}
    with np.load(Path(path)) as z:
        for k in z.files:
            if k == _CFG_KEY:
                cfg = z[k].tobytes().decode()
            elif k != _FINGERPRINT_KEY:
                flat[k] = z[k]
    return flat, cfg


def checkpoint_params(ckpt, step: int) -> dict[str, np.ndarray]:
    """The f32 master parameters of checkpoint ``step`` of a
    ``CheckpointManager``, as flat flax keys."""
    from runet_tpu_torch.params import state_to_flax

    return state_to_flax(ckpt.restore(step, map_location="cpu")["params"])


def export_run(run_dir: str | Path, out_path: str | Path, average: int = 1) -> Path:
    """Export a training run's BEST checkpoint to a serving .npz.

    ``run_dir`` is a run directory of this package (``config.json`` and
    ``ckpt/``). ``average > 1``: export the element-wise MEAN of the
    best-``average`` retained checkpoints' f32 master parameters instead
    (SWA-style weight averaging; InstanceNorm keeps no running statistics
    to invalidate), summed best first, divided and cast back as the JAX
    package does. Distinct from ``infer/ensemble.py`` (K forwards, averaged
    probabilities): averaging costs nothing at serving time.
    """
    from runet_tpu_torch.train.checkpoint import CheckpointManager

    run_dir = Path(run_dir)
    cfg_json = (run_dir / "config.json").read_text()
    ckpt = CheckpointManager(run_dir / "ckpt")
    if average > 1:
        steps = ckpt.best_steps(average)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {run_dir / 'ckpt'}")
        acc = None
        for s in steps:
            p = checkpoint_params(ckpt, s)
            acc = p if acc is None else {k: np.add(acc[k], p[k]) for k in acc}
        mean = {k: (a / len(steps)).astype(a.dtype) for k, a in acc.items()}
        return save_params_npz(out_path, mean, cfg_json)
    # Explicit None check: a best step of 0 is falsy but must still win
    # over the latest checkpoint.
    step = ckpt.best_step()
    if step is None:
        step = ckpt.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {run_dir / 'ckpt'}")
    return save_params_npz(out_path, checkpoint_params(ckpt, step), cfg_json)


def export_program(
    out_path: str | Path,
    model_cfg,
    params: dict[str, np.ndarray],
    patch_size: tuple[int, int, int],
    batch: int = 1,
) -> Path:
    """Serialize the model forward as a ``torch.export`` ExportedProgram
    (``torch.export.save``), the parameters in its state. Input: ``(batch,
    *patch_size, in_channels)`` f32, HU-normalized as in preprocess; output:
    class logits (f32) at the same grid. ``torch.export.load(path).module()``
    runs it without this package.

    Traced on the CPU only: the model's kernel wrappers choose the CUDA
    kernel or the plain version by a Python branch on the tensor's device,
    which tracing resolves once, so a CPU trace records the plain PyTorch
    ops and no custom kernel.
    """
    from runet_tpu_torch.models.unet3d import UNet3D
    from runet_tpu_torch.params import load_state

    model = load_state(UNet3D(model_cfg, device="cpu"), params).eval()
    x = torch.zeros((batch, *patch_size, model_cfg.in_channels), dtype=torch.float32)
    with torch.no_grad():
        program = torch.export.export(model, (x,))
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, out_path)
    return out_path
