"""Edge cases of the port, mirroring ``tests/test_robustness.py``: big-endian
NIfTI, non-finite and zero ``scl_slope``, garbage rejection, NaN in the
metrics log, the config JSON round trip, checkpoint keep-best and periodic
saves, and ``get_config`` on a JSON path. Where both packages have the
function, the port is also held to the JAX package on the same input."""

import json
import struct

import numpy as np
import pytest
import torch

from runet_tpu.config import get_config as jax_get_config
from runet_tpu.io.nifti import load_volume as jax_load_volume
from runet_tpu_torch.config import Config, ModelConfig, TrainConfig, get_config
from runet_tpu_torch.io.nifti import load_volume

PRESETS = ("coarse", "fine_kits", "cascade", "renal_anatomy", "dp_full")


def _nifti(endian: str, slope: float, inter: float, pixdim=(1.0, 1.5, 1.5, 3.0)) -> bytes:
    """A hand-built single-file NIfTI-1 of int16 0..7 in a 2x2x2 grid."""
    data = np.arange(8, dtype=f"{endian}i2").reshape(2, 2, 2)
    hdr = bytearray(348)
    struct.pack_into(f"{endian}i", hdr, 0, 348)
    struct.pack_into(f"{endian}8h", hdr, 40, 3, 2, 2, 2, 1, 1, 1, 1)
    struct.pack_into(f"{endian}h", hdr, 70, 4)  # int16
    struct.pack_into(f"{endian}h", hdr, 72, 16)
    struct.pack_into(f"{endian}8f", hdr, 76, *pixdim, 0, 0, 0, 0)
    struct.pack_into(f"{endian}f", hdr, 108, 352.0)
    struct.pack_into(f"{endian}f", hdr, 112, slope)
    struct.pack_into(f"{endian}f", hdr, 116, inter)
    hdr[344:348] = b"n+1\x00"
    return bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")


def _load_both(path):
    vol, want = load_volume(path), jax_load_volume(path)
    assert vol.spacing == want.spacing
    np.testing.assert_array_equal(vol.data, want.data)
    assert vol.data.dtype == want.data.dtype
    return vol


def test_nifti_big_endian(tmp_path):
    p = tmp_path / "be.nii"
    p.write_bytes(_nifti(">", 1.0, 0.0))
    vol = _load_both(p)
    assert vol.spacing == (1.5, 1.5, 3.0)
    np.testing.assert_array_equal(vol.data, np.arange(8).reshape(2, 2, 2))


def test_nifti_nonfinite_scl_slope_means_no_scaling(tmp_path):
    p = tmp_path / "nanslope.nii"
    p.write_bytes(_nifti(">", float("nan"), float("nan")))
    vol = _load_both(p)
    assert np.isfinite(vol.data).all()
    np.testing.assert_array_equal(vol.data, np.arange(8).reshape(2, 2, 2))


def test_nifti_zero_slope_ignores_intercept(tmp_path):
    p = tmp_path / "zeroslope.nii"
    p.write_bytes(_nifti("<", 0.0, 5.0, pixdim=(1.0, 1.0, 1.0, 1.0)))
    vol = _load_both(p)
    np.testing.assert_array_equal(vol.data, np.arange(8).reshape(2, 2, 2))


def test_metrics_logger_nan_is_valid_json(tmp_path):
    from runet_tpu.train.metrics import MetricsLogger as JMetricsLogger
    from runet_tpu_torch.train.metrics import MetricsLogger

    records = []
    for cls, d in ((MetricsLogger, tmp_path / "port"), (JMetricsLogger, tmp_path / "jax")):
        logger = cls(d)
        logger.log(1, loss=float("nan"), dice=float("inf"), ok=0.5, tag="a")
        logger.close()
        rec = json.loads((d / "metrics.jsonl").read_text().strip())  # strict: no bare NaN
        assert rec["loss"] is None and rec["dice"] is None
        assert rec["ok"] == 0.5 and rec["tag"] == "a"
        rec.pop("wall_s")
        records.append(rec)
    assert records[0] == records[1]


def test_nifti_rejects_garbage(tmp_path):
    p = tmp_path / "bad.nii"
    p.write_bytes(b"\x00" * 400)
    with pytest.raises(ValueError):
        load_volume(p)
    with pytest.raises(ValueError):
        jax_load_volume(p)


def test_config_json_roundtrip_all_presets():
    for name in PRESETS:
        cfg = get_config(name)
        assert Config.from_json(cfg.to_json()) == cfg, name
        assert json.loads(cfg.to_json()) == json.loads(jax_get_config(name).to_json()), name


def _port_state():
    from runet_tpu_torch.models.unet3d import create_train_model
    from runet_tpu_torch.train.state import create_train_state

    torch.manual_seed(0)
    model = create_train_model(ModelConfig(num_classes=2, base_features=4, num_levels=2,
                                           compute_dtype="float32"), device="cpu")
    return create_train_state(model, TrainConfig())


def _saves(saves, tmp_path, **kw):
    """Run the same (step, metrics) saves through both managers; returns the
    port's manager, its state, and the JAX manager's retained steps and
    latest / best step. The JAX manager's retention does not read the saved
    tree, so it saves a small one."""
    from runet_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
    from runet_tpu_torch.train.checkpoint import CheckpointManager

    jmgr = JCheckpointManager(tmp_path / "jax", **kw)
    host = {"step": np.int32(0), "w": np.zeros(4, np.float32)}
    state = _port_state()
    mgr = CheckpointManager(tmp_path / "port", **kw)
    for step, metrics in saves:
        jmgr.save(step, host, metrics=metrics)
        jmgr.wait()
        mgr.save(step, state.state_dict(), metrics=metrics)
    want = (sorted(jmgr._mgr.all_steps()), jmgr.latest_step(), jmgr.best_step())
    jmgr.close()
    return mgr, state, want


def test_checkpoint_keep_best(tmp_path):
    mgr, state, want = _saves([(1, {"val_dice": 0.5}), (2, {"val_dice": 0.9}),
                               (3, {"val_dice": 0.7})], tmp_path, keep=2)
    assert mgr.latest_step() == 3
    assert mgr.best_step() == 2
    assert (mgr.all_steps(), mgr.latest_step(), mgr.best_step()) == want
    restored = mgr.restore(step=mgr.best_step())
    state.load_state_dict(restored)
    assert state.step == int(restored["step"])


def test_checkpoint_periodic_saves_survive_keep_best(tmp_path):
    """Periodic (metrics=None) saves are kept by the latest-N arm, the best
    validated ones by the best-K arm; the same steps as the JAX manager's."""
    saves = [(1, {"val_dice": 0.8}), (2, {"val_dice": 0.9}), (3, None), (4, None)]
    mgr, state, want = _saves(saves, tmp_path, keep=2, latest_keep=2)
    assert mgr.latest_step() == 4, "periodic save was garbage-collected"
    assert mgr.best_step() == 2
    assert (mgr.all_steps(), mgr.latest_step(), mgr.best_step()) == want
    assert int(mgr.restore(step=4)["step"]) == state.step
    mgr2, _, want2 = _saves(saves + [(5, None)], tmp_path / "more", keep=2, latest_keep=2)
    steps = set(mgr2.all_steps())
    assert {1, 2} <= steps and 5 in steps
    assert sorted(steps) == want2[0]


def test_get_config_accepts_json_file(tmp_path):
    cfg = get_config("coarse")
    p = tmp_path / "my.json"
    p.write_text(cfg.to_json())
    assert get_config(str(p)) == cfg
    assert json.loads(jax_get_config(str(p)).to_json()) == json.loads(cfg.to_json())
    with pytest.raises(KeyError, match="unknown preset"):
        get_config("nope_not_a_preset")
