"""The port's ``utils/export.py`` against ``runet_tpu.utils.export``: the
``.npz`` crosses between the packages both ways (keys, shapes, config and
values exact; a JAX-made file drives the port's forward within the model
parity tolerance), ``export_run`` picks and averages checkpoints as the JAX
package does, and ``export_program`` reloads to the model's CPU forward."""

import numpy as np
import pytest
import torch

import jax
from flax.traverse_util import flatten_dict

from runet_tpu.config import ModelConfig as JModel
from runet_tpu.models.unet3d import create_model as jcreate_model
from runet_tpu.models.unet3d import init_params as jinit_params
from runet_tpu.utils import export as jexport
from runet_tpu_torch.config import Config, ModelConfig, PreprocessConfig, TrainConfig, get_config
from runet_tpu_torch.models.unet3d import UNet3D, create_train_model, init_params
from runet_tpu_torch.params import ARTIFACT_DIR, load_npz, load_state, torch_to_flax
from runet_tpu_torch.train.checkpoint import CheckpointManager
from runet_tpu_torch.train.state import create_train_state
from runet_tpu_torch.utils import export as texport

SMALL = dict(num_classes=3, base_features=4, max_features=8, num_levels=3,
             compute_dtype="float32")


def _model(seed=0, **kw):
    m = UNet3D(ModelConfig(**{**SMALL, **kw}), device="cpu")
    return init_params(m, torch.Generator().manual_seed(seed))


def test_port_npz_loads_in_jax_exactly(tmp_path):
    m = _model()
    cfg = Config(model=m.cfg)
    p = texport.save_params_npz(tmp_path / "m.npz", torch_to_flax(m), cfg.to_json())
    tree, cfg_json = jexport.load_params_npz(p)
    got = {"/".join(k): v for k, v in flatten_dict(tree).items()}
    want = torch_to_flax(m)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)
    assert cfg_json == cfg.to_json()
    # And the JAX package's model takes that tree.
    from runet_tpu.config import Config as JConfig

    jm = jcreate_model(JConfig.from_json(cfg_json).model)
    x = np.random.default_rng(0).normal(size=(1, 16, 16, 16, 1)).astype(np.float32)
    assert jm.apply({"params": tree}, x).shape == (1, 16, 16, 16, 3)


def test_jax_npz_drives_the_port_forward(tmp_path):
    from runet_tpu.config import Config as JConfig

    jcfg = JConfig(model=JModel(**SMALL))
    jm = jcreate_model(jcfg.model)
    params = jax.device_get(jinit_params(jm, jax.random.key(3), (16, 16, 16)))
    p = jexport.save_params_npz(tmp_path / "j.npz", params, jcfg.to_json())
    flat, cfg_json = texport.load_params_npz(p)
    cfg = Config.from_json(cfg_json)
    assert cfg.model == ModelConfig(**SMALL)
    model = load_state(UNet3D(cfg.model, device="cpu"), flat).eval()
    x = np.random.default_rng(1).normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply({"params": params}, x))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_load_drops_the_fingerprint_of_committed_artifacts():
    path = ARTIFACT_DIR / "bench_params_coarse.npz"
    flat, cfg_json = texport.load_params_npz(path)
    assert cfg_json is None and "__fingerprint__" not in flat
    ref = load_npz(path)
    assert sorted(flat) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(flat[k].astype(np.float32), v)
    # The file serves: its arrays load into the coarse preset's model.
    load_state(UNet3D(get_config("coarse").model, device="cpu"), flat)


def _run_dir(tmp_path, metrics_by_step):
    """A run dir of this package holding one checkpoint per step, each with
    other weights (seed = step) and the given val_dice (None: periodic)."""
    cfg = Config(model=ModelConfig(**SMALL), preprocess=PreprocessConfig(hu_stats=None),
                 train=TrainConfig(patch_size=(16, 16, 16)))
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.json").write_text(cfg.to_json())
    ckpt = CheckpointManager(run / "ckpt", keep=5, latest_keep=5)
    states = {}
    for step, dice in metrics_by_step.items():
        model = create_train_model(cfg.model, "cpu")
        init_params(model, torch.Generator().manual_seed(step))
        state = create_train_state(model, cfg.train)
        state.step = step
        ckpt.save(step, state.state_dict(), None if dice is None else {"val_dice": dice})
        states[step] = torch_to_flax(model)
    return run, cfg, ckpt, states


def test_export_run_takes_the_best_step_even_when_it_is_zero(tmp_path):
    run, cfg, _, states = _run_dir(tmp_path, {0: 0.9, 5: 0.1, 7: None})
    flat, cfg_json = texport.load_params_npz(texport.export_run(run, tmp_path / "best.npz"))
    assert cfg_json == cfg.to_json()
    for k, v in states[0].items():
        np.testing.assert_array_equal(flat[k], v)


def test_export_run_falls_back_to_the_latest_step(tmp_path):
    run, _, _, states = _run_dir(tmp_path, {2: None, 4: None})
    flat, _ = texport.load_params_npz(texport.export_run(run, tmp_path / "latest.npz"))
    for k, v in states[4].items():
        np.testing.assert_array_equal(flat[k], v)


def test_export_run_average_is_the_best_first_sum_over_k(tmp_path):
    run, _, ckpt, states = _run_dir(tmp_path, {2: 0.3, 4: 0.8, 6: 0.5})
    assert ckpt.best_steps(2) == [4, 6]
    p = texport.export_run(run, tmp_path / "avg.npz", average=2)
    flat, _ = texport.load_params_npz(p)
    tree, _ = jexport.load_params_npz(p)  # and the JAX package reads it
    jflat = {"/".join(k): v for k, v in flatten_dict(tree).items()}
    assert sorted(flat) == sorted(states[4])
    for k in states[4]:
        want = ((states[4][k] + states[6][k]) / 2).astype(np.float32)
        assert flat[k].dtype == np.float32
        np.testing.assert_array_equal(flat[k], want)
        np.testing.assert_array_equal(jflat[k], want)
    with pytest.raises(FileNotFoundError):
        empty = tmp_path / "empty"
        empty.mkdir()
        (empty / "config.json").write_text(Config().to_json())
        texport.export_run(empty, tmp_path / "none.npz", average=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_program_reloads_to_the_cpu_forward(tmp_path, dtype):
    m = _model(seed=4, compute_dtype=dtype)
    flat = torch_to_flax(m)
    path = texport.export_program(tmp_path / "fwd.pt2", m.cfg, flat, (16, 16, 16), batch=2)
    program = torch.export.load(path)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 16, 16, 16, 1))
                         .astype(np.float32))
    ref = load_state(UNet3D(m.cfg, device="cpu"), flat).eval()
    with torch.no_grad():
        got = program.module()(x)
        want = ref(x)
    assert got.shape == (2, 16, 16, 16, 3) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # Portable: no custom op of the port in the graph.
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert not any("runet" in t for t in targets), targets


def test_save_accepts_flat_arrays_and_keeps_their_dtype(tmp_path):
    flat = {k: v.astype(np.float16) for k, v in torch_to_flax(_model()).items()}
    p = texport.save_params_npz(tmp_path / "h.npz", flat)
    got, cfg_json = texport.load_params_npz(p)
    assert cfg_json is None
    for k, v in flat.items():
        assert got[k].dtype == np.float16
        np.testing.assert_array_equal(got[k], v)
    load_state(UNet3D(ModelConfig(**SMALL), device="cpu"), got)
