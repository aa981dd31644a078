"""The port's data parallelism and serving lanes against the JAX package's
``runet_tpu/parallel`` on the CPU.

The JAX side runs on fake CPU devices in this process (conftest); the port
runs one process per rank over gloo (``parallel/launch.spawn``), the rank
bodies in ``tests/torch_mp_workers.py``. Same inputs from numpy seeds and
the same weights (``params.flax_to_torch``), f32 compute, at the setup of
``tests/test_parallel.py``. Tolerances: DP against JAX's
``make_dp_train_step`` on as many devices, updated parameters within 1e-4
(the Adam step is about lr·sign(g) = 1e-3, reduced in another order), loss
rtol 1e-5, ``grad_norm`` rtol 1e-4; port against port, the JAX tests' own
(2e-5 plain, 5e-5 with augmentation) or bit for bit where the arithmetic
is the same.

``test_gspmd_jit_matches_shard_map`` has no counterpart: it holds XLA's
automatic partitioning of the one-device step against the explicit
``shard_map`` step, and PyTorch has no partitioner that turns a one-device
step into a multi-device one; the port's only data-parallel step is the
explicit one. ``test_dp_step_runs_fused_blocks_interpret`` neither: on the
CPU every rank runs the kernels' plain versions, and ``chip_smoke.py``'s
``parallel`` phase runs the CUDA kernels in each rank on the card.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runet_tpu.config import ModelConfig as JModelConfig
from runet_tpu.config import TrainConfig as JTrainConfig
from runet_tpu.models.unet3d import UNet3D as JUNet3D
from runet_tpu.models.unet3d import init_params as jax_init_params
from runet_tpu.parallel import comm as jcomm
from runet_tpu.parallel.dp import make_dp_train_step as jax_dp_step
from runet_tpu.train.state import create_train_state as jax_train_state
from runet_tpu_torch.config import CascadeConfig, ModelConfig, PreprocessConfig, TrainConfig
from runet_tpu_torch.data.augment import augment_batch
from runet_tpu_torch.models.unet3d import create_train_model
from runet_tpu_torch.params import load_state, torch_to_flax
from runet_tpu_torch.parallel import comm
from runet_tpu_torch.parallel.launch import spawn
from runet_tpu_torch.train.state import create_train_state, make_train_step
from tests import torch_mp_workers as workers

MCFG = dict(num_classes=2, base_features=4, num_levels=2, compute_dtype="float32")
TCFG = dict(lr=1e-3, warmup_steps=0, lr_schedule="const", weight_decay=0.0)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def setup():
    """``tests/test_parallel.py``'s setup: weights, images (8, 8³, 1) and
    labels, with the JAX DP step's results on 2 and 4 fake devices."""
    jmodel = JUNet3D(JModelConfig(**MCFG))
    params = jax_init_params(jmodel, jax.random.key(0), (8, 8, 8))
    flat = _flat(jax.device_get(params))
    rng = np.random.default_rng(0)
    images = rng.normal(size=(8, 8, 8, 8, 1)).astype(np.float32)
    labels = (rng.uniform(size=(8, 8, 8, 8)) < 0.3).astype(np.int32)
    jax_out = {}
    for n in (2, 4):
        mesh = jcomm.make_mesh(n)
        state = jcomm.replicate(mesh, jax_train_state(
            jmodel, jax.tree.map(jnp.copy, params), JTrainConfig(**TCFG)))
        im, lb = jcomm.shard_batch(mesh, (images, labels))
        state, aux = jax_dp_step(jmodel, mesh)(state, im, lb)
        jax_out[n] = (_flat(jax.device_get(state.params)), {k: float(v) for k, v in aux.items()})
    return flat, images, labels, jax_out


def _single(flat, images, labels, generators=None, seed=None):
    """The port's one-process step on the whole global batch."""
    model = load_state(create_train_model(ModelConfig(**MCFG), device="cpu"), flat)
    state = create_train_state(model, TrainConfig(**TCFG))
    aux = make_train_step(model, augment=seed is not None)(
        state, torch.from_numpy(images), torch.from_numpy(labels), generators, seed)
    return torch_to_flax(model), {k: float(v) for k, v in aux.items()}


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    from runet_tpu_torch.data.phantom import write_phantom_dataset

    flat, images, labels, _ = setup
    root = tmp_path_factory.mktemp("dp")
    write_phantom_dataset(root / "data", num_cases=2, shape=(48, 48, 32))
    rng = np.random.default_rng(5)
    superbatch = (rng.normal(size=(2, 8, 8, 8, 8, 1)).astype(np.float32),
                  (rng.uniform(size=(2, 8, 8, 8, 8)) < 0.3).astype(np.int32))
    results = spawn(workers.dp_suite, 2, args=(flat, MCFG, TCFG, images, labels, superbatch,
                                               str(root / "data"), str(root / "run")))
    return results, root / "run"


@pytest.fixture(scope="module")
def four_ranks(setup):
    flat, images, labels, _ = setup
    return spawn(workers.dp_four, 4, args=(flat, MCFG, TCFG, images, labels))


def _close(got: dict, want: dict, atol: float):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


def test_init_distributed_single_process_noop():
    assert comm.init_distributed() is False  # nothing to coordinate with
    assert comm.world_size() == 1 and comm.rank() == 0


def test_mesh_helpers(two_ranks):
    results, _ = two_ranks
    for rank, r in enumerate(results):
        assert r["init_again"] is True and r["world"] == 2  # idempotent
        assert r["mesh"] == {"names": (comm.DATA_AXIS,), "shape": (2,),
                             "data_axes": (comm.DATA_AXIS,), "data_size": 2, "data_index": rank}
    with pytest.raises(RuntimeError, match="init_distributed"):
        comm.make_mesh(1)


def test_hybrid_mesh_helpers(four_ranks):
    """The (dcn x ici) mesh: row-major, data axes (dcn, ici); the default on
    one host is (1, n); a shape that does not cover the world raises."""
    for rank, r in enumerate(four_ranks):
        assert r["hybrid"] == {"names": (comm.DCN_AXIS, comm.ICI_AXIS), "shape": (2, 2),
                               "data_axes": (comm.DCN_AXIS, comm.ICI_AXIS), "data_size": 4,
                               "data_index": rank}
        assert r["hybrid_default"] == (1, 4)
        assert r["bad_hybrid"] == "mesh (3, 3) != 4 devices"


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_jax(setup, two_ranks, four_ranks, world):
    """The port's DP step over ``world`` gloo ranks against JAX's
    ``make_dp_train_step`` over as many fake devices, on the same global
    batch and weights; every rank ends with the same parameters."""
    _, _, _, jax_out = setup
    ranks = [r["plain"] for r in two_ranks[0]] if world == 2 else [r["data"] for r in four_ranks]
    jparams, jaux = jax_out[world]
    params, aux = ranks[0]
    _close(params, jparams, 1e-4)
    np.testing.assert_allclose(aux["loss"], jaux["loss"], rtol=1e-5)
    np.testing.assert_allclose(aux["grad_norm"], jaux["grad_norm"], rtol=1e-4)
    for other, other_aux in ranks[1:]:
        assert all(np.array_equal(other[k], params[k]) for k in params)
        assert other_aux == aux


def test_dp_on_hybrid_mesh_matches_single_process(setup, four_ranks):
    """The DP step over a (2, 2) hybrid mesh (reduced over ici, then dcn)
    equals the one-process step on the whole batch."""
    flat, images, labels, _ = setup
    want, want_aux = _single(flat, images, labels)
    params, aux = four_ranks[0]["hybrid_step"]
    _close(params, want, 2e-5)
    np.testing.assert_allclose(aux["loss"], want_aux["loss"], atol=1e-5)
    np.testing.assert_allclose(aux["grad_norm"], want_aux["grad_norm"], rtol=1e-5)


def test_dp_augmented_step_matches_single_process(setup, two_ranks):
    """Each rank draws its samples' augmentations from (step seed, global
    sample index), so the augmented DP step equals the one-process
    augmented step on the same global batch."""
    flat, images, labels, _ = setup
    want, want_aux = _single(flat, images, labels, (torch.Generator(), torch.Generator()), 11)
    for r in two_ranks[0]:
        params, aux = r["augmented"]
        _close(params, want, 5e-5)
        np.testing.assert_allclose(aux["loss"], want_aux["loss"], atol=1e-5)


def test_augment_draws_follow_global_sample_index():
    """Draw for draw: the augmented global batch is the concatenation of
    its shards, each augmented from its first global index, bit for bit;
    without a seed the samples draw one after another."""
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.normal(size=(4, 8, 8, 8, 1)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 3, (4, 8, 8, 8)).astype(np.int64))

    def gens():
        return torch.Generator().manual_seed(99), torch.Generator().manual_seed(98)

    whole = augment_batch(images, labels, *gens(), elastic=True, seed=7)
    parts = [augment_batch(images[i:i + 2], labels[i:i + 2], *gens(), elastic=True, seed=7,
                           first_index=i) for i in (0, 2)]
    for j in range(2):
        assert torch.equal(whole[j], torch.cat([p[j] for p in parts]))
    other = augment_batch(images, labels, *gens(), elastic=True, seed=8)
    assert not torch.equal(whole[0], other[0])
    a = augment_batch(images, labels, *gens())
    b = augment_batch(images, labels, *gens())
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0][0], a[0][1])


def test_dp_multi_step_matches_sequence(two_ranks):
    """The K = 2 DP chunk leaves the parameters of two DP steps bit for bit
    (the same per-step seeds) and returns the chunk's mean aux."""
    for r in two_ranks[0]:
        assert r["chunk_equal"]
        for k, v in r["chunk_aux"].items():
            np.testing.assert_allclose(v, np.mean([a[k] for a in r["single_aux"]]), rtol=1e-6)


def test_shard_batch_and_replicate(two_ranks):
    results, _ = two_ranks
    whole = np.arange(8 * 3).reshape(8, 3)
    for rank, r in enumerate(results):
        np.testing.assert_array_equal(r["shard"], whole[4 * rank: 4 * rank + 4])
    a, b = (r["replicated"] for r in results)
    assert all(np.array_equal(a[k], b[k]) for k in a)  # rank 0's, everywhere


def test_train_loop_data_parallel(two_ranks):
    """``train`` inside a 2-rank process group with no mesh runs DP over the
    world: both ranks end with the same parameters at the resumed step, and
    rank 0 alone wrote the metrics and checkpoints."""
    from runet_tpu_torch.train.checkpoint import CheckpointManager

    results, run = two_ranks
    a, b = (r["train"] for r in results)
    assert a["step"] == b["step"] == 3 and np.isfinite(a["loss"]) and a["loss"] == b["loss"]
    assert all(np.array_equal(a["params"][k], b["params"][k]) for k in a["params"])
    assert CheckpointManager(run / "ckpt").latest_step() == 3
    lines = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines if "loss" in ln] == [1, 2, 3]  # one writer


def test_spawn_raises_with_rank_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*rank one fails on purpose"):
        spawn(workers.fail_on_rank_one, 2)


def test_dryrun_multichip_cpu(capsys):
    from runet_tpu_torch.parallel.dryrun import dryrun_multichip

    line = dryrun_multichip(2)
    assert line.startswith("dryrun_multichip(2): ok, loss=")
    assert line in capsys.readouterr().out


def _lane_bundles():
    """A coarse and a fine tiny U-Net (random weights from a seed) as
    ``from_model`` bundles, and two 48x48x32 phantoms."""
    from runet_tpu_torch.config import Config, InferConfig
    from runet_tpu_torch.data.phantom import make_phantom
    from runet_tpu_torch.infer.cascade import ModelBundle
    from runet_tpu_torch.models.unet3d import UNet3D, init_params

    hu = dict(hu_window=(-100.0, 300.0), hu_stats=None)
    out = []
    for k, sp, seed in ((2, 2.0, 0), (3, 1.0, 1)):
        cfg = Config(model=ModelConfig(num_classes=k, base_features=4, num_levels=2,
                                       compute_dtype="float32"),
                     preprocess=PreprocessConfig(spacing=(sp,) * 3, **hu),
                     infer=InferConfig(patch_size=(16, 16, 16)))
        model = init_params(UNet3D(cfg.model, device="cpu"), torch.Generator().manual_seed(seed))
        out.append(ModelBundle.from_model(model.eval(), cfg))
    cases = [(make_phantom((48, 48, 32), (1.0, 1.0, 1.0), seed=s)[0], (1.0, 1.0, 1.0))
             for s in (0, 1)]
    return out[0], out[1], cases


def test_predict_cases_on_lanes_equals_serial():
    """Two lanes on the CPU: the bundles are shared (same device), cases
    come back in order and equal serial ``predict_case``."""
    from runet_tpu_torch.infer.cascade import bundle_on_device, predict_case, predict_cases

    coarse, fine, cases = _lane_bundles()
    ccfg = CascadeConfig(roi_margin_mm=4.0, roi_bucket=16, max_components=2)
    serial = [predict_case(coarse, fine, img, sp, ccfg, device="cpu") for img, sp in cases]
    laned = list(predict_cases(coarse, fine, iter(cases), ccfg, devices=["cpu", "cpu"]))
    assert len(laned) == 2
    for a, b in zip(serial, laned):
        np.testing.assert_array_equal(a, b)
    assert bundle_on_device(fine, "cpu").params is fine.params


def test_bundle_on_another_device_is_a_copy():
    """A lane on another device than the bundles' gets a copy of each
    module there (the original stays where it was); two lanes on one
    device share one copy."""
    from runet_tpu_torch.infer.cascade import bundle_on_device, device_lanes

    coarse, fine, _ = _lane_bundles()
    moved = bundle_on_device(fine, "meta")
    assert moved.params is not fine.params
    assert {p.device.type for p in moved.params.parameters()} == {"meta"}
    assert {p.device.type for p in fine.params.parameters()} == {"cpu"}
    ens = bundle_on_device(dataclasses.replace(fine, params=[fine.params, coarse.params]), "meta")
    assert [{p.device.type for p in m.parameters()} for m in ens.params] == [{"meta"}, {"meta"}]
    (d0, c0, f0), (d1, c1, f1) = device_lanes(coarse, fine, ["meta", "meta"])
    assert d0 == d1 == torch.device("meta")
    assert f0.params is f1.params and c0.params is c1.params
    assert f0.params is not fine.params


def test_warmup_cases_on_lanes():
    from runet_tpu_torch.infer.warmup import warmup_cases

    coarse, fine, cases = _lane_bundles()
    out = warmup_cases(coarse, fine, cases, CascadeConfig(max_components=2),
                       devices=["cpu", "cpu"])
    assert sorted(out) == ["lane0_case0_s", "lane0_case1_s", "lane1_case0_s", "lane1_case1_s",
                           "total_s"]
    serial = warmup_cases(coarse, fine, cases, CascadeConfig(max_components=2), device="cpu")
    assert sorted(serial) == ["case0_s", "case1_s", "total_s"]
