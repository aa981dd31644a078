"""The port's command line (``runet_tpu_torch/cli.py``) end to end on the
CPU, mirroring ``tests/test_cli_viz.py``: phantom -> train -> predict ->
evaluate, serve (and its failure containment), warmup, export, curves,
mesh, visualize, plan, doctor, serve-http, ``--debug`` and the
``--device`` / ``--device-lanes`` rules; and one JAX-made ``.npz`` through
both packages' ``predict`` (labels agree on >= 99.9% of voxels)."""

import json
import shutil
import threading

import numpy as np
import pytest
import torch

from runet_tpu_torch.cli import main
from runet_tpu_torch.config import Config, InferConfig, ModelConfig, PreprocessConfig, TrainConfig
from runet_tpu_torch.io.nifti import load_volume, save_volume

NO_GPU = not torch.cuda.is_available()
CPU = ["--device", "cpu"]
SHAPE = (40, 40, 24)


def _tiny_config() -> Config:
    return Config(
        name="tiny",
        model=ModelConfig(num_classes=3, base_features=4, num_levels=2, compute_dtype="float32"),
        preprocess=PreprocessConfig(spacing=(2.0, 2.0, 2.0), hu_stats=None),
        train=TrainConfig(patch_size=(16, 16, 16), batch_size=2, steps=4, warmup_steps=0,
                          val_every=2, ckpt_every=2, augment=False),
        infer=InferConfig(patch_size=(16, 16, 16)),
    )


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-case phantom dataset and a run trained by ``train`` through the
    CLI (checkpoints at steps 2 and 4, each with a val_dice)."""
    root = tmp_path_factory.mktemp("cli")
    data, run, cfg_path = root / "data", root / "run", root / "tiny.json"
    assert main([*CPU, "phantom", "--out", str(data), "--cases", "2",
                 "--shape", *map(str, SHAPE)]) is None
    cfg_path.write_text(_tiny_config().to_json())
    main([*CPU, "train", "--config", str(cfg_path), "--data", str(data), "--out", str(run),
          "--steps", "2"])
    main([*CPU, "train", "--config", str(cfg_path), "--data", str(data), "--out", str(run),
          "--steps", "4", "--resume"])
    return data, run


def _watch_dir(tmp_path, data):
    watch = tmp_path / "incoming"
    watch.mkdir()
    for case_dir in sorted(data.iterdir()):
        shutil.copy(case_dir / "imaging.nii.gz", watch / f"{case_dir.name}.nii.gz")
    return watch


def test_phantom_train_predict_evaluate(trained, tmp_path, capsys):
    from runet_tpu_torch.eval.evaluate import evaluate_prediction, json_sanitize
    from runet_tpu_torch.train.checkpoint import CheckpointManager

    data, run = trained
    assert CheckpointManager(run / "ckpt").all_steps() == [2, 4]
    steps = [json.loads(l)["step"] for l in (run / "metrics.jsonl").read_text().splitlines()]
    assert max(steps) == 4

    preds = tmp_path / "preds"
    main([*CPU, "predict", "--data", str(data), "--fine", str(run), "--out", str(preds)])
    assert "case_00000: wrote" in capsys.readouterr().out
    pred = load_volume(preds / "case_00000.nii.gz")
    assert pred.shape == SHAPE and pred.data.dtype == np.uint8

    out_json = tmp_path / "eval" / "eval.json"
    main([*CPU, "evaluate", "--data", str(data), "--fine", str(run), "--surface",
          "--out", str(out_json)])
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert "dice_fg_mean" in lines[-1]["summary"]
    assert "hd95_c1" in lines[0] and "volume_ml_c1" in lines[0]
    doc = json.loads(out_json.read_text())
    for row in doc["cases"]:
        cid = row["case_id"]
        labels = load_volume(preds / f"{cid}.nii.gz")
        gt = load_volume(data / cid / "segmentation.nii.gz").data
        want = evaluate_prediction(labels.data, np.asarray(gt), 3, spacing=labels.spacing,
                                   surface=True)
        want["case_id"] = cid
        assert row == json.loads(json.dumps(json_sanitize(want)))


def test_predict_cascade_equals_in_process_predict_case(trained, tmp_path):
    from runet_tpu_torch.cli import _load_bundle
    from runet_tpu_torch.infer.cascade import predict_case

    data, run = trained
    out = tmp_path / "preds"
    main([*CPU, "predict", "--data", str(data), "--fine", str(run), "--coarse", str(run),
          "--out", str(out), "--workers", "2"])
    fine, cfg = _load_bundle(run, device="cpu")
    for cid in ("case_00000", "case_00001"):
        vol = load_volume(data / cid / "imaging.nii.gz")
        want = predict_case(fine, fine, vol.data, vol.spacing, cfg.cascade, device="cpu")
        np.testing.assert_array_equal(load_volume(out / f"{cid}.nii.gz").data, want)


@pytest.mark.parametrize("cascade", [False, True], ids=["fine_only", "cascade"])
def test_serve_once(trained, tmp_path, capsys, cascade):
    """serve --once drains a watch folder: labels NIfTI + JSON report (+ STL
    with --mesh-classes), idempotent on re-run, unreadable files skipped."""
    from runet_tpu_torch.eval.mesh import read_stl
    from runet_tpu_torch.eval.surface import volumetry

    data, run = trained
    watch = _watch_dir(tmp_path, data)
    (watch / "broken.nii.gz").write_bytes(b"not a nifti")
    out = tmp_path / "served"
    extra = ["--coarse", str(run)] if cascade else []
    rc = main([*CPU, "serve", "--watch", str(watch), "--out", str(out), "--fine", str(run),
               *extra, "--once", "--mesh-classes", "1"])
    txt = capsys.readouterr()
    assert rc == 0
    assert (out / "case_00000.nii.gz").exists() and (out / "case_00001.nii.gz").exists()
    assert not (out / "broken.nii.gz").exists()
    assert "broken" in txt.err
    rep = json.loads((out / "case_00000.json").read_text())
    assert rep["case_id"] == "case_00000" and rep["latency_s"] >= 0
    served = load_volume(out / "case_00000.nii.gz")
    assert served.data.shape == SHAPE
    assert {k: rep[k] for k in volumetry(served.data, served.spacing, 3)} == volumetry(
        served.data, served.spacing, 3)
    assert rep["shape"] == list(SHAPE)
    if (served.data == 1).any():
        assert len(read_stl(out / "case_00000_c1.stl")) > 0
    assert (out / "case_00000_c1.stl").exists()

    mtime = (out / "case_00000.nii.gz").stat().st_mtime_ns
    assert main([*CPU, "serve", "--watch", str(watch), "--out", str(out), "--fine", str(run),
                 *extra, "--once"]) == 0
    capsys.readouterr()
    assert (out / "case_00000.nii.gz").stat().st_mtime_ns == mtime


def test_serve_isolates_predict_failures(trained, tmp_path, capsys, monkeypatch):
    """A case that parses but fails prediction gets a .failed.json marker
    and never blocks later cases or re-runs (delete the marker to retry)."""
    import runet_tpu_torch.infer.cascade as cascade_mod

    data, run = trained
    watch = _watch_dir(tmp_path, data)
    real = cascade_mod.predict_volume
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("synthetic predict failure")
        return real(*a, **kw)

    monkeypatch.setattr(cascade_mod, "predict_volume", flaky)
    out = tmp_path / "served"
    args = [*CPU, "serve", "--watch", str(watch), "--out", str(out), "--fine", str(run), "--once"]
    rc = main(args)
    err = capsys.readouterr().err
    assert rc == 1 and "FAILED" in err
    assert (out / "case_00000.failed.json").exists()
    assert not (out / "case_00000.nii.gz").exists()
    assert (out / "case_00001.nii.gz").exists()

    assert main(args) == 0  # the marker stands: not retried
    assert calls["n"] == 2
    (out / "case_00000.failed.json").unlink()
    assert main(args) == 0
    capsys.readouterr()
    assert (out / "case_00000.nii.gz").exists()


def test_serve_cascade_isolates_a_failing_case(trained, tmp_path, capsys, monkeypatch):
    """In the pipelined cascade one bad case aborts the batch; the rest is
    rerun case by case on the same device, and only the bad case gets a
    marker."""
    import runet_tpu_torch.infer.cascade as cascade_mod

    data, run = trained
    watch = _watch_dir(tmp_path, data)
    img = load_volume(watch / "case_00000.nii.gz")
    save_volume(watch / "odd.nii.gz", img.data[:32], img.spacing)
    real = cascade_mod.predict_case
    devices = []

    def bad_for_odd(coarse, fine, image, spacing, *a, device=None, **kw):
        devices.append(torch.device(device))
        if np.asarray(image).shape[0] == 32:
            raise RuntimeError("synthetic failure of one case")
        return real(coarse, fine, image, spacing, *a, device=device, **kw)

    monkeypatch.setattr(cascade_mod, "predict_case", bad_for_odd)
    out = tmp_path / "served"
    rc = main([*CPU, "serve", "--watch", str(watch), "--out", str(out), "--fine", str(run),
               "--coarse", str(run), "--once", "--workers", "2"])
    err = capsys.readouterr().err
    assert rc == 1 and "retrying per-case" in err
    assert (out / "odd.failed.json").exists() and not (out / "odd.nii.gz").exists()
    assert (out / "case_00000.nii.gz").exists() and (out / "case_00001.nii.gz").exists()
    assert set(devices) == {torch.device("cpu")}


def test_warmup_command(trained, capsys):
    data, run = trained
    main([*CPU, "warmup", "--fine", str(run), "--coarse", str(run),
          "--shape", *map(str, SHAPE), "--spacing", "1", "1", "2", "--roi", "16x16x16"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(stats) == {"case0_s", "roi_16x16x16_b1_s", "total_s"}
    main([*CPU, "warmup", "--fine", str(run), "--coarse", str(run), "--data", str(data),
          "--cases", "2"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(stats) == {"case0_s", "case1_s", "total_s"}


def test_curves_mesh_visualize(trained, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    from runet_tpu_torch.eval.mesh import read_stl

    data, run = trained
    png = tmp_path / "curves.png"
    main(["curves", "--run", str(run), "--out", str(png)])
    assert png.stat().st_size > 5000

    from runet_tpu_torch.data.phantom import make_phantom

    _img, seg = make_phantom((32, 32, 24), num_classes=3, seed=1)
    lab = tmp_path / "case.nii.gz"
    save_volume(lab, seg.astype(np.uint8), spacing=(1.0, 1.0, 2.0))
    main(["mesh", "--labels", str(lab), "--out", str(tmp_path / "meshes"), "--classes", "1,2"])
    txt = capsys.readouterr().out
    assert "class 1" in txt and "class 2" in txt
    tri = read_stl(tmp_path / "meshes" / "case_c1.stl")
    zmax_voxel = np.argwhere(seg == 1)[:, 2].max()
    assert tri[..., 2].max() == pytest.approx(2.0 * zmax_voxel, abs=4.0)
    main(["mesh", "--labels", str(lab), "--out", str(tmp_path / "obj"), "--classes", "2",
          "--format", "obj"])
    assert (tmp_path / "obj" / "case_c2.obj").read_text().startswith("#")

    preds = tmp_path / "preds"
    main([*CPU, "predict", "--data", str(data), "--fine", str(run), "--out", str(preds)])
    main(["visualize", "--data", str(data), "--pred", str(preds), "--out", str(tmp_path / "viz")])
    assert (tmp_path / "viz" / "case_00001.png").stat().st_size > 1000


def test_export_and_predict_from_npz(trained, tmp_path, capsys):
    """export writes a serving .npz whose predictions equal the run dir's;
    --average 2 writes the mean of the best two checkpoints; the exported
    program reloads to the forward of those weights."""
    from runet_tpu_torch.config import Config as TConfig
    from runet_tpu_torch.train.checkpoint import CheckpointManager
    from runet_tpu_torch.utils.export import checkpoint_params, load_params_npz

    data, run = trained
    npz = tmp_path / "model.npz"
    main(["export", "--run", str(run), "--out", str(npz)])
    assert "best checkpoint" in capsys.readouterr().out
    out_a, out_b = tmp_path / "preds_run", tmp_path / "preds_npz"
    main([*CPU, "predict", "--data", str(data), "--fine", str(run), "--out", str(out_a)])
    main([*CPU, "predict", "--data", str(data), "--fine", str(npz), "--out", str(out_b)])
    for cid in ("case_00000", "case_00001"):
        np.testing.assert_array_equal(load_volume(out_a / f"{cid}.nii.gz").data,
                                      load_volume(out_b / f"{cid}.nii.gz").data)

    avg, prog = tmp_path / "avg.npz", tmp_path / "fwd.pt2"
    main(["export", "--run", str(run), "--out", str(avg), "--average", "2",
          "--exported-program", str(prog), "--patch", "16", "16", "16"])
    assert "mean of best 2 checkpoints" in capsys.readouterr().out
    got, cfg_json = load_params_npz(avg)
    assert TConfig.from_json(cfg_json) == TConfig.from_json((run / "config.json").read_text())
    ckpt = CheckpointManager(run / "ckpt")
    a, b = (checkpoint_params(ckpt, s) for s in ckpt.best_steps(2))
    for k in a:
        np.testing.assert_array_equal(got[k], ((a[k] + b[k]) / 2).astype(np.float32))

    from runet_tpu_torch.models.unet3d import UNet3D
    from runet_tpu_torch.params import load_state

    cfg = TConfig.from_json(cfg_json)
    model = load_state(UNet3D(cfg.model, device="cpu"), got).eval()
    x = torch.randn(1, 16, 16, 16, 1, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(torch.export.load(prog).module()(x), model(x),
                                   rtol=1e-5, atol=1e-5)


def test_predict_probs_out(trained, tmp_path):
    data, run = trained
    out, probs = tmp_path / "preds", tmp_path / "probs"
    main([*CPU, "predict", "--data", str(data), "--fine", str(run), "--out", str(out),
          "--probs-out", str(probs)])
    z = np.load(sorted(probs.glob("*_probs.npz"))[0])
    assert z["probs"].dtype == np.float16 and z["probs"].shape[-1] == 3
    np.testing.assert_allclose(z["probs"].astype(np.float32).sum(-1), 1.0, atol=2e-2)
    assert tuple(z["native_shape"]) == SHAPE
    with pytest.raises(SystemExit, match="probs-out"):
        main([*CPU, "predict", "--data", str(data), "--fine", str(run), "--coarse", str(run),
              "--out", str(out), "--probs-out", str(probs)])


def test_plan_writes_a_config_ready_json(trained, tmp_path, capsys):
    from runet_tpu_torch.config import get_config

    data, _ = trained
    out = tmp_path / "plan.json"
    assert main(["plan", "--data", str(data), "--config", "fine_kits", "--out", str(out)]) == 0
    cfg = get_config(str(out))
    assert cfg.model.num_classes == 3 and len(cfg.preprocess.spacing) == 3
    assert main(["plan", "--data", str(data), "--cases", "1"]) == 0
    assert "preprocess" in json.loads(capsys.readouterr().out.split("plan: wrote")[-1]
                                      .split("\n", 1)[-1])


def test_serve_http_command(trained, monkeypatch, capsys):
    """serve-http binds, answers /healthz and /v1/predict with the same
    labels as in-process predict_case, and returns on interrupt."""
    import urllib.request

    import runet_tpu_torch.infer.http_serve as hs
    from runet_tpu_torch.cli import _load_bundle
    from runet_tpu_torch.infer.cascade import predict_case
    from runet_tpu_torch.io.nifti import volume_from_bytes

    data, run = trained
    body = (data / "case_00000" / "imaging.nii.gz").read_bytes()
    replies = {}
    real = hs.make_server

    def make_server(service, host, port):
        srv = real(service, host, port)

        def serve_forever():
            base = "http://%s:%d" % srv.server_address[:2]

            def client():
                with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
                    replies["health"] = json.loads(r.read())
                req = urllib.request.Request(base + "/v1/predict", data=body)
                with urllib.request.urlopen(req, timeout=60) as r:
                    replies["labels"] = volume_from_bytes(r.read()).data

            t = threading.Thread(target=client)
            t.start()
            srv.handle_request()
            srv.handle_request()
            t.join()
            srv.server_close()
            raise KeyboardInterrupt

        srv.serve_forever = serve_forever
        srv.shutdown = lambda: None
        return srv

    monkeypatch.setattr(hs, "make_server", make_server)
    main([*CPU, "serve-http", "--port", "0", "--fine", str(run), "--coarse", str(run),
          "--warmup-shape", "32", "32", "16"])
    assert "serving on http://127.0.0.1:" in capsys.readouterr().out
    assert replies["health"]["status"] == "ok" and replies["health"]["num_classes"] == 3
    fine, cfg = _load_bundle(run, device="cpu")
    vol = load_volume(data / "case_00000" / "imaging.nii.gz")
    want = predict_case(fine, fine, vol.data, vol.spacing, cfg.cascade, device="cpu")
    np.testing.assert_array_equal(replies["labels"], want)


def test_debug_raises_on_a_non_finite_model(trained, tmp_path):
    from runet_tpu_torch.utils.export import load_params_npz, save_params_npz

    data, run = trained
    npz = tmp_path / "model.npz"
    main(["export", "--run", str(run), "--out", str(npz)])
    params, cfg_json = load_params_npz(npz)
    key = next(k for k in params if k.endswith("kernel"))
    params[key] = params[key].copy()
    params[key].flat[0] = np.nan
    bad = save_params_npz(tmp_path / "nan.npz", params, cfg_json)
    case = data / "case_00000" / "imaging.nii.gz"
    main(["--debug", *CPU, "predict", "--data", str(case), "--fine", str(npz),
          "--out", str(tmp_path / "ok")])
    assert (tmp_path / "ok" / "imaging.nii.gz").exists()
    with pytest.raises(FloatingPointError, match="non-finite"):
        main(["--debug", *CPU, "predict", "--data", str(case), "--fine", str(bad),
              "--out", str(tmp_path / "bad")])
    assert not torch.is_anomaly_enabled()


def test_device_lanes_above_one_exit(trained, tmp_path, monkeypatch):
    """--device-lanes N takes the first N local devices of --device's kind
    and exits with the JAX package's message when fewer are present (the
    CPU is one device; CUDA counts its cards); N = 1 serves on one lane."""
    from runet_tpu_torch.cli import _resolve_lanes

    data, run = trained
    fewer = r"--device-lanes 2: only 1 local device\(s\) present"
    for cmd in (["predict", "--data", str(data), "--out", str(tmp_path / "p")],
                ["evaluate", "--data", str(data)],
                ["serve", "--watch", str(data), "--out", str(tmp_path / "s"), "--once"],
                ["warmup", "--coarse", str(run), "--shape", "8", "8", "8"]):
        with pytest.raises(SystemExit, match=fewer):
            main([*CPU, *cmd, "--fine", str(run), "--device-lanes", "2"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=fewer):
        _resolve_lanes(2, "cuda")
    assert _resolve_lanes(1, "cuda") == [torch.device("cuda", 0)]
    assert _resolve_lanes(0, "cuda") is None
    main([*CPU, "predict", "--data", str(data), "--fine", str(run), "--coarse", str(run),
          "--out", str(tmp_path / "one"), "--device-lanes", "1"])
    assert (tmp_path / "one" / "case_00000.nii.gz").exists()


@pytest.mark.skipif(not NO_GPU, reason="a GPU is present; the default device is valid")
def test_default_device_raises_without_a_gpu(trained, tmp_path):
    data, run = trained
    for cmd in (["predict", "--data", str(data), "--fine", str(run), "--out", str(tmp_path)],
                ["train", "--config", "fine_kits", "--data", str(data), "--out", str(tmp_path)]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(cmd)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--device", "cuda", "evaluate", "--data", str(data), "--fine", str(run)])


@pytest.mark.skipif(not NO_GPU, reason="a GPU is present: the probe succeeds")
def test_doctor_exits_one_without_a_card(capsys):
    assert main(["doctor", "--timeout", "120"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["backend_reachable"] is False and "kernel_build" in report


def test_missing_config_raises(tmp_path):
    from runet_tpu_torch.cli import _load_bundle
    from runet_tpu_torch.utils.export import save_params_npz

    (tmp_path / "run").mkdir()
    with pytest.raises(FileNotFoundError, match="config"):
        _load_bundle(tmp_path / "run", device="cpu")
    from runet_tpu_torch.models.unet3d import UNet3D, init_params
    from runet_tpu_torch.params import torch_to_flax

    m = init_params(UNet3D(_tiny_config().model, device="cpu"), torch.Generator().manual_seed(0))
    npz = save_params_npz(tmp_path / "bare.npz", torch_to_flax(m))
    with pytest.raises(FileNotFoundError, match="no embedded config"):
        _load_bundle(npz, device="cpu")
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(_tiny_config().to_json())
    bundle, cfg = _load_bundle(npz, str(cfg_path), device="cpu")
    assert bundle.num_classes == 3 and cfg.name == "tiny"


def test_jax_npz_predicts_alike_in_both_clis(tmp_path, capsys):
    """One JAX-made .npz through the JAX CLI's predict and the port CLI's
    ``predict --device cpu`` on one phantom: labels agree on >= 99.9% of
    voxels (f32 noise of an untrained net may flip near-tie voxels; the
    per-volume z-score keeps them few, tests/test_torch_cascade.py)."""
    import jax

    from runet_tpu import cli as jcli
    from runet_tpu.config import Config as JConfig
    from runet_tpu.config import InferConfig as JInfer
    from runet_tpu.config import ModelConfig as JModel
    from runet_tpu.config import PreprocessConfig as JPre
    from runet_tpu.models.unet3d import create_model, init_params
    from runet_tpu.utils.export import save_params_npz

    jcfg = JConfig(model=JModel(num_classes=3, base_features=4, max_features=8, num_levels=3,
                                compute_dtype="float32"),
                   preprocess=JPre(spacing=(2.0, 2.0, 2.0), hu_stats=None),
                   infer=JInfer(patch_size=(16, 16, 16)))
    params = jax.device_get(init_params(create_model(jcfg.model), jax.random.key(7),
                                        (16, 16, 16)))
    npz = save_params_npz(tmp_path / "jax.npz", params, jcfg.to_json())
    data = tmp_path / "data"
    main(["phantom", "--out", str(data), "--cases", "1", "--shape", "48", "48", "32"])
    jcli.main(["predict", "--data", str(data), "--fine", str(npz), "--out", str(tmp_path / "j")])
    main([*CPU, "predict", "--data", str(data), "--fine", str(npz), "--out", str(tmp_path / "t")])
    capsys.readouterr()
    want = np.asarray(load_volume(tmp_path / "j" / "case_00000.nii.gz").data)
    got = load_volume(tmp_path / "t" / "case_00000.nii.gz").data
    assert got.shape == want.shape == (48, 48, 32)
    assert (got == want).mean() >= 0.999, (got == want).mean()
    assert len(np.unique(want)) > 1  # not a trivially constant labelmap
