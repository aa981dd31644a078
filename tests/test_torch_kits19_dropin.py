"""Real-KiTS19 drop-in readiness of the port, mirroring
``tests/test_kits19_dropin.py``: index → fingerprint → plan → 2 train steps
per stage → cascade predict → evaluate, on the CPU.

No KiTS19 data ships with the repo, so both tests skip unless a KiTS19
layout (``case_XXXXX/imaging.nii.gz`` + ``segmentation.nii.gz``) is found at
``$KITS19_ROOT`` or ``/data/kits19``; then they run with no code change.
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest

CANDIDATE_ROOTS = ("/data/kits19",)


@pytest.fixture
def kits19() -> Path:
    for root in (os.environ.get("KITS19_ROOT", ""), *CANDIDATE_ROOTS):
        p = Path(root) if root else None
        if p is not None and p.is_dir():
            cases = sorted(p.glob("case_*"))
            if cases and (cases[0] / "imaging.nii.gz").exists():
                return p
    pytest.skip("no real KiTS19 mount (set KITS19_ROOT to a dir of "
                "case_XXXXX/imaging.nii.gz); phantom-based coverage runs elsewhere")


def test_kits19_index_fingerprint_plan(kits19):
    from runet_tpu_torch.data.dataset import index_cases
    from runet_tpu_torch.data.fingerprint import fingerprint_dataset, plan_json, suggest_preprocess

    assert index_cases(kits19), f"no case_* dirs under {kits19}"
    fp = fingerprint_dataset(kits19, limit=5)
    assert "fingerprint" in json.loads(plan_json(fp))
    pp = suggest_preprocess(fp)
    # KiTS19 voxels are sub-3 mm in-plane; a wildly off suggestion means the
    # NIfTI affine / spacing parse broke on real headers.
    assert all(0.1 < s < 8.0 for s in pp.spacing), pp
    assert dataclasses.asdict(pp)


def test_kits19_train_smoke_and_cascade_predict(kits19, tmp_path):
    from runet_tpu_torch.config import get_config
    from runet_tpu_torch.data.dataset import index_cases
    from runet_tpu_torch.eval.evaluate import evaluate_prediction
    from runet_tpu_torch.infer.cascade import ModelBundle, predict_case
    from runet_tpu_torch.io.nifti import load_volume
    from runet_tpu_torch.models.unet3d import UNet3D
    from runet_tpu_torch.params import load_state, state_to_flax
    from runet_tpu_torch.train.loop import train

    def smoke_cfg(preset):
        cfg = get_config(preset)
        return dataclasses.replace(
            cfg,
            model=dataclasses.replace(cfg.model, base_features=8, num_levels=3),
            train=dataclasses.replace(
                cfg.train, patch_size=(64, 64, 64), batch_size=1, steps=2, warmup_steps=1,
                val_every=10**9, val_full_every=0, ckpt_every=10**9),
        )

    bundles = {}
    for preset in ("coarse", "fine_kits"):
        cfg = smoke_cfg(preset)
        # train() reads the KiTS19 layout directly: the drop-in itself.
        state, aux = train(cfg, data_root=kits19, out_dir=tmp_path / f"run_{preset}",
                           max_steps=cfg.train.steps, log_every=1, device="cpu")
        assert np.isfinite(float(aux["loss"]))
        model = load_state(UNet3D(cfg.model, device="cpu"),
                           state_to_flax(state.model.state_dict())).eval()
        bundles[preset] = ModelBundle.from_model(model, cfg)

    rec = index_cases(kits19)[0]
    vol = load_volume(rec.image_path)
    pred = predict_case(bundles["coarse"], bundles["fine_kits"], vol.data, vol.spacing,
                        get_config("fine_kits").cascade, device="cpu")
    assert pred.shape == vol.data.shape
    # Two-step models make no quality promise: the real-data path runs end
    # to end and gives a sane label volume.
    assert pred.max() < bundles["fine_kits"].num_classes
    seg = load_volume(rec.label_path)
    m = evaluate_prediction(pred, seg.data.astype(np.uint8), 3)
    assert np.isfinite(m["kidney_composite"])
