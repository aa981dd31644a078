"""Multi-rank dry run of the data-parallel train step and the serving lanes.

Counterpart of the JAX package's ``dryrun_multichip`` (its
``__graft_entry__.py``): ``n`` ranks (``parallel/launch.spawn``) each run
one augmented data-parallel step and one K = 2 step chunk of a tiny U-Net
on their shards of a global batch; then two oracle cascade cases served on
two lanes must equal the serial results. Prints
``dryrun_multichip(n): ok, loss=...``.

    python -m runet_tpu_torch.parallel.dryrun 2            # gloo on the CPU
    python -m runet_tpu_torch.parallel.dryrun 1 --device cuda
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

PATCH = (16, 16, 16)


def _rank_steps(rank: int, world: int) -> tuple[float, float]:
    """One augmented data-parallel step and one K = 2 chunk on this rank's
    shards; returns (loss, chunk loss), the same on every rank."""
    from runet_tpu_torch.config import ModelConfig, TrainConfig
    from runet_tpu_torch.models.unet3d import create_train_model, init_params
    from runet_tpu_torch.parallel import comm
    from runet_tpu_torch.parallel.dp import make_dp_multi_train_step, make_dp_train_step
    from runet_tpu_torch.train.state import create_train_state

    torch.set_num_threads(1)
    dev = comm.device()
    cfg = ModelConfig(num_classes=3, base_features=4, num_levels=2, compute_dtype="float32")
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0, lr_schedule="const")
    model = init_params(create_train_model(cfg, dev), torch.Generator().manual_seed(0))
    mesh = comm.make_mesh(world)
    comm.replicate(mesh, model)
    state = create_train_state(model, tcfg)
    gens = (torch.Generator(), torch.Generator(device=dev))

    rng = np.random.default_rng(0)
    images = rng.normal(size=(world, *PATCH, 1)).astype(np.float32)
    labels = (rng.uniform(size=(world, *PATCH)) < 0.3).astype(np.int32)
    images, labels = comm.shard_batch(mesh, (images, labels))
    aux = make_dp_train_step(model, mesh, augment=True)(state, images, labels, gens, 1)
    loss = float(aux["loss"])

    ims = np.stack([rng.normal(size=(world, *PATCH, 1)).astype(np.float32)] * 2)
    lbs = np.stack([(rng.uniform(size=(world, *PATCH)) < 0.3).astype(np.int32)] * 2)
    ims, lbs = comm.shard_batch(mesh, (ims, lbs), batch_axis=1)
    multi = make_dp_multi_train_step(model, mesh, 2, augment=True)
    mloss = float(multi(state, ims, lbs, gens, [2, 3])["loss"])
    if not (math.isfinite(loss) and math.isfinite(mloss)):
        raise AssertionError(f"non-finite losses {loss}, {mloss}")
    return loss, mloss


def _oracle_bundles():
    from runet_tpu_torch.config import InferConfig, PreprocessConfig
    from runet_tpu_torch.infer.cascade import ModelBundle

    def binary(_p, w):
        x = w[..., 0]
        return torch.stack([10.0 * (0.5 - x), 10.0 * (x - 0.5)], dim=-1)

    def classes(_p, w):
        x = torch.clamp(torch.round(w[..., 0]).long(), 0, 2)
        return 20.0 * torch.nn.functional.one_hot(x, 3).float()

    hu = dict(hu_window=(0.0, 100.0), hu_stats=(0.0, 1.0))
    infer = InferConfig(patch_size=PATCH)
    coarse = ModelBundle(binary, None, 2, PreprocessConfig(spacing=(2.0, 2.0, 2.0), **hu), infer)
    fine = ModelBundle(classes, None, 3, PreprocessConfig(spacing=(1.0, 1.0, 1.0), **hu), infer)
    return coarse, fine


def _check_lanes(device) -> list:
    """Two oracle cascade cases on two lanes of ``device`` equal the serial
    ``predict_case`` results; returns the lanes' devices."""
    from runet_tpu_torch.config import CascadeConfig
    from runet_tpu_torch.data.phantom import make_phantom
    from runet_tpu_torch.infer.cascade import predict_case, predict_cases

    coarse, fine = _oracle_bundles()
    ccfg = CascadeConfig(roi_margin_mm=4.0, roi_bucket=16, max_components=1)
    cases = []
    for seed in (0, 1):
        _, seg = make_phantom((32, 32, 24), (1.0, 1.0, 1.0), seed=seed)
        cases.append((seg.astype(np.float32), (1.0, 1.0, 1.0)))
    lanes = [device, device]
    serial = [predict_case(coarse, fine, img, sp, ccfg, device=device) for img, sp in cases]
    laned = list(predict_cases(coarse, fine, iter(cases), ccfg, devices=lanes))
    for a, b in zip(serial, laned):
        if not np.array_equal(a, b):
            raise AssertionError("serving-lane result != single-device")
    return lanes


def dryrun_multichip(n_devices: int, device="cpu") -> str:
    """Spawn ``n_devices`` ranks on ``device`` (gloo on the CPU; NCCL on
    CUDA, rank r on ``cuda:r``), run the data-parallel step and chunk there
    and the two serving lanes here; prints and returns the summary line."""
    from runet_tpu_torch.parallel.launch import spawn

    (loss, mloss), *rest = spawn(_rank_steps, n_devices, device=device)
    if any(r != (loss, mloss) for r in rest):
        raise AssertionError(f"ranks disagree on the losses: {[(loss, mloss), *rest]}")
    dev = torch.device(device)
    lanes = _check_lanes(dev)
    line = (f"dryrun_multichip({n_devices}): ok, loss={loss:.4f} multi_loss={mloss:.4f} "
            f"serving_lanes={len(lanes)} on {[str(d) for d in lanes]}")
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n", type=int, help="ranks")
    p.add_argument("--device", default="cpu", help="cpu, or cuda (rank r on cuda:r)")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
