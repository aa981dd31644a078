"""Command line of the port: ``python -m runet_tpu_torch <cmd>``.

Counterpart of ``runet_tpu/cli.py``, with its subcommands, flags and
defaults:

- ``phantom``    — generate a synthetic KiTS19-layout dataset
- ``train``      — train a preset config on a dataset
- ``predict``    — segment cases (fine model alone, or the full cascade)
- ``serve``      — watch-folder serving daemon (predict + report + meshes)
- ``serve-http`` — HTTP inference endpoint
- ``evaluate``   — predict + Dice table against ground truth
                   (``--surface`` adds hd95/assd/nsd + volumetry)
- ``warmup``     — run the cascade once before traffic
- ``export``     — a run's best checkpoint(s) to a serving ``.npz``
- ``curves``, ``mesh``, ``visualize``, ``plan``, ``doctor``

One global ``--device`` (default ``cuda``) names where the model runs; the
commands that run it raise when no GPU is present rather than fall back to
the CPU (``runet_tpu_torch.resolve_device``). ``--device cpu`` runs the
plain PyTorch path. The host-only commands (``phantom``, ``export``,
``curves``, ``mesh``, ``visualize``, ``plan``) and ``doctor``, which probes
the card itself, do no device work.

The JAX package's ``main`` turns on XLA's persistent compile cache; its
counterpart here is ``kernels/build.py``'s build directory, which keeps
every nvcc-built kernel library across processes, so ``main`` turns on
nothing.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _load_bundle(run_dir: Path, cfg_override: str | None = None, device=None):
    """Rebuild the serving model from a training run dir of this package
    (config.json + ckpt/; the best checkpoint, else the latest) or a serving
    ``.npz`` (utils/export.py, either package's) on ``device``; returns
    (ModelBundle, Config)."""
    from runet_tpu_torch import resolve_device
    from runet_tpu_torch.config import Config, get_config
    from runet_tpu_torch.infer.cascade import ModelBundle
    from runet_tpu_torch.models.unet3d import UNet3D
    from runet_tpu_torch.params import load_state
    from runet_tpu_torch.utils.export import checkpoint_params, load_params_npz

    dev = resolve_device(device)
    if run_dir.is_file() and run_dir.suffix == ".npz":
        params, cfg_json = load_params_npz(run_dir)
        if cfg_json is not None:
            cfg = Config.from_json(cfg_json)
        elif cfg_override:
            cfg = get_config(cfg_override)
        else:
            raise FileNotFoundError(f"{run_dir} has no embedded config and no --config given")
    else:
        from runet_tpu_torch.train.checkpoint import CheckpointManager

        cfg_path = run_dir / "config.json"
        if cfg_path.exists():
            cfg = Config.from_json(cfg_path.read_text())
        elif cfg_override:
            cfg = get_config(cfg_override)
        else:
            raise FileNotFoundError(f"{cfg_path} missing and no --config given")
        ckpt = CheckpointManager(run_dir / "ckpt")
        # `best or latest` would misroute a best step of 0 (falsy) to the
        # latest checkpoint.
        step = ckpt.best_step()
        if step is None:
            step = ckpt.latest_step()
        params = checkpoint_params(ckpt, step)
    model = load_state(UNet3D(cfg.model, device=dev), params).eval()
    return ModelBundle.from_model(model, cfg), cfg


def _load_bundle_spec(spec: str, cfg_override: str | None = None, device=None):
    """``--fine``/``--coarse`` accept a comma-separated list of run dirs /
    serving .npz files; >1 entries are fused into a probability-averaging
    checkpoint ensemble (infer/ensemble.py)."""
    paths = [p for p in str(spec).split(",") if p]
    first, cfg = _load_bundle(Path(paths[0]), cfg_override, device)
    if len(paths) == 1:
        return first, cfg
    from runet_tpu_torch.infer.ensemble import ensemble_bundle

    members = [first] + [_load_bundle(Path(p), cfg_override, device)[0] for p in paths[1:]]
    return ensemble_bundle(members), cfg


def _iter_cases(data: Path):
    from runet_tpu_torch.data.dataset import index_cases
    from runet_tpu_torch.io.nifti import load_volume

    if data.is_file():
        vol = load_volume(data)
        yield data.stem.replace(".nii", ""), vol, None
        return
    for rec in index_cases(data):
        vol = load_volume(rec.image_path)
        gt = load_volume(rec.label_path).data if rec.label_path else None
        yield rec.case_id, vol, gt


def _with_tta(bundle):
    import dataclasses

    return dataclasses.replace(
        bundle, infer=dataclasses.replace(bundle.infer, tta=True)
    )


def _check_lanes(n: int) -> None:
    """--device-lanes N: N <= 1 is the one device of ``--device``; the
    port has no per-device serving lanes yet."""
    if n > 1:
        raise SystemExit(
            f"--device-lanes {n}: multi-device serving lanes are not ported yet "
            "(ROADMAP.md Queue A item 7); use --device-lanes 0 or 1"
        )


def _pipelined_cascade(coarse, fine, case_iter, cascade_cfg, workers=2, device=None):
    """(cid, vol, gt, pred) stream via the pipelined serving path — host
    pre/post of one case overlaps device compute of the next
    (infer/cascade.py predict_cases); holds ≤ workers+1 volumes in RAM."""
    from collections import deque

    from runet_tpu_torch.infer.cascade import predict_cases

    meta: deque = deque()

    def gen():
        for cid, vol, gt in case_iter:
            meta.append((cid, vol, gt))
            yield vol.data, vol.spacing

    for pred in predict_cases(coarse, fine, gen(), cascade_cfg, workers=workers,
                              device=device):
        cid, vol, gt = meta.popleft()
        yield cid, vol, gt, pred


class _AsyncWriter:
    """Overlap per-case output writing with the next case's device compute.

    gzip of a native-shape labelmap (plus meshes/report in serve) is about
    half a second of host CPU for a 512x512x160 case (PERF.md §6); done
    serially on the results loop it would stall the pipelined cascade's
    yield path and cap volumes/min. One
    writer thread keeps disk writes from contending with each other;
    ``max_pending`` bounds how many finished predictions (tens of MB each)
    wait in RAM. ``submit`` applies backpressure; ``close`` drains and
    re-raises the first write error (unless the task guards itself)."""

    def __init__(self, max_pending: int = 2):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = deque()
        self._max = max_pending

    def submit(self, fn, *a) -> None:
        self._pending.append(self._pool.submit(fn, *a))
        while len(self._pending) > self._max:
            self._pending.popleft().result()

    def close(self) -> None:
        try:
            while self._pending:
                self._pending.popleft().result()
        finally:
            self._pool.shutdown(wait=True)


def _stages(args):
    """(fine, fine_cfg, coarse | None) of a serving command, on
    ``args.device``, with ``--tta`` applied to the fine stage."""
    fine, fine_cfg = _load_bundle_spec(args.fine, args.config, args.device)
    coarse = None
    if args.coarse:
        coarse, _ = _load_bundle_spec(args.coarse, device=args.device)
    if args.tta:
        fine = _with_tta(fine)
    return fine, fine_cfg, coarse


def cmd_phantom(args):
    from runet_tpu_torch.data.phantom import write_phantom_dataset

    ids = write_phantom_dataset(
        args.out,
        num_cases=args.cases,
        shape=tuple(args.shape),
        spacing=tuple(args.spacing),
        num_classes=args.classes,
    )
    print(f"wrote {len(ids)} cases to {args.out}")


def cmd_train(args):
    from runet_tpu_torch.config import get_config
    from runet_tpu_torch.train.loop import train

    cfg = get_config(args.config)
    cases = val_cases = None
    if args.fold:
        # --fold i/k: deterministic cross-validation split; the K run dirs
        # fuse at inference via --fine dir0,...,dirK-1 (infer/ensemble.py).
        from runet_tpu_torch.data.dataset import prepare_dataset, split_folds

        i, k = (int(x) for x in args.fold.split("/"))
        all_cases = prepare_dataset(args.data, cfg.preprocess, cache_dir=args.cache,
                                    device=args.device)
        cases, val_cases = split_folds(all_cases, k, i)
        print(f"fold {i}/{k}: {len(cases)} train / {len(val_cases)} val cases")
    state, aux = train(
        cfg,
        data_root=args.data,
        out_dir=args.out,
        cases=cases,
        val_cases=val_cases,
        max_steps=args.steps,
        resume=args.resume,
        cache_dir=args.cache,
        device=args.device,
    )
    print(f"done at step {int(state.step)}; loss={float(aux['loss']):.4f}")


def cmd_predict(args):
    from runet_tpu_torch.infer.cascade import predict_volume
    from runet_tpu_torch.io.nifti import save_volume

    if args.probs_out and args.coarse:
        raise SystemExit(
            "--probs-out needs the whole-volume path (omit --coarse): the "
            "cascade fetches per-ROI labels only"
        )
    fine, fine_cfg, coarse = _stages(args)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    def emit(cid, vol, pred):
        save_volume(out_dir / f"{cid}.nii.gz", pred, vol.spacing, vol.affine)
        print(f"{cid}: wrote {out_dir / f'{cid}.nii.gz'}")

    if coarse is not None:
        w = _AsyncWriter()
        try:
            for cid, vol, _gt, pred in _pipelined_cascade(
                coarse, fine, _iter_cases(Path(args.data)), fine_cfg.cascade,
                workers=args.workers, device=args.device,
            ):
                w.submit(emit, cid, vol, pred)
        finally:
            w.close()
    else:
        probs_dir = Path(args.probs_out) if args.probs_out else None
        if probs_dir:
            probs_dir.mkdir(parents=True, exist_ok=True)
        for cid, vol, _gt in _iter_cases(Path(args.data)):
            if probs_dir:
                pred, probs, pp_spacing = predict_volume(
                    fine, vol.data, vol.spacing, return_probs=True, device=args.device
                )
                np.savez(
                    probs_dir / f"{cid}_probs.npz", probs=probs,
                    spacing=np.asarray(pp_spacing),
                    native_shape=np.asarray(vol.data.shape),
                    native_spacing=np.asarray(vol.spacing),
                )
                emit(cid, vol, pred)
            else:
                emit(cid, vol, predict_volume(fine, vol.data, vol.spacing, device=args.device))


def cmd_serve_http(args):
    """HTTP inference endpoint (infer/http_serve.py): POST a NIfTI body to
    /v1/predict and get the gzipped labelmap back on the same connection
    (report in the X-Runet-Report header), or /v1/report for JSON only.
    GET /healthz for liveness."""
    from runet_tpu_torch.infer.http_serve import InferenceService, make_server

    fine, fine_cfg, coarse = _stages(args)
    service = InferenceService(fine, coarse, fine_cfg.cascade, device=args.device)
    if args.warmup_shape:
        from runet_tpu_torch.infer.warmup import warmup_cases
        from runet_tpu_torch.io.nifti import Volume

        img = np.zeros(tuple(args.warmup_shape), np.float32)
        sp_mm = tuple(args.warmup_spacing)
        if coarse is not None:
            warmup_cases(coarse, fine, [(img, sp_mm)], fine_cfg.cascade, device=args.device)
        else:
            service.predict(Volume(data=img, spacing=sp_mm, affine=np.eye(4)))
    srv = make_server(service, host=args.host, port=args.port)
    host, port = srv.server_address[:2]
    print(f"serving on http://{host}:{port} "
          f"(cascade={coarse is not None}, classes={fine.num_classes})",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


def cmd_serve(args):
    """Watch-folder serving daemon: new ``*.nii``/``*.nii.gz`` files
    appearing in --watch are segmented through the pipelined cascade (or
    whole-volume fine model), each emitting <cid>.nii.gz + a <cid>.json
    report (intake-to-done latency incl. queueing, per-structure volumetry)
    and optionally per-class STL meshes. ``--once`` drains the current
    backlog and exits (batch mode / tests).

    Failure containment: a file that fails to PARSE (partial upload) is
    retried next poll; a case that fails to PREDICT poisons nothing — the
    pipelined batch falls back to per-case processing on the same device
    and the bad case gets a <cid>.failed.json marker (inspect + delete to
    retry) so it never blocks later arrivals. The labelmap is renamed into
    place LAST, so output existence == fully emitted and restarts are
    idempotent."""
    import os
    import time

    from runet_tpu_torch.eval.surface import volumetry
    from runet_tpu_torch.infer import cascade as cascade_mod
    from runet_tpu_torch.io.nifti import load_volume, save_volume

    fine, fine_cfg, coarse = _stages(args)
    watch, out_dir = Path(args.watch), Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    mesh_classes = (
        [int(c) for c in args.mesh_classes.split(",")] if args.mesh_classes else []
    )

    warned_shadowed: set[tuple[str, str]] = set()

    def pending():
        seen: dict[str, Path] = {}
        for p in sorted(watch.iterdir()):
            if p.name.startswith("."):
                continue  # hidden/temp files (incl. our own when out==watch)
            if p.name.endswith(".nii.gz"):
                cid = p.name[: -len(".nii.gz")]
            elif p.name.endswith(".nii"):
                cid = p.name[: -len(".nii")]
            else:
                continue
            if cid in seen:  # scan.nii next to scan.nii.gz: one cid
                if (cid, p.name) not in warned_shadowed:  # once, not per poll
                    warned_shadowed.add((cid, p.name))
                    print(
                        f"{p.name}: shadowed by {seen[cid].name} (same case id); "
                        "rename to serve both", file=sys.stderr,
                    )
                continue
            seen[cid] = p
            done = (out_dir / f"{cid}.nii.gz").exists()
            failed = (out_dir / f"{cid}.failed.json").exists()
            if not done and not failed:
                yield cid, p

    def load_ok(path: Path):
        try:
            return load_volume(path)
        except Exception as e:  # partial upload, bad header — retry next poll
            print(f"{path.name}: unreadable ({e}); will retry", file=sys.stderr)
            return None

    def emit(cid, vol, pred, dt):
        report = {
            "case_id": cid,
            "latency_s": round(dt, 3),  # intake -> done, incl. queue time
            "shape": list(vol.data.shape),
            **volumetry(pred, vol.spacing, fine.num_classes),
        }
        if mesh_classes:
            from runet_tpu_torch.eval.mesh import labelmap_to_meshes, write_stl

            meshes = labelmap_to_meshes(pred, mesh_classes, affine=vol.affine)
            for k, (verts, faces) in meshes.items():
                report[f"mesh_c{k}"] = str(
                    write_stl(out_dir / f"{cid}_c{k}.stl", verts, faces)
                )
        (out_dir / f"{cid}.json").write_text(json.dumps(report, indent=1) + "\n")
        # The labelmap is the done-marker: write to a temp name and rename
        # into place only after the report/meshes exist (atomic on POSIX).
        # The temp name must keep the .gz suffix — save_volume picks gzip
        # by extension, and a ".tmp" suffix would silently write an
        # uncompressed payload into a file later named *.nii.gz.
        tmp = out_dir / f".{cid}.tmp.nii.gz"
        save_volume(tmp, pred, vol.spacing, vol.affine)
        os.replace(tmp, out_dir / f"{cid}.nii.gz")
        print(f"{cid}: segmented in {dt:.2f}s -> {out_dir / f'{cid}.nii.gz'}", flush=True)

    failed_cids: set[str] = set()

    def mark_failed(cid, err):
        failed_cids.add(cid)
        (out_dir / f"{cid}.failed.json").write_text(
            json.dumps({"case_id": cid, "error": repr(err)}, indent=1) + "\n"
        )
        print(f"{cid}: FAILED ({err!r}); marker written, case skipped",
              file=sys.stderr, flush=True)

    def one_case(cid, p):
        vol = load_ok(p)
        if vol is None:
            return
        t0 = time.monotonic()
        try:
            if coarse is not None:
                pred = cascade_mod.predict_case(
                    coarse, fine, vol.data, vol.spacing, fine_cfg.cascade, device=args.device
                )
            else:
                pred = cascade_mod.predict_volume(fine, vol.data, vol.spacing,
                                                  device=args.device)
            emit(cid, vol, pred, time.monotonic() - t0)
        except Exception as e:
            mark_failed(cid, e)

    def drain(paths):
        if coarse is None:
            for cid, p in paths:
                one_case(cid, p)
            return
        t_intake: dict[str, float] = {}

        def case_iter():  # lazy: _pipelined_cascade holds <= workers+1 in RAM
            for cid, p in paths:
                vol = load_ok(p)
                if vol is None:
                    continue
                t_intake[cid] = time.monotonic()
                yield cid, vol, None

        def emit_guarded(cid, vol, pred, dt):
            # Runs on the writer thread: a write/mesh failure marks THIS
            # case failed instead of surfacing later and aborting the batch.
            try:
                emit(cid, vol, pred, dt)
            except Exception as e:
                mark_failed(cid, e)

        w = _AsyncWriter()
        try:
            for cid, vol, _gt, pred in _pipelined_cascade(
                coarse, fine, case_iter(), fine_cfg.cascade,
                workers=args.workers, device=args.device,
            ):
                w.submit(emit_guarded, cid, vol, pred,
                         time.monotonic() - t_intake[cid])
            w.close()
        except Exception as e:
            w.close()
            # One bad case aborts the shared pipeline; isolate it by
            # re-running the remainder per-case (each in its own guard).
            print(f"pipelined batch failed ({e!r}); retrying per-case",
                  file=sys.stderr, flush=True)
            for cid, p in paths:
                if not (out_dir / f"{cid}.nii.gz").exists() and not (
                    out_dir / f"{cid}.failed.json"
                ).exists():
                    one_case(cid, p)

    print(f"serving: watching {watch} -> {out_dir}", flush=True)
    while True:
        drain(list(pending()))
        if args.once:
            # Batch mode is scriptable (`serve --once && publish`): exit
            # nonzero when any case wrote a .failed.json marker.
            return 1 if failed_cids else 0
        time.sleep(args.poll)


def cmd_evaluate(args):
    from runet_tpu_torch.eval.evaluate import evaluate_prediction, finite_mean, json_sanitize
    from runet_tpu_torch.infer.cascade import predict_volume

    fine, fine_cfg, coarse = _stages(args)

    def labeled_cases():
        # Skip BEFORE predicting: unlabeled cases (e.g. a test split) must
        # not burn a full cascade each just to be discarded.
        for cid, vol, gt in _iter_cases(Path(args.data)):
            if gt is None:
                print(f"{cid}: no ground truth, skipping", file=sys.stderr)
                continue
            yield cid, vol, gt

    def results():
        if coarse is not None:
            yield from _pipelined_cascade(
                coarse, fine, labeled_cases(), fine_cfg.cascade,
                workers=args.workers, device=args.device,
            )
        else:
            for cid, vol, gt in labeled_cases():
                yield cid, vol, gt, predict_volume(fine, vol.data, vol.spacing,
                                                   device=args.device)

    cldice_classes = None  # default: vessel classes (>= 3) when --surface
    if args.cldice == "all":
        cldice_classes = range(1, fine.num_classes)
    elif args.cldice:
        cldice_classes = [int(c) for c in args.cldice.split(",")]
    rows = []
    for cid, vol, gt, pred in results():
        row = evaluate_prediction(
            pred, np.asarray(gt), fine.num_classes,
            spacing=vol.spacing, surface=args.surface,
            cldice_classes=cldice_classes,
        )
        row["case_id"] = cid
        rows.append(row)
        print(json.dumps(json_sanitize(row)))
    summary = None
    if rows:
        # Finite-only means: one empty-prediction case has inf hd95/assd and
        # must not erase every other case's summary value.
        summary = {
            k: finite_mean(r[k] for r in rows)
            for k in rows[0]
            if k != "case_id"
        }
        print(json.dumps(json_sanitize({"summary": summary})))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(
            json.dumps(json_sanitize({"cases": rows, "summary": summary}), indent=1)
            + "\n"
        )
        print(f"wrote {args.out}", file=sys.stderr)


def cmd_warmup(args):
    """Serving warm-up: run the cascade once at startup so the first real
    case runs at steady-state latency (infer/warmup.py: the first case of a
    process pays the kernel build or load, the library handles and the
    allocator's first allocations)."""
    from runet_tpu_torch.infer.warmup import warmup_cases, warmup_roi_buckets

    fine, fine_cfg = _load_bundle_spec(args.fine, args.config, args.device)
    coarse, _ = _load_bundle_spec(args.coarse, device=args.device)
    if args.tta:
        fine = _with_tta(fine)

    stats = {}
    if args.data:
        cases = []
        for i, (_cid, vol, _gt) in enumerate(_iter_cases(Path(args.data))):
            if i >= args.cases:
                break
            cases.append((vol.data, vol.spacing))
        stats.update(warmup_cases(coarse, fine, cases, fine_cfg.cascade, device=args.device))
    elif args.shape:
        # No data: an all-air dummy case warms the (canonical) coarse
        # stage; pair with --roi for the fine buckets.
        img = np.full(tuple(args.shape), -1000.0, np.float16)
        stats.update(
            warmup_cases(coarse, fine, [(img, tuple(args.spacing))], fine_cfg.cascade,
                         device=args.device)
        )
    if args.roi:
        shapes = [tuple(int(v) for v in s.split("x")) for s in args.roi]
        stats.update(
            warmup_roi_buckets(
                fine, shapes, tuple(args.spacing), cascade=fine_cfg.cascade,
                device=args.device,
            )
        )
    print(json.dumps(stats))


def cmd_export(args):
    from runet_tpu_torch.utils.export import export_run

    p = export_run(Path(args.run), Path(args.out), average=args.average)
    what = (
        f"mean of best {args.average} checkpoints" if args.average > 1
        else "best checkpoint"
    )
    print(f"exported {what} to {p}")
    if args.exported_program:
        from runet_tpu_torch.config import Config
        from runet_tpu_torch.utils.export import export_program, load_params_npz

        params, cfg_json = load_params_npz(p)
        cfg = Config.from_json(cfg_json)
        patch = tuple(args.patch) if args.patch else tuple(cfg.infer.patch_size)
        ep = export_program(
            Path(args.exported_program), cfg.model, params, patch, batch=args.batch
        )
        print(
            f"exported the plain forward (batch={args.batch}, patch={patch}) "
            f"to {ep} ({ep.stat().st_size} bytes)"
        )


def cmd_visualize(args):
    from runet_tpu_torch.eval.visualize import save_case_panel
    from runet_tpu_torch.io.nifti import load_volume

    out_dir = Path(args.out)
    for cid, vol, gt in _iter_cases(Path(args.data)):
        pred = None
        if args.pred:
            pred_path = Path(args.pred) / f"{cid}.nii.gz"
            if pred_path.exists():
                pred = load_volume(pred_path).data
        p = save_case_panel(
            out_dir / f"{cid}.png", vol.data, labels=gt, pred=pred, title=cid
        )
        print(f"{cid}: wrote {p}")


def cmd_curves(args):
    from runet_tpu_torch.eval.visualize import save_training_curves

    run = Path(args.run)
    out = Path(args.out) if args.out else run / "curves.png"
    p = save_training_curves(run / "metrics.jsonl", out, title=run.name)
    print(f"wrote {p}")


def cmd_mesh(args):
    """Labelmap NIfTI -> per-class surface meshes in world mm (eval/mesh.py
    marching tetrahedra; vertices mapped through the NIfTI affine)."""
    from runet_tpu_torch.eval.mesh import labelmap_to_meshes, mesh_stats, write_obj, write_stl
    from runet_tpu_torch.io.nifti import load_volume

    vol = load_volume(Path(args.labels))
    classes = [int(c) for c in args.classes.split(",")]
    meshes = labelmap_to_meshes(
        vol.data, classes, affine=vol.affine, smooth_iters=args.smooth
    )
    out_dir = Path(args.out)
    stem = Path(args.labels).name.replace(".nii.gz", "").replace(".nii", "")
    writer = write_obj if args.format == "obj" else write_stl
    for k, (verts, faces) in meshes.items():
        p = writer(out_dir / f"{stem}_c{k}.{args.format}", verts, faces)
        s = mesh_stats(verts, faces)
        print(
            f"class {k}: {p} ({s['n_faces']} faces, "
            f"{s['volume'] / 1000.0:.1f} mL, {s['area'] / 100.0:.1f} cm^2)"
        )


def cmd_plan(args):
    import dataclasses as _dc

    from runet_tpu_torch.data.fingerprint import (
        fingerprint_dataset,
        plan_json,
        suggest_preprocess,
    )

    fp = fingerprint_dataset(args.data, limit=args.cases)
    if args.config:
        from runet_tpu_torch.config import get_config

        cfg = get_config(args.config)
        cfg = _dc.replace(cfg, preprocess=suggest_preprocess(fp))
        n = fp.get("num_classes_incl_bg")
        if n and n != cfg.model.num_classes:
            print(
                f"plan: dataset has {n} classes (incl. background); "
                f"overriding {args.config!r} model.num_classes="
                f"{cfg.model.num_classes}",
                file=sys.stderr,
            )
            cfg = _dc.replace(cfg, model=_dc.replace(cfg.model, num_classes=n))
        doc = json.loads(cfg.to_json())
        doc["fingerprint"] = fp
        out = json.dumps(doc, indent=1)
    else:
        out = plan_json(fp)
    if args.out:
        Path(args.out).write_text(out)
        print(f"plan: wrote {args.out}")
    else:
        print(out)
    return 0


def cmd_doctor(args):
    from runet_tpu_torch.utils.health import doctor_report

    report = doctor_report(probe_timeout_s=args.timeout)
    print(json.dumps(report, indent=1))
    return 0 if report["backend_reachable"] else 1


_LANES_HELP = ("serve cases across the first N local devices (independent "
               "per-device lanes; 0 = single device; N > 1 is not ported yet)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="runet_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument(
        "--debug",
        action="store_true",
        help="sanitizer mode: autograd anomaly detection + a check of every "
        "module's output for NaN/Inf (utils/debug.py; slow — not for "
        "production runs)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="device the model runs on (default cuda; raises without a GPU); "
        "'cpu' runs the plain PyTorch path",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("phantom", help="generate synthetic dataset")
    sp.add_argument("--out", required=True)
    sp.add_argument("--cases", type=int, default=3)
    sp.add_argument("--shape", type=int, nargs=3, default=[96, 96, 64])
    sp.add_argument("--spacing", type=float, nargs=3, default=[1.0, 1.0, 2.0])
    sp.add_argument("--classes", type=int, default=3)
    sp.set_defaults(fn=cmd_phantom, on_device=False)

    sp = sub.add_parser("train", help="train a preset config")
    sp.add_argument("--config", required=True)
    sp.add_argument("--data", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--steps", type=int, default=None)
    sp.add_argument("--resume", action="store_true")
    sp.add_argument(
        "--cache", default=None,
        help="preprocessed-case cache dir (memory-mapped; full-KiTS scale "
        "without holding the dataset in host RAM)",
    )
    sp.add_argument(
        "--fold", default=None, metavar="I/K",
        help="cross-validation fold, e.g. 0/5: deterministic K-fold split; "
        "fuse the K runs at inference with --fine run0,...,runK-1",
    )
    sp.set_defaults(fn=cmd_train, on_device=True)

    sp = sub.add_parser("predict", help="segment cases")
    sp.add_argument("--data", required=True, help="case dir or single .nii(.gz)")
    sp.add_argument("--fine", required=True, help="fine model run dir / .npz; comma-separate K for a prob-averaging ensemble")
    sp.add_argument("--coarse", default=None, help="coarse run dir (enables cascade)")
    sp.add_argument(
        "--probs-out", default=None, metavar="DIR",
        help="also write f16 class probabilities at the preprocessed grid "
        "({cid}_probs.npz; whole-volume path only) for offline fusion",
    )
    sp.add_argument("--config", default=None, help="preset fallback if run has no config.json")
    sp.add_argument("--out", required=True)
    sp.add_argument("--tta", action="store_true", help="mirror-flip test-time augmentation (fine stage)")
    sp.add_argument("--workers", type=int, default=2, help="pipelined cascade workers")
    sp.add_argument("--device-lanes", type=int, default=0, help=_LANES_HELP)
    sp.set_defaults(fn=cmd_predict, on_device=True)

    sp = sub.add_parser(
        "serve", help="watch-folder serving daemon (predict + report + meshes)"
    )
    sp.add_argument("--watch", required=True, help="directory to watch for *.nii[.gz]")
    sp.add_argument("--out", required=True, help="output directory (also the done-marker)")
    sp.add_argument("--fine", required=True)
    sp.add_argument("--coarse", default=None)
    sp.add_argument("--config", default=None)
    sp.add_argument("--tta", action="store_true")
    sp.add_argument("--workers", type=int, default=2)
    sp.add_argument("--device-lanes", type=int, default=0, help=_LANES_HELP)
    sp.add_argument("--poll", type=float, default=2.0, help="rescan interval seconds")
    sp.add_argument("--once", action="store_true", help="drain current backlog and exit")
    sp.add_argument(
        "--mesh-classes", default=None,
        help="also write per-class STL meshes for these comma-separated ids",
    )
    sp.set_defaults(fn=cmd_serve, on_device=True)

    sp = sub.add_parser(
        "serve-http",
        help="HTTP inference endpoint (POST NIfTI -> labelmap/report)",
    )
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8080, help="0 = ephemeral")
    sp.add_argument("--fine", required=True)
    sp.add_argument("--coarse", default=None)
    sp.add_argument("--config", default=None)
    sp.add_argument("--tta", action="store_true")
    sp.add_argument("--warmup-shape", type=int, nargs=3, default=None,
                    help="warm up with a dummy case of this shape before "
                    "binding, e.g. 512 512 160")
    sp.add_argument("--warmup-spacing", type=float, nargs=3,
                    default=[0.78125, 0.78125, 3.0])
    sp.set_defaults(fn=cmd_serve_http, on_device=True)

    sp = sub.add_parser("evaluate", help="predict + Dice vs ground truth")
    sp.add_argument("--data", required=True)
    sp.add_argument("--fine", required=True)
    sp.add_argument("--coarse", default=None)
    sp.add_argument("--config", default=None)
    sp.add_argument("--tta", action="store_true", help="mirror-flip test-time augmentation (fine stage)")
    sp.add_argument("--workers", type=int, default=2, help="pipelined cascade workers")
    sp.add_argument("--device-lanes", type=int, default=0, help=_LANES_HELP)
    sp.add_argument("--out", default=None, help="also write {cases, summary} JSON here")
    sp.add_argument(
        "--surface", action="store_true",
        help="also report hd95/assd/nsd boundary metrics per class (slower)",
    )
    sp.add_argument(
        "--cldice", default=None,
        help="with --surface: classes for centerline Dice — 'all', or comma "
        "ids (default: vessel classes >= 3)",
    )
    sp.set_defaults(fn=cmd_evaluate, on_device=True)

    sp = sub.add_parser(
        "warmup",
        help="warm the cascade (serving startup step)",
    )
    sp.add_argument("--fine", required=True, help="fine model run dir / .npz (comma-separate for ensemble)")
    sp.add_argument("--coarse", required=True, help="coarse run dir / .npz")
    sp.add_argument("--config", default=None)
    sp.add_argument("--data", default=None, help="warm with the first --cases real cases")
    sp.add_argument("--cases", type=int, default=2)
    sp.add_argument("--shape", type=int, nargs=3, default=None,
                    help="no-data alternative: dummy case shape (e.g. 512 512 160)")
    sp.add_argument("--spacing", type=float, nargs=3, default=[0.78125, 0.78125, 3.0])
    sp.add_argument("--roi", nargs="*", default=None,
                    help="explicit fine ROI buckets to warm, e.g. 192x160x256")
    sp.add_argument("--tta", action="store_true")
    sp.add_argument("--device-lanes", type=int, default=0,
                    help="also warm each of the first N local devices (N > 1 is not ported yet)")
    sp.set_defaults(fn=cmd_warmup, on_device=True)

    sp = sub.add_parser("export", help="export a run's best checkpoint to a serving .npz")
    sp.add_argument("--run", required=True, help="training run dir")
    sp.add_argument("--out", required=True, help="output .npz path")
    sp.add_argument(
        "--average", type=int, default=1, metavar="K",
        help="export the element-wise mean of the best K retained "
        "checkpoints (SWA-style weight averaging) instead of the single best",
    )
    sp.add_argument(
        "--exported-program", default=None, metavar="PATH",
        help="also save the model forward (plain PyTorch path, traced on the "
        "CPU) as a torch.export ExportedProgram, parameters included, "
        "loadable with torch.export.load without this package",
    )
    sp.add_argument("--patch", type=int, nargs=3, default=None,
                    help="exported program's input patch size (default: infer preset)")
    sp.add_argument("--batch", type=int, default=1,
                    help="exported program's input batch dimension")
    sp.set_defaults(fn=cmd_export, on_device=False)

    sp = sub.add_parser("curves", help="plot a run's learning curves to PNG")
    sp.add_argument("--run", required=True, help="run dir containing metrics.jsonl")
    sp.add_argument("--out", default=None, help="output PNG (default <run>/curves.png)")
    sp.set_defaults(fn=cmd_curves, on_device=False)

    sp = sub.add_parser(
        "mesh", help="extract per-class surface meshes (STL/OBJ, world mm)"
    )
    sp.add_argument("--labels", required=True, help="labelmap .nii/.nii.gz (e.g. predict output)")
    sp.add_argument("--out", required=True, help="output directory")
    sp.add_argument("--classes", default="1,2", help="comma-separated class ids")
    sp.add_argument("--format", choices=["stl", "obj"], default="stl")
    sp.add_argument("--smooth", type=int, default=2, help="box-smoothing iterations before extraction")
    sp.set_defaults(fn=cmd_mesh, on_device=False)

    sp = sub.add_parser("visualize", help="write PNG overlay panels per case")
    sp.add_argument("--data", required=True)
    sp.add_argument("--pred", default=None, help="dir of predicted .nii.gz (from predict)")
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_visualize, on_device=False)

    sp = sub.add_parser(
        "plan",
        help="fingerprint a dataset (fg HU percentiles, median spacing, "
        "class balance) and emit a --config-ready JSON with the derived "
        "preprocess section",
    )
    sp.add_argument("--data", required=True)
    sp.add_argument("--out", default=None, help="write the plan JSON here")
    sp.add_argument("--cases", type=int, default=None, help="scan first N cases")
    sp.add_argument(
        "--config", default=None,
        help="preset (or config JSON) to merge the derived preprocess into; "
        "without it the plan carries only the preprocess section",
    )
    sp.set_defaults(fn=cmd_plan, on_device=False)

    sp = sub.add_parser(
        "doctor",
        help="backend health + env report (probes the card in a subprocess "
        "with a timeout; exit 1 when it does not answer)",
    )
    sp.add_argument("--timeout", type=int, default=300,
                    help="probe subprocess timeout, seconds")
    sp.set_defaults(fn=cmd_doctor, on_device=False)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.on_device:
        from runet_tpu_torch import resolve_device

        _check_lanes(getattr(args, "device_lanes", 0))
        args.device = resolve_device(args.device)
    if args.debug:
        from runet_tpu_torch.utils.debug import sanitize

        with sanitize():
            return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
