"""Readings that set the limits of the correctness comparison, for one cell.

    python3 -m benchmark.control --workload <cell> --program-seeds S.. \
        --control-seeds S.. [--fault-seeds S..] [--seconds 2]

Prints one JSON line per reading: ``{"kind", "seed", "checks"}``.

- ``program``: a run of the cell as the benchmark runs it (a short window),
  its numbers against the reference: the lower readings. For a serving
  cell also, per case judged, the mismatch against the reference's own
  boxes, the margins of the box lists nearest to a tie (and, where the
  own boxes' mismatch exceeds the limit, the mismatch against each), and
  how far the coarse stage's logit margin moves when the
  reference's operands are rounded to bf16 (``coarse_roundoff``): the
  readings the tie bound is set from.
- ``control``: the reference itself put in the program's place, computed
  with fp8 operands (``reference/precision.py``), judged against the f32
  reference on the same inputs: the upper readings.
- ``fault:<name>``: a run with the timed path broken underneath
  (``FAULTS``), for the training cells, whose numbers are also held
  against each fault a training step can have.

All in one process, so the program's kernels and imports are paid once.
The benchmark's own runs never run any of this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from benchmark.run import ROOT, run_cell, use_checkout_caches


def coarse_roundoff(case, device, band: float = 1.0) -> dict:
    """How far the coarse margin moves with bf16 operands: the largest move
    over voxels within ``band`` of a tie and over the whole grid, and the
    bf16 reference's boxes where they differ from the f32 reference's."""
    import numpy as np

    from benchmark.reference import cascade as ref_cascade
    from benchmark.reference.precision import bf16

    coarse, fine = case.parts
    c16 = ref_cascade.Coarse(coarse, fine["cfg"]["cascade"], case.image, case.spacing, bf16,
                             device)
    move = np.abs(c16.margin - case.coarse.margin)
    near = np.abs(case.coarse.margin) <= band
    same = [(a.tolist(), b.tolist()) for a, b in c16.boxes] == \
        [(a.tolist(), b.tolist()) for a, b in case.coarse.boxes]
    return {"near_tie_max": float(move[near].max()) if near.any() else None,
            "all_max": float(move.max()), "bf16_boxes_differ": not same}


def serve_program(details: list):
    """The driver's comparison, then the readings the tie bound is set from,
    appended to ``details``."""
    def check(run, st, win):
        from benchmark.drivers import serve

        out = serve.check(run, st, win)
        for n, i, labels in win["kept"]:
            case = win["cases"][i]
            own = serve.mismatch(labels, case.labels(case.coarse.boxes))
            near = [(margin, serve.mismatch(labels, case.labels(boxes))
                     if own > run.limits["mismatch"] else None)
                    for margin, boxes in case.coarse.variants(serve.VARIANTS)]
            details.append({"case": n, "pool": i, "own": own, "nearest": near,
                            "coarse_roundoff": coarse_roundoff(case, run.device)})
            print(f"reading {json.dumps(details[-1])}", file=sys.stderr)
        return out
    return check


def serve_control(run, st, win):
    """The fp8 reference's label maps, judged as the served ones are against
    the f32 reference, on the cases the run kept."""
    from benchmark.drivers import serve
    from benchmark.reference import cascade as ref_cascade
    from benchmark.reference.precision import fp8

    serve.free_program(st)
    coarse, fine = serve.reference_parts(run, st, run.device)
    tta = tuple(run.traffic.get("tta_axes", []))
    spacing = tuple(run.traffic["spacing"])
    worst = 0.0
    for i in sorted({k[1] for k in win["kept"]}):
        ctl = ref_cascade.Case(coarse, fine, st["images"][i], spacing, tta, fp8, run.device)
        ref = ref_cascade.Case(coarse, fine, st["images"][i], spacing, tta, None, run.device)
        m, margin, _ = serve.judge(ref, ctl.labels(ctl.coarse.boxes),
                                   float(run.settings["tie_margin"]))
        print(f"control pool {i}: mismatch {m!r}, flip margin {margin!r}", file=sys.stderr)
        worst = max(worst, m)
    return {"mismatch": worst}


def train_control(run, st, win):
    """The training numbers of the fp8 reference's steps against the f32
    reference's, from the same weights and batches."""
    from benchmark.drivers import train
    from benchmark.reference.precision import fp8

    train.free_program(st)
    ctl_losses, ctl_grad, ctl_change = train.reference(run, st, quant=fp8)
    ctl_grad = {k.replace("/", "."): v for k, v in ctl_grad.items()}
    ctl_change = {k.replace("/", "."): v for k, v in ctl_change.items()}
    return train.gaps(ctl_losses, ctl_grad, ctl_change, train.reference(run, st))


@contextlib.contextmanager
def half_batch():
    """The loss of a step over half of its batch, the mean taken over the
    rest."""
    from runet_tpu_torch.train import losses

    orig = losses.dice_ce_loss

    def broken(logits, labels, **kw):
        h = max(1, logits.shape[0] // 2)
        return orig(logits[:h], labels[:h], **kw)

    losses.dice_ce_loss = broken
    try:
        yield
    finally:
        losses.dice_ce_loss = orig


@contextlib.contextmanager
def state_unchanged():
    """A step that returns its state unchanged."""
    from runet_tpu_torch.train.state import Optimizer

    orig = Optimizer.step
    Optimizer.step = lambda self, params, grads, norm=None: False
    try:
        yield
    finally:
        Optimizer.step = orig


@contextlib.contextmanager
def labels_altered():
    """A served label map altered where it is produced: kidney and tumor
    swapped."""
    import numpy as np

    from runet_tpu_torch.infer import cascade

    orig = cascade.predict_case

    def broken(*args, **kw):
        out = orig(*args, **kw)
        lut = np.arange(256, dtype=np.uint8)
        lut[1], lut[2] = 2, 1
        return lut[out]

    cascade.predict_case = broken
    try:
        yield
    finally:
        cascade.predict_case = orig


FAULTS = {"half_batch": half_batch, "state_unchanged": state_unchanged,
          "labels_altered": labels_altered}


def readings(workload, program_seeds, control_seeds, fault_seeds, faults, seconds,
             device="cuda", overrides=None):
    """Yield each reading as a dict."""
    serving = _driver(workload) == "serve"
    for seed in program_seeds:
        details: list = []
        res = run_cell(ROOT, workload, seed, seconds, False, device, overrides,
                       check=serve_program(details) if serving else None)
        yield {"kind": "program", "seed": seed, "correct": res["correct"],
               "checks": {k: c["value"] for k, c in res["checks"].items()},
               **({"cases": details} if serving else {})}
    for seed in control_seeds:
        res = run_cell(ROOT, workload, seed, seconds, False, device, overrides,
                       check=_control_for(workload))
        yield {"kind": "control", "seed": seed, "correct": res["correct"],
               "checks": {k: c["value"] for k, c in res["checks"].items()}}
    for name in faults:
        for seed in fault_seeds:
            with FAULTS[name]():
                res = run_cell(ROOT, workload, seed, seconds, False, device, overrides)
            yield {"kind": f"fault:{name}", "seed": seed, "correct": res["correct"],
                   "checks": {k: c["value"] for k, c in res["checks"].items()}}


def _driver(workload) -> str:
    from benchmark.run import load_cell

    return load_cell(ROOT, workload).traffic["driver"]


def _control_for(workload):
    return {"serve": serve_control, "train": train_control}[_driver(workload)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    use_checkout_caches(ROOT)
    for r in readings(args.workload, args.program_seeds, args.control_seeds, args.fault_seeds,
                      args.faults, args.seconds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
