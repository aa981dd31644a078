"""Closed-loop cascade serving: ``predict_cases`` over a pool of phantom cases.

Traffic parameters (``benchmark/traffic/<mix>.json``):

- ``pool``, ``shape``, ``spacing``, ``num_classes``: the phantom cases made
  in set-up from the run's seed (``benchmark/phantom.py``, in parallel
  threads) and fed round-robin in a seeded order;
- ``workers``: the cases ``predict_cases`` keeps in flight, a closed loop: a
  case is submitted when the entry pulls it from the feed;
- ``tta_axes``: mirror test-time augmentation of the fine stage over these
  axes (empty: none);
- ``check_cases``: how many finished cases, drawn from the seed, the
  reference recomputes once the window has closed (with ``--trace 1`` also
  the first served map of each pool case, for the work model's grids);
- ``metrics``: the names under which the mix reports its rate and its
  95th-percentile latency (``rate``, ``p95``), so that cells whose runs
  spread differently are held to bounds of their own.

The feed stops when the window's ``--seconds`` have passed, and the cases
in flight then drain. A case's latency runs from its submission (the entry
pulling it from the feed) to the entry yielding its labels, for every case
submitted. The rate is every submitted case over the time from the
window's start to the last of them finishing: all the work and all its
time, the drain included, which is also the traced window.

The comparison's ``settings`` (``benchmark/limits/<cell>.json``) hold
``tie_margin``: how far from a tie a coarse logit margin may lie and still
be flipped by the served precision's round-off (``judge``).
"""

from __future__ import annotations

import copy
import gc
import json
import sys
import time

import numpy as np
import torch

from benchmark.phantom import make_pool
from benchmark.reference import cascade as ref_cascade
from benchmark.reference import unet as ref_unet
from benchmark.weights import checked_path


def fine_config(run) -> dict:
    """The fine stage's configuration as served: the file's, with the mix's
    test-time augmentation."""
    cfg = copy.deepcopy(run.config["fine"])
    axes = list(run.traffic.get("tta_axes", []))
    cfg["infer"]["tta"] = bool(axes)
    if axes:
        cfg["infer"]["tta_axes"] = axes
    return cfg


def phantom_kwargs(run) -> list[dict]:
    tr = run.traffic
    seeds = np.random.default_rng([run.seed, 1]).integers(0, 2**31 - 1, tr["pool"])
    return [dict(shape=tuple(tr["shape"]), spacing=tuple(tr["spacing"]),
                 num_classes=tr["num_classes"], seed=int(s)) for s in seeds]


def _bundle(cfg_dict: dict, path, device):
    from runet_tpu_torch.config import Config
    from runet_tpu_torch.infer.cascade import ModelBundle
    from runet_tpu_torch.params import load_model

    cfg = Config.from_json(json.dumps(cfg_dict))
    model, cfg = load_model(cfg, path, device=device)
    return ModelBundle.from_model(model, cfg), cfg


def setup(run):
    t = [time.perf_counter()]
    paths = {k: checked_path(run.root, w) for k, w in run.config["weights"].items()}
    images = make_pool(phantom_kwargs(run))
    t.append(time.perf_counter())
    coarse, _ = _bundle(run.config["coarse"], paths["coarse"], run.device)
    fine, fcfg = _bundle(fine_config(run), paths["fine"], run.device)
    t.append(time.perf_counter())
    order = np.random.default_rng([run.seed, 2]).permutation(len(images))
    st = dict(images=images, order=[int(i) for i in order], coarse=coarse, fine=fine,
              cascade=fcfg.cascade, paths=paths)
    # Warm-up: every pool case once through the entry, so every shape the
    # window meets has been run.
    for _ in _serve(run, st, iter(range(len(images)))):
        pass
    _sync(run.device)
    t.append(time.perf_counter())
    print("set-up: phantoms %.2f s, weights %.2f s, warm-up %.2f s" % tuple(np.diff(t)),
          file=sys.stderr)
    return st


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve(run, st, indices):
    from runet_tpu_torch.infer.cascade import predict_cases

    spacing = tuple(run.traffic["spacing"])
    cases = ((st["images"][i], spacing) for i in indices)
    return predict_cases(st["coarse"], st["fine"], cases, st["cascade"],
                         workers=int(run.traffic["workers"]), device=run.device)


def window(run, st):
    pool_order = st["order"]
    deadline = [None]
    submitted: list[tuple[int, float]] = []  # (pool index, submit time)

    def feed():
        k = 0
        while time.perf_counter() < deadline[0]:
            i = pool_order[k % len(pool_order)]
            submitted.append((i, time.perf_counter()))
            k += 1
            yield i

    rng = np.random.default_rng([run.seed, 3])
    want = int(run.traffic["check_cases"])
    kept: list[tuple[int, int, np.ndarray]] = []  # reservoir of (case number, pool index, labels)
    first: dict[int, np.ndarray] = {}  # with --trace 1: each pool case's first served map
    done_t: list[float] = []
    t0 = time.perf_counter()
    deadline[0] = t0 + run.seconds
    t_prev = t0
    for n, labels in enumerate(_serve(run, st, feed())):
        t = time.perf_counter()
        run.spans.add("wait_case", int(t_prev * 1e9), int(t * 1e9))
        t_prev = t
        done_t.append(t)
        if run.trace:
            first.setdefault(submitted[n][0], labels)
        if n < want:
            kept.append((n, submitted[n][0], labels))
        else:
            j = int(rng.integers(0, n + 1))
            if j < want:
                kept[j] = (n, submitted[n][0], labels)
    _sync(run.device)
    lat = [d - s for (_, s), d in zip(submitted, done_t)]
    names = run.traffic["metrics"]
    metrics = {names["rate"]: 60.0 * len(done_t) / (done_t[-1] - t0),
               names["p95"]: float(np.percentile(lat, 95))}
    return {"setup_s": t0 - run.t_start, "metrics": metrics, "attempted": len(submitted),
            "failed": len(submitted) - len(done_t), "kept": kept, "first": first,
            "served": [i for i, _ in submitted]}


def reference_parts(run, st, device):
    """The reference's view of the two stages: configuration dicts and the
    weights read again from the checked npz files."""
    def part(key, cfg):
        return {"cfg": cfg, "weights": ref_unet.to_device(ref_unet.load_npz(st["paths"][key]),
                                                           device)}
    return part("coarse", run.config["coarse"]), part("fine", fine_config(run))


def free_program(st) -> None:
    for k in ("coarse", "fine"):
        st.pop(k, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def mismatch(served: np.ndarray, ref: np.ndarray) -> float:
    """Share of the voxels either side labels foreground on which the two
    label maps differ."""
    fg = int(np.count_nonzero((served > 0) | (ref > 0)))
    return float(np.count_nonzero(served != ref)) / max(fg, 1)


VARIANTS = 3


def judge(case: ref_cascade.Case, served: np.ndarray, tie_margin: float):
    """(mismatch, margin, boxes) of a served label map: the least mismatch
    against the reference's answer for its own coarse boxes and for each of
    the ``VARIANTS`` box lists nearest to a tie whose margin is within
    ``tie_margin``; ``margin`` and ``boxes`` are those of the list taken (0
    for the reference's own). A coarse voxel on a box face whose foreground
    and background logits nearly tie flips with the served precision's
    round-off, moves the ROI's crop by one coarse voxel and shifts the fine
    grid's sampling phase: 0.6-0.9% of the foreground then differs on the
    boundaries alone. ``tie_margin`` bounds that round-off (PERF.md, "How
    correct is decided")."""
    best = (mismatch(served, case.labels(case.coarse.boxes)), 0.0, case.coarse.boxes)
    for margin, boxes in case.coarse.variants(VARIANTS):
        if margin > tie_margin:
            break
        m = mismatch(served, case.labels(boxes))
        if m < best[0]:
            best = (m, margin, boxes)
    return best


def check(run, st, win):
    """Recompute served cases with the reference and judge them: the sample
    drawn from the seed and, with ``--trace 1``, the first served map of
    every pool case besides. The box lists the served maps match give the
    grids the program's nets ran on (the work model's shapes)."""
    free_program(st)
    coarse, fine = reference_parts(run, st, run.device)
    tta = tuple(run.traffic.get("tta_axes", []))
    spacing = tuple(run.traffic["spacing"])
    tie = float(run.settings["tie_margin"])
    judged = sorted(win["kept"], key=lambda k: k[1])
    judged += [(f"first of pool {i}", i, labels) for i, labels in sorted(win["first"].items())]
    cases, matched = {}, {}
    worst = 0.0
    for n, i, labels in judged:
        if i not in cases:
            cases[i] = ref_cascade.Case(coarse, fine, st["images"][i], spacing, tta, None,
                                        run.device)
        m, margin, boxes = judge(cases[i], labels, tie)
        matched.setdefault(i, boxes)
        grids = cases[i].grids(boxes)["rois"]
        print(f"case {n} (pool {i}): mismatch {m!r}, flip margin {margin!r} "
              f"(tie bound {tie!r}), ROI grids {grids}", file=sys.stderr)
        worst = max(worst, m)
    win["cases"] = cases
    win["grids"] = {i: cases[i].grids(boxes) for i, boxes in matched.items()}
    win["coarse_model"] = run.config["coarse"]["model"]
    win["fine_model"] = fine_config(run)["model"]
    win["tta_passes"] = 2 ** len(tta)
    return {"mismatch": worst}
