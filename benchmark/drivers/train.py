"""The training loop's step path: ``PatchLoader`` feeding ``make_train_step``.

Traffic parameters (``benchmark/traffic/<mix>.json``):

- ``pool``, ``shape``, ``spacing``, ``num_classes``: the phantom cases made
  in set-up from the run's seed (``benchmark/phantom.py``, in parallel
  threads), each turned into a ``PreparedCase`` on the device with the
  program's ``preprocess_case`` (no files written);
- ``check_steps``: the first steps, run in set-up through the window's own
  call and feed, that the reference follows.
- ``torch_threads`` (read by ``benchmark/run.py``): the process's intra-op
  threads.

Batch, patch, foreground share, augmentation and optimizer are the
configuration's ``train`` section. Set-up builds one train state from the
benchmark's seeded weights, runs the ``check_steps`` first steps, and hands
that same state to the window, which runs steps until ``--seconds`` have
passed on the host clock and then waits for the device: ``train_imgs_per_s``
is the images of every step over that whole time.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np
import torch

from benchmark.phantom import make_pool
from benchmark.reference import train as ref_train
from benchmark.weights import load_into, seeded_init

MAX_FG_PER_CLASS = 100_000


def _config(run):
    from runet_tpu_torch.config import Config

    return Config.from_json(json.dumps(run.config["fine"]))


def prepared_cases(run, cfg):
    """The pool as the loader's ``PreparedCase``s: image through the
    program's ``preprocess_case`` on the device, labels resampled by
    nearest neighbour, foreground coordinates per class."""
    from runet_tpu_torch.data.dataset import PreparedCase
    from runet_tpu_torch.preprocess.normalize import preprocess_case
    from runet_tpu_torch.preprocess.resample import output_shape_for_spacing, resample

    tr = run.traffic
    seeds = np.random.default_rng([run.seed, 1]).integers(0, 2**31 - 1, tr["pool"])
    spacing = tuple(tr["spacing"])
    pairs = make_pool([dict(shape=tuple(tr["shape"]), spacing=spacing,
                            num_classes=tr["num_classes"], seed=int(s)) for s in seeds],
                      labels=True)
    pp = cfg.preprocess
    gen = torch.Generator(device=run.device).manual_seed(run.seed % 2**63)
    cases = []
    for n, (img, lab) in enumerate(pairs):
        out_shape = output_shape_for_spacing(img.shape, spacing, pp.spacing)
        scale = tuple(d / s for s, d in zip(spacing, pp.spacing))
        x = preprocess_case(torch.from_numpy(img).to(run.device), spacing, pp.spacing,
                            pp.hu_window, pp.hu_stats)
        labels = resample(torch.from_numpy(lab.astype(np.int32)).to(run.device), out_shape, scale,
                          method="nearest")
        fg = {}
        for cls in range(1, int(labels.max()) + 1):
            coords = torch.nonzero(labels == cls)
            if len(coords) > MAX_FG_PER_CLASS:
                pick = torch.randperm(len(coords), generator=gen, device=run.device)
                coords = coords[pick[:MAX_FG_PER_CLASS]]
            if len(coords):
                fg[cls] = coords.to(torch.int32).cpu().numpy()
        cases.append(PreparedCase(case_id=f"phantom_{n}", image=x.cpu().numpy(),
                                  labels=labels.to(torch.uint8).cpu().numpy(),
                                  native_shape=img.shape, native_spacing=spacing,
                                  affine=np.eye(4), fg_coords=fg))
        del x, labels
    return cases


def setup(run):
    from runet_tpu_torch.data.pipeline import PatchLoader
    from runet_tpu_torch.models.unet3d import create_train_model
    from runet_tpu_torch.train.loop import _step_seed
    from runet_tpu_torch.train.state import create_train_state, make_train_step

    cfg = _config(run)
    t = cfg.train
    marks = [time.perf_counter()]
    cases = prepared_cases(run, cfg)
    marks.append(time.perf_counter())
    init = seeded_init(run.config["fine"]["model"], run.seed, run.device)
    model = create_train_model(cfg.model, run.device)
    load_into(model, init)
    state = create_train_state(model, t)
    step = make_train_step(model, augment=t.augment, elastic=t.elastic,
                           loss_kwargs={"tversky_alpha": t.tversky_alpha,
                                        "tversky_beta": t.tversky_beta})
    loader = PatchLoader(cases, batch_size=t.batch_size, patch_size=t.patch_size,
                         fg_prob=t.fg_prob, seed=run.seed, device=run.device)
    gens = (torch.Generator(), torch.Generator(device=run.device))
    st = dict(init=init, model=model, state=state, step=step, loader=loader, gens=gens,
              seed_of=lambda i: _step_seed(run.seed, i), n=0, batch=t.batch_size,
              batches=[], losses=[])
    names = [n for n, _ in model.named_parameters()]
    for i in range(int(run.traffic["check_steps"])):
        images, labels = next(loader)
        st["batches"].append((images.cpu(), labels.cpu()))
        aux = _step(st, images, labels)
        st["losses"].append(aux["loss"])
        if i == 0:
            mu = state.optimizer.mu
            st["first_grad"] = {n: float(m.norm()) / (1 - state.optimizer.B1)
                                for n, m in zip(names, mu)}
    st["change"] = {n: float((p.detach().float() - init[n.replace(".", "/")].reshape(p.shape))
                             .norm()) for n, p in model.named_parameters()}
    st["losses"] = [float(x) for x in st["losses"]]
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    marks.append(time.perf_counter())
    print("set-up: cases %.2f s, model and first steps %.2f s" % tuple(np.diff(marks)),
          file=sys.stderr)
    return st


def _step(st, images, labels):
    aux = st["step"](st["state"], images, labels, st["gens"], st["seed_of"](st["n"]))
    st["n"] += 1
    return aux


def window(run, st):
    loader, spans = st["loader"], run.spans
    steps, wait = 0, 0.0
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while time.perf_counter() < deadline:
        a = time.perf_counter()
        images, labels = next(loader)
        b = time.perf_counter()
        _step(st, images, labels)
        c = time.perf_counter()
        wait += b - a
        spans.add("loader", int(a * 1e9), int(b * 1e9))
        spans.add("step", int(b * 1e9), int(c * 1e9))
        steps += 1
    a = time.perf_counter()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    end = time.perf_counter()
    spans.add("sync", int(a * 1e9), int(end * 1e9))
    return {"setup_s": t0 - run.t_start, "attempted": steps, "failed": 0, "steps": steps,
            "batch": st["batch"], "loader_wait_s": wait, "elapsed_s": end - t0,
            "metrics": {"train_imgs_per_s": steps * st["batch"] / (end - t0)},
            "model": run.config["fine"]["model"], "patch": run.config["fine"]["train"]["patch_size"]}


def free_program(st) -> None:
    st["loader"].close()
    for k in ("model", "state", "step", "loader", "gens"):
        st.pop(k, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def leaf_gaps(first_grad, change, ref) -> tuple[dict, dict]:
    """Per leaf, the gap between the two sides' norms of the first clipped
    gradient and of the change over the steps, each against the larger of
    the reference's norm of that leaf and of the median leaf. Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the change."""
    _, r_grad, r_change = ref
    keyed = {k.replace("/", "."): k for k in r_grad}
    med_g = float(np.median(list(r_grad.values())))
    grad = {n: abs(first_grad[n] - r_grad[k]) / max(r_grad[k], med_g) for n, k in keyed.items()}
    moved = {n: k for n, k in keyed.items() if r_grad[k] >= 1e-3 * med_g}
    med_c = float(np.median([r_change[k] for k in moved.values()]))
    chg = {n: abs(change[n] - r_change[k]) / max(r_change[k], med_c) for n, k in moved.items()}
    return grad, chg


def gaps(losses, first_grad, change, ref) -> dict:
    """The numbers compared: the largest relative gap of a step's loss; the
    median leaf's gap of the first gradient; the worst leaf's gap of the
    change (``leaf_gaps``). The worst leaf's gradient gap is printed and not
    compared: it is the first conv's kernel on most seeds, whose gradient
    cancels to a small part of its terms and so magnifies the bf16 rounding
    of the backward (PERF.md, "How correct is decided")."""
    grad, chg = leaf_gaps(first_grad, change, ref)
    worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:3]  # noqa: E731
    print(f"worst gradient leaves {worst(grad)}; worst change leaves {worst(chg)}",
          file=sys.stderr)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref[0])),
            "grad_gap_median": float(np.median(list(grad.values()))),
            "change_gap": max(chg.values())}


def reference(run, st, quant=None):
    batches = [(i.to(run.device), lab.to(run.device)) for i, lab in st["batches"]]
    seeds = [ref_train.step_seed(run.seed, i) for i in range(len(batches))]
    return ref_train.run_steps(run.config["fine"], st["init"], batches, seeds, quant)


def check(run, st, win):
    free_program(st)
    return gaps(st["losses"], st["first_grad"], st["change"], reference(run, st))
