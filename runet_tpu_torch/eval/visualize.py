"""Segmentation visualization (SURVEY.md §2.1 "Visualization").

A copy of ``runet_tpu/eval/visualize.py``: numpy, with matplotlib imported
inside the functions, so importing this module needs no matplotlib.

Reference form: matplotlib slice plots in notebooks (provenance [RECALL]).
Rebuild: headless helpers that write PNG panels — axial/coronal/sagittal
slices with label overlays, and a per-axis max-intensity projection — for
eyeballing training/eval outputs without a notebook.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# Label colors (RGBA), index = class id: bg, kidney, tumor, artery, vein.
_COLORS = np.array(
    [
        [0.0, 0.0, 0.0, 0.0],
        [0.9, 0.2, 0.2, 0.5],
        [0.2, 0.9, 0.2, 0.6],
        [0.9, 0.2, 0.9, 0.6],
        [0.2, 0.4, 0.9, 0.6],
    ]
)


def save_training_curves(
    metrics_path: str | Path, out_path: str | Path, title: str = ""
) -> Path:
    """Learning-curve panel from a run's metrics.jsonl (train/metrics.py).

    The reference eyeballed training from notebook plots (SURVEY.md §5.5,
    [RECALL]); this is the headless equivalent: loss terms, validation Dice,
    and throughput vs step, one PNG.
    """
    import json

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = [
        json.loads(l)
        for l in Path(metrics_path).read_text().splitlines()
        if l.strip()
    ]
    series: dict[str, tuple[list, list]] = {}
    for r in rows:
        for k, v in r.items():
            if k in ("step", "wall_s") or not isinstance(v, (int, float)):
                continue
            series.setdefault(k, ([], []))
            series[k][0].append(r["step"])
            series[k][1].append(v)

    groups = [
        ("loss", [k for k in series if "loss" in k]),
        ("validation Dice", [k for k in series if k.startswith("val_")]),
        ("throughput", [k for k in series if "per_s" in k]),
    ]
    shown = {k for _, ks in groups for k in ks}
    other = [k for k in series if k not in shown]
    if other:
        groups.append(("other", other))
    groups = [(name, ks) for name, ks in groups if ks]

    fig, axes = plt.subplots(1, max(len(groups), 1), figsize=(5 * max(len(groups), 1), 4))
    axes = np.atleast_1d(axes)
    for ax, (name, keys) in zip(axes, groups):
        for k in sorted(keys):
            xs, ys = series[k]
            ax.plot(xs, ys, label=k, marker="." if len(xs) < 50 else None)
        ax.set_xlabel("step")
        ax.set_title(name, fontsize=10)
        if name == "loss" and all(v > 0 for k in keys for v in series[k][1]):
            ax.set_yscale("log")
        ax.legend(fontsize=7)
        ax.grid(True, alpha=0.3)
    if title:
        fig.suptitle(title)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def _window(img: np.ndarray, lo: float = -160.0, hi: float = 400.0) -> np.ndarray:
    x = np.clip(img.astype(np.float32), lo, hi)
    return (x - lo) / (hi - lo)


def overlay_slice(
    image: np.ndarray, labels: np.ndarray | None, axis: int, index: int
) -> np.ndarray:
    """(H, W, 3) float RGB of one slice with label overlay."""
    sl = [slice(None)] * 3
    sl[axis] = index
    img2d = _window(image[tuple(sl)])
    rgb = np.stack([img2d] * 3, axis=-1)
    if labels is not None:
        lab2d = labels[tuple(sl)].astype(int)
        lab2d = np.clip(lab2d, 0, len(_COLORS) - 1)
        color = _COLORS[lab2d]
        alpha = color[..., 3:4]
        rgb = rgb * (1 - alpha) + color[..., :3] * alpha
    return rgb


def save_case_panel(
    path: str | Path,
    image: np.ndarray,
    labels: np.ndarray | None = None,
    pred: np.ndarray | None = None,
    title: str = "",
) -> Path:
    """3×N panel: rows = axial/coronal/sagittal center (or label-centroid)
    slices; columns = image, gt overlay, pred overlay (as available)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ref = labels if labels is not None else pred
    if ref is not None and (ref > 0).any():
        center = np.round(np.argwhere(ref > 0).mean(axis=0)).astype(int)
    else:
        center = np.asarray(image.shape) // 2

    cols = [("image", None)]
    if labels is not None:
        cols.append(("ground truth", labels))
    if pred is not None:
        cols.append(("prediction", pred))

    fig, axes = plt.subplots(3, len(cols), figsize=(4 * len(cols), 12))
    axes = np.atleast_2d(axes)
    if axes.shape[0] != 3:
        axes = axes.T
    for r, ax_dim in enumerate(range(3)):
        for c, (name, lab) in enumerate(cols):
            a = axes[r][c]
            a.imshow(
                overlay_slice(image, lab, ax_dim, int(center[ax_dim])).transpose(1, 0, 2),
                origin="lower",
            )
            a.set_title(f"{name} [{'xyz'[ax_dim]}={center[ax_dim]}]", fontsize=9)
            a.axis("off")
    if title:
        fig.suptitle(title)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return path
