"""The plain coarse → ROI → fine cascade: the serving cells' reference.

Everything the served path does to a case, computed again in plain
NumPy/PyTorch from the image and the committed weights, with the U-Nets in
f32 (``reference/unet.py``):

1. the coarse upload: integer striding to the coarse spacing, edge padding to
   multiples of 32, 4-bit quantization over the HU window (or uint8, or
   none, as the configuration says) and its inverse;
2. the staging resample: per axis, linear interpolation at the f32 positions
   j * (dst / src spacing), clamped to the volume; HU clip and z-score;
3. the coarse U-Net on the canonical grid, argmax, foreground mask cropped
   to the true coarse extent;
4. 6-connected components of the mask (scipy), the largest
   ``max_components`` of at least 8 voxels, their boxes;
5. per box: to native voxels with the margin, the physical cap, the fine
   grid bucketed up, the native crop grown to cover it (edge padded), the
   uint8 upload, the staging resample, the fine U-Net (with mirror TTA: the
   mean softmax over every flip subset), argmax;
6. the one-hot label resample back to the native crop (bf16 one-hot values
   and weights, each axis' f32 sums re-rounded to bf16, first maximum: the
   arithmetic the configuration's label resample is defined by), pasted
   nonzero over a native canvas;
7. keep the ``max_components`` largest 6-connected components, ranked over
   the merged ROI boxes.

The geometry (steps 1, 4, 5) is integer and f64 host arithmetic; the
comparison that decides ``correct`` judges everything downstream of it.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from benchmark.reference import unet


def _out_shape(shape, src, dst):
    return tuple(max(1, int(round(n * s / d))) for n, s, d in zip(shape, src, dst))


def _quantize(image: np.ndarray, pp: dict) -> tuple[np.ndarray, float | None]:
    """The upload's values: (levels as f32, step) for a quantized upload,
    (f32 image, None) otherwise."""
    if not pp["transfer_quant"]:
        return image.astype(np.float16).astype(np.float32), None
    lo, hi = pp["hu_window"]
    levels = 15.0 if pp["transfer_quant4"] else 255.0
    q = (image.astype(np.float32) - lo) * (levels / (hi - lo))
    return np.clip(np.rint(q), 0.0, levels).astype(np.float32), (hi - lo) / levels


def _upload(image: np.ndarray, pp: dict, device) -> torch.Tensor:
    """Quantize on the host, dequantize in f32 on the device."""
    q, step = _quantize(image, pp)
    x = torch.from_numpy(np.ascontiguousarray(q)).to(device)
    return x if step is None else x * step + pp["hu_window"][0]


def _positions(n_in: int, n_out: int, scale: float, device):
    pos = torch.arange(n_out, dtype=torch.float32, device=device) \
        * torch.tensor(scale, dtype=torch.float32, device=device)
    pos = pos.clamp(0.0, float(n_in - 1))
    i0 = pos.floor().long().clamp(0, n_in - 1)
    i1 = (i0 + 1).clamp_max(n_in - 1)
    return i0, i1, pos - i0.float()


def _lerp_axis(x: torch.Tensor, axis: int, n_out: int, scale: float, round_bf16: bool):
    i0, i1, w = _positions(x.shape[axis], n_out, scale, x.device)
    w0, w1 = 1.0 - w, w
    if round_bf16:
        w0, w1 = w0.bfloat16().float(), w1.bfloat16().float()
    shape = [1] * x.dim()
    shape[axis] = n_out
    out = x.index_select(axis, i0) * w0.view(shape) + x.index_select(axis, i1) * w1.view(shape)
    return out.bfloat16().float() if round_bf16 else out


def resample(x: torch.Tensor, out_shape, scale) -> torch.Tensor:
    """Linear resample of a 3-D f32 volume, every axis."""
    for a in range(3):
        x = _lerp_axis(x, a, int(out_shape[a]), float(np.float32(scale[a])), False)
    return x


def normalize(x: torch.Tensor, pp: dict) -> torch.Tensor:
    lo, hi = pp["hu_window"]
    x = x.clamp(lo, hi)
    if pp["hu_stats"] is None:
        return (x - x.mean()) / (x.std(correction=0) + 1e-8)
    mean, std = pp["hu_stats"]
    return (x - mean) / std


def resample_labels(labels: torch.Tensor, out_shape, scale, num_classes: int) -> torch.Tensor:
    """One-hot → per-axis linear interpolation in bf16 values → argmax."""
    x = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    for a in range(3):
        x = _lerp_axis(x, a, int(out_shape[a]), float(np.float32(scale[a])), True)
    return torch.argmax(x, dim=-1).to(torch.uint8)


def _probs(w, model_cfg, x: torch.Tensor, tta_axes, quant) -> torch.Tensor:
    """Softmax (K, X, Y, Z) of the U-Net on a (X, Y, Z) volume; with
    ``tta_axes`` the mean over every flip subset of those axes."""
    subsets = [()]
    for a in tta_axes or ():
        subsets += [s + (a,) for s in subsets]
    total = None
    for flips in subsets:
        dims = tuple(d + 2 for d in flips)
        inp = x[None, None]
        inp = inp.flip(dims) if dims else inp
        p = torch.softmax(unet.forward(w, model_cfg, inp, quant), dim=1)
        p = p.flip(dims) if dims else p
        total = p if total is None else total + p
        del p
    return (total / len(subsets))[0]


def _components(mask: np.ndarray):
    lab, n = ndimage.label(mask)
    sizes = np.bincount(lab.ravel(), minlength=n + 1)[1:]
    return lab, n, sizes


def _bbox(sel: np.ndarray):
    idx = np.nonzero(sel)
    return np.asarray([i.min() for i in idx]), np.asarray([i.max() + 1 for i in idx])


class Coarse:
    """Steps 1-4 for one case: the coarse foreground ``mask`` at the true
    coarse extent, its ``margin`` (the best foreground logit less the
    background's), the ``grid`` the net ran on, and the ``boxes`` of the
    largest components."""

    def __init__(self, coarse: dict, cascade: dict, image: np.ndarray, spacing, quant=None,
                 device="cuda"):
        cfg = coarse["cfg"]
        pp, casc = cfg["preprocess"], cascade
        n_sp = np.asarray(spacing, np.float64)
        c_sp = np.asarray(pp["spacing"], np.float64)
        stride = np.maximum((c_sp // n_sp).astype(int), 1)
        strided = image[:: stride[0], :: stride[1], :: stride[2]]
        b32 = tuple(-(-s // 32) * 32 for s in strided.shape)
        if b32 != strided.shape:
            strided = np.pad(strided, [(0, b - s) for s, b in zip(strided.shape, b32)],
                             mode="edge")
        st_sp = tuple(n_sp * stride)
        out_shape = _out_shape(strided.shape, st_sp, tuple(c_sp))
        self.grid = tuple(c if o <= c else -(-o // 16) * 16
                          for o, c in zip(out_shape, casc["coarse_canonical"]))
        if any(r % 32 for r in self.grid) or np.prod(self.grid) > \
                cfg["infer"]["single_pass_ratio"] * np.prod(cfg["infer"]["patch_size"]):
            raise ValueError(f"coarse grid {self.grid} is outside the single-pass path this "
                             "reference covers")
        scale = [d / s for s, d in zip(st_sp, c_sp)]
        x = normalize(resample(_upload(strided, pp, device), self.grid, scale), pp)
        with torch.inference_mode(), unet.strict_f32():
            logits = unet.forward(coarse["weights"], cfg["model"], x[None, None], quant)[0]
        margin = (logits[1:].amax(dim=0) - logits[0]).cpu().numpy()
        self.margin = margin[tuple(slice(0, o) for o in out_shape)]
        self.mask = self.margin > 0
        self.lab, _, sizes = _components(self.mask)
        order = np.argsort(sizes)[::-1]
        self.ids = [int(i) + 1 for i in order[: casc["max_components"]] if sizes[i] >= 8]
        self.boxes = [_bbox(self.lab == i) for i in self.ids]

    def variants(self, k: int) -> list[tuple[float, list]]:
        """The ``k`` box lists nearest to a tie, as (margin, boxes): each
        moves one face of one box by one coarse voxel, inward where every
        voxel of the component on that face could flip out, outward where a
        voxel just beyond it could flip in; ``margin`` is the largest
        |logit margin| that has to flip, and ranks them."""
        found = []
        for b, cid in enumerate(self.ids):
            comp = self.lab == cid
            lo, hi = self.boxes[b]
            for a in range(3):
                for side, plane, beyond in ((0, lo[a], lo[a] - 1), (1, hi[a] - 1, hi[a])):
                    on = np.take(comp, plane, axis=a)
                    rest = comp.copy()
                    np.moveaxis(rest, a, 0)[plane] = False
                    if rest.any():
                        score = float(np.abs(np.take(self.margin, plane, axis=a)[on]).max())
                        found.append((score, b, _bbox(rest)))
                    if 0 <= beyond < self.mask.shape[a]:
                        out = on & ~np.take(self.mask, beyond, axis=a)
                        if out.any():
                            score = float(np.abs(np.take(self.margin, beyond, axis=a)[out]).min())
                            new_lo, new_hi = lo.copy(), hi.copy()
                            (new_lo if side == 0 else new_hi)[a] = beyond + side
                            found.append((score, b, (new_lo, new_hi)))
        found.sort(key=lambda f: f[0])
        out = []
        for score, b, box in found[:k]:
            boxes = list(self.boxes)
            boxes[b] = box
            out.append((score, boxes))
        return out


def roi_plan(coarse: dict, fine: dict, image_shape, spacing, boxes):
    """Step 5's geometry per coarse box: (lo, hi, hi_buf, want_buf, padded
    fine grid), in the order the boxes are pasted."""
    casc = fine["cfg"]["cascade"]
    n_sp = np.asarray(spacing, np.float64)
    c_sp = np.asarray(coarse["cfg"]["preprocess"]["spacing"], np.float64)
    f_sp = np.asarray(fine["cfg"]["preprocess"]["spacing"], np.float64)
    shape = np.asarray(image_shape)
    margin = np.ceil(casc["roi_margin_mm"] / n_sp).astype(int)
    max_vox = np.maximum((casc["roi_max_mm"] / n_sp).astype(int), 1)
    plan = []
    for lo_c, hi_c in boxes:
        lo = np.floor(lo_c * c_sp / n_sp).astype(int) - margin
        hi = np.ceil(hi_c * c_sp / n_sp).astype(int) + margin
        over = np.maximum(hi - lo - max_vox, 0)
        lo, hi = lo + over // 2, hi - (over - over // 2)
        lo, hi = np.maximum(lo, 0), np.minimum(hi, shape)
        if np.any(hi <= lo):
            continue
        exact = _out_shape(tuple(int(s) for s in hi - lo), tuple(spacing), tuple(f_sp))
        b = casc["roi_bucket"]
        padded = tuple(-(-int(s) // b) * b for s in exact)
        want = np.asarray([int(np.ceil((p - 1) * (f / n))) + 1
                           for p, f, n in zip(padded, f_sp, n_sp)])
        cb = max(1, int(casc["crop_bucket"]))
        want_buf = -(-want // cb) * cb
        extra = np.maximum(want - (hi - lo), 0)
        lo = np.maximum(lo - extra // 2, 0)
        lo = np.minimum(lo, np.maximum(shape - want, 0))
        hi = np.minimum(lo + want, shape)
        hi_buf = np.minimum(lo + want_buf, shape)
        plan.append((lo, hi, hi_buf, want_buf, padded))
    return plan


def _keep_largest(canvas: np.ndarray, boxes, max_components: int) -> np.ndarray:
    boxes = [(np.asarray(lo), np.asarray(hi)) for lo, hi in boxes]
    merged = True
    while merged:
        merged, out = False, []
        for lo, hi in boxes:
            for i, (olo, ohi) in enumerate(out):
                if np.all(lo <= ohi) and np.all(olo <= hi):
                    out[i] = (np.minimum(lo, olo), np.maximum(hi, ohi))
                    merged = True
                    break
            else:
                out.append((lo, hi))
        boxes = out
    parts = []
    for lo, hi in boxes:
        sl = tuple(slice(a, b) for a, b in zip(lo, hi))
        lab, n, sizes = _components(canvas[sl] > 0)
        parts.append((sl, lab, sizes))
    ranked = sorted(((int(s), bi, ci + 1) for bi, (_, _, sizes) in enumerate(parts)
                     for ci, s in enumerate(sizes)), reverse=True)
    keep = {(bi, c) for s, bi, c in ranked[:max_components] if s > 0}
    for bi, (sl, lab, sizes) in enumerate(parts):
        lut = np.zeros(len(sizes) + 1, bool)
        for c in range(1, len(sizes) + 1):
            lut[c] = (bi, c) in keep
        crop = canvas[sl]
        crop[~lut[lab]] = 0
    return canvas


class Case:
    """The reference's answers for one case: ``labels(boxes)`` runs steps
    5-7 for a list of coarse boxes (``coarse.boxes``, the reference's own, or
    one of ``coarse.variants``), each fine ROI computed once. The cascade
    settings (canonical grid, components, margins) are the fine stage's
    configuration's, as the served entry takes them."""

    def __init__(self, coarse: dict, fine: dict, image: np.ndarray, spacing, tta_axes=(),
                 quant=None, device="cuda"):
        self.parts, self.image, self.spacing = (coarse, fine), image, spacing
        self.tta, self.quant, self.device = tuple(tta_axes), quant, device
        self.coarse = Coarse(coarse, fine["cfg"]["cascade"], image, spacing, quant, device)
        self._rois: dict = {}

    def plan(self, boxes):
        return roi_plan(*self.parts, self.image.shape, self.spacing, boxes)

    def _roi(self, lo, hi, hi_buf, want_buf, padded) -> np.ndarray:
        key = (tuple(lo), tuple(hi), tuple(hi_buf), tuple(want_buf), padded)
        if key in self._rois:
            return self._rois[key]
        fcfg = self.parts[1]["cfg"]
        pp, infer = fcfg["preprocess"], fcfg["infer"]
        if np.prod(padded) > infer["single_pass_ratio"] * np.prod(infer["patch_size"]):
            raise ValueError(f"ROI grid {padded} is outside the single-pass path this "
                             "reference covers")
        n_sp = np.asarray(self.spacing, np.float64)
        f_sp = np.asarray(pp["spacing"], np.float64)
        img = self.image
        crop = img[lo[0]: hi_buf[0], lo[1]: hi_buf[1], lo[2]: hi_buf[2]]
        if np.any(hi_buf - lo < want_buf):
            crop = np.pad(crop, [(0, int(w - (h - l))) for w, l, h in zip(want_buf, lo, hi_buf)],
                          mode="edge")
        x = normalize(resample(_upload(crop, pp, self.device), padded,
                               [f / n for n, f in zip(n_sp, f_sp)]), pp)
        with torch.inference_mode(), unet.strict_f32():
            probs = _probs(self.parts[1]["weights"], fcfg["model"], x, self.tta, self.quant)
            labels = torch.argmax(probs, dim=0)
        del probs, x
        native = resample_labels(labels, crop.shape, [n / f for n, f in zip(n_sp, f_sp)],
                                 fcfg["model"]["num_classes"]).cpu().numpy()
        self._rois[key] = native[: hi[0] - lo[0], : hi[1] - lo[1], : hi[2] - lo[2]]
        return self._rois[key]

    def labels(self, boxes) -> np.ndarray:
        plan = self.plan(boxes)
        canvas = np.zeros(self.image.shape, np.uint8)
        for lo, hi, hi_buf, want_buf, padded in plan:
            native = self._roi(lo, hi, hi_buf, want_buf, padded)
            dst = canvas[lo[0]: hi[0], lo[1]: hi[1], lo[2]: hi[2]]
            dst[...] = np.where(native > 0, native, dst)
        if plan:
            canvas = _keep_largest(canvas, [(lo, hi) for lo, hi, *_ in plan],
                                   self.parts[1]["cfg"]["cascade"]["max_components"])
        return canvas

    def grids(self, boxes=None) -> dict:
        """The grids the nets run on with ``boxes`` (the reference's own by
        default): the work model's shapes for a case."""
        boxes = self.coarse.boxes if boxes is None else boxes
        return {"coarse": tuple(int(s) for s in self.coarse.grid),
                "rois": [tuple(int(s) for s in p[4]) for p in self.plan(boxes)]}
