"""Coarse → ROI → fine cascade: the serving path.

Counterpart of ``runet_tpu/infer/cascade.py``. Per case:

1. upload the (optionally quantized) image, dequantize, resample to the
   coarse spacing and normalize on the device;
2. coarse U-Net at the 128³ canonical grid → binary mask, bit-packed;
3. host connected components → up to ``max_components`` ROI boxes + margin;
4. per ROI: crop the NATIVE volume, resample the crop to the fine spacing at
   a bucketed grid, fine U-Net, argmax;
5. one-hot back-resample of each ROI's labels to its native crop, packed;
6. host paste into a native canvas and keep the 2 largest components.

The full volume never exists at fine spacing — only kidney ROIs do.
Not ported yet (ROADMAP.md): mirror-flip TTA, ``roi_batch > 1`` and
multi-device serving lanes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from runet_tpu_torch import resolve_device
from runet_tpu_torch.config import CascadeConfig, Config, InferConfig, PreprocessConfig
from runet_tpu_torch.infer.packing import (
    pack_bits,
    pack_crumbs,
    pack_nibbles,
    pack_width,
    unpack_bits,
    unpack_crumbs,
    unpack_nibbles,
)
from runet_tpu_torch.infer.postprocess import (
    component_bounding_boxes,
    keep_largest_components_in_boxes,
)
from runet_tpu_torch.infer.sliding_window import _single_pass, sliding_window_predict
from runet_tpu_torch.preprocess.normalize import normalize
from runet_tpu_torch.preprocess.resample import (
    output_shape_for_spacing,
    resample_dynamic,
    resample_labels_onehot_dynamic,
)
from runet_tpu_torch.utils.timing import PhaseTimer


@dataclasses.dataclass
class ModelBundle:
    """Everything needed to run one stage of the cascade."""

    apply_fn: Callable[[Any, torch.Tensor], torch.Tensor]  # (params, windows (B,px,py,pz,C)) -> logits
    params: Any
    num_classes: int
    preprocess: PreprocessConfig
    infer: InferConfig

    @classmethod
    def from_model(cls, model: torch.nn.Module, cfg: Config) -> "ModelBundle":
        """Bundle a loaded ``UNet3D`` with its config (``params`` is unused:
        the module holds its weights)."""
        return cls(apply_fn=lambda _p, w: model(w), params=None,
                   num_classes=cfg.model.num_classes, preprocess=cfg.preprocess,
                   infer=cfg.infer)


def _check_bundle(bundle: ModelBundle):
    if bundle.infer.tta:
        raise NotImplementedError("test-time augmentation is not ported yet")


def _to_transfer_dtype(image: np.ndarray, pp: PreprocessConfig | None = None) -> np.ndarray:
    """One canonical upload dtype: f16 by default (HU exact to 2048); with
    ``pp.transfer_quant`` uint8 over ``pp.hu_window`` (np.rint: half to
    even); with ``transfer_quant4`` two 4-bit voxels per byte along z, low
    nibble = even z, an odd z edge-padded."""
    if pp is not None and pp.transfer_quant:
        lo, hi = pp.hu_window
        if pp.transfer_quant4:
            q = (image.astype(np.float32) - lo) * (15.0 / (hi - lo))
            q = np.clip(np.rint(q), 0.0, 15.0).astype(np.uint8)
            if q.shape[-1] % 2:
                q = np.concatenate([q, q[..., -1:]], axis=-1)
            return q[..., 0::2] | (q[..., 1::2] << 4)
        q = (image.astype(np.float32) - lo) * (255.0 / (hi - lo))
        return np.clip(np.rint(q), 0.0, 255.0).astype(np.uint8)
    if image.dtype == np.float16:
        return image
    return image.astype(np.float16)


def _dequant(x: torch.Tensor, hu_window: tuple[float, float]) -> torch.Tensor:
    """Inverse of the uint8 transfer quantization, to f32 (a float upload
    passes through)."""
    if x.dtype != torch.uint8:
        return x
    lo, hi = hu_window
    return x.float() * ((hi - lo) / 255.0) + lo


def _dequant4(x: torch.Tensor, hu_window: tuple[float, float], in_z: int) -> torch.Tensor:
    """Inverse of the 4-bit packing: two voxels per byte along z (low
    nibble = even z), the odd-z pad sliced off, 16 levels to f32."""
    lo_w, hi_w = hu_window
    full = torch.stack([x & 0x0F, x >> 4], dim=-1).reshape(*x.shape[:-1], -1)[..., :in_z]
    return full.float() * ((hi_w - lo_w) / 15.0) + lo_w


def _upload(image: np.ndarray, pp: PreprocessConfig, device) -> torch.Tensor:
    return torch.from_numpy(_to_transfer_dtype(np.ascontiguousarray(image), pp)).to(device)


def _stage_resample_in(up: torch.Tensor, out_shape, scale, pp: PreprocessConfig,
                       in_z: int | None = None) -> torch.Tensor:
    """dequant → resample → normalize."""
    deq = _dequant4(up, pp.hu_window, in_z) if in_z is not None else _dequant(up, pp.hu_window)
    return normalize(resample_dynamic(deq, out_shape, scale, "linear"), pp.hu_window, pp.hu_stats)


def _predict_stage(bundle: ModelBundle, volume: torch.Tensor, return_probs: bool = False):
    return sliding_window_predict(
        bundle.apply_fn, bundle.params, volume,
        patch_size=tuple(bundle.infer.patch_size),
        num_classes=bundle.num_classes,
        overlap=bundle.infer.overlap,
        sigma_scale=bundle.infer.sigma_scale,
        use_gaussian=bundle.infer.use_gaussian,
        window_batch=bundle.infer.window_batch,
        single_pass_ratio=bundle.infer.single_pass_ratio,
        expand_windows=bundle.infer.expand_windows,
        return_probs=return_probs,
    )


def _pack_labels(native: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Widest lossless last-axis packing for the label fetch."""
    w = pack_width(num_classes)
    if w == 2:
        return pack_crumbs(native)
    if w == 4:
        return pack_nibbles(native)
    return native


def _unpack_labels(packed: np.ndarray, num_classes: int, n: int) -> np.ndarray:
    w = pack_width(num_classes)
    if w == 2:
        return unpack_crumbs(packed, n)
    if w == 4:
        return unpack_nibbles(packed, n)
    return np.asarray(packed)


def _labels_to_native(labels: torch.Tensor, native_shape, scale_fn, num_classes: int) -> np.ndarray:
    """One-hot back-resample of device labels to a native grid, fetched
    packed, as host uint8."""
    native = resample_labels_onehot_dynamic(
        labels.to(torch.int32), tuple(int(s) for s in native_shape),
        np.asarray(scale_fn, np.float32), num_classes).to(torch.uint8)
    packed = _pack_labels(native, num_classes).cpu().numpy()
    return _unpack_labels(packed, num_classes, int(native_shape[2]))


def _bucket_up(size, bucket: int) -> tuple[int, int, int]:
    """Round dims up to multiples of ``bucket``. The TPU package's separate
    lane-axis bucket exists for its kernels' W gate; it is what JAX runs
    off the TPU (``lane_bucket=None``), and the Hopper kernels need none."""
    return tuple(-(-int(s) // bucket) * bucket for s in size)


def _coarse_stage_core(bundle: ModelBundle, x: torch.Tensor) -> torch.Tensor:
    """pad32 (with the volume minimum, "air") → forward → argmax → binarize
    → bit-pack along z."""
    shape = x.shape
    div32 = tuple(-(-s // 32) * 32 for s in shape)
    if div32 != tuple(shape):
        x = F.pad(x, (0, div32[2] - shape[2], 0, div32[1] - shape[1], 0, div32[0] - shape[0]),
                  value=float(x.min()))
    labels, _ = _single_pass(bundle.apply_fn, bundle.params, x[..., None])
    return pack_bits(labels[: shape[0], : shape[1], : shape[2]] > 0)


def predict_volume(fine: ModelBundle, image: np.ndarray, native_spacing,
                   return_probs: bool = False, device=None):
    """Fine model over the whole volume (single pass or windows), labels
    resampled back to the native grid as host uint8. ``return_probs`` also
    returns the class probabilities at the preprocessed grid as f16 numpy,
    with the preprocess spacing."""
    dev = resolve_device(device)
    _check_bundle(fine)
    pp = fine.preprocess
    with torch.inference_mode():
        out_shape = output_shape_for_spacing(image.shape, native_spacing, pp.spacing)
        scale = np.asarray([d / s for s, d in zip(native_spacing, pp.spacing)], np.float32)
        in_z = int(image.shape[-1]) if pp.transfer_quant and pp.transfer_quant4 else None
        vol = _stage_resample_in(_upload(image, pp, dev), out_shape, scale, pp, in_z)
        scale_fn = [n / f for n, f in zip(native_spacing, pp.spacing)]
        if return_probs:
            labels, probs = _predict_stage(fine, vol, return_probs=True)
            native = _labels_to_native(labels, image.shape, scale_fn, fine.num_classes)
            return native, probs.half().cpu().numpy(), pp.spacing
        labels = _predict_stage(fine, vol)
        return _labels_to_native(labels, image.shape, scale_fn, fine.num_classes)


def predict_case(
    coarse: ModelBundle,
    fine: ModelBundle,
    image: np.ndarray,
    native_spacing,
    cascade: CascadeConfig = CascadeConfig(),
    postprocess: bool = True,
    timer: PhaseTimer | None = None,
    device=None,
) -> np.ndarray:
    """Full cascade on ``device`` (CUDA unless named); returns uint8 labels
    at the native shape."""
    dev = resolve_device(device)
    with torch.inference_mode():
        return _predict_case(coarse, fine, np.asarray(image), native_spacing, cascade,
                             postprocess, timer, dev)


def _predict_case(coarse, fine, image, native_spacing, cascade, postprocess, timer, dev):
    _check_bundle(coarse)
    _check_bundle(fine)
    if cascade.roi_batch > 1:
        raise NotImplementedError("roi_batch > 1 is not ported yet")
    if fine.preprocess.transfer_quant4:
        raise ValueError("transfer_quant4 is not supported on the fine/ROI path; "
                         "set it only on the coarse preset's PreprocessConfig")
    t = timer if timer is not None else PhaseTimer(enabled=False)
    n_sp = np.asarray(native_spacing, np.float64)
    c_sp = np.asarray(coarse.preprocess.spacing, np.float64)
    f_sp = np.asarray(fine.preprocess.spacing, np.float64)
    c_pp = coarse.preprocess

    # ---- coarse localization ----
    with t.phase("coarse_preprocess"):
        # Host-side integer striding before upload: localization tolerates
        # the aliasing and the upload shrinks by the stride product.
        stride = np.maximum((c_sp // n_sp).astype(int), 1)
        strided = image[:: stride[0], :: stride[1], :: stride[2]]
        # Bucket the strided shape up to multiples of 32 (edge pad).
        bucket32 = tuple(-(-s // 32) * 32 for s in strided.shape)
        if bucket32 != strided.shape:
            strided = np.pad(strided, [(0, b - s) for s, b in zip(strided.shape, bucket32)],
                             mode="edge")
        strided_spacing = tuple(n_sp * stride)
        c_out_shape = output_shape_for_spacing(strided.shape, strided_spacing, c_pp.spacing)
        # Canonical coarse grid: positions clamp at the volume edge, so a
        # larger fixed output grid is safe; the mask is cropped back below.
        c_run_shape = tuple(
            c if o <= c else -(-o // 16) * 16
            for o, c in zip(c_out_shape, cascade.coarse_canonical)
        )
        c_scale = np.asarray([d / s for s, d in zip(strided_spacing, c_pp.spacing)], np.float32)
        c_single = (
            coarse.infer.single_pass_ratio > 0
            and np.prod([-(-s // 32) * 32 for s in c_run_shape])
            <= coarse.infer.single_pass_ratio * np.prod(coarse.infer.patch_size)
        )
    with t.phase("coarse_predict", sync=dev):
        in_z = int(strided.shape[-1]) if c_pp.transfer_quant and c_pp.transfer_quant4 else None
        if c_single:
            x = _stage_resample_in(_upload(strided, c_pp, dev), c_run_shape, c_scale, c_pp, in_z)
            mask = unpack_bits(_coarse_stage_core(coarse, x).cpu().numpy(), c_run_shape[2])
        else:
            vol = _stage_resample_in(_upload(strided, c_pp, dev), c_out_shape, c_scale, c_pp, in_z)
            mask = (_predict_stage(coarse, vol).cpu().numpy() > 0).astype(np.uint8)
        mask = mask[: c_out_shape[0], : c_out_shape[1], : c_out_shape[2]]

    with t.phase("coarse_boxes"):
        boxes = component_bounding_boxes(mask, max_components=cascade.max_components,
                                         min_voxels=8)

    native_canvas = np.zeros(image.shape, np.uint8)
    margin_vox = np.ceil(cascade.roi_margin_mm / n_sp).astype(int)
    native_boxes = []
    roi_results = []  # (lo, hi, want_buf, device packed labels)
    scale_nf = np.asarray([f / n for n, f in zip(n_sp, f_sp)], np.float32)
    scale_fn = np.asarray([n / f for n, f in zip(n_sp, f_sp)], np.float32)
    f_pp = fine.preprocess

    for lo_c, hi_c in boxes:
        # coarse voxel → mm → NATIVE voxel, plus margin.
        lo = np.floor(lo_c * c_sp / n_sp).astype(int) - margin_vox
        hi = np.ceil(hi_c * c_sp / n_sp).astype(int) + margin_vox
        # Cap the ROI's physical extent (centred).
        max_vox = np.maximum((cascade.roi_max_mm / n_sp).astype(int), 1)
        over = np.maximum(hi - lo - max_vox, 0)
        lo = lo + over // 2
        hi = hi - (over - over // 2)
        lo = np.maximum(lo, 0)
        hi = np.minimum(hi, image.shape)
        if np.any(hi <= lo):
            continue

        # Bucket the FINE grid, then grow the native crop so the bucketed
        # grid is filled with real context.
        fine_exact = output_shape_for_spacing(tuple(int(s) for s in (hi - lo)),
                                              native_spacing, tuple(f_sp))
        padded_shape = _bucket_up(fine_exact, cascade.roi_bucket)
        scale_nf_t = tuple(f / n for n, f in zip(n_sp, f_sp))
        # Native extent whose corner-aligned resample covers the padded fine
        # grid without edge clamping: (p-1)*scale <= want-1.
        want = np.asarray([int(np.ceil((p - 1) * s)) + 1 for p, s in zip(padded_shape, scale_nf_t)])
        cb = max(1, int(cascade.crop_bucket))
        want_buf = -(-want // cb) * cb
        # Place the exact covered window first (symmetric growth to want);
        # the bucket buffer is a pure suffix of context / edge pad.
        extra = np.maximum(want - (hi - lo), 0)
        lo = np.maximum(lo - extra // 2, 0)
        lo = np.minimum(lo, np.maximum(np.asarray(image.shape) - want, 0))
        hi = np.minimum(lo + want, image.shape)
        hi_buf = np.minimum(lo + want_buf, image.shape)
        native_boxes.append((lo.copy(), hi.copy()))
        crop = image[lo[0]: hi_buf[0], lo[1]: hi_buf[1], lo[2]: hi_buf[2]]
        if np.any(hi_buf - lo < want_buf):
            crop = np.pad(crop, [(0, int(w - (h - l))) for w, l, h in zip(want_buf, lo, hi_buf)],
                          mode="edge")
        single_pass = (
            fine.infer.single_pass_ratio > 0
            and np.prod(padded_shape) <= fine.infer.single_pass_ratio * np.prod(fine.infer.patch_size)
        )
        with t.phase("roi_predict"):
            roi = _stage_resample_in(_upload(crop, f_pp, dev), padded_shape, scale_nf, f_pp)
            if single_pass:
                roi_labels, _ = _single_pass(fine.apply_fn, fine.params, roi[..., None])
            else:
                roi_labels = _predict_stage(fine, roi)
            native = resample_labels_onehot_dynamic(
                roi_labels.to(torch.int32), tuple(crop.shape), scale_fn, fine.num_classes
            ).to(torch.uint8)
            roi_results.append((lo, hi, tuple(int(w) for w in want_buf),
                                _pack_labels(native, fine.num_classes)))

    # ---- fetch + paste (every ROI's device work is already queued) ----
    for lo, hi, want_buf, dev_packed in roi_results:
        with t.phase("roi_fetch_paste"):
            # Labels come back at the crop BUFFER shape; only the exactly
            # covered region [0 : hi-lo) is pasted, nonzero over the canvas.
            fetched = _unpack_labels(dev_packed.cpu().numpy(), fine.num_classes, want_buf[2])
            crop_labels = fetched[: hi[0] - lo[0], : hi[1] - lo[1], : hi[2] - lo[2]]
            dst = native_canvas[lo[0]: hi[0], lo[1]: hi[1], lo[2]: hi[2]]
            native_canvas[lo[0]: hi[0], lo[1]: hi[1], lo[2]: hi[2]] = np.where(
                crop_labels > 0, crop_labels, dst)

    if postprocess and native_boxes:
        with t.phase("postprocess_cc"):
            native_canvas = keep_largest_components_in_boxes(
                native_canvas, native_boxes, max_components=cascade.max_components,
                inplace=True)
    return native_canvas


def predict_cases(
    coarse: ModelBundle,
    fine: ModelBundle,
    cases,  # iterable of (image, native_spacing)
    cascade: CascadeConfig = CascadeConfig(),
    postprocess: bool = True,
    workers: int = 2,
    device=None,
):
    """Pipelined multi-case cascade: ``workers`` cases in flight on a thread
    pool, so case i's host work (striding, components, paste) overlaps case
    i+1's device work. Results are yielded IN ORDER; ``cases`` may be lazy
    (at most ``workers + 1`` cases are held)."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    dev = resolve_device(device)

    def run_one(img, sp):
        return predict_case(coarse, fine, img, sp, cascade, postprocess, device=dev)

    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        inflight: deque = deque()
        for img, sp in cases:
            inflight.append(pool.submit(run_one, img, sp))
            if len(inflight) > workers:
                yield inflight.popleft().result()
        while inflight:
            yield inflight.popleft().result()
