"""Coarse → ROI → fine cascade: the serving path.

Counterpart of ``runet_tpu/infer/cascade.py``. Per case:

1. upload the (optionally quantized) image, dequantize, resample to the
   coarse spacing and normalize on the device;
2. coarse U-Net at the 128³ canonical grid → binary mask, bit-packed;
3. host connected components → up to ``max_components`` ROI boxes + margin;
4. per ROI: crop the NATIVE volume, resample the crop to the fine spacing at
   a bucketed grid, fine U-Net, argmax;
5. one-hot back-resample of each ROI's labels to its native crop, packed;
6. host paste into a native canvas and keep the 2 largest components,
   both through the native C++ tier (``utils/native.py``) where it builds.

The full volume never exists at fine spacing — only kidney ROIs do.
``InferConfig.tta`` wraps a stage's ``apply_fn`` with mirror-flip averaging
(``infer/tta.py``); ``CascadeConfig.roi_batch > 1`` holds single-pass ROIs of
the same bucket and runs each full group through one batched forward.
``predict_cases(devices=...)`` serves cases on independent per-device lanes,
each holding its own copy of the models (``bundle_on_device``).
"""

from __future__ import annotations

import contextlib
import copy
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
from runet_tpu_torch.infer.tta import effective_apply_fn
from runet_tpu_torch.preprocess.normalize import normalize
from runet_tpu_torch.preprocess.resample import (
    output_shape_for_spacing,
    resample_dynamic,
    resample_labels_onehot_dynamic,
)
from runet_tpu_torch.utils.native import native_paste_crumbs, native_paste_nibbles
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
        """Bundle a loaded ``UNet3D`` with its config: the module is the
        bundle's ``params`` (it holds its weights), so a serving lane can
        hold a copy of it on its own device (``bundle_on_device``)."""
        return cls(apply_fn=module_apply, params=model, num_classes=cfg.model.num_classes,
                   preprocess=cfg.preprocess, infer=cfg.infer)


def module_apply(model: torch.nn.Module, windows: torch.Tensor) -> torch.Tensor:
    """``apply_fn`` of a bundle whose ``params`` is the module itself."""
    return model(windows)


def _params_on(params, device: torch.device):
    """``params`` with every module in it (itself, or the members of an
    ensemble's list) on ``device``: one already there is shared, any other
    copied whole; anything else is returned as it is."""
    if isinstance(params, torch.nn.Module):
        on = {p.device for p in params.parameters()} | {b.device for b in params.buffers()}
        if on <= {device}:
            return params
        return copy.deepcopy(params).to(device)
    if isinstance(params, (list, tuple)):
        return type(params)(_params_on(p, device) for p in params)
    return params


def bundle_on_device(bundle: ModelBundle, device) -> ModelBundle:
    """Copy of ``bundle`` with its modules on ``device``; one serving lane
    of ``predict_cases(devices=...)``. A lane on the bundle's own device
    shares its module."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dataclasses.replace(bundle, params=_params_on(bundle.params, dev))


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
        effective_apply_fn(bundle), bundle.params, volume,
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


def _native_paste_packed(canvas: np.ndarray, packed: np.ndarray, lo, extent,
                         num_classes: int) -> bool:
    """Fused native unpack + nonzero paste of the ``extent`` prefix of a
    packed crop at ``canvas[lo : lo + extent]``, for whichever packing
    ``_pack_labels`` chose; False when the native tier is unavailable or the
    labels were fetched unpacked."""
    w = pack_width(num_classes)
    if w == 2:
        return native_paste_crumbs(canvas, packed, lo, extent)
    if w == 4:
        return native_paste_nibbles(canvas, packed, lo, extent)
    return False


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


def _roi_program(apply_fn, fine: ModelBundle, up: torch.Tensor, padded_shape, crop_shape,
                 scale_nf, scale_fn) -> torch.Tensor:
    """One single-pass ROI on the device: dequant → resample → normalize →
    forward → argmax → one-hot back-resample to the native crop → pack."""
    roi = _stage_resample_in(up, padded_shape, scale_nf, fine.preprocess)
    labels, _ = _single_pass(apply_fn, fine.params, roi[..., None])
    native = resample_labels_onehot_dynamic(
        labels.to(torch.int32), tuple(crop_shape), scale_fn, fine.num_classes).to(torch.uint8)
    return _pack_labels(native, fine.num_classes)


def _stage_resample_in_batch(ups: torch.Tensor, padded_shape, scale_nf,
                             pp: PreprocessConfig) -> torch.Tensor:
    """``_stage_resample_in`` per sample of a (B, cx, cy, cz) upload (normalize
    must see per-ROI statistics when ``hu_stats`` is None)."""
    return torch.stack([_stage_resample_in(u, padded_shape, scale_nf, pp) for u in ups])


def _roi_stage_core_batch(apply_fn, params, rois: torch.Tensor) -> torch.Tensor:
    """The batched forward and argmax: (B, *padded) → uint8 labels."""
    probs = torch.softmax(apply_fn(params, rois[..., None]).float(), dim=-1)
    return torch.argmax(probs, dim=-1).to(torch.uint8)


def _roi_stage_out_batch(labels: torch.Tensor, crop_shape, scale_fn,
                         num_classes: int) -> torch.Tensor:
    """One-hot back-resample per sample, then the (batch-agnostic) last-axis
    pack."""
    native = torch.stack([
        resample_labels_onehot_dynamic(lab.to(torch.int32), tuple(crop_shape), scale_fn,
                                       num_classes).to(torch.uint8)
        for lab in labels])
    return _pack_labels(native, num_classes)


def _roi_program_batch(apply_fn, fine: ModelBundle, ups: torch.Tensor, padded_shape, crop_shape,
                       scale_nf, scale_fn) -> torch.Tensor:
    """``_roi_program`` for B same-bucket ROIs: one batched forward between
    per-sample resamples."""
    rois = _stage_resample_in_batch(ups, padded_shape, scale_nf, fine.preprocess)
    labels = _roi_stage_core_batch(apply_fn, fine.params, rois)
    return _roi_stage_out_batch(labels, crop_shape, scale_fn, fine.num_classes)


def _coarse_stage_core(apply_fn, params, x: torch.Tensor) -> torch.Tensor:
    """pad32 (with the volume minimum, "air") → forward → argmax → binarize
    → bit-pack along z."""
    shape = x.shape
    div32 = tuple(-(-s // 32) * 32 for s in shape)
    if div32 != tuple(shape):
        x = F.pad(x, (0, div32[2] - shape[2], 0, div32[1] - shape[1], 0, div32[0] - shape[0]),
                  value=float(x.min()))
    labels, _ = _single_pass(apply_fn, params, x[..., None])
    return pack_bits(labels[: shape[0], : shape[1], : shape[2]] > 0)


def predict_volume(fine: ModelBundle, image: np.ndarray, native_spacing,
                   return_probs: bool = False, device=None):
    """Fine model over the whole volume (single pass or windows), labels
    resampled back to the native grid as host uint8. ``return_probs`` also
    returns the class probabilities at the preprocessed grid as f16 numpy,
    with the preprocess spacing."""
    dev = resolve_device(device)
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
    with torch.inference_mode(), _on(dev):
        return _predict_case(coarse, fine, np.asarray(image), native_spacing, cascade,
                             postprocess, timer, dev)


def _on(dev: torch.device):
    """The current-device guard of a case on ``dev`` (a lane's device, so
    the library calls and streams it makes are that device's)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _predict_case(coarse, fine, image, native_spacing, cascade, postprocess, timer, dev):
    if fine.preprocess.transfer_quant4:
        raise ValueError("transfer_quant4 is not supported on the fine/ROI path; "
                         "set it only on the coarse preset's PreprocessConfig")
    t = timer if timer is not None else PhaseTimer(enabled=False)
    coarse_apply = effective_apply_fn(coarse)
    fine_apply = effective_apply_fn(fine)
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
            mask = unpack_bits(_coarse_stage_core(coarse_apply, coarse.params, x).cpu().numpy(),
                               c_run_shape[2])
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
    roi_results = []  # (lo, hi, want_buf, device packed labels, batch index or None)
    # roi_batch > 1: single-pass ROIs whose bucketed shapes match are held
    # here and run as ONE batched program when a group fills; groups still
    # short at the end go through the B = 1 program one by one. Staging can
    # reorder pastes across buckets, which shows only where two ROI boxes
    # overlap with conflicting nonzero labels.
    roi_batch = max(1, int(cascade.roi_batch))
    pending_rois: dict[tuple, list] = {}
    scale_nf = np.asarray([f / n for n, f in zip(n_sp, f_sp)], np.float32)
    scale_fn = np.asarray([n / f for n, f in zip(n_sp, f_sp)], np.float32)
    f_pp = fine.preprocess

    def dispatch_rois(entries):
        """Queue the device work of 1..B staged same-bucket ROIs."""
        padded = entries[0][4]
        with t.phase("roi_predict"):
            if len(entries) == 1:
                lo_, hi_, wb_, crop_, _ = entries[0]
                packed = _roi_program(fine_apply, fine, _upload(crop_, f_pp, dev), padded,
                                      crop_.shape, scale_nf, scale_fn)
                roi_results.append((lo_, hi_, wb_, packed, None))
            else:
                ups = torch.stack([_upload(e[3], f_pp, dev) for e in entries])
                packed = _roi_program_batch(fine_apply, fine, ups, padded, entries[0][3].shape,
                                            scale_nf, scale_fn)
                for i, (lo_, hi_, wb_, _c, _p) in enumerate(entries):
                    roi_results.append((lo_, hi_, wb_, packed, i))

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
        want_buf_t = tuple(int(w) for w in want_buf)
        if single_pass:
            entry = (lo, hi, want_buf_t, crop, tuple(int(p) for p in padded_shape))
            if roi_batch > 1:
                key = (entry[4], tuple(crop.shape))
                grp = pending_rois.setdefault(key, [])
                grp.append(entry)
                if len(grp) >= roi_batch:
                    dispatch_rois(grp)
                    pending_rois[key] = []
            else:
                dispatch_rois([entry])
            continue
        with t.phase("roi_predict"):
            roi = _stage_resample_in(_upload(crop, f_pp, dev), padded_shape, scale_nf, f_pp)
            native = resample_labels_onehot_dynamic(
                _predict_stage(fine, roi).to(torch.int32), tuple(crop.shape), scale_fn,
                fine.num_classes).to(torch.uint8)
            roi_results.append((lo, hi, want_buf_t, _pack_labels(native, fine.num_classes), None))

    for grp in pending_rois.values():
        for e in grp:
            dispatch_rois([e])

    # ---- fetch + paste (every ROI's device work is already queued) ----
    fetched_memo: dict[int, np.ndarray] = {}
    for lo, hi, want_buf, dev_packed, bidx in roi_results:
        with t.phase("roi_fetch_paste"):
            # Labels come back at the crop BUFFER shape; only the exactly
            # covered region [0 : hi-lo) is pasted, nonzero over the canvas.
            # A batched group is fetched once and indexed per sample.
            host = fetched_memo.get(id(dev_packed))
            if host is None:
                host = fetched_memo[id(dev_packed)] = dev_packed.cpu().numpy()
            if bidx is not None:
                host = host[bidx]
            # One native pass over the packed bytes (nonzero lanes overwrite,
            # as np.where below); the numpy chain only without the tier.
            if _native_paste_packed(native_canvas, host, lo, hi - lo, fine.num_classes):
                continue
            fetched = _unpack_labels(host, fine.num_classes, want_buf[2])
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


def device_lanes(coarse: ModelBundle, fine: ModelBundle, devices):
    """One (device, coarse, fine) serving lane per entry of ``devices``, the
    bundles' params on that device; lanes on one device share one copy."""
    on: dict = {}
    lanes = []
    for d in devices:
        dev = resolve_device(d)
        if dev not in on:
            on[dev] = (bundle_on_device(coarse, dev), bundle_on_device(fine, dev))
        lanes.append((dev, *on[dev]))
    return lanes


def predict_cases(
    coarse: ModelBundle,
    fine: ModelBundle,
    cases,  # iterable of (image, native_spacing)
    cascade: CascadeConfig = CascadeConfig(),
    postprocess: bool = True,
    workers: int = 2,
    device=None,
    devices=None,
):
    """Pipelined multi-case cascade: ``workers`` cases in flight on a thread
    pool, so case i's host work (striding, components, paste) overlaps case
    i+1's device work. Results are yielded IN ORDER; ``cases`` may be lazy
    (at most ``workers + 1`` cases are held).

    The workers take serving lanes from a queue, one lane per case, and run
    the whole case there. Without ``devices`` there are ``workers`` lanes
    on ``device``. ``devices`` (a list of devices) serves on independent
    lanes, one per entry: each holds the bundles on its device
    (``bundle_on_device``; a lane on the bundles' own device shares their
    modules). Cases share nothing, so lanes need no collectives. With
    ``devices`` set, ``workers`` is the lane count and ``device`` is not
    read."""
    import queue
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    lanes = device_lanes(coarse, fine, devices or [device] * max(1, workers))
    free: queue.SimpleQueue = queue.SimpleQueue()
    for lane in lanes:
        free.put(lane)
    workers = len(lanes)

    def run_one(img, sp):
        dev, c_d, f_d = free.get()
        try:
            return predict_case(c_d, f_d, img, sp, cascade, postprocess, device=dev)
        finally:
            free.put((dev, c_d, f_d))

    with ThreadPoolExecutor(max_workers=workers) as pool:
        inflight: deque = deque()
        for img, sp in cases:
            inflight.append(pool.submit(run_one, img, sp))
            if len(inflight) > workers:
                yield inflight.popleft().result()
        while inflight:
            yield inflight.popleft().result()
