"""Frozen dataclass configuration: one config tree per run.

The five presets are those of the JAX package (``runet_tpu/config.py``), so a
preset name means the same model, preprocessing and cascade in both.
``fused_kernel`` picks the stride-1 conv kernel here as it does there ("v2m",
"v2" or "v1": one CUDA kernel each, ``kernels/fused_block.py``). The gates
``fused_blocks``, ``fused_blocks_train``, ``fused_contracting`` and
``fused_downsample`` exist for the TPU kernels' shape limits; they are kept
so that a config serialised by either package loads in the other, and in
this package every 3x3x3 convolution runs through the kernels of
``runet_tpu_torch.kernels`` whatever they say.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

# KiTS19-style HU window + z-score stats. stats=None => per-volume z-score.
DEFAULT_HU_WINDOW = (-79.0, 304.0)
DEFAULT_HU_STATS = (100.93, 76.9)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    in_channels: int = 1
    num_classes: int = 3  # bg / kidney / tumor
    base_features: int = 32
    max_features: int = 320
    num_levels: int = 5  # encoder resolutions (incl. bottleneck)
    negative_slope: float = 1e-2
    norm_eps: float = 1e-5
    # "pixelshuffle": 1x1x1 conv to 8F channels + depth-to-space (the same
    # linear family as ConvTranspose(k=2, s=2)); "convtranspose": classic.
    upsample_mode: str = "pixelshuffle"
    # Recompute block activations in the backward pass (training only).
    remat: bool = False
    # Kernel selection; see the module docstring.
    fused_blocks: bool = True
    fused_kernel: str = "v2m"
    fused_blocks_train: bool = True
    fused_contracting: bool = True
    fused_downsample: bool = True
    # Deep supervision: aux 1x1x1 logits heads at decoder levels 1-2.
    deep_supervision: bool = False
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Mesh axis name for spatial-partition inference; None = one device.
    spatial_axis: str | None = None


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0)
    hu_window: tuple[float, float] = DEFAULT_HU_WINDOW
    # (mean, std) applied after clipping; None => per-volume z-score.
    hu_stats: tuple[float, float] | None = DEFAULT_HU_STATS
    # Quantize host->device image uploads to uint8 over hu_window (the
    # device dequantizes before resampling). Values are clipped to
    # hu_window by normalize anyway, so only the ~1.5 HU quantization step
    # remains. OFF by default (oracle tests push label-valued images through
    # the pipeline and must stay exact); ON in the shipping CT presets.
    transfer_quant: bool = False
    # With transfer_quant: pack TWO 4-bit voxels per upload byte (16 levels
    # over hu_window, ~25 HU/step). Suitable ONLY for the coarse
    # localization stage, whose output is a foreground box with margin.
    transfer_quant4: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    patch_size: tuple[int, int, int] = (128, 128, 128)
    batch_size: int = 2
    fg_prob: float = 0.5
    steps: int = 25000
    lr: float = 3e-4
    weight_decay: float = 1e-5
    warmup_steps: int = 500
    lr_schedule: str = "poly"  # poly | cosine | const
    poly_power: float = 0.9
    optimizer: str = "adamw"  # adamw | sgd (Nesterov, nnU-Net lineage)
    sgd_momentum: float = 0.99
    grad_accum: int = 1
    steps_per_dispatch: int = 1
    seed: int = 0
    ckpt_every: int = 1000
    val_every: int = 1000
    val_full_every: int = 0
    keep_checkpoints: int = 3
    augment: bool = True
    elastic: bool = False
    tversky_alpha: float = 0.5
    tversky_beta: float = 0.5


@dataclasses.dataclass(frozen=True)
class InferConfig:
    patch_size: tuple[int, int, int] = (128, 128, 128)
    overlap: float = 0.5  # stride = patch * (1 - overlap)
    sigma_scale: float = 0.125  # gaussian importance sigma = size * scale
    # Windows evaluated per forward on the windowed fallback path.
    window_batch: int = 1
    # Grow fallback windows toward the single_pass_ratio voxel budget
    # ("super-windows"): a ROI beyond the single-pass budget is covered by a
    # few large overlapping windows instead of many patch-sized ones.
    expand_windows: bool = True
    use_gaussian: bool = True
    # Whole-volume single forward when the padded volume is at most
    # ratio x the patch volume (the network is fully convolutional; 0
    # disables). Windows remain the fallback beyond the ratio.
    single_pass_ratio: float = 8.0
    # Mirror-flip test-time augmentation: average the softmax over all flip
    # subsets of tta_axes (2^k forwards per window), infer/tta.py.
    tta: bool = False
    tta_axes: tuple[int, ...] = (0, 1, 2)


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    roi_margin_mm: float = 16.0  # margin around coarse kidney bbox
    # ROI dims rounded up to multiples of this: fewer distinct fine-stage
    # shapes across a dataset at some padded-voxel overhead.
    roi_bucket: int = 32
    # Last-axis bucket of the TPU kernels' lane gate. Unused here: the
    # Hopper kernels take any W, so z is bucketed like x and y.
    roi_bucket_z: int = 64
    # Native-crop extent bucket: bounds the distinct crop shapes per fine
    # bucket; the extra rows are real context (or edge padding).
    crop_bucket: int = 16
    # Fixed canonical coarse-grid shape: a 512 mm abdominal FOV at 4 mm iso
    # is <=128 voxels/axis. Falls back to the 16-bucketed true shape if a
    # case exceeds it.
    coarse_canonical: tuple[int, int, int] = (128, 128, 128)
    max_components: int = 2  # keep <=2 largest kidney CCs
    # Same-bucket single-pass ROIs batched into one forward (1 = off).
    roi_batch: int = 1
    # Hard cap on ROI physical extent per axis.
    roi_max_mm: float = 192.0


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "fine_kits"
    model: ModelConfig = ModelConfig()
    preprocess: PreprocessConfig = PreprocessConfig()
    train: TrainConfig = TrainConfig()
    infer: InferConfig = InferConfig()
    cascade: CascadeConfig = CascadeConfig()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        raw = json.loads(s)
        sub = {
            "model": ModelConfig,
            "preprocess": PreprocessConfig,
            "train": TrainConfig,
            "infer": InferConfig,
            "cascade": CascadeConfig,
        }

        def build(cls: Any, d: dict) -> Any:
            kwargs = {}
            for f in dataclasses.fields(cls):
                if f.name not in d:
                    continue
                v = d[f.name]
                if f.name in sub:
                    kwargs[f.name] = build(sub[f.name], v)
                elif isinstance(v, list):
                    kwargs[f.name] = tuple(v)
                else:
                    kwargs[f.name] = v
            return cls(**kwargs)

        return build(Config, raw)


def _preset_coarse() -> Config:
    """Coarse kidney-localization net, 128³ patch."""
    return Config(
        name="coarse",
        model=ModelConfig(num_classes=2, base_features=24, num_levels=4),
        # 4 mm iso: localization tolerates coarse voxels (boxes get a 16 mm
        # margin downstream), and the 512 mm FOV then fits the 128³
        # canonical grid. 4-bit uploads: the 16-level coarse input cannot
        # move a margined box edge; the fine stages keep uint8.
        preprocess=PreprocessConfig(spacing=(4.0, 4.0, 4.0), transfer_quant=True,
                                    transfer_quant4=True),
        train=TrainConfig(patch_size=(128, 128, 128), fg_prob=0.5,
                          batch_size=1, grad_accum=2, val_full_every=5000),
        infer=InferConfig(patch_size=(128, 128, 128), overlap=0.5),
    )


def _preset_fine_kits() -> Config:
    """Fine kidney+tumor net with sliding-window."""
    return Config(
        name="fine_kits",
        model=ModelConfig(num_classes=3),
        preprocess=PreprocessConfig(spacing=(0.8, 0.8, 0.8), transfer_quant=True),
        train=TrainConfig(patch_size=(128, 128, 128), batch_size=2,
                          grad_accum=1, val_full_every=5000),
        infer=InferConfig(patch_size=(128, 128, 128)),
    )


def _preset_cascade() -> Config:
    """Coarse→ROI→fine cascade, resample to native."""
    cfg = _preset_fine_kits()
    return dataclasses.replace(cfg, name="cascade")


def _preset_renal_anatomy() -> Config:
    """Kidney/tumor/artery/vein multi-class."""
    return Config(
        name="renal_anatomy",
        model=ModelConfig(num_classes=5),
        preprocess=PreprocessConfig(spacing=(0.8, 0.8, 0.8), transfer_quant=True),
        train=TrainConfig(patch_size=(128, 128, 128), batch_size=2,
                          grad_accum=1, val_full_every=5000),
        infer=InferConfig(patch_size=(128, 128, 128)),
    )


def _preset_dp_full() -> Config:
    """Data-parallel training over full KiTS19."""
    cfg = _preset_fine_kits()
    return dataclasses.replace(
        cfg,
        name="dp_full",
        train=dataclasses.replace(cfg.train, batch_size=8, steps=250000),
    )


PRESETS = {
    "coarse": _preset_coarse,
    "fine_kits": _preset_fine_kits,
    "cascade": _preset_cascade,
    "renal_anatomy": _preset_renal_anatomy,
    "dp_full": _preset_dp_full,
}


def get_config(name: str) -> Config:
    """Resolve a preset name, or a path to a config JSON file (the format
    ``Config.to_json`` writes)."""
    if name in PRESETS:
        return PRESETS[name]()
    import os

    if os.path.isfile(name):
        with open(name) as f:
            return Config.from_json(f.read())
    raise KeyError(
        f"unknown preset {name!r} (not a file either); have {sorted(PRESETS)}"
    )
