"""3D U-Net: (Conv3D → InstanceNorm → LeakyReLU) x2 per resolution, stride-2
conv downsampling, pixelshuffle upsampling, skip concatenation and a 1x1x1
logits head.

Counterpart of ``runet_tpu/models/unet3d.py``, with the same parameter tree:
module and parameter names follow the flax paths (``enc0.ConvNormAct_0.
kernel`` is flax's ``enc0/ConvNormAct_0/kernel``), so ``params.flax_to_torch``
maps a checkpoint one key at a time.

- Public I/O is NDHWC in, NDHWC f32 logits out. Inside, activations keep the
  JAX package's (B, D, C, H, W) layout, so each block can be compared tensor
  for tensor with the reference.
- Every 3x3x3 conv, at every level, runs through the fused conv+moment
  kernels (``kernels/fused_block.py`` stride 1, ``kernels/strided_conv.py``
  stride 2): CUDA kernels on the card, their plain versions on the CPU.
- Conv and projection weights are held in the compute dtype (cast once at
  load); InstanceNorm affine params and the head stay f32, and the head
  runs in f32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from runet_tpu_torch.config import ModelConfig
from runet_tpu_torch.kernels.conv_common import pack_weight
from runet_tpu_torch.kernels.fused_block import conv_in_stats_dchw_batch
from runet_tpu_torch.kernels.strided_conv import conv_s2_stats_dchw_batch
from runet_tpu_torch.models.norm import InstanceNorm


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device), requires_grad=False)


class ConvNormAct(nn.Module):
    """3x3x3 conv (stride 1 or 2) → InstanceNorm from the kernel's moments →
    LeakyReLU, on a (B, D, C, H, W) activation."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 negative_slope: float = 1e-2, norm_eps: float = 1e-5,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"stride must be 1 or 2, got {stride}")
        self.stride = stride
        self.negative_slope = negative_slope
        self.dtype = dtype
        self.kernel = _param((3, 3, 3, cin, features), dtype, device)
        self.InstanceNorm_0 = InstanceNorm(features, norm_eps, dtype, device=device)
        self._packed = None  # (key of the kernel it was packed from, packed)

    def packed_kernel(self) -> torch.Tensor:
        """The kernel in the CUDA layout, packed once per loaded weight (the
        key changes when the parameter is replaced or written in place)."""
        k = self.kernel
        key = (k.device, k.data_ptr(), k._version)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_weight(k.detach()))
        return self._packed[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = conv_s2_stats_dchw_batch if self.stride == 2 else conv_in_stats_dchw_batch
        packed = self.packed_kernel() if x.is_cuda else None
        y, mean, sqm = conv(x.to(self.dtype), self.kernel, packed)
        y = self.InstanceNorm_0(y, moments=(mean, sqm), channel_axis=2)
        return F.leaky_relu(y, self.negative_slope)


class EncoderBlock(nn.Module):
    def __init__(self, cin: int, features: int, downsample: bool, **kw):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(cin, features, 2 if downsample else 1, **kw)
        self.ConvNormAct_1 = ConvNormAct(features, features, 1, **kw)

    def forward(self, x):  # (B, D, C, H, W)
        return self.ConvNormAct_1(self.ConvNormAct_0(x))


def depth_to_space_dchw(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, D, r³·F, H, W) → (B, rD, F, rH, rW) with channel order
    c = ((rd·r + rh)·r + rw)·F + f, as the JAX package assigns it."""
    B, D, C, H, W = x.shape
    f = C // (r * r * r)
    x = x.reshape(B, D, r, r, r, f, H, W)
    x = x.permute(0, 1, 2, 5, 6, 3, 7, 4)  # (B, D, rd, F, H, rh, W, rw)
    return x.reshape(B, D * r, f, H * r, W * r)


class _PixelShuffleProj(nn.Module):
    """1x1x1 projection to r³·F channels over the channel axis of a
    (B, D, C, H, W) activation; kernel (C, out) in the compute dtype."""

    def __init__(self, cin: int, features_out: int, dtype, device=None):
        super().__init__()
        self.kernel = _param((cin, features_out), dtype, device)

    def forward(self, x):
        B, D, C, H, W = x.shape
        y = torch.matmul(self.kernel.t(), x.to(self.kernel.dtype).reshape(B, D, C, H * W))
        return y.reshape(B, D, -1, H, W)


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, features: int, dtype=torch.bfloat16, device=None, **kw):
        super().__init__()
        self.Conv_0 = _PixelShuffleProj(cin, features * 8, dtype, device)
        kw = dict(kw, dtype=dtype, device=device)
        self.ConvNormAct_0 = ConvNormAct(2 * features, features, 1, **kw)
        self.ConvNormAct_1 = ConvNormAct(features, features, 1, **kw)

    def forward(self, x, skip):  # both (B, D, C, H, W)
        x = depth_to_space_dchw(self.Conv_0(x), 2)
        x = torch.cat([x, skip.to(x.dtype)], dim=2)
        return self.ConvNormAct_1(self.ConvNormAct_0(x))


class _Head(nn.Module):
    """1x1x1 logits head in f32: (B, D, C, H, W) → (B, D, H, W, K)."""

    def __init__(self, cin: int, num_classes: int, device=None):
        super().__init__()
        self.kernel = _param((cin, num_classes), torch.float32, device)
        self.bias = _param((num_classes,), torch.float32, device)

    def forward(self, x):
        B, D, C, H, W = x.shape
        y = torch.matmul(self.kernel.t(), x.float().reshape(B, D, C, H * W))
        y = y.reshape(B, D, -1, H, W).permute(0, 1, 3, 4, 2)
        return y + self.bias


def level_features(cfg: ModelConfig) -> Sequence[int]:
    return [min(cfg.base_features * (2**i), cfg.max_features) for i in range(cfg.num_levels)]


class UNet3D(nn.Module):
    """cfg-driven 3D U-Net: (B, D, H, W, C_in) → logits (B, D, H, W, K) f32.

    Spatial dims must be divisible by 2**(num_levels - 1)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.upsample_mode != "pixelshuffle":
            raise NotImplementedError("upsample_mode='convtranspose' is not ported yet")
        if cfg.deep_supervision:
            raise NotImplementedError("deep-supervision heads are not ported yet")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        feats = level_features(cfg)
        kw = dict(negative_slope=cfg.negative_slope, norm_eps=cfg.norm_eps,
                  dtype=self.dtype, device=device)
        cin = cfg.in_channels
        for lvl, f in enumerate(feats):
            self.add_module(f"enc{lvl}", EncoderBlock(cin, f, downsample=lvl > 0, **kw))
            cin = f
        for lvl in reversed(range(len(feats) - 1)):
            self.add_module(f"dec{lvl}", DecoderBlock(feats[lvl + 1], feats[lvl], **kw))
        self.Conv_0 = _Head(feats[0], cfg.num_classes, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(level_features(self.cfg))
        divisor = 2 ** (n - 1)
        if any(d % divisor for d in x.shape[1:4]):
            raise ValueError(
                f"spatial dims {tuple(x.shape[1:4])} must be divisible by "
                f"2**(num_levels-1)={divisor} for skip concatenation"
            )
        x = x.to(self.dtype).permute(0, 1, 4, 2, 3).contiguous()  # NDHWC → (B, D, C, H, W)
        skips = []
        for lvl in range(n):
            x = getattr(self, f"enc{lvl}")(x)
            if lvl < n - 1:
                skips.append(x)
        for lvl in reversed(range(n - 1)):
            x = getattr(self, f"dec{lvl}")(x, skips[lvl])
        return self.Conv_0(x)


def create_model(cfg: ModelConfig, device=None) -> UNet3D:
    return UNet3D(cfg, device=device)
