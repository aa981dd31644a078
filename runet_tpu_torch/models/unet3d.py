"""3D U-Net: (Conv3D → InstanceNorm → LeakyReLU) x2 per resolution, stride-2
conv downsampling, pixelshuffle (or transposed-conv) upsampling, skip
concatenation, a 1x1x1 logits head and optional deep-supervision heads.

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
  Where autograd records nothing (serving, validation), the norm's apply
  and the LeakyReLU after each conv are one CUDA pass too
  (``kernels/norm_act.py``); training keeps the differentiable torch chain.
  ``ModelConfig.fused_kernel`` picks the stride-1 kernel: "v2m", "v2", or
  "v1", whose blocks permute to (B, D, H, C, W) around their stride-1 convs
  as the JAX package's ``_pair_dchw`` does. Stride-2 convs take the one
  stride-2 kernel under all three.
- ``ModelConfig.remat`` (train model): each encoder and decoder block runs
  under ``torch.utils.checkpoint``, so only block inputs and outputs are
  kept for the backward and each block's forward runs a second time there.
- Serving model: conv and projection weights are held in the compute dtype
  (cast once at load), frozen; InstanceNorm affine params and the head stay
  f32, and the head runs in f32.
- Train model (``create_train_model``): every weight is a trainable f32
  master (``ModelConfig.param_dtype``) cast to the compute dtype in the
  forward, as flax does; the CUDA layout of each conv kernel is repacked
  from that cast whenever the master changes (``packed_kernel``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from runet_tpu_torch.config import ModelConfig
from runet_tpu_torch.kernels import norm_act
from runet_tpu_torch.kernels.conv_common import pack_weight
from runet_tpu_torch.kernels.fused_block import (
    VERSIONS,
    conv_in_stats_dchw_batch,
    conv_in_stats_dhcw_batch,
)
from runet_tpu_torch.kernels.strided_conv import conv_s2_stats_dchw_batch
from runet_tpu_torch.models.norm import InstanceNorm
from runet_tpu_torch.utils import timing


def _param(shape, dtype, device, param_dtype=None) -> nn.Parameter:
    """A frozen parameter in ``dtype``, or with ``param_dtype`` given a
    trainable one in that dtype (the train model's master weight)."""
    return nn.Parameter(torch.zeros(shape, dtype=param_dtype or dtype, device=device),
                        requires_grad=param_dtype is not None)


def _fused_norm_act(y: torch.Tensor, norm: InstanceNorm) -> bool:
    """Whether the norm and LeakyReLU after a conv run as one CUDA pass (bit
    for bit the plain chain): y on the card, and autograd recording nothing
    for the call (serving, validation; not the train step)."""
    return y.is_cuda and not (torch.is_grad_enabled() and (
        y.requires_grad or norm.scale.requires_grad or norm.bias.requires_grad))


class ConvNormAct(nn.Module):
    """3x3x3 conv (stride 1 or 2) → InstanceNorm from the kernel's moments →
    LeakyReLU, on a (B, D, C, H, W) activation; ``layout="dhcw"`` (stride 1
    under ``fused_kernel="v1"``) takes and returns (B, D, H, C, W). On CUDA,
    where autograd records nothing for the call, the norm and activation
    are one kernel (``kernels/norm_act.py``); each call adds 1 to the
    ``norm_act.fused`` or ``norm_act.plain`` counter of the open span."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 negative_slope: float = 1e-2, norm_eps: float = 1e-5,
                 dtype=torch.bfloat16, device=None, param_dtype=None,
                 fused_kernel: str = "v2m", axis_name: str | None = None):
        """``param_dtype`` given: a trainable kernel in that dtype (the
        train model's f32 master); otherwise a frozen one in ``dtype``.
        ``axis_name``: the mesh axis the norm's moments are averaged over."""
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"stride must be 1 or 2, got {stride}")
        if fused_kernel not in VERSIONS:
            raise ValueError(f"unknown fused_kernel {fused_kernel!r}; expected one of {VERSIONS}")
        self.stride = stride
        self.fused_kernel = fused_kernel
        self.negative_slope = negative_slope
        self.dtype = dtype
        self.kernel = _param((3, 3, 3, cin, features), dtype, device, param_dtype)
        self.InstanceNorm_0 = InstanceNorm(features, norm_eps, dtype, device=device,
                                           param_dtype=param_dtype, axis_name=axis_name)
        self._packed = None  # (key of the kernel it was packed from, packed)

    def packed_kernel(self) -> torch.Tensor:
        """The kernel in the CUDA layout, packed from its bf16 cast once per
        weight value (the key changes when the parameter is replaced or
        written in place, e.g. by an optimizer step)."""
        k = self.kernel
        key = (k.device, k.data_ptr(), k._version)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_weight(k.detach()))
        return self._packed[1]

    def forward(self, x: torch.Tensor, layout: str = "dchw") -> torch.Tensor:
        packed = self.packed_kernel() if x.is_cuda else None
        x, k = x.to(self.dtype), self.kernel.to(self.dtype)
        if self.stride == 2:
            if layout != "dchw":
                raise ValueError("the stride-2 conv takes the (B, D, C, H, W) layout only")
            y, mean, sqm = conv_s2_stats_dchw_batch(x, k, packed)
        elif layout == "dhcw":
            y, mean, sqm = conv_in_stats_dhcw_batch(x, k, packed)
        else:
            y, mean, sqm = conv_in_stats_dchw_batch(x, k, packed, self.fused_kernel)
        norm = self.InstanceNorm_0
        if _fused_norm_act(y, norm):
            timing.count("norm_act.fused")
            if norm.axis_name is not None:
                from runet_tpu_torch.parallel.comm import axis_mean

                mean, sqm = axis_mean((mean, sqm), norm.axis_name)
            return norm_act.norm_lrelu(y, mean, sqm, norm.scale.float(), norm.bias.float(),
                                       norm.eps, self.negative_slope, layout=layout)
        timing.count("norm_act.plain")
        y = norm(y, moments=(mean, sqm), channel_axis=3 if layout == "dhcw" else 2)
        return F.leaky_relu(y, self.negative_slope)


def _pair_dchw(cna0, cna1, x: torch.Tensor) -> torch.Tensor:
    """One (``cna0`` None) or two stride-1 ConvNormActs on a (B, D, C, H, W)
    activation. Under ``fused_kernel="v1"`` the pair runs in the v1 kernel's
    (B, D, H, C, W) layout between two local permutes."""
    if cna1.fused_kernel == "v1":
        x = x.permute(0, 1, 3, 2, 4)
        if cna0 is not None:
            x = cna0(x, layout="dhcw")
        return cna1(x, layout="dhcw").permute(0, 1, 3, 2, 4)
    if cna0 is not None:
        x = cna0(x)
    return cna1(x)


class EncoderBlock(nn.Module):
    def __init__(self, cin: int, features: int, downsample: bool, **kw):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(cin, features, 2 if downsample else 1, **kw)
        self.ConvNormAct_1 = ConvNormAct(features, features, 1, **kw)

    def forward(self, x):  # (B, D, C, H, W)
        if self.ConvNormAct_0.stride == 2:
            return _pair_dchw(None, self.ConvNormAct_1, self.ConvNormAct_0(x))
        return _pair_dchw(self.ConvNormAct_0, self.ConvNormAct_1, x)


def depth_to_space_3d(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, D, H, W, r³·F) → (B, rD, rH, rW, F), the NDHWC pixel shuffle,
    with channel order c = ((rd·r + rh)·r + rw)·F + f."""
    B, D, H, W, C = x.shape
    f = C // (r * r * r)
    x = x.reshape(B, D, H, W, r, r, r, f)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)  # (B, D, rd, H, rh, W, rw, F)
    return x.reshape(B, D * r, H * r, W * r, f)


def depth_to_space_dchw(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, D, r³·F, H, W) → (B, rD, F, rH, rW) with the channel order of
    ``depth_to_space_3d``, as the JAX package assigns it."""
    B, D, C, H, W = x.shape
    f = C // (r * r * r)
    x = x.reshape(B, D, r, r, r, f, H, W)
    x = x.permute(0, 1, 2, 5, 6, 3, 7, 4)  # (B, D, rd, F, H, rh, W, rw)
    return x.reshape(B, D * r, f, H * r, W * r)


class _PixelShuffleProj(nn.Module):
    """1x1x1 projection to r³·F channels over the channel axis of a
    (B, D, C, H, W) activation; kernel (C, out), applied in the compute
    dtype."""

    def __init__(self, cin: int, features_out: int, dtype, device=None, param_dtype=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((cin, features_out), dtype, device, param_dtype)

    def forward(self, x):
        B, D, C, H, W = x.shape
        k = self.kernel.to(self.dtype)
        y = torch.matmul(k.t(), x.to(self.dtype).reshape(B, D, C, H * W))
        return y.reshape(B, D, -1, H, W)


class _ConvTranspose(nn.Module):
    """ConvTranspose(k=2, s=2, no bias) on a (B, D, C, H, W) activation, the
    ``upsample_mode="convtranspose"`` upsample. The kernel keeps flax's
    (2, 2, 2, Cin, Cout) shape under flax's name (``ConvTranspose_0``); flax's
    is ``lax.conv_transpose`` with unflipped taps and torch's the conv
    gradient (flipped), so the taps are flipped on the way to
    ``F.conv_transpose3d``'s (Cin, Cout, kd, kh, kw) weight."""

    def __init__(self, cin: int, features: int, dtype, device=None, param_dtype=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((2, 2, 2, cin, features), dtype, device, param_dtype)

    def forward(self, x):
        w = torch.flip(self.kernel.to(self.dtype), dims=(0, 1, 2)).permute(3, 4, 0, 1, 2)
        y = F.conv_transpose3d(x.to(self.dtype).permute(0, 2, 1, 3, 4), w, stride=2)
        return y.permute(0, 2, 1, 3, 4)


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, features: int, dtype=torch.bfloat16, device=None,
                 param_dtype=None, upsample_mode: str = "pixelshuffle", **kw):
        super().__init__()
        if upsample_mode == "pixelshuffle":
            self.Conv_0 = _PixelShuffleProj(cin, features * 8, dtype, device, param_dtype)
        elif upsample_mode == "convtranspose":
            self.ConvTranspose_0 = _ConvTranspose(cin, features, dtype, device, param_dtype)
        else:
            raise ValueError(f"unknown upsample_mode {upsample_mode!r}")
        self.upsample_mode = upsample_mode
        kw = dict(kw, dtype=dtype, device=device, param_dtype=param_dtype)
        self.ConvNormAct_0 = ConvNormAct(2 * features, features, 1, **kw)
        self.ConvNormAct_1 = ConvNormAct(features, features, 1, **kw)

    def forward(self, x, skip):  # both (B, D, C, H, W)
        if self.upsample_mode == "pixelshuffle":
            x = depth_to_space_dchw(self.Conv_0(x), 2)
        else:
            x = self.ConvTranspose_0(x)
        x = torch.cat([x, skip.to(x.dtype)], dim=2)
        return _pair_dchw(self.ConvNormAct_0, self.ConvNormAct_1, x)


class _Head(nn.Module):
    """1x1x1 logits head in f32: (B, D, C, H, W) → (B, D, H, W, K)."""

    def __init__(self, cin: int, num_classes: int, device=None, param_dtype=None):
        super().__init__()
        self.kernel = _param((cin, num_classes), torch.float32, device, param_dtype)
        self.bias = _param((num_classes,), torch.float32, device, param_dtype)

    def forward(self, x):
        B, D, C, H, W = x.shape
        y = torch.matmul(self.kernel.float().t(), x.float().reshape(B, D, C, H * W))
        y = y.reshape(B, D, -1, H, W).permute(0, 1, 3, 4, 2)
        return y + self.bias.float()


def level_features(cfg: ModelConfig) -> Sequence[int]:
    return [min(cfg.base_features * (2**i), cfg.max_features) for i in range(cfg.num_levels)]


class UNet3D(nn.Module):
    """cfg-driven 3D U-Net: (B, D, H, W, C_in) → logits (B, D, H, W, K) f32.

    Spatial dims must be divisible by 2**(num_levels - 1). ``trainable``:
    f32 master weights with gradients (``create_train_model``); otherwise
    frozen serving weights in the compute dtype. With ``cfg.spatial_axis``
    every norm averages its moments over the ranks of that mesh axis
    (spatial-partition inference, ``parallel/spatial.py``); a forward with
    no process group bound to the axis raises ``RuntimeError``. With
    ``cfg.deep_supervision`` the aux heads ``ds1`` and ``ds2`` (decoder
    levels 1 and 2, where depth allows) are in the parameter tree whatever
    the call mode."""

    def __init__(self, cfg: ModelConfig, device=None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        # Recompute each block in the backward; only where there is one.
        self.remat = bool(cfg.remat) and trainable
        feats = level_features(cfg)
        param_dtype = getattr(torch, cfg.param_dtype) if trainable else None
        kw = dict(negative_slope=cfg.negative_slope, norm_eps=cfg.norm_eps,
                  dtype=self.dtype, device=device, param_dtype=param_dtype,
                  fused_kernel=cfg.fused_kernel, axis_name=cfg.spatial_axis)
        cin = cfg.in_channels
        for lvl, f in enumerate(feats):
            self.add_module(f"enc{lvl}", EncoderBlock(cin, f, downsample=lvl > 0, **kw))
            cin = f
        for lvl in reversed(range(len(feats) - 1)):
            self.add_module(f"dec{lvl}", DecoderBlock(feats[lvl + 1], feats[lvl],
                                                      upsample_mode=cfg.upsample_mode, **kw))
            if cfg.deep_supervision and 1 <= lvl <= 2:
                self.add_module(f"ds{lvl}", _Head(feats[lvl], cfg.num_classes, device,
                                                  param_dtype))
        self.Conv_0 = _Head(feats[0], cfg.num_classes, device, param_dtype)

    def _block(self, block: nn.Module, *args: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            # The blocks draw no random numbers: no RNG state to keep.
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        return block(*args)

    def forward(self, x: torch.Tensor, deep_outputs: bool = False):
        """``deep_outputs=True`` (training with ``cfg.deep_supervision``)
        also returns the aux logits as a list ordered by level: [stride 2,
        stride 4] where depth allows. The default call does not run the aux
        heads."""
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
            x = self._block(getattr(self, f"enc{lvl}"), x)
            if lvl < n - 1:
                skips.append(x)
        want_aux = deep_outputs and self.cfg.deep_supervision
        aux = []
        for lvl in reversed(range(n - 1)):
            x = self._block(getattr(self, f"dec{lvl}"), x, skips[lvl])
            if want_aux and 1 <= lvl <= 2:
                aux.append(getattr(self, f"ds{lvl}")(x))
        logits = self.Conv_0(x)
        if want_aux:
            return logits, aux[::-1]  # deepest-first → [level 1, level 2]
        return logits


def create_model(cfg: ModelConfig, device=None) -> UNet3D:
    return UNet3D(cfg, device=device)


def create_train_model(cfg: ModelConfig, device=None) -> UNet3D:
    """The model of the training step: the serving model's parameter tree
    with trainable f32 master weights, on ``device`` (CUDA unless named).
    Every 3x3x3 conv runs through the kernels and their autograd Functions
    whatever ``fused_blocks_train`` says (the Hopper kernels have no gate)."""
    from runet_tpu_torch import resolve_device

    return UNet3D(cfg, device=resolve_device(device), trainable=True)


_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


@torch.no_grad()
def init_params(model: UNet3D, generator: torch.Generator) -> UNet3D:
    """Initialise ``model`` in place as flax's ``init`` does: ``lecun_normal``
    kernels (a unit normal truncated to [-2, 2], scaled by
    sqrt(1/fan_in)/0.8796 so the std is sqrt(1/fan_in); fan_in = 27·Cin for
    the 3x3x3 convs, C for the 1x1x1 projections and the head), zero head
    bias, unit InstanceNorm scale and zero bias. Draws come from
    ``generator`` (a CPU generator) in the module order, so a seed gives the
    same weights on every device."""
    for name, p in model.named_parameters():
        if name.endswith("kernel"):
            # flax: fan_in = receptive field x Cin (27·Cin for the 3x3x3
            # convs, 8·Cin for the 2x2x2 transposed conv).
            fan_in = p[..., 0, 0].numel() * p.shape[3] if p.dim() == 5 else p.shape[0]
            w = torch.empty(p.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            p.copy_(w * (fan_in ** -0.5 / _TRUNC_STD))
        elif name.endswith("scale"):
            p.fill_(1.0)
        else:
            p.zero_()
    return model
