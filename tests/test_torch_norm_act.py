"""The fused norm + LeakyReLU pass (``runet_tpu_torch/kernels/norm_act.py``)
and its routing in ``ConvNormAct``, on the CPU: the plain version equals
``InstanceNorm`` with moments followed by ``F.leaky_relu`` bit for bit, the
training path keeps the differentiable chain and its gradients, and each
call is counted on the open span. The kernel itself runs in
``tests/test_torch_cuda.py`` on the card."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from runet_tpu_torch.config import ModelConfig
from runet_tpu_torch.kernels import norm_act
from runet_tpu_torch.kernels.fused_block import conv_in_stats_dchw_batch, conv_in_stats_dhcw_batch
from runet_tpu_torch.kernels.strided_conv import conv_s2_stats_dchw_batch
from runet_tpu_torch.models import unet3d
from runet_tpu_torch.models.norm import InstanceNorm
from runet_tpu_torch.models.unet3d import ConvNormAct, UNet3D, init_params
from runet_tpu_torch.utils import timing

SLOPE = 1e-2


def _activation(layout, dtype, constant_channel, seed=0):
    """y in ``layout`` with its f32 (mean, sqmean) and a norm with a
    non-trivial affine; channel 1 constant where asked, its sqmean just
    under mean² so the variance clamps at 0."""
    rng = np.random.default_rng(seed)
    B, D, C, H, W = 2, 3, 5, 4, 6
    y = torch.from_numpy((1.5 + 2.0 * rng.standard_normal((B, D, C, H, W))).astype(np.float32))
    if constant_channel:
        y[:, :, 1] = 0.75
    y = y.to(dtype)
    mean = y.float().mean(dim=(1, 3, 4))
    sq = (y.float() ** 2).mean(dim=(1, 3, 4))
    if constant_channel:
        sq[:, 1] = mean[:, 1] * mean[:, 1] * (1 - 2.0 ** -20)
    if layout == "dhcw":
        y = y.permute(0, 1, 3, 2, 4).contiguous()
    norm = InstanceNorm(C, 1e-5, dtype)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(1.0 + 0.2 * rng.standard_normal(C).astype(np.float32)))
        norm.bias.copy_(torch.from_numpy(0.3 * rng.standard_normal(C).astype(np.float32)))
    return y, mean, sq, norm


@pytest.mark.parametrize("constant_channel", [False, True], ids=["random", "constant"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", ["dchw", "dhcw"])
def test_plain_equals_instance_norm_then_leaky_relu(layout, dtype, constant_channel):
    y, mean, sq, norm = _activation(layout, dtype, constant_channel)
    ax = 3 if layout == "dhcw" else 2
    want = F.leaky_relu(norm(y, moments=(mean, sq), channel_axis=ax), SLOPE)
    for fn in (norm_act.norm_lrelu_plain, norm_act.norm_lrelu):
        got = fn(y, mean, sq, norm.scale, norm.bias, norm.eps, SLOPE, layout)
        assert got.dtype == dtype and got.shape == y.shape
        assert torch.equal(got, want)
    if constant_channel:
        c = (slice(None),) * ax + (1,)
        assert torch.isfinite(want).all() and (want[c] == want[c].flatten()[0]).all()


def test_wrapper_rejects_an_unknown_layout():
    y, mean, sq, norm = _activation("dchw", torch.float32, False)
    with pytest.raises(ValueError, match="layout"):
        norm_act.norm_lrelu(y, mean, sq, norm.scale, norm.bias, layout="dhwc")


def _unfused_chain(cna, x, layout):
    """The conv, ``InstanceNorm`` and ``F.leaky_relu`` called one by one."""
    k = cna.kernel.to(cna.dtype)
    if cna.stride == 2:
        y, mean, sq = conv_s2_stats_dchw_batch(x, k)
    elif layout == "dhcw":
        y, mean, sq = conv_in_stats_dhcw_batch(x, k)
    else:
        y, mean, sq = conv_in_stats_dchw_batch(x, k, version=cna.fused_kernel)
    y = cna.InstanceNorm_0(y, moments=(mean, sq), channel_axis=3 if layout == "dhcw" else 2)
    return F.leaky_relu(y, cna.negative_slope)


@pytest.mark.parametrize("stride,fused_kernel,layout", [
    (1, "v2m", "dchw"), (1, "v2", "dchw"), (1, "v1", "dhcw"), (2, "v2m", "dchw")])
def test_training_keeps_the_differentiable_chain(stride, fused_kernel, layout):
    """Under autograd with trainable parameters ConvNormAct counts a plain
    call, and its output and every gradient equal the unfused chain's."""
    torch.manual_seed(0)
    cna = ConvNormAct(3, 8, stride, dtype=torch.float32, param_dtype=torch.float32,
                      fused_kernel=fused_kernel)
    with torch.no_grad():
        cna.kernel.normal_(0.0, 0.2)
        cna.InstanceNorm_0.scale.uniform_(0.5, 1.5)
        cna.InstanceNorm_0.bias.uniform_(-0.3, 0.3)
    shape = (2, 4, 8, 3, 6) if layout == "dhcw" else (2, 4, 3, 8, 6)
    x0 = torch.randn(shape)
    grads = []
    for run in ("module", "unfused"):
        x = x0.clone().requires_grad_(True)
        cna.zero_grad()
        with torch.enable_grad(), timing.span("test.block") as s:
            out = cna(x, layout=layout) if run == "module" else _unfused_chain(cna, x, layout)
            (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        if run == "module":
            assert s.counters == {"norm_act.plain": 1}
        else:
            assert s.counters is None
        grads.append([out.detach(), x.grad, cna.kernel.grad, cna.InstanceNorm_0.scale.grad,
                      cna.InstanceNorm_0.bias.grad])
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_the_route_takes_the_card_only():
    """On the CPU every call keeps the plain chain, whatever autograd does."""
    cna = ConvNormAct(2, 4, dtype=torch.float32)
    y = torch.zeros(1, 2, 4, 2, 2)
    for mode in (torch.inference_mode, torch.no_grad, torch.enable_grad):
        with mode():
            assert not unet3d._fused_norm_act(y, cna.InstanceNorm_0)


@pytest.mark.parametrize("fused_kernel", ["v2m", "v1"])
def test_the_fused_branch_counts_each_block_and_equals_the_plain_one(monkeypatch, fused_kernel):
    """The fused branch (its route forced open; ``norm_lrelu`` on a CPU
    tensor is the plain version) gives the plain branch's logits bit for
    bit, and each branch adds 1 per ConvNormAct to its counter of the
    open span."""
    cfg = ModelConfig(num_classes=3, base_features=4, num_levels=3, compute_dtype="float32",
                      fused_kernel=fused_kernel)
    model = init_params(UNet3D(cfg, device="cpu"), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("scale", "bias")) and "InstanceNorm" in name:
                p.uniform_(0.5, 1.5) if name.endswith("scale") else p.uniform_(-0.2, 0.2)
    blocks = sum(isinstance(m, ConvNormAct) for m in model.modules())
    x = torch.randn(1, 8, 8, 8, 1)
    out = {}
    for route in ("plain", "fused"):
        if route == "fused":
            monkeypatch.setattr(unet3d, "_fused_norm_act", lambda y, norm: True)
        with torch.inference_mode(), timing.span("test.forward") as s:
            out[route] = model(x)
        assert s.counters == {f"norm_act.{route}": blocks}
    assert blocks == 10 and torch.equal(out["fused"], out["plain"])
