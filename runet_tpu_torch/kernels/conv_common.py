"""What the stride-1 and stride-2 conv+moment wrappers share: the weight
packing done once at load, the ctypes binding and the launch with its
scratch buffers. The wrappers themselves (with their launch counters and
plain versions) live in ``fused_block.py`` and ``strided_conv.py``."""

from __future__ import annotations

import ctypes
from contextlib import contextmanager

import torch

from runet_tpu_torch.kernels import build

# Output-channel tile of both CUDA kernels; packed weights pad Cout to it
# and the loaded library is checked against it.
COUT_TILE = 32
CIN_CHUNK = 16

_bound: dict[str, ctypes.CDLL] = {}


def pack_weight(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Cin, Cout) conv kernel → (27, Cout_pad, Cin_pad) bf16, the
    layout the CUDA kernels read: tap-major, then output channel, with the
    input channels contiguous. Cin is zero-padded to a multiple of 16 and
    Cout to a multiple of ``COUT_TILE``."""
    if kernel.shape[:3] != (3, 3, 3):
        raise ValueError(f"expected a (3, 3, 3, Cin, Cout) kernel, got {tuple(kernel.shape)}")
    cin, cout = kernel.shape[3], kernel.shape[4]
    cin_p = -(-cin // CIN_CHUNK) * CIN_CHUNK
    cout_p = -(-cout // COUT_TILE) * COUT_TILE
    w = kernel.reshape(27, cin, cout).permute(0, 2, 1).to(torch.bfloat16)
    out = torch.zeros((27, cout_p, cin_p), dtype=torch.bfloat16, device=kernel.device)
    out[:, :cout, :cin] = w
    return out


def _library(name: str) -> ctypes.CDLL:
    lib = _bound.get(name)
    if lib is not None:
        return lib
    lib = build.load(name)
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    nblk = getattr(lib, f"{name}_nblk")
    nblk.argtypes = [ctypes.c_int] * 3
    nblk.restype = ctypes.c_longlong
    tile = getattr(lib, f"{name}_cout_tile")
    tile.restype = ctypes.c_int
    if tile() != COUT_TILE:
        raise RuntimeError(f"{name}: library Cout tile {tile()} != {COUT_TILE}")
    _bound[name] = lib
    return lib


def launch_conv_stats(name: str, x: torch.Tensor, packed: torch.Tensor, cout: int,
                      out_dhw: tuple[int, int, int]):
    """Run the CUDA kernel ``name`` on x (B, D, C, H, W) bf16 with packed
    weights; returns (y (B, Do, Cout, Ho, Wo) bf16, sums (B, Cout) f32,
    sqs (B, Cout) f32) for the output extents ``out_dhw``."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bf16 activations, got {x.dtype}")
    if packed.device != x.device or packed.dtype != torch.bfloat16:
        raise ValueError(f"{name}: packed weights must be bf16 on {x.device}")
    x = x.contiguous()
    B, D, C, H, W = x.shape
    cout_p, cin_p = packed.shape[1], packed.shape[2]
    if packed.shape[0] != 27 or cin_p < C or cin_p % CIN_CHUNK or cout_p < cout \
            or cout_p % COUT_TILE:
        raise ValueError(f"{name}: packed weights {tuple(packed.shape)} do not fit "
                         f"Cin={C}, Cout={cout}")
    lib = _library(name)
    Do, Ho, Wo = out_dhw
    nblk = int(getattr(lib, f"{name}_nblk")(Do, Ho, Wo))
    dev = x.device
    y = torch.empty((B, Do, cout, Ho, Wo), dtype=torch.bfloat16, device=dev)
    psum = torch.empty((B, cout_p, nblk), dtype=torch.float32, device=dev)
    psq = torch.empty_like(psum)
    sums = torch.empty((B, cout), dtype=torch.float32, device=dev)
    sqs = torch.empty_like(sums)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            x.data_ptr(), packed.data_ptr(), y.data_ptr(), psum.data_ptr(),
            psq.data_ptr(), sums.data_ptr(), sqs.data_ptr(),
            B, D, C, H, W, cout, cin_p, cout_p, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    return y, sums, sqs


@contextmanager
def no_tf32_conv():
    """Context in which an f32 ``F.conv3d`` on the card is true f32, not
    TF32 (cuDNN's default) — the plain versions are the kernels' yardstick."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
