// Weight gradient of the stride-1 3x3x3 SAME convolution, bf16 in, f32 out,
// for Hopper (sm_90a).
//
// Replaces runet_tpu/kernels/fused_block.py::_dw_kernel_v2 (the Pallas
// kernel behind conv3x3_dchw_dw, the dw of the v2 and v2m custom_vjps).
// Contract:
//   x  (B, D, C, H, W) bf16, the conv's input;
//   g  (B, D, Cout, H, W) bf16, the folded output cotangent;
//   dw (3, 3, 3, C, Cout) f32 with
//      dw[kd, kh, kw, ci, co] = sum_{b,d,h,w} x[b, d+kd-1, ci, h+kh-1, w+kw-1]
//                                              * g[b, d, co, h, w]
//      (SAME zero padding), summed over the whole batch in one launch.
//
// Design (conv3x3_dw_common.cuh): an mma.sync implicit GEMM with M = 27*C,
// N = Cout and K = B*D*H*W voxels; K is split over blocks into per-block f32
// partials that a second pass sums in a fixed order (bit-identical across
// runs, no float atomics). The TPU kernel shifted g with rolls and masks to
// keep its lanes aligned; here the kw = 1 tap's misaligned A fragment is one
// byte-permute of the two aligned words the kw = 0 and kw = 2 taps load.
//
// What bounds it on the H100: the same FLOPs as the forward conv
// (2*27*C*Cout per voxel) over bytes that are read once (x and g), ~27*Cout/2
// FLOP per byte, so at the U-Net's level-0 widths (C, Cout = 32..64) it is
// tensor-core bound (above the ~295 FLOP/byte ridge).
// This first version stages each K-tile synchronously (8 independent loads
// per thread) and runs mma.sync, not wgmma/TMA; overlapping staging and
// MMAs (cp.async/TMA pipeline) is the next step toward the bound.
#include "conv3x3_dw_common.cuh"

extern "C" {

int conv3x3_dw_splits(int B, int D, int H, int W, int C, int Cout, int num_sms) {
  return convk::dw_splits<1>(B, D, H, W, C, Cout, num_sms);
}

int conv3x3_dw_launch(const void* x, const void* g, void* part, void* out, int B, int D,
                      int C, int H, int W, int Cout, int n_splits, void* stream) {
  return convk::dw_launch<1>(x, g, part, out, B, D, C, H, W, Cout, n_splits, stream);
}

}  // extern "C"
