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
// Design (conv3x3_dw_s1.cuh on conv3x3_dw_common.cuh): an mma.sync implicit
// GEMM with M = 27*C, N = Cout and K = B*D*H*W voxels; K is split over blocks
// into per-block f32 partials that a second pass sums in a fixed order
// (bit-identical across runs, no float atomics). The TPU kernel shifted g
// with rolls and masks to keep its lanes aligned; here the input halo is
// staged with column w0 on a 16-byte boundary, in 16-byte chunks, and the
// kw = 0 and kw = 2 taps' misaligned A fragments are one byte-permute each
// of the aligned kw = 1 word and its neighbour.
//
// What bounds it on the H100: the same FLOPs as the forward conv
// (2*27*C*Cout per voxel) over bytes that are read once (x and g), ~27*Cout/2
// FLOP per byte, so at the U-Net's level-0 widths (C, Cout = 32..64) it is
// tensor-core bound (above the ~295 FLOP/byte ridge). Staging the K-tiles
// synchronously (stage, sync, MMAs) left it at 150-190 TFLOP/s where W >= 32;
// each K-tile now goes through a two-stage cp.async ring in two halves, so a
// block's copies are in flight during its MMAs, and at W <= 16 the k-step
// over the all-zero columns 16-31 is skipped. The DW1_PHASES mask of
// conv3x3_dw_s1.cuh lets utils/phase_probe.py time each phase's share (H100
// 80GB HBM3, 700 W; PERF.md §6): at B 2, 128³, 32->32 the kernel without its
// MMAs still takes 0.83 of its 1.15 ms, as the x halo is read again for each
// of its three kd planes and each 4-row half (36 lines per 8 output rows);
// at 32³ 128->128 and 16³ 256->256 the MMAs are the largest share.
#include "conv3x3_dw_s1.cuh"

extern "C" {

int conv3x3_dw_splits(int B, int D, int H, int W, int C, int Cout, int num_sms) {
  return convk::dw_splits<1>(B, D, H, W, C, Cout, num_sms);
}

int conv3x3_dw_launch(const void* x, const void* g, void* part, void* out, int B, int D,
                      int C, int H, int W, int Cout, int n_splits, void* stream) {
  return convk::dw1_launch(x, g, part, out, B, D, C, H, W, Cout, n_splits, stream);
}

}  // extern "C"
