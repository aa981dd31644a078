// Weight gradient of the stride-2 3x3x3 convolution with XLA's SAME
// padding, bf16 in, f32 out, for Hopper (sm_90a).
//
// Replaces runet_tpu/kernels/strided_conv.py::_s2_dw_kernel (the Pallas
// kernel behind conv3x3_s2_dw, the dw of the stride-2 custom_vjp). Contract:
//   x  (B, D, C, H, W) bf16 with D, H, W even, the conv's input;
//   g  (B, D/2, Cout, H/2, W/2) bf16, the folded output cotangent;
//   dw (3, 3, 3, C, Cout) f32 with
//      dw[kd, kh, kw, ci, co] = sum_{b,d,h,w} x[b, 2d+kd, ci, 2h+kh, 2w+kw]
//                                              * g[b, d, co, h, w]
//      where an input index past the extent reads zero: the (low 0, high 1)
//      SAME pad of a stride-2 conv on an even extent. Any B >= 1.
//
// Design (conv3x3_dw_s2.cuh on conv3x3_dw_common.cuh): the implicit GEMM
// of conv3x3_dw.cu with blocks of 18 warps that own 16 input x 64 output
// channels, each K-tile (4 output rows x 32 output columns) staged whole,
// once for both 32-channel halves, in one of two stages. The input lines are
// kept raw (input column 2w0 + c at index c), and each stride-2 A fragment
// (two K voxels, two input columns apart) is one byte-permute of two words
// from two 64-bit shared loads. The Pallas kernel decimated the lanes with
// 0/1 selection matmuls instead.
//
// What bounds it on the H100: K is the OUTPUT voxel count, an eighth of the
// input's, so the FLOPs per input byte are an eighth of the stride-1 dw's.
// At the main path's 32->64 level-0 shape (128^3, B = 2) the work is ~58
// GFLOP against ~335 MB of x and g: HBM bytes bound it (~0.10 ms vs ~0.06 ms
// of tensor-core time); the deeper levels (64->128 .. 256->320) are bound by
// operations. A K-tile of 128 output voxels stages 3 planes x 9 rows x 16
// channels x 66 columns of x, 223 elements per output voxel, once for 64
// output channels (at level 0, Cout = 64, once in all). Copies that every
// thread issues (cp.async) took the warps' time from their MMAs, so that
// copies and MMAs added up; where x and g allow it (16-byte aligned, W and
// Wo multiples of 8: every main-path launch) one thread loads a K-tile by
// seven TMA tensor copies that complete on an mbarrier, the next K-tile in
// flight during this one's MMAs. The element-load instance keeps a cp.async
// ring. Where Wo - w0 <= 16 the k-step over the zero-filled output columns
// 16-31 is skipped (half the MMAs at Wo = 16 and 8). The DW2_PHASES mask
// of conv3x3_dw_s2.cuh lets utils/phase_probe.py --kernel dw2 time each
// phase's share (PERF.md §6).
#include "conv3x3_dw_s2.cuh"

extern "C" {

// D, H, W are the INPUT extents (even).
int conv3x3_s2_dw_splits(int B, int D, int H, int W, int C, int Cout, int num_sms) {
  return convk::dw_splits<2>(B, D / 2, H / 2, W / 2, C, Cout, num_sms);
}

int conv3x3_s2_dw_launch(const void* x, const void* g, void* part, void* out, int B, int D,
                         int C, int H, int W, int Cout, int n_splits, void* stream) {
  return convk::dw2_launch(x, g, part, out, B, D, C, H, W, Cout, n_splits, stream);
}

}  // extern "C"
