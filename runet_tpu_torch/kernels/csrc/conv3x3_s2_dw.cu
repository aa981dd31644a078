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
// Design (conv3x3_dw_s2.cuh on conv3x3_dw_common.cuh): the implicit GEMM of
// conv3x3_dw.cu with the input halo staged as separate even and odd
// columns, so the stride-2 A fragments (two K voxels, two input columns
// apart) are aligned 32-bit loads for kw = 0, 1 and one byte-permute for
// kw = 2. The Pallas kernel decimated the lanes with 0/1 selection matmuls
// instead. The halo is staged in 16-byte chunks (one index computation per
// 8 elements), each split into its even and odd columns in registers by
// byte-permutes; only the 65th column of a line is an element load.
//
// What bounds it on the H100: K is the OUTPUT voxel count, an eighth of the
// input's, so the FLOPs per input byte are an eighth of the stride-1 dw's.
// At the main path's 32->64 level-0 shape (128^3, B = 2) the work is ~58
// GFLOP against ~335 MB of x and g: HBM bytes bound it (~0.10 ms vs ~0.06 ms
// of tensor-core time). A K-tile of 128 output voxels stages 3 planes x 9
// rows x 16 channels x 65 columns of x, 219 elements per output voxel. By
// instruction count, element-wise staging issued ~25 K warp-instructions per
// K-tile against ~3 K for the MMAs and fragment loads; the chunked staging,
// 4 loads of 16 bytes in flight per thread, cuts it to about 4 K. Staging is still synchronous (stage, sync, MMAs): a
// cp.async/TMA ring that overlaps it with the MMAs is the next step.
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
