// Stride-1 3x3x3 SAME convolution, NDHWC bf16 in and out, f32 accumulation,
// no moments, for Hopper (sm_90a).
//
// Replaces runet_tpu/kernels/attic/conv3d.py::_conv_kernel (the Pallas
// im2col conv behind conv3x3x3_same and the custom_vjp pallas_conv3x3).
// Contract:
//   x  (B, D, H, W, C) bf16, SAME zero padding on D, H and W;
//   wt (27, Cout_pad, Cin_pad) bf16, packed as for conv3x3_stats.cu;
//   y  (B, D, H, W, Cout) bf16.
// Bound on the H100: tensor-core throughput (2*27*C*Cout FLOP per output
// voxel). Design and what it does about the bound: conv3x3_ndhwc.cuh (the
// implicit GEMM that conv3x3_ndhwc_stats.cu shares, without the moment
// epilogue). The TPU kernel's im2col tile packed K to the MXU's 128; here
// the 27 taps read the staged halo in place.
#include "conv3x3_ndhwc.cuh"

extern "C" {

int conv3x3_ndhwc_cout_tile() { return ndhwc::CO_T; }

// psum, psq, sums and sqs are not used (pass null). Returns cudaGetLastError().
int conv3x3_ndhwc_launch(const void* x, const void* wt, void* y, void* psum, void* psq,
                         void* sums, void* sqs, int B, int D, int C, int H, int W, int Cout,
                         int Cin_pad, int Cout_pad, void* stream) {
  return ndhwc::launch<false>(x, wt, y, psum, psq, sums, sqs, B, D, C, H, W, Cout, Cin_pad,
                              Cout_pad, stream);
}

}  // extern "C"
