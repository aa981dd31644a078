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
// voxel). Design and what it does about the bound: conv3x3_ndhwc.cuh (row
// 1's three tiles, one (chunk, kd plane) phase a stage in a two-stage ring
// that TMA tensor copies fill, ldmatrix fragments). The TPU kernel's im2col
// tile packed K to the MXU's 128; here the 9 taps of a kd plane read the
// staged halo plane in place.
#include "conv3x3_ndhwc.cuh"

extern "C" {

// The Cout multiple of the packed weights this library takes (a Cout_pad
// that is an odd multiple of 32 takes the 32-channel tile).
int conv3x3_ndhwc_cout_tile() { return ndhwc::CO_T; }

// psum, psq, sums and sqs are not used (pass null). Returns cudaGetLastError(),
// or the error of a TMA tensor map that could not be made.
int conv3x3_ndhwc_launch(const void* x, const void* wt, void* y, void* psum, void* psq,
                         void* sums, void* sqs, int B, int D, int C, int H, int W, int Cout,
                         int Cin_pad, int Cout_pad, void* stream) {
  return ndhwc::launch(x, wt, y, B, D, C, H, W, Cout, Cin_pad, Cout_pad, stream);
}

}  // extern "C"
