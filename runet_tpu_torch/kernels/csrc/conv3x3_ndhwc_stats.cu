// Stride-1 3x3x3 SAME convolution + per-channel moments, NDHWC bf16 in and
// out, f32 accumulation, for Hopper (sm_90a).
//
// Replaces runet_tpu/kernels/attic/conv_v3_deep.py::_v3_kernel (the
// channels-on-lanes deep-level conv behind conv3x3_v3). Contract:
//   x  (B, D, H, W, C) bf16, SAME zero padding on D, H and W;
//   wt (27, Cout_pad, Cin_pad) bf16, packed as for conv3x3_stats.cu;
//   y  (B, D, H, W, Cout) bf16;
//   sums, sqs (B, Cout) f32: per-(sample, channel) sum of y and of y^2 over
//      the valid voxels, taken from the bf16-ROUNDED output.
// Bound on the H100: tensor-core throughput (2*27*C*Cout FLOP per output
// voxel; the deep levels' C >= 128 fill the MMA's K). Design and what it
// does about the bound: conv3x3_ndhwc_stats.cuh (64-channel 8 x 32 tiles
// where W > 16, 32-channel 16 x 16 tiles where W <= 16, each staged one kd
// plane per phase through a two-stage cp.async ring). The TPU kernel's
// flattened, filler-padded slab (P' rows per plane, masked filler rows)
// existed to keep Mosaic's DMAs tile-aligned; here padding is the
// zero-filled halo and only valid voxels are stored or summed. Moments:
// per-block partials reduced in a fixed order by convk::reduce_moments (no
// float atomics).
#include "conv3x3_ndhwc_stats.cuh"

extern "C" {

// The Cout multiple of the packed weights this library takes (a Cout_pad
// that is an odd multiple of 32 leaves the last 64-channel tile half empty).
int conv3x3_ndhwc_stats_cout_tile() { return v3::COUT_PAD; }

// Moment partials per (sample, channel) for a (D, H, W) output.
long long conv3x3_ndhwc_stats_nblk(int D, int H, int W) { return v3::nblk(D, H, W); }

// psum/psq: (B, Cout_pad, nblk) f32 scratch. Returns cudaGetLastError().
int conv3x3_ndhwc_stats_launch(const void* x, const void* wt, void* y, void* psum, void* psq,
                               void* sums, void* sqs, int B, int D, int C, int H, int W,
                               int Cout, int Cin_pad, int Cout_pad, void* stream) {
  return v3::launch(x, wt, y, psum, psq, sums, sqs, B, D, C, H, W, Cout, Cin_pad, Cout_pad,
                    stream);
}

}  // extern "C"
