// Stride-1 3x3x3 SAME convolution + InstanceNorm moments as nine accumulating
// (kh, kw) tap GEMMs with kd folded into K: bf16 in/out, f32 accumulation,
// for Hopper (sm_90a).
//
// Replaces runet_tpu/kernels/fused_block.py::_conv_stats_kernel_v2 (the
// Pallas kernel behind conv_in_stats_dchw_batch(version="v2")). Contract, the
// same as conv3x3_stats.cu's:
//   x  (B, D, C, H, W) bf16, SAME zero padding on D, H and W;
//   wt (27, Cout_pad, Cin_pad) bf16: tap-major, channels zero-padded;
//   y  (B, D, Cout, H, W) bf16;
//   sums, sqs (B, Cout) f32 of the bf16-ROUNDED output.
//
// Design (conv3x3_stats_v2.cuh): row 1's tiles (8 rows x 32 columns x 32
// channels, or 16 x 16 x 32 where W <= 16) and its cp.async raw-plane
// stager and transpose, with a two-stage ring of raw kd planes and three
// transposed kd planes in shared memory beside the chunk's 27 taps of
// weights, so that each 16-channel chunk runs v2's nine kd-folded (kh, kw)
// tap GEMMs: every accumulator takes its k-steps in the order (c0, kh, kw,
// kd), and y, sums and sqs keep the bits of the W-shifted-slab kernel this
// design replaced. Two blocks per SM.
//
// What bounds it on the H100: at the U-Net's widths the arithmetic
// intensity is ~27*Cout FLOP per input byte, far above the ~295 FLOP/byte
// ridge, so the bound is tensor-core throughput (989 TFLOP/s bf16 dense);
// what holds the kernel back is the latency of staging one kd plane at a
// time. Over the 62 shapes the renal serve and train paths launch it reads
// 74.58-74.69 ms against a 16.68 ms bound and 132.2-132.9 for cuDNN + sums
// (the slab kernel: 116.1-116.5); the 31 deep shapes (Cin >= 128, W < 128)
// 16.3 ms against cuDNN's 11.3-11.4, the 9 with W <= 16 1.37 against
// 0.96-1.03, the 31 others 58.3-58.4 against 120.9-121.6; the level-0
// 32->32 conv (B 2, 128^3) 1.07 ms, 217 TFLOP/s, of which the build
// without MMAs takes 0.88 (chip_smoke.py's kernels phase,
// utils/phase_probe.py --kernel v2; NVIDIA H100 80GB HBM3, 700.00 W).
// Left: the waits at kd = 1 and 2 have nothing of this block to overlap;
// every block re-stages its chunk's 27 taps of weights; 32 output channels
// a block re-stage each halo plane Cout / 32 times; the element-load
// instance loads synchronously.
#include "conv3x3_stats_v2.cuh"

namespace v2 {

// Launch the conv kernel and the moment reduction on `stream`. psum/psq:
// (B, Cout_pad, nblk(D, H, W)) f32 scratch; sums/sqs: (B, Cout) f32. x takes
// the cp.async copies when W % 8 == 0 and x is 16-byte aligned. Returns
// cudaGetLastError().
static int launch(const void* x, const void* wt, void* y, void* psum, void* psq, void* sums,
                  void* sqs, int B, int D, int C, int H, int W, int Cout, int Cin_pad,
                  int Cout_pad, void* stream) {
  typedef int (*Launch)(const bf16*, const bf16*, bf16*, float*, float*, int, int, int, int, int,
                        int, int, int, cudaStream_t);
  static const Launch table[2][2] = {{launch_tile<Narrow, false>, launch_tile<Narrow, true>},
                                     {launch_tile<Wide32, false>, launch_tile<Wide32, true>}};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vx = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int e = table[W > 16][vx](static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
                                  static_cast<bf16*>(y), static_cast<float*>(psum),
                                  static_cast<float*>(psq), B, D, C, H, W, Cout, Cin_pad,
                                  Cout_pad, st);
  if (e != cudaSuccess) return e;
  convk::reduce_moments<<<dim3(Cout, B), 256, 0, st>>>(
      static_cast<const float*>(psum), static_cast<const float*>(psq),
      static_cast<float*>(sums), static_cast<float*>(sqs), v2m::nblk(D, H, W), Cout, Cout_pad);
  return (int)cudaGetLastError();
}

}  // namespace v2

extern "C" {

int conv3x3_stats_v2_cout_tile() { return 32; }

// Moment partials per (sample, channel) for a (D, H, W) output.
long long conv3x3_stats_v2_nblk(int D, int H, int W) { return v2m::nblk(D, H, W); }

// Launch the conv kernel and the moment reduction on `stream`.
// psum/psq: (B, Cout_pad, nblk) f32 scratch. Returns cudaGetLastError().
int conv3x3_stats_v2_launch(const void* x, const void* wt, void* y, void* psum, void* psq,
                            void* sums, void* sqs, int B, int D, int C, int H, int W,
                            int Cout, int Cin_pad, int Cout_pad, void* stream) {
  return v2::launch(x, wt, y, psum, psq, sums, sqs, B, D, C, H, W, Cout, Cin_pad, Cout_pad,
                    stream);
}

}  // extern "C"
