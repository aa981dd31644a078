// Stride-1 3x3x3 SAME convolution + InstanceNorm moments, bf16 in/out with
// f32 accumulation, for Hopper (sm_90a).
//
// Replaces runet_tpu/kernels/fused_block.py::_conv_stats_kernel_v2m (the
// Pallas kernel behind conv_in_stats_dchw_batch). Contract:
//   x  (B, D, C, H, W) bf16, SAME zero padding on D, H and W;
//   wt (27, Cout_pad, Cin_pad) bf16: tap-major, channels zero-padded
//      (Cin_pad % 16 == 0, Cout_pad % 32 == 0; packed once at load);
//   y  (B, D, Cout, H, W) bf16;
//   sums, sqs (B, Cout) f32: per-(sample, channel) sum of y and of y^2,
//      taken from the bf16-ROUNDED output (what the XLA fallback computes).
//
// Design (conv3x3_stats.cuh): an mma.sync implicit GEMM whose tile the
// launcher picks from W and Cout_pad (8 rows x 32 columns x 64 channels, 8 x
// 32 x 32, or 16 x 16 x 32 where W <= 16), fed one (16-channel chunk, kd
// plane) phase at a time through a two-stage cp.async ring. A phase's raw
// halo plane arrives in x's W-innermost order and is transposed in shared
// memory to channel-innermost, so an A fragment register is one 32-bit
// shared load. Moments: per-block partials in one slot per (d, 8-row tile,
// 32-column tile), whatever the tile, summed in a fixed order and reduced
// by convk::reduce_moments (no float atomics), so y, sums and sqs keep the
// bits of the synchronous 8 x 32 x 32 kernel this design replaced.
//
// What bounds it on the H100: at the U-Net's level-0 widths (C = 24..64) the
// arithmetic intensity is ~27*Cout FLOP per input byte, far above the ~295
// FLOP/byte ridge, so the bound is tensor-core throughput (989 TFLOP/s bf16
// dense). The synchronous 8 x 32 x 32 kernel this design replaced ran its
// loads, transposing stores and MMAs one after another between two
// __syncthreads(), re-staged the whole halo for each 32-channel output
// tile, and at W <= 16 left half its 32-column tile as padding. This design
// overlaps the next phase's copies with the current phase's transpose and
// MMAs, stages each halo once per 64 output channels where Cout_pad allows,
// and fits the tile to W <= 16. Over the 92 main-path shapes it reads
// 70.97-71.08 ms against 76.73-77.10 for the synchronous kernel, 116.6-
// 116.9 for cuDNN + sums and a 14.32 ms bound; the 49 deep shapes (Cin >=
// 128, W < 128) 17.9-18.0 ms (cuDNN 12.8-13.2), the 16 with W <= 16 2.7-2.8
// (cuDNN 1.6-1.9); 245 TFLOP/s at 32^3 128->128, 188 at 16^3 256->256
// (chip_smoke.py's kernels phase and kernel bench; NVIDIA H100 80GB HBM3,
// 700.00 W). What is left: at 128^3 32->32 the staging alone (raw copies,
// the transpose, two barriers per kd plane) takes 0.975 of 1.168 ms; the
// element-load instance stalls on its loads once per kd plane; every block
// re-stages its 9 taps' weights per phase; the GEMM is mma.sync, not wgmma.
#include "conv3x3_stats.cuh"

namespace v2m {

// Launch the conv kernel and the moment reduction on `stream`. psum/psq:
// (B, Cout_pad, nblk(D, H, W)) f32 scratch; sums/sqs: (B, Cout) f32. x takes
// the cp.async copies when W % 8 == 0 and x is 16-byte aligned. Returns
// cudaGetLastError().
static int launch(const void* x, const void* wt, void* y, void* psum, void* psq, void* sums,
                  void* sqs, int B, int D, int C, int H, int W, int Cout, int Cin_pad,
                  int Cout_pad, void* stream) {
  typedef int (*Launch)(const bf16*, const bf16*, bf16*, float*, float*, int, int, int, int, int,
                        int, int, int, cudaStream_t);
  static const Launch table[3][2] = {
      {launch_tile<Narrow, false>, launch_tile<Narrow, true>},
      {launch_tile<Wide32, false>, launch_tile<Wide32, true>},
      {launch_tile<Wide64, false>, launch_tile<Wide64, true>}};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int tile = W <= 16 ? 0 : Cout_pad % 64 == 0 ? 2 : 1;
  const bool vx = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int e = table[tile][vx](static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
                                static_cast<bf16*>(y), static_cast<float*>(psum),
                                static_cast<float*>(psq), B, D, C, H, W, Cout, Cin_pad, Cout_pad,
                                st);
  if (e != cudaSuccess) return e;
  convk::reduce_moments<<<dim3(Cout, B), 256, 0, st>>>(
      static_cast<const float*>(psum), static_cast<const float*>(psq),
      static_cast<float*>(sums), static_cast<float*>(sqs), nblk(D, H, W), Cout, Cout_pad);
  return (int)cudaGetLastError();
}

}  // namespace v2m

extern "C" {

// Geometry the caller needs to size the scratch: the Cout multiple of the
// packed weights and the number of moment partials per (sample, channel)
// for a (D, H, W) output.
int conv3x3_stats_cout_tile() { return 32; }

long long conv3x3_stats_nblk(int D, int H, int W) { return v2m::nblk(D, H, W); }

// Launch the conv kernel and the moment reduction on `stream`.
// psum/psq: (B, Cout_pad, nblk) f32 scratch. Returns cudaGetLastError().
int conv3x3_stats_launch(const void* x, const void* wt, void* y, void* psum, void* psq,
                         void* sums, void* sqs, int B, int D, int C, int H, int W,
                         int Cout, int Cin_pad, int Cout_pad, void* stream) {
  return v2m::launch(x, wt, y, psum, psq, sums, sqs, B, D, C, H, W, Cout, Cin_pad, Cout_pad,
                     stream);
}

}  // extern "C"
