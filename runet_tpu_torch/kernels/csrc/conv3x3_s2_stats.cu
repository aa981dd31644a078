// Stride-2 3x3x3 convolution (XLA SAME padding) + InstanceNorm moments,
// bf16 in/out with f32 accumulation, for Hopper (sm_90a).
//
// Replaces runet_tpu/kernels/strided_conv.py::_conv_s2_kernel (the Pallas
// kernel behind conv_s2_stats_dchw_batch). Contract:
//   x  (B, D, C, H, W) bf16 with D, H, W even;
//   wt (27, Cout_pad, Cin_pad) bf16, packed as for conv3x3_stats.cu;
//   y  (B, D/2, Cout, H/2, W/2) bf16 where output (d, h, w) reads input
//      (2d+kd, 2h+kh, 2w+kw), k = 0..2, and an index past the extent reads
//      zero: the asymmetric SAME padding (low 0, high 1) of a stride-2 conv
//      on an even extent;
//   sums, sqs (B, Cout) f32 moments of the bf16-ROUNDED output.
// Any B >= 1 (the Pallas gate accepts only B = 1).
//
// Design (conv3x3_s2_stats.cuh): an mma.sync implicit GEMM whose tile the
// launcher picks from Wo and Cout_pad (4 output rows x 32 columns or 8 x 16
// where Wo <= 16, by 64 output channels where Cout_pad % 64 == 0, else 32),
// fed one (16-channel chunk, kd plane) phase at a time through a two-stage
// cp.async ring. A phase's raw input plane arrives in x's W-innermost order
// and is transposed in shared memory to channel-innermost with its even and
// odd columns apart, so that each tap's A fragment is 16 consecutive
// positions and comes by one ldmatrix. The Pallas kernel decimated W with
// 0/1 selection matmuls because the TPU cannot stride its lanes. Moments:
// per-block partials in one slot per (d, 4-row tile, 32-column tile),
// whatever the tile, summed in a fixed order and reduced by
// convk::reduce_moments (no float atomics), so y, sums and sqs keep the bits
// of the synchronous 4 x 32 x 32 kernel this design replaced.
//
// What bounds it on the H100: each output reads 8x its own volume of input,
// so at the main path's widths the least time is the HBM bytes of reading
// the input once (~27 * Cout / 8 FLOP per input byte, below the ~295
// FLOP/byte ridge). The synchronous kernel it replaced staged each K-tile's
// three kd planes and 27 taps before any MMA, re-staged the halo for each
// 32-channel output tile, ran the Cout tiles of one halo a whole sample
// apart, and at Wo <= 16 left half its 32-column tile as padding: 19.35-
// 19.41 ms over the 43 main-path shapes against a 2.43 ms bound. This design
// reads 11.51-11.74 ms there (cuDNN + sums 30.26-30.39), 1.78-2.00 at the 14
// with Wo <= 16 (the synchronous kernel 2.98, cuDNN 1.65-1.76)
// (chip_smoke.py's kernels phase; NVIDIA H100 80GB HBM3, 700.00 W). Left: at
// level 0 the build without MMAs takes 0.336 of 0.340 ms (utils/
// phase_probe.py --kernel s2), each block re-copying its 9 taps of weights a
// phase; at Wo <= 8 and Cin 256 a launch has as few as 40 blocks.
#include "conv3x3_s2_stats.cuh"

namespace s2 {

// Launch the conv kernel and the moment reduction on `stream`. D, H, W are
// the INPUT extents (even); psum/psq: (B, Cout_pad, nblk(D/2, H/2, W/2)) f32
// scratch; sums/sqs: (B, Cout) f32. x takes the cp.async copies when W % 8
// == 0 and x is 16-byte aligned. Returns cudaGetLastError().
static int launch(const void* x, const void* wt, void* y, void* psum, void* psq, void* sums,
                  void* sqs, int B, int D, int C, int H, int W, int Cout, int Cin_pad,
                  int Cout_pad, void* stream) {
  typedef int (*Launch)(const bf16*, const bf16*, bf16*, float*, float*, int, int, int, int, int,
                        int, int, int, cudaStream_t);
  static const Launch table[2][2][2] = {
      {{launch_tile<Narrow32, false>, launch_tile<Narrow32, true>},
       {launch_tile<Narrow64, false>, launch_tile<Narrow64, true>}},
      {{launch_tile<Wide32, false>, launch_tile<Wide32, true>},
       {launch_tile<Wide64, false>, launch_tile<Wide64, true>}}};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vx = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int e = table[W / 2 > 16][Cout_pad % 64 == 0][vx](
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt), static_cast<bf16*>(y),
      static_cast<float*>(psum), static_cast<float*>(psq), B, D, C, H, W, Cout, Cin_pad, Cout_pad,
      st);
  if (e != cudaSuccess) return e;
  convk::reduce_moments<<<dim3(Cout, B), 256, 0, st>>>(
      static_cast<const float*>(psum), static_cast<const float*>(psq),
      static_cast<float*>(sums), static_cast<float*>(sqs), nblk(D / 2, H / 2, W / 2), Cout,
      Cout_pad);
  return (int)cudaGetLastError();
}

}  // namespace s2

extern "C" {

int conv3x3_s2_stats_cout_tile() { return 32; }

// Moment partials per (sample, channel) for an (Do, Ho, Wo) OUTPUT.
long long conv3x3_s2_stats_nblk(int Do, int Ho, int Wo) { return s2::nblk(Do, Ho, Wo); }

// D, H, W are the INPUT extents (even). psum/psq: (B, Cout_pad, nblk) f32.
int conv3x3_s2_stats_launch(const void* x, const void* wt, void* y, void* psum, void* psq,
                            void* sums, void* sqs, int B, int D, int C, int H, int W,
                            int Cout, int Cin_pad, int Cout_pad, void* stream) {
  return s2::launch(x, wt, y, psum, psq, sums, sqs, B, D, C, H, W, Cout, Cin_pad, Cout_pad,
                    stream);
}

}  // extern "C"
