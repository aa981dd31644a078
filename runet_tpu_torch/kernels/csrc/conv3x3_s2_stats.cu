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
// Design: the implicit GEMM of conv3x3_stats.cu with strided A fragments.
// A block owns one output depth, TH x TW output (h, w) positions and CO_T
// output channels; it stages the input halo 3 x (2TH+1) x (2TW+1) x 16
// channels and reads A[m][k] at column 2m + kw, so the stride costs nothing
// in the MMA loop. A per-position stride of 20 bf16 keeps the stride-2
// fragment loads bank-conflict free. The Pallas kernel decimated W with 0/1
// selection matmuls because the TPU cannot stride its lanes; a GPU thread
// simply addresses the strided element.
//
// What bounds it on the H100: each output reads 8x its own volume of input,
// so at the main path's widths (24->48, 32->64) the bound is the HBM bytes
// of reading the input once (~27*Cout/8 FLOP per input byte, below the
// ~295 FLOP/byte ridge). The kernel is far from that bound: it re-reads
// halos per output-channel tile and stages synchronously (8 independent
// loads per thread, stage_halo), without overlapping staging and MMAs.
#include "conv3x3_common.cuh"

namespace {

using convk::bf16;

constexpr int TH = 4;      // output rows per block (one warp each)
constexpr int TW = 32;     // output columns per block
constexpr int CO_T = 32;   // output channels per block
constexpr int KC = 16;     // input channels per staged chunk (MMA K)
constexpr int XS = 20;     // shared stride (bf16) of one staged input position
constexpr int WS = 24;     // shared stride (bf16) of one (tap, cout) weight row
constexpr int MT = TW / 16;
constexpr int NT = CO_T / 8;
constexpr int NTHREADS = TH * 32;
constexpr int XR = 2 * TH + 1, XC = 2 * TW + 1;
constexpr int SMEM_X = convk::round_up(3 * XR * XC * XS, 8);
constexpr int SMEM_W = 27 * CO_T * WS;
constexpr int SMEM_BYTES = (SMEM_X + SMEM_W) * 2;

__global__ void __launch_bounds__(NTHREADS)
conv3x3_s2_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                        bf16* __restrict__ y, float* __restrict__ psum,
                        float* __restrict__ psq, int D, int C, int H, int W, int Cout,
                        int Cin_pad, int Cout_pad, int n_wtiles, int n_cotiles,
                        int64_t nblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ws = xs + SMEM_X;
  __shared__ float red_s[TH][CO_T], red_q[TH][CO_T];

  const int Do = D / 2, Ho = H / 2, Wo = W / 2;
  const int ht = blockIdx.x / n_wtiles, wtile = blockIdx.x % n_wtiles;
  const int d = blockIdx.y;
  const int b = blockIdx.z / n_cotiles, cot = blockIdx.z % n_cotiles;
  const int h0 = ht * TH, w0 = wtile * TW, co0 = cot * CO_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t HW = (int64_t)H * W;
  const bf16* xb = x + (int64_t)b * D * C * HW;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  for (int c0 = 0; c0 < Cin_pad; c0 += KC) {
    __syncthreads();
    // Input rows 2d.., 2h0.., 2w0..; past the extent reads zero (the
    // (0, 1) SAME pad).
    convk::stage_halo<NTHREADS, KC, XR, XC, XS>(xs, xb, D, C, H, W, 2 * d, 2 * h0, 2 * w0, c0);
    convk::stage_weights<NTHREADS, CO_T, WS>(ws, wt, Cout_pad, Cin_pad, co0, c0);
    __syncthreads();

    convk::mma_27taps<2, MT, NT, XR, XC, XS, CO_T, WS>(acc, xs, ws, warp, g, t);
  }

  const int h = h0 + warp;
  const int64_t HWo = (int64_t)Ho * Wo;
  const int64_t blk = (int64_t)d * gridDim.x + blockIdx.x;
  bf16* ybase = y + ((int64_t)b * Do + d) * Cout * HWo;
  convk::store_tile_and_moments<MT, NT, TH>(
      acc, ybase, HWo, Wo, h, h < Ho, w0, co0, Cout, red_s, red_q, psum, psq,
      ((int64_t)b * Cout_pad + co0) * nblk + blk, nblk);
}

}  // namespace

extern "C" {

int conv3x3_s2_stats_cout_tile() { return CO_T; }

// Moment partials per (sample, channel) for an (Do, Ho, Wo) OUTPUT.
long long conv3x3_s2_stats_nblk(int Do, int Ho, int Wo) {
  return (long long)Do * ((Ho + TH - 1) / TH) * ((Wo + TW - 1) / TW);
}

// D, H, W are the INPUT extents (even). psum/psq: (B, Cout_pad, nblk) f32.
int conv3x3_s2_stats_launch(const void* x, const void* wt, void* y, void* psum, void* psq,
                            void* sums, void* sqs, int B, int D, int C, int H, int W,
                            int Cout, int Cin_pad, int Cout_pad, void* stream) {
  static bool attr_done = false;
  if (!attr_done) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3x3_s2_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_done = true;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int Do = D / 2, Ho = H / 2, Wo = W / 2;
  const int nh = (Ho + TH - 1) / TH, nw = (Wo + TW - 1) / TW, nco = Cout_pad / CO_T;
  const int64_t nblk = (int64_t)Do * nh * nw;
  dim3 grid(nh * nw, Do, B * nco);
  conv3x3_s2_stats_kernel<<<grid, NTHREADS, SMEM_BYTES, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt), static_cast<bf16*>(y),
      static_cast<float*>(psum), static_cast<float*>(psq), D, C, H, W, Cout, Cin_pad,
      Cout_pad, nw, nco, nblk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  convk::reduce_moments<<<dim3(Cout, B), 256, 0, st>>>(
      static_cast<const float*>(psum), static_cast<const float*>(psq),
      static_cast<float*>(sums), static_cast<float*>(sqs), nblk, Cout, Cout_pad);
  return (int)cudaGetLastError();
}

}  // extern "C"
