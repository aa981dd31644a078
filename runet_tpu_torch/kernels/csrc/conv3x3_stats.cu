// Stride-1 3x3x3 SAME convolution + InstanceNorm moments, bf16 in/out with
// f32 accumulation, for Hopper (sm_90a).
//
// Replaces runet_tpu/kernels/fused_block.py::_conv_stats_kernel_v2m (the
// Pallas kernel behind conv_in_stats_dchw_batch). Contract:
//   x  (B, D, C, H, W) bf16, SAME zero padding on D, H and W;
//   wt (27, Cout_pad, Cin_pad) bf16: tap-major, channels zero-padded
//      (Cin_pad % 16 == 0, Cout_pad % CO_T == 0; packed once at load);
//   y  (B, D, Cout, H, W) bf16;
//   sums, sqs (B, Cout) f32: per-(sample, channel) sum of y and of y^2,
//      taken from the bf16-ROUNDED output (what the XLA fallback computes).
//
// Design: an implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16).
// One block owns one output depth d, a TH x TW patch of (h, w) and CO_T
// output channels; warp i computes output row h0 + i as M = TW positions
// (2 m16 tiles) by N = CO_T channels (4 n8 tiles). K runs over 16 input
// channels at a time times the 27 taps: for each 16-channel chunk the block
// stages the zero-padded input halo (3 x (TH+2) x (TW+2) x 16, channel
// innermost so an A fragment register is one 32-bit shared load) and the
// chunk's weights (27 x CO_T x 16) in shared memory, then runs 27 taps of
// MMAs from it. Padding the per-position stride to 24 bf16 makes both
// fragment loads bank-conflict free.
//
// What bounds it on the H100: at the U-Net's level-0 widths (C = 24..64) the
// arithmetic intensity is ~27*Cout FLOP per input byte, far above the
// ~295 FLOP/byte ridge, so the bound is tensor-core throughput. This first
// version uses mma.sync (not wgmma/TMA) and stages synchronously: each
// thread issues 8 independent halo loads before storing any (stage_halo),
// but staging and MMAs of one block do not overlap. A cp.async/TMA pipeline
// and wgmma are the next steps toward the bound.
#include "conv3x3_common.cuh"

namespace {

using convk::bf16;

constexpr int TH = 8;      // output rows per block (one warp each)
constexpr int TW = 32;     // output columns per block
constexpr int CO_T = 32;   // output channels per block
constexpr int KC = 16;     // input channels per staged chunk (MMA K)
constexpr int XS = 24;     // shared stride (bf16) of one staged input position
constexpr int WS = 24;     // shared stride (bf16) of one (tap, cout) weight row
constexpr int MT = TW / 16;
constexpr int NT = CO_T / 8;
constexpr int NTHREADS = TH * 32;
constexpr int XR = TH + 2, XC = TW + 2;
constexpr int SMEM_X = convk::round_up(3 * XR * XC * XS, 8);
constexpr int SMEM_W = 27 * CO_T * WS;
constexpr int SMEM_BYTES = (SMEM_X + SMEM_W) * 2;

__global__ void __launch_bounds__(NTHREADS)
conv3x3_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                     bf16* __restrict__ y, float* __restrict__ psum,
                     float* __restrict__ psq, int D, int C, int H, int W, int Cout,
                     int Cin_pad, int Cout_pad, int n_wtiles, int n_cotiles,
                     int64_t nblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ws = xs + SMEM_X;
  __shared__ float red_s[TH][CO_T], red_q[TH][CO_T];

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
    __syncthreads();  // the previous chunk's fragments have been read
    // Input halo (SAME padding: rows d-1.., h0-1.., w0-1..), channel
    // innermost; channels past C are zero.
    convk::stage_halo<NTHREADS, KC, XR, XC, XS>(xs, xb, D, C, H, W, d - 1, h0 - 1, w0 - 1, c0);
    // Weights of this chunk: 16 contiguous input channels per (tap, cout)
    // row, copied as two 16-byte vectors.
    convk::stage_weights<NTHREADS, CO_T, WS>(ws, wt, Cout_pad, Cin_pad, co0, c0);
    __syncthreads();

    convk::mma_27taps<1, MT, NT, XR, XC, XS, CO_T, WS>(acc, xs, ws, warp, g, t);
  }

  const int h = h0 + warp;
  const int64_t blk = (int64_t)d * gridDim.x + blockIdx.x;
  bf16* ybase = y + ((int64_t)b * D + d) * Cout * HW;
  convk::store_tile_and_moments<MT, NT, TH>(
      acc, ybase, HW, W, h, h < H, w0, co0, Cout, red_s, red_q, psum, psq,
      ((int64_t)b * Cout_pad + co0) * nblk + blk, nblk);
}

}  // namespace

extern "C" {

// Geometry the caller needs to size the scratch: the output-channel tile
// (Cout_pad must be a multiple of it) and the number of moment partials
// per (sample, channel) for a (D, H, W) output.
int conv3x3_stats_cout_tile() { return CO_T; }

long long conv3x3_stats_nblk(int D, int H, int W) {
  return (long long)D * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// Launch the conv kernel and the moment reduction on `stream`.
// psum/psq: (B, Cout_pad, nblk) f32 scratch. Returns cudaGetLastError().
int conv3x3_stats_launch(const void* x, const void* wt, void* y, void* psum, void* psq,
                         void* sums, void* sqs, int B, int D, int C, int H, int W,
                         int Cout, int Cin_pad, int Cout_pad, void* stream) {
  static bool attr_done = false;
  if (!attr_done) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3x3_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_done = true;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nh = (H + TH - 1) / TH, nw = (W + TW - 1) / TW, nco = Cout_pad / CO_T;
  const int64_t nblk = (int64_t)D * nh * nw;
  dim3 grid(nh * nw, D, B * nco);
  conv3x3_stats_kernel<<<grid, NTHREADS, SMEM_BYTES, st>>>(
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
