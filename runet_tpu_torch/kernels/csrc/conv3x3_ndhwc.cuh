// Stride-1 3x3x3 SAME convolution on channel-innermost (B, D, H, W, C)
// bf16 activations, f32 accumulation, bf16 output (B, D, H, W, Cout); with
// STATS also the per-(sample, channel) sums of the bf16-ROUNDED output and
// of its square. One implicit GEMM, two epilogues:
//   conv3x3_ndhwc.cu       (STATS = false) replaces
//       runet_tpu/kernels/attic/conv3d.py::_conv_kernel;
//   conv3x3_ndhwc_stats.cu (STATS = true)  replaces
//       runet_tpu/kernels/attic/conv_v3_deep.py::_v3_kernel.
//
// Design: the GEMM of conv3x3_stats.cu (mma.sync m16n8k16 bf16): M = output
// voxels (a block owns one output depth d, TH = 8 rows (one warp each) by
// TW = 32 columns), N = Cout in tiles of CO_T = 32, K = 27 taps x 16-channel
// chunks. For each chunk the block stages the zero-padded input halo
// (3 x (TH+2) x (TW+2) positions x 16 channels, channel innermost, 24-bf16
// stride per position) and the chunk's weights, then runs the 27 taps from
// shared memory (convk::mma_27taps). NDHWC is already channel-innermost in
// device memory, so a position's 16 channels are two 16-byte loads (when C
// is a multiple of 8 and x is 16-byte aligned; otherwise element loads,
// zero past C). Positions outside the extent are zero: SAME padding, and
// any D, H, W, Cin, Cout runs (the TPU kernels' D % TD, H % 8, W % 128 and
// Cin % 8 gates were Mosaic tiling only). No im2col tile is built: the
// taps read the halo in place.
//
// Moments (STATS): each block writes its per-channel partials to a slot of
// its own and convk::reduce_moments sums the slots in a fixed order, so a
// run gives the same bits every time (no float atomics).
//
// What bounds it on the H100: ~27*Cout*2 FLOP per input byte at the
// attic's widths (Cout = 32..256), far above the ~295 FLOP/byte ridge, so
// tensor-core throughput. Like conv3x3_stats.cu this first version uses
// mma.sync (not wgmma/TMA) and stages synchronously (each thread issues its
// halo loads before storing any); staging does not overlap the MMAs. The
// epilogue stores bf16 elements one by one (the output's bytes are small
// beside the GEMM's work).
#pragma once

#include "conv3x3_common.cuh"

namespace ndhwc {

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
constexpr int NPOS = 3 * XR * XC;  // staged halo positions
constexpr int SMEM_X = convk::round_up(NPOS * XS, 8);
constexpr int SMEM_W = 27 * CO_T * WS;
constexpr int SMEM_BYTES = (SMEM_X + SMEM_W) * 2;

// Stage one 16-channel chunk of the NDHWC halo: xs[pos * XS + ci] =
// x[b, d0 + kd, h0 + row, w0 + col, c0 + ci] with pos = (kd * XR + row) * XC
// + col, zero outside the extent and past channel C. One element of the
// loop is 8 channels of one position (16 bytes); VEC: one vector load
// (C % 8 == 0, x 16-byte aligned), else element loads. Each thread issues
// U loads before it stores any.
template <bool VEC>
__device__ __forceinline__ void stage_halo(bf16* __restrict__ xs, const bf16* __restrict__ xb,
                                           int D, int H, int W, int C, int d0, int h0, int w0,
                                           int c0) {
  constexpr int NE = NPOS * 2;
  constexpr int U = 8;
  const unsigned short zero_bits = 0;
  for (int base = threadIdx.x; base < NE; base += NTHREADS * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * NTHREADS;
      const int half = e & 1, pos = e >> 1;
      const int kd = pos / (XR * XC), p = pos - kd * (XR * XC);
      const int row = p / XC, col = p - row * XC;
      const int dd = d0 + kd, hh = h0 + row, ww = w0 + col, cb = c0 + half * 8;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < NE && (unsigned)dd < (unsigned)D && (unsigned)hh < (unsigned)H &&
          (unsigned)ww < (unsigned)W && cb < C) {
        const bf16* src = xb + (((int64_t)dd * H + hh) * W + ww) * C + cb;
        if (VEC) {
          v[u] = *reinterpret_cast<const uint4*>(src);
        } else {
          unsigned short h[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            h[j] = cb + j < C ? __bfloat16_as_ushort(src[j]) : zero_bits;
          v[u] = make_uint4(h[0] | ((unsigned)h[1] << 16), h[2] | ((unsigned)h[3] << 16),
                            h[4] | ((unsigned)h[5] << 16), h[6] | ((unsigned)h[7] << 16));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * NTHREADS;
      if (e < NE) *reinterpret_cast<uint4*>(xs + (e >> 1) * XS + (e & 1) * 8) = v[u];
    }
  }
}

// grid: (ceil(H/TH) * ceil(W/TW), D, B * Cout_pad/CO_T).
template <bool STATS, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_ndhwc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                     bf16* __restrict__ y, float* __restrict__ psum, float* __restrict__ psq,
                     int D, int H, int W, int C, int Cout, int Cin_pad, int Cout_pad,
                     int n_wtiles, int n_cotiles, int64_t nblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ws = xs + SMEM_X;
  __shared__ float red_s[STATS ? TH : 1][CO_T], red_q[STATS ? TH : 1][CO_T];

  const int ht = blockIdx.x / n_wtiles, wtile = blockIdx.x % n_wtiles;
  const int d = blockIdx.y;
  const int b = blockIdx.z / n_cotiles, cot = blockIdx.z % n_cotiles;
  const int h0 = ht * TH, w0 = wtile * TW, co0 = cot * CO_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t DHW = (int64_t)D * H * W;
  const bf16* xb = x + (int64_t)b * DHW * C;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  for (int c0 = 0; c0 < Cin_pad; c0 += KC) {
    __syncthreads();  // the previous chunk's fragments have been read
    stage_halo<VEC>(xs, xb, D, H, W, C, d - 1, h0 - 1, w0 - 1, c0);
    convk::stage_weights<NTHREADS, CO_T, WS>(ws, wt, Cout_pad, Cin_pad, co0, c0);
    __syncthreads();
    convk::mma_27taps<1, MT, NT, XR, XC, XS, CO_T, WS>(acc, xs, ws, warp, g, t);
  }

  const int h = h0 + warp;
  const int64_t blk = (int64_t)d * gridDim.x + blockIdx.x;
  bf16* ybase = y + ((int64_t)b * D + d) * H * W * Cout;
  convk::store_tile<MT, NT, TH, STATS>(
      acc, ybase, 1, (int64_t)W * Cout, Cout, W, h, h < H, w0, co0, Cout, red_s, red_q, psum,
      psq, STATS ? ((int64_t)b * Cout_pad + co0) * nblk + blk : 0, nblk);
}

inline long long nblk(int D, int H, int W) {
  return (long long)D * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// Launch the conv kernel (and with STATS the moment reduction) on `stream`.
// psum/psq: (B, Cout_pad, nblk) f32 scratch; sums/sqs: (B, Cout) f32 (all
// four unused, and may be null, without STATS). Returns cudaGetLastError().
template <bool STATS>
int launch(const void* x, const void* wt, void* y, void* psum, void* psq, void* sums, void* sqs,
           int B, int D, int C, int H, int W, int Cout, int Cin_pad, int Cout_pad,
           void* stream) {
  const bool vec = C % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto kern = vec ? conv3x3_ndhwc_kernel<STATS, true> : conv3x3_ndhwc_kernel<STATS, false>;
  static bool attr_done[2] = {false, false};
  if (!attr_done[vec]) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_done[vec] = true;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nh = (H + TH - 1) / TH, nw = (W + TW - 1) / TW, nco = Cout_pad / CO_T;
  const int64_t nb = nblk(D, H, W);
  dim3 grid(nh * nw, D, B * nco);
  kern<<<grid, NTHREADS, SMEM_BYTES, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt), static_cast<bf16*>(y),
      static_cast<float*>(psum), static_cast<float*>(psq), D, H, W, C, Cout, Cin_pad, Cout_pad,
      nw, nco, nb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !STATS) return (int)e;
  convk::reduce_moments<<<dim3(Cout, B), 256, 0, st>>>(
      static_cast<const float*>(psum), static_cast<const float*>(psq),
      static_cast<float*>(sums), static_cast<float*>(sqs), nb, Cout, Cout_pad);
  return (int)cudaGetLastError();
}

}  // namespace ndhwc
