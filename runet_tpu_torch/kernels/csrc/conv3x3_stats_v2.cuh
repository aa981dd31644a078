// The kernel of conv3x3_stats_v2.cu: the stride-1 3x3x3 SAME convolution of
// (B, D, C, H, W) bf16 activations with the moments of its bf16-ROUNDED
// output, as an mma.sync (m16n8k16 bf16) implicit GEMM in v2's formulation:
// per 16-channel chunk, nine (kh, kw) tap GEMMs with kd folded into K.
//
// Tiles: row 1's (conv3x3_stats.cuh), picked by the launcher from W:
//   Wide32 (W > 16): 8 rows x 32 columns x 32 output channels; warp w
//          computes row w as 2 m16 tiles x 4 n8 tiles;
//   Narrow (W <= 16): 16 rows x 16 columns x 32 channels; warp w computes
//          rows 2w and 2w + 1, one m16 tile each, x 4 n8 tiles.
// Row 1's 64-channel tile is left out: its 27 taps of weights (55,296 B at
// the stride below) would leave one block per SM.
//
// Shared memory, one block: two raw halo planes as v2m::stage_raw fills
// them (x's own W-innermost order); three transposed kd planes xs[0..2],
// each (TH + 2) x (TW + 2) positions channel-innermost at stride XS = 24,
// as v2m::transpose_plane writes it; the chunk's 27 taps of weights for the
// block's 32 output channels at stride WSW = 16, the two 16-byte halves of
// a row swapped where (row / 4) is odd, so that an ldmatrix phase's 8 rows
// fall on distinct bank quads without padding. 107,328 B (Wide32) or
// 111,168 B (Narrow), so two blocks fit on an SM.
//
// Schedule. A phase is one (chunk c0, kd) pair: c0 ascending, then kd = 0,
// 1, 2; raw plane ph lives in raw buffer ph % 2. Per phase: every thread
// waits for its own copies of the phase's raw plane (at kd = 2 also for the
// chunk's weights); __syncthreads (A) makes them, the end of the previous
// phase's transpose and of the previous chunk's MMAs visible to all; the
// next phase's raw plane is issued into the other buffer, and at kd = 0
// then the chunk's 27 weight taps, each set committed as a group of its
// own; the raw plane is transposed into xs[kd]; __syncthreads (B); at kd =
// 2 the chunk's 27 taps run on xs[0..2]. So the next raw plane is in
// flight during each transpose and a chunk's MMAs, and the weights during
// two phases; where a wait finds nothing to hide behind, the SM's other
// block runs.
//
// Bits. Every accumulator receives its k-steps in the order c0, kh, kw, kd,
// one mma each, as the nine kd-folded tap GEMMs of the W-shifted-slab
// kernel this design replaced gave them, with the same A and B values (A[m]
// [k] the input at column w0 + m + kw - 1, channel c0 + k). Moments: Wide32
// writes that kernel's slot (d, 8-row tile, 32-column tile) in
// convk::store_tile's order; Narrow folds each 8-row half into the same
// slot in the same order (v2m::store_narrow). So y, sums and sqs keep its
// bits.
//
// What bounds it on the H100: tensor-core throughput (2*27*C*Cout FLOP per
// output voxel), behind the staging of each kd plane: bytes copied per MMA
// 42.7 (Wide32) or 48.0 (Narrow), as row 1's 32-channel tiles, and 256
// bytes of shared-memory fragments per MMA, by 0.5 ldmatrix instructions
// (row 1: 2.0 32-bit loads).
#pragma once

#include "conv3x3_stats.cuh"

// The phases the kernel runs: 1 the raw plane copies and their transpose,
// 2 the weight copies, 4 the MMAs. A build that leaves one out computes a
// wrong y; it exists only to time the phase's share (utils/phase_probe.py
// --kernel v2).
#ifndef V2_PHASES
#define V2_PHASES 7
#endif

namespace v2 {

using convk::bf16;
using v2m::KC;
using v2m::NTHREADS;
using v2m::NWARPS;
using v2m::XS;
constexpr int WSW = 16;  // shared stride (bf16) of one (tap, cout) weight row

// Row 1's tile T with v2's shared memory: two raw planes, three transposed
// kd planes, 27 taps of weights.
template <class T_>
struct Tile : T_ {
  static constexpr int PLANE = T_::SMEM_XS;                  // bf16 of one xs[kd]
  static constexpr int SMEM_W = 27 * T_::CO_T * WSW;         // bf16 of the chunk's weights
  static constexpr int SMEM_BYTES = (2 * T_::RAW + 3 * PLANE + SMEM_W) * 2;
  static constexpr int STATIC_BYTES = 2 * T_::TH * 32 * 4;   // red_s, red_q
  static_assert(T_::CO_T == 32, "32 output channels a block (conv3x3_stats_v2_cout_tile)");
  static_assert((T_::RAW * 2) % 16 == 0 && (PLANE * 2) % 16 == 0, "16-byte aligned buffers");
};
using Wide32 = Tile<v2m::Wide32>;  // W > 16
using Narrow = Tile<v2m::Narrow>;  // W <= 16
static_assert(Wide32::SMEM_BYTES == 107328 && Narrow::SMEM_BYTES == 111168, "the budget");
// Two blocks per SM: 228 KB of shared memory, 1 KB of it reserved per block.
static_assert(2 * (Wide32::SMEM_BYTES + Wide32::STATIC_BYTES + 1024) <= 228 * 1024 &&
                  2 * (Narrow::SMEM_BYTES + Narrow::STATIC_BYTES + 1024) <= 228 * 1024,
              "two blocks per SM");

// Stage the chunk's 27 taps of weights by cp.async (commit not included):
// row (tap, co) = wt[tap, co0 + co, c0 .. c0 + 15] at ws + (tap * CO_T +
// co) * WSW, its 16-byte half h at 8 * (h ^ (co / 4 % 2)); zero past
// Cout_pad. A thread's copies share their channel and half and step over
// the taps from one base and one stride, as convk::stage_weights_kd's do.
template <int CO_T>
__device__ __forceinline__ void stage_weights_27(bf16* __restrict__ ws,
                                                 const bf16* __restrict__ wt, int Cout_pad,
                                                 int Cin_pad, int co0, int c0) {
  constexpr int TSTEP = NTHREADS / (2 * CO_T);  // taps between a thread's copies
  static_assert(NTHREADS % (2 * CO_T) == 0, "whole taps per step");
  const int half = threadIdx.x & 1, co = (threadIdx.x >> 1) % CO_T;
  const int tap0 = (threadIdx.x >> 1) / CO_T;
  const bool ok = co0 + co < Cout_pad;
  const bf16* src = ok ? wt + ((int64_t)tap0 * Cout_pad + co0 + co) * Cin_pad + c0 + half * 8 : wt;
  const int64_t sstep = ok ? (int64_t)TSTEP * Cout_pad * Cin_pad : 0;
  bf16* dst = ws + (tap0 * CO_T + co) * WSW + 8 * (half ^ ((co >> 2) & 1));
#pragma unroll
  for (int tap = tap0; tap < 27; tap += TSTEP) {
    convk::cp_async16_zfill(dst, src, ok);
    src += sstep;
    dst += TSTEP * CO_T * WSW;
  }
}

// The 27 taps of one staged chunk in v2's order: for kh, for kw, for kd,
// acc[mt][nt] += A * B, so every accumulator takes its k-steps in the order
// (kh, kw, kd). m16 tile mt of warp `warp` is output row warp * RPW + mt /
// MPR of the tile, columns (mt % MPR) * 16 + 0..15; A[m][k] is the input at
// halo row row + kh, halo column col + m + kw of plane kd (xs + kd * PLANE,
// position (row, col) at (row * XC + col) * XS), channel k; B[k][n] the
// weight of tap (kd, kh, kw), output channel n, as stage_weights_27 lays
// it out. Both are channel-innermost, so each fragment comes by
// convk::ldmatrix_x4: one per m16 tile, one per pair of n8 tiles (the same
// registers as 32-bit loads would fill, in a quarter of the instructions).
// One kd step's A fragments are held at a time. Rows of 48 bytes (XS = 24),
// and 32-byte weight rows with their halves swapped every 4 rows, put the 8
// rows of an ldmatrix phase on distinct bank quads.
template <class T>
__device__ __forceinline__ void mma_27taps_kd_inner(float (&acc)[T::MT][T::NT][4],
                                                    const bf16* __restrict__ xs,
                                                    const bf16* __restrict__ ws, int warp,
                                                    int lane) {
  // A: lane l supplies row m = l % 8 + 8 * (l / 8 % 2), channels 8 * (l / 16)..;
  // B: row n = l % 8 + 8 * (l / 16) of an n8 pair, channels 8 * (l / 8 % 2)...
  const int am = (lane & 7) + ((lane >> 3) & 1) * 8, ak = (lane >> 4) * 8;
  const int bn = (lane & 7) + (lane >> 4) * 8;
  const int boff = bn * WSW + 8 * (((lane >> 3) & 1) ^ ((bn >> 2) & 1));
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        uint32_t a[T::MT][4];
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
          const int row = warp * T::RPW + mt / T::MPR, col = (mt % T::MPR) * 16;
          convk::ldmatrix_x4(
              a[mt], xs + kd * T::PLANE + ((row + kh) * T::XC + col + am + kw) * XS + ak);
        }
#pragma unroll
        for (int np = 0; np < T::NT / 2; ++np) {
          uint32_t b[4];
          const int tap = (kd * 3 + kh) * 3 + kw;
          convk::ldmatrix_x4(b, ws + (tap * T::CO_T + np * 16) * WSW + boff);
          const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
          for (int mt = 0; mt < T::MT; ++mt) convk::mma_16816(acc[mt][2 * np], a[mt], b0);
#pragma unroll
          for (int mt = 0; mt < T::MT; ++mt) convk::mma_16816(acc[mt][2 * np + 1], a[mt], b1);
        }
      }
    }
  }
}

// grid: (ceil(H/TH) * ceil(W/TW), D, B * Cout_pad / 32); psum/psq: (B,
// Cout_pad, nblk) f32 with nblk = D * ceil(H/8) * ceil(W/32), one slot per
// (d, 8-row tile, 32-column tile) whatever the tile. Two blocks per SM hold
// a thread to 128 registers.
template <class T, bool VX>
__global__ void __launch_bounds__(NTHREADS, 2)
conv3x3_stats_v2_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                        bf16* __restrict__ y, float* __restrict__ psum, float* __restrict__ psq,
                        int D, int C, int H, int W, int Cout, int Cin_pad, int Cout_pad,
                        int n_wtiles, int n_cotiles, int64_t nblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const raw = reinterpret_cast<bf16*>(smem_raw);  // raw[ph % 2] at raw + ph % 2 * RAW
  bf16* const xs = raw + 2 * T::RAW;
  bf16* const ws = xs + 3 * T::PLANE;
  __shared__ float red_s[T::TH][32], red_q[T::TH][32];

  const int ht = blockIdx.x / n_wtiles, wtile = blockIdx.x % n_wtiles;
  const int d = blockIdx.y;
  const int b = blockIdx.z / n_cotiles, cot = blockIdx.z % n_cotiles;
  const int h0 = ht * T::TH, w0 = wtile * T::TW, co0 = cot * T::CO_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t HW = (int64_t)H * W;
  const bf16* xb = x + (int64_t)b * D * C * HW;

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  // Issue (without committing) phase ph's raw plane into its buffer.
  auto issue_raw = [&](int ph) {
    if constexpr ((V2_PHASES & 1) != 0)
      v2m::stage_raw<T, VX>(raw + (ph & 1) * T::RAW, xb, D, C, H, W, d - 1 + ph % 3, h0, w0,
                            ph / 3 * KC);
  };

  const int n_phases = 3 * (Cin_pad / KC);
  issue_raw(0);
  convk::cp_async_commit();
  for (int ph = 0; ph < n_phases; ++ph) {
    const int kd = ph % 3;
    // At kd = 1 the chunk's weights, committed after raw(ph), may still be
    // in flight.
    if (kd == 1) convk::cp_async_wait<1>();
    else convk::cp_async_wait<0>();
    __syncthreads();  // (A) raw(ph) has landed; raw(ph - 1) is transposed
    if (ph + 1 < n_phases) issue_raw(ph + 1);
    convk::cp_async_commit();
    if (kd == 0) {
      if constexpr ((V2_PHASES & 2) != 0)
        stage_weights_27<T::CO_T>(ws, wt, Cout_pad, Cin_pad, co0, ph / 3 * KC);
      convk::cp_async_commit();
    }
    if constexpr ((V2_PHASES & 1) != 0)
      v2m::transpose_plane<T>(xs + kd * T::PLANE, raw + (ph & 1) * T::RAW);
    __syncthreads();  // (B) xs[kd] holds plane d - 1 + kd
    if constexpr ((V2_PHASES & 4) != 0) {
      if (kd == 2) mma_27taps_kd_inner<T>(acc, xs, ws, warp, lane);
    }
  }

  bf16* ybase = y + ((int64_t)b * D + d) * Cout * HW;
  if constexpr (T::RPW == 1) {
    const int h = h0 + warp;
    const int64_t blk = (int64_t)d * gridDim.x + blockIdx.x;
    convk::store_tile_and_moments<T::MT, T::NT, NWARPS>(
        acc, ybase, HW, W, h, h < H, w0, co0, Cout, red_s, red_q, psum, psq,
        ((int64_t)b * Cout_pad + co0) * nblk + blk, nblk);
  } else {
    // W <= 16: one 32-column slot tile; this block's rows are 8-row tiles
    // 2 ht and 2 ht + 1.
    static_assert(T::TH == 2 * v2m::SLOT_H && T::TW <= v2m::SLOT_W, "two 8-row slots a tile");
    const int nh8 = (H + v2m::SLOT_H - 1) / v2m::SLOT_H;
    const int64_t blk = (int64_t)d * nh8 + 2 * ht;
    v2m::store_narrow(acc, ybase, HW, H, W, h0, w0, co0, Cout, red_s, red_q, psum, psq,
                      ((int64_t)b * Cout_pad + co0) * nblk + blk, nblk, 2 * ht + 1 < nh8);
  }
}

// Internal linkage, as row 1's launchers (conv3x3_stats.cuh).
template <class T, bool VX>
static int launch_tile(const bf16* x, const bf16* wt, bf16* y, float* psum, float* psq, int B,
                       int D, int C, int H, int W, int Cout, int Cin_pad, int Cout_pad,
                       cudaStream_t st) {
  static bool attr_done[convk::MAX_DEVICES] = {};
  if (int e = convk::set_smem_attrs(conv3x3_stats_v2_kernel<T, VX>, T::SMEM_BYTES, attr_done))
    return e;
  const int nh = (H + T::TH - 1) / T::TH, nw = (W + T::TW - 1) / T::TW;
  const int nco = Cout_pad / T::CO_T;
  dim3 grid(nh * nw, D, B * nco);
  conv3x3_stats_v2_kernel<T, VX><<<grid, NTHREADS, T::SMEM_BYTES, st>>>(
      x, wt, y, psum, psq, D, C, H, W, Cout, Cin_pad, Cout_pad, nw, nco, v2m::nblk(D, H, W));
  return (int)cudaGetLastError();
}

}  // namespace v2
