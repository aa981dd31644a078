// The kernel of conv3x3_s2_stats.cu: the stride-2 3x3x3 convolution (XLA
// SAME padding, low 0, high 1) of (B, D, C, H, W) bf16 activations with
// the moments of its bf16-ROUNDED output, as an mma.sync (m16n8k16 bf16)
// implicit GEMM: M = output voxels, N = Cout, K = 27 taps x 16-channel
// chunks. Output (d, h, w) reads input (2d + kd, 2h + kh, 2w + kw).
//
// Tiles. A block of 8 warps owns one output depth d of one sample, TH
// output rows by TW columns, and CO_T output channels. The launcher picks
// the tile from Wo and Cout_pad:
//   Wide64   (Wo > 16, Cout_pad % 64 == 0): 4 rows x 32 columns x 64
//            channels; warp w computes row w >> 1, channels 32 (w & 1) ..,
//            as 2 m16 tiles x 4 n8 tiles;
//   Narrow64 (Wo <= 16, Cout_pad % 64 == 0): 8 x 16 x 64; warp w computes
//            row w as 1 m16 tile x 8 n8 tiles;
//   Wide32   (Wo > 16, otherwise): 4 x 32 x 32, 2 m16 x 2 n8 a warp;
//   Narrow32 (Wo <= 16, otherwise): 8 x 16 x 32, 1 m16 x 4 n8 a warp.
// A 64-channel tile stages each input plane once for twice the output
// channels; at Wo <= 16 no m16 tile runs on columns past Wo = 16. The grid
// runs the Cout tiles of one halo next to each other, so that the second
// reads the halo from L2.
//
// Staging. A phase is one (16-channel chunk c0, kd) pair: c0 ascending,
// then kd = 0, 1, 2. Two stages form a cp.async ring; a stage holds the
// phase's RAW input plane 2d + kd in x's own W-innermost order, and its 9
// (kh, kw) taps of weights for the block's CO_T channels. Per phase: every
// thread waits for its own copies; __syncthreads (A) makes every thread's
// copies, and the end of the previous phase's MMAs, visible to all; the
// next phase's copies are issued into the other stage; the raw plane is
// transposed into one channel-innermost xs plane; __syncthreads (B); the 9
// taps run on xs and the stage's weights.
//   Raw plane: rows 2h0 .. 2h0 + 2TH, channels c0 .. c0 + 15, and the
// 8-column chunks from column 2w0 to 2w0 + 2TW + 7: 2TW / 8 interior
// chunks and the right halo chunk, of which only column 2w0 + 2TW is read.
// Line (row, ch) sits at raw[(row * 16 + ch) * RAWW], its chunks
// contiguous. The interior chunks are copied one chunk a lane, whole lines
// an instruction; the halo chunks in a pass of their own, one a lane (a
// line of 9 chunks would idle 7 of 16 lanes). With VX (W % 8 == 0 and x
// 16-byte aligned) a chunk is one 16-byte cp.async, zero-filled (src-size
// 0) past D, H or W and past C: that fill is the (0, 1) SAME pad; without
// VX masked element loads stored into the same cells.
//   Weights: row (tap, co) = wt[kd * 9 + tap, co0 + co, c0 .. c0 + 15] at
// stride WSW = 16, its two 16-byte halves swapped where (co / 4) is odd,
// so that an ldmatrix phase's 8 rows fall on distinct bank quads.
//   Transpose, even and odd columns apart: input row 2h0 + row of xs is an
// EVEN sub-row E[j] = column 2w0 + 2j (TW + 1 positions) followed by an
// ODD sub-row O[j] = column 2w0 + 2j + 1 (TW positions), each position 16
// channels at stride XS = 24. One unit is (row, 8-column chunk q, channel
// quad cq): four 16-byte reads of its channels' chunks, byte-permuted in
// registers (0x5410 takes the even columns, 0x7632 the odd ones) into four
// 8-byte stores to E[4q ..] and four to O[4q ..]; where (q >> 1) is odd
// the stores run in the order 2, 3, 0, 1, so a half-warp's stores cover 32
// banks. A halo unit (row, cq) moves column 2w0 + 2TW of four channels.
//   MMAs: tap kw = 0 reads E[m], kw = 1 O[m], kw = 2 E[m + 1], so an m16
// tile's A rows are 16 consecutive 48-byte positions, as at stride 1: one
// ldmatrix.x4 a tile, free of bank conflicts; B by one ldmatrix.x4 per
// pair of n8 tiles.
//
// Bits. Every accumulator receives its k-steps in the order c0, kd, kh,
// kw, one mma per tap with the same A and B values as the synchronous
// 4 x 32 x 32 kernel this design replaced (A[m][k] the input at column
// 2 (w0 + m) + kw - 1, channel c0 + k; B[k][n] the weight of tap (kd, kh,
// kw), output channel n, input channel c0 + k), every
// phase's 9 taps even on a zero-filled plane (skipping an mma can turn the
// sign of a zero). Moments keep that kernel's slot (d, 4-row tile,
// 32-column tile), blk = (d * ceil(Ho/4) + ht4) * ceil(Wo/32) + wtile, and
// its order: per thread over mt, then r; an xor-butterfly over the 8 row
// lanes; the slot's 4 rows summed in index order from 0.f; each channel on
// its own, so a warp's 64 channels are summed 32 at a time. Narrow writes
// two slots, 2 ht8 and 2 ht8 + 1, the second where it exists.
//
// What bounds it on the H100: each output reads 8x its own volume of
// input, ~27 * Cout / 8 FLOP per input byte, below the ~295 FLOP/byte
// ridge at the main path's widths, so the least time is the HBM bytes of
// reading the input once. Bytes copied per MMA: 68.0 (Wide64), 69.8
// (Narrow64), 104.0 (Wide32), 107.6 (Narrow32), halo chunks counted whole
// (the synchronous kernel: 97.0, and at Wo <= 16 half its MMAs on padding).
#pragma once

#include "conv3x3_common.cuh"

// The phases the kernel runs: 1 the raw plane copies and the transpose, 2
// the weight copies, 4 the MMAs. A build that leaves one out computes a
// wrong y; it exists only to time the phase's share (utils/phase_probe.py
// --kernel s2).
#ifndef S2_PHASES
#define S2_PHASES 7
#endif

namespace s2 {

using convk::bf16;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int KC = 16;     // input channels per chunk (MMA K)
constexpr int XS = 24;     // shared stride (bf16) of one transposed position
constexpr int WSW = 16;    // shared stride (bf16) of one (tap, cout) weight row
constexpr int SLOT_H = 4;  // output rows of a moment slot (x 32 columns)

template <int TH_, int TW_, int CO_T_>
struct Tile {
  static constexpr int TH = TH_, TW = TW_, CO_T = CO_T_;
  static constexpr int WPR = NWARPS / TH;          // warps per output row
  static constexpr int MT = TW / 16;               // m16 tiles per warp
  static constexpr int NT = CO_T / (8 * WPR);      // n8 tiles per warp
  static constexpr int XR = 2 * TH + 1;            // input rows of a plane
  static constexpr int NQ = TW / 4;                // interior 8-column chunks per line
  static constexpr int RAWW = 8 * (NQ + 1);        // bf16 per raw line, with the halo chunk
  static constexpr int RAW = XR * KC * RAWW;       // bf16 of a raw plane
  static constexpr int SMEM_W = 9 * CO_T * WSW;    // bf16 of a stage's weights
  static constexpr int STAGE = RAW + SMEM_W;       // bf16 per stage
  static constexpr int XP = 2 * TW + 1;            // positions of an xs row: E, then O
  static constexpr int SMEM_XS = XR * XP * XS;     // bf16 of the transposed plane
  static constexpr int SMEM_BYTES = (2 * STAGE + SMEM_XS) * 2;
  static constexpr int STATIC_BYTES = 2 * TH * CO_T * 4;  // red_s, red_q
  static_assert(TH * WPR == NWARPS && MT * 16 == TW && NT % 2 == 0, "whole rows a warp");
  static_assert(NTHREADS % NQ == 0 && (NTHREADS / NQ) % KC == 0, "whole lines per copy step");
  static_assert((RAW * 2) % 16 == 0 && (STAGE * 2) % 16 == 0, "16-byte copy targets");
};
using Wide64 = Tile<4, 32, 64>;    // Wo > 16, Cout_pad % 64 == 0
using Narrow64 = Tile<8, 16, 64>;  // Wo <= 16, Cout_pad % 64 == 0
using Wide32 = Tile<4, 32, 32>;    // Wo > 16, Cout_pad % 64 != 0
using Narrow32 = Tile<8, 16, 32>;  // Wo <= 16, Cout_pad % 64 != 0
static_assert(Wide64::STAGE * 2 == 39168 && Narrow64::STAGE * 2 == 40192 &&
                  Wide64::SMEM_XS * 2 == 28080 && Narrow64::SMEM_XS * 2 == 26928,
              "the stage and plane budget");
static_assert(Wide64::SMEM_BYTES == 106416 && Narrow64::SMEM_BYTES == 107312 &&
                  Wide32::SMEM_BYTES == 87984 && Narrow32::SMEM_BYTES == 88880,
              "the budget");
// Two blocks per SM: 228 KB of shared memory, 1 KB of it reserved per block.
static_assert(2 * (Wide64::SMEM_BYTES + Wide64::STATIC_BYTES + 1024) <= 228 * 1024 &&
                  2 * (Narrow64::SMEM_BYTES + Narrow64::STATIC_BYTES + 1024) <= 228 * 1024,
              "two blocks per SM");

// Copy one 8-column chunk of a channel line for raw rows row0, row0 +
// RSTEP, .. < XR (input rows hh0 + row): src and dst at row row0, stepping
// RSTEP rows; zero where !ok0 or past H (VX) or past W (element loads).
// The element path loads N of the chunk's 8 columns (the halo chunk: 1, the
// only one read), stored one bf16 at a time.
template <class T, int RSTEP, int N, bool VX>
__device__ __forceinline__ void copy_chunks(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                            const bf16* __restrict__ xb, bool ok0, int row0,
                                            int hh0, int H, int W, int ww) {
  constexpr int DSTEP = RSTEP * KC * T::RAWW;
  if constexpr (VX) {
#pragma unroll
    for (int row = row0; row < T::XR; row += RSTEP) {
      const bool ok = ok0 && hh0 + row < H;
      convk::cp_async16_zfill(dst, ok ? src : xb, ok);
      src += (int64_t)RSTEP * W;
      dst += DSTEP;
    }
  } else {
#pragma unroll 1
    for (int row = row0; row < T::XR; row += RSTEP) {
      const bool ok = ok0 && hh0 + row < H;
#pragma unroll
      for (int i = 0; i < N; ++i)
        dst[i] = __ushort_as_bfloat16(ok && ww + i < W ? __bfloat16_as_ushort(src[i])
                                                       : (unsigned short)0);
      src += (int64_t)RSTEP * W;
      dst += DSTEP;
    }
  }
}

// Issue (without committing) the raw plane dd into raw (see the header):
// lane j = tid % NQ of the interior pass takes chunk j of lines tid / NQ,
// + NTHREADS / NQ, ..; the halo pass takes the halo chunk of lines tid,
// tid + NTHREADS. A line is (row, ch) = (line / 16, line % 16), so a
// thread's copies share their channel and chunk and step over rows.
template <class T, bool VX>
__device__ __forceinline__ void stage_raw(bf16* __restrict__ raw, const bf16* __restrict__ xb,
                                          int D, int C, int H, int W, int dd, int h0, int w0,
                                          int c0) {
  const int64_t HW = (int64_t)H * W;
  const int hh0 = 2 * h0;
  {
    const int j = threadIdx.x % T::NQ, line = threadIdx.x / T::NQ;
    const int ch = line % KC, row0 = line / KC, ww = 2 * w0 + 8 * j;
    const bool ok0 = dd < D && c0 + ch < C && (!VX || ww < W);
    const bf16* src = xb + ((int64_t)dd * C + c0 + ch) * HW + (int64_t)(hh0 + row0) * W + ww;
    copy_chunks<T, NTHREADS / T::NQ / KC, 8, VX>(raw + line * T::RAWW + 8 * j, src, xb, ok0,
                                                  row0, hh0, H, W, ww);
  }
  if (threadIdx.x < T::XR * KC) {
    const int ch = threadIdx.x % KC, row0 = threadIdx.x / KC, ww = 2 * w0 + 2 * T::TW;
    const bool ok0 = dd < D && c0 + ch < C && ww < W;
    const bf16* src = xb + ((int64_t)dd * C + c0 + ch) * HW + (int64_t)(hh0 + row0) * W + ww;
    copy_chunks<T, NTHREADS / KC, 1, VX>(raw + threadIdx.x * T::RAWW + 8 * T::NQ, src, xb, ok0,
                                         row0, hh0, H, W, ww);
  }
}

// Issue (without committing) the 9 (kh, kw) taps of plane kd: row (tap, co)
// = wt[kd * 9 + tap, co0 + co, c0 .. c0 + 15] at ws + (tap * CO_T + co) *
// WSW, its 16-byte half h at 8 * (h ^ (co / 4 % 2)). A thread's copies
// share their channel and half and step over the taps from one base and
// one stride.
template <int CO_T>
__device__ __forceinline__ void stage_weights_kd(bf16* __restrict__ ws,
                                                 const bf16* __restrict__ wt, int Cout_pad,
                                                 int Cin_pad, int co0, int c0, int kd) {
  constexpr int TSTEP = NTHREADS / (2 * CO_T);  // taps between a thread's copies
  static_assert(NTHREADS % (2 * CO_T) == 0, "whole taps per step");
  const int half = threadIdx.x & 1, co = (threadIdx.x >> 1) % CO_T;
  const int tap0 = (threadIdx.x >> 1) / CO_T;
  const bf16* src = wt + ((int64_t)(kd * 9 + tap0) * Cout_pad + co0 + co) * Cin_pad + c0 + half * 8;
  const int64_t sstep = (int64_t)TSTEP * Cout_pad * Cin_pad;
  bf16* dst = ws + (tap0 * CO_T + co) * WSW + 8 * (half ^ ((co >> 2) & 1));
#pragma unroll
  for (int tap = tap0; tap < 9; tap += TSTEP) {
    convk::cp_async16(dst, src);
    src += sstep;
    dst += TSTEP * CO_T * WSW;
  }
}

// Transpose the raw plane into xs (see the header): input row 2h0 + row,
// column 2w0 + 2j (+ 1), channel c0 + ci at xs[(row * XP + j) * XS + ci]
// (xs[(row * XP + TW + 1 + j) * XS + ci]). Units, one a thread and a
// second for the first: the interior units (row, q, cq), row-major, a row's
// 4 NQ units in lane order q = (i & 3) | (i >> 4) << 2, cq = (i >> 2) & 3,
// so a half-warp holds one row's chunks 0-3 or 4-7; then the halo units
// (row, cq).
template <class T>
__device__ __forceinline__ void transpose_plane(bf16* __restrict__ xs,
                                                const bf16* __restrict__ raw) {
  constexpr int UPR = 4 * T::NQ;            // interior units per row
  constexpr int NINT = T::XR * UPR;         // interior units
  constexpr int NUNITS = NINT + 4 * T::XR;  // and one halo unit per (row, quad)
#pragma unroll
  for (int u0 = 0; u0 < NUNITS; u0 += NTHREADS) {
    const int u = u0 + threadIdx.x;
    if (u < NINT) {
      const int row = u / UPR, i = u % UPR;
      const int q = (i & 3) | ((i >> 4) << 2), cq = (i >> 2) & 3;
      const bool rot = (q >> 1) & 1;
      // r[c][k]: word k of channel c's chunk (columns 2k, 2k + 1), halves
      // swapped when rot.
      uint32_t r[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(raw + (row * KC + 4 * cq + c) * T::RAWW + 8 * q);
        r[c][0] = rot ? v.z : v.x;
        r[c][1] = rot ? v.w : v.y;
        r[c][2] = rot ? v.x : v.z;
        r[c][3] = rot ? v.y : v.w;
      }
      bf16* e = xs + (row * T::XP + 4 * q) * XS + 4 * cq;
      bf16* o = e + (T::TW + 1) * XS;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = k ^ (rot ? 2 : 0);  // columns 2p (even) and 2p + 1 (odd) of the chunk
        *reinterpret_cast<uint2*>(e + p * XS) = make_uint2(
            __byte_perm(r[0][k], r[1][k], 0x5410), __byte_perm(r[2][k], r[3][k], 0x5410));
        *reinterpret_cast<uint2*>(o + p * XS) = make_uint2(
            __byte_perm(r[0][k], r[1][k], 0x7632), __byte_perm(r[2][k], r[3][k], 0x7632));
      }
    } else if (u < NUNITS) {
      const int row = (u - NINT) >> 2, cq = (u - NINT) & 3;
      const bf16* src = raw + (row * KC + 4 * cq) * T::RAWW + 8 * T::NQ;
      unsigned e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) e[c] = __bfloat16_as_ushort(src[c * T::RAWW]);
      *reinterpret_cast<uint2*>(xs + (row * T::XP + T::TW) * XS + 4 * cq) =
          make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
    }
  }
}

// The 9 (kh, kw) taps of one staged phase: acc[mt][nt] += A * B, where the
// warp computes output row warp / WPR of the tile, columns 16 mt + m, and
// block channels nb + 8 nt + n, nb = (warp % WPR) * 8 NT. A[m][k] is the
// input at xs row 2 row + kh, position E[16 mt + m] (kw = 0), O[16 mt + m]
// (kw = 1) or E[16 mt + m + 1] (kw = 2), channel k; B[k][n] the weight of
// tap (kh, kw). One ldmatrix.x4 per m16 tile (lane l: row m = l % 8 + 8 (l
// / 8 % 2), channels 8 (l / 16)..) and per pair of n8 tiles (row n = l % 8
// + 8 (l / 16), channels 8 (l / 8 % 2)..): the registers that 32-bit loads
// of the mma's fragment layout would fill. Each accumulator takes one mma
// per tap.
template <class T>
__device__ __forceinline__ void mma_9taps(float (&acc)[T::MT][T::NT][4],
                                          const bf16* __restrict__ xs,
                                          const bf16* __restrict__ ws, int warp, int lane) {
  const int row = warp / T::WPR, nb = (warp % T::WPR) * T::NT * 8;
  const int am = (lane & 7) + ((lane >> 3) & 1) * 8, ak = (lane >> 4) * 8;
  const int bn = (lane & 7) + (lane >> 4) * 8;
  const bf16* xa = xs + (2 * row * T::XP + am) * XS + ak;
  const bf16* wb = ws + (nb + bn) * WSW + 8 * (((lane >> 3) & 1) ^ ((bn >> 2) & 1));
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int pos = kw == 1 ? T::TW + 1 : kw / 2;  // E[m], O[m], E[m + 1]
      uint32_t a[T::MT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        convk::ldmatrix_x4(a[mt], xa + (kh * T::XP + pos + 16 * mt) * XS);
#pragma unroll
      for (int np = 0; np < T::NT / 2; ++np) {
        uint32_t b[4];
        convk::ldmatrix_x4(b, wb + ((kh * 3 + kw) * T::CO_T + 16 * np) * WSW);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) convk::mma_16816(acc[mt][2 * np], a[mt], b0);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) convk::mma_16816(acc[mt][2 * np + 1], a[mt], b1);
      }
    }
  }
}

// The epilogue: y as bf16, and the ROUNDED values folded into the block's
// moment slots (see the header's Bits), 32 channels at a time so that at
// most 16 partial sums are live beside the accumulators. Slot s (< n_slots)
// of block channel j is psum[pbase + s * slot_step + j * nblk]. Every
// thread of the block calls it.
template <class T>
__device__ __forceinline__ void store_tile(const float (&acc)[T::MT][T::NT][4],
                                           bf16* __restrict__ ybase, int64_t HWo, int Ho, int Wo,
                                           int h0, int w0, int co0, int Cout,
                                           float (*red_s)[T::CO_T], float (*red_q)[T::CO_T],
                                           float* __restrict__ psum, float* __restrict__ psq,
                                           int64_t pbase, int64_t slot_step, int n_slots,
                                           int64_t nblk) {
  constexpr int PN = T::NT < 4 ? T::NT : 4;  // n8 tiles of a 32-channel part
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = warp / T::WPR, nb = (warp % T::WPR) * T::NT * 8, h = h0 + row;
#pragma unroll
  for (int part = 0; part < T::NT / PN; ++part) {
    float s[PN][2], q[PN][2];
#pragma unroll
    for (int nt = 0; nt < PN; ++nt) s[nt][0] = s[nt][1] = q[nt][0] = q[nt][1] = 0.f;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < PN; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int w = w0 + mt * 16 + g + (r >= 2 ? 8 : 0);
          const int co = co0 + nb + (part * PN + nt) * 8 + 2 * t + (r & 1);
          if (h < Ho && w < Wo && co < Cout) {
            const bf16 v = __float2bfloat16_rn(acc[mt][part * PN + nt][r]);
            ybase[(int64_t)co * HWo + (int64_t)h * Wo + w] = v;
            const float f = __bfloat162float(v);
            s[nt][r & 1] += f;
            q[nt][r & 1] += f * f;
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < PN; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s[nt][j] += __shfl_xor_sync(0xffffffffu, s[nt][j], off);
          q[nt][j] += __shfl_xor_sync(0xffffffffu, q[nt][j], off);
        }
    if (g == 0) {
#pragma unroll
      for (int nt = 0; nt < PN; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          red_s[row][nb + (part * PN + nt) * 8 + 2 * t + j] = s[nt][j];
          red_q[row][nb + (part * PN + nt) * 8 + 2 * t + j] = q[nt][j];
        }
    }
  }
  __syncthreads();
  constexpr int SLOTS = T::TH / SLOT_H;
  const int slot = threadIdx.x / T::CO_T, j = threadIdx.x % T::CO_T;
  if (slot < SLOTS && slot < n_slots) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int rw = 0; rw < SLOT_H; ++rw) {
      ts += red_s[slot * SLOT_H + rw][j];
      tq += red_q[slot * SLOT_H + rw][j];
    }
    psum[pbase + slot * slot_step + (int64_t)j * nblk] = ts;
    psq[pbase + slot * slot_step + (int64_t)j * nblk] = tq;
  }
}

// Moment slots per (sample, channel) for a (Do, Ho, Wo) output: one per
// (d, 4-row tile, 32-column tile), whatever the tile.
static long long nblk(int Do, int Ho, int Wo) {
  return (long long)Do * ((Ho + SLOT_H - 1) / SLOT_H) * ((Wo + 31) / 32);
}

// grid: (Cout_pad / CO_T * ceil(Ho/TH) * ceil(Wo/TW), Do, B), the Cout tile
// fastest in blockIdx.x; psum/psq: (B, Cout_pad, nblk) f32. Two blocks per
// SM hold a thread to 128 registers.
template <class T, bool VX>
__global__ void __launch_bounds__(NTHREADS, 2)
conv3x3_s2_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                        bf16* __restrict__ y, float* __restrict__ psum, float* __restrict__ psq,
                        int D, int C, int H, int W, int Cout, int Cin_pad, int Cout_pad,
                        int n_wtiles, int n_cotiles, int64_t nblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const stages = reinterpret_cast<bf16*>(smem_raw);
  bf16* const xs = stages + 2 * T::STAGE;
  __shared__ float red_s[T::TH][T::CO_T], red_q[T::TH][T::CO_T];

  const int Ho = H / 2, Wo = W / 2;
  const int cot = blockIdx.x % n_cotiles, tile = blockIdx.x / n_cotiles;
  const int ht = tile / n_wtiles, wtile = tile % n_wtiles;
  const int d = blockIdx.y, b = blockIdx.z;
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

  // Issue (without committing) phase ph's copies into stage ph & 1.
  auto issue = [&](int ph) {
    const int c0 = ph / 3 * KC, kd = ph % 3;
    bf16* stage = stages + (ph & 1) * T::STAGE;
    if constexpr ((S2_PHASES & 1) != 0)
      stage_raw<T, VX>(stage, xb, D, C, H, W, 2 * d + kd, h0, w0, c0);
    if constexpr ((S2_PHASES & 2) != 0)
      stage_weights_kd<T::CO_T>(stage + T::RAW, wt, Cout_pad, Cin_pad, co0, c0, kd);
  };

  const int n_phases = 3 * (Cin_pad / KC);
  issue(0);
  convk::cp_async_commit();
  for (int ph = 0; ph < n_phases; ++ph) {
    convk::cp_async_wait<0>();
    __syncthreads();  // (A) phase ph has landed; phase ph - 1's MMAs are done
    if (ph + 1 < n_phases) issue(ph + 1);
    convk::cp_async_commit();
    const bf16* stage = stages + (ph & 1) * T::STAGE;
    if constexpr ((S2_PHASES & 1) != 0) transpose_plane<T>(xs, stage);
    __syncthreads();  // (B) xs holds phase ph
    if constexpr ((S2_PHASES & 4) != 0) mma_9taps<T>(acc, xs, stage + T::RAW, warp, lane);
  }

  // This block's rows are 4-row slots SLOTS * ht .. of the (d, 4-row tile,
  // 32-column tile) numbering; at Wo <= 16 there is one 32-column tile.
  constexpr int SLOTS = T::TH / SLOT_H;
  const int nh4 = (Ho + SLOT_H - 1) / SLOT_H, nw32 = (Wo + 31) / 32;
  const int64_t blk = ((int64_t)d * nh4 + SLOTS * ht) * nw32 + wtile;
  const int64_t HWo = (int64_t)Ho * Wo;
  store_tile<T>(acc, y + ((int64_t)b * (D / 2) + d) * Cout * HWo, HWo, Ho, Wo, h0, w0, co0, Cout,
                red_s, red_q, psum, psq, ((int64_t)b * Cout_pad + co0) * nblk + blk, nw32,
                nh4 - SLOTS * ht, nblk);
}

// Internal linkage, as row 1's launchers (conv3x3_stats.cuh).
template <class T, bool VX>
static int launch_tile(const bf16* x, const bf16* wt, bf16* y, float* psum, float* psq, int B,
                       int D, int C, int H, int W, int Cout, int Cin_pad, int Cout_pad,
                       cudaStream_t st) {
  static bool attr_done[convk::MAX_DEVICES] = {};
  if (int e = convk::set_smem_attrs(conv3x3_s2_stats_kernel<T, VX>, T::SMEM_BYTES, attr_done))
    return e;
  const int Do = D / 2, Ho = H / 2, Wo = W / 2;
  const int nh = (Ho + T::TH - 1) / T::TH, nw = (Wo + T::TW - 1) / T::TW;
  const int nco = Cout_pad / T::CO_T;
  dim3 grid(nco * nh * nw, Do, B);
  conv3x3_s2_stats_kernel<T, VX><<<grid, NTHREADS, T::SMEM_BYTES, st>>>(
      x, wt, y, psum, psq, D, C, H, W, Cout, Cin_pad, Cout_pad, nw, nco, nblk(Do, Ho, Wo));
  return (int)cudaGetLastError();
}

}  // namespace s2
