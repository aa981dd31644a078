// The kernel of conv3x3_stats.cu: the stride-1 3x3x3 SAME convolution of
// (B, D, C, H, W) bf16 activations with the moments of its bf16-ROUNDED
// output, as an mma.sync (m16n8k16 bf16) implicit GEMM: M = output voxels,
// N = Cout, K = 27 taps x 16-channel chunks.
//
// Tiles. A block of 8 warps owns one output depth d of one sample, TH output
// rows by TW columns, and CO_T output channels. The launcher picks the tile:
//   Wide64 (W > 16, Cout_pad % 64 == 0): 8 rows x 32 columns x 64 channels;
//          warp w computes row w as 2 m16 tiles x 8 n8 tiles;
//   Wide32 (W > 16, Cout_pad % 64 != 0): 8 x 32 x 32, 2 m16 x 4 n8 a warp;
//   Narrow (W <= 16): 16 rows x 16 columns x 32 channels; warp w computes
//          rows 2w and 2w + 1, one m16 tile each, x 4 n8 tiles.
// 64 channels stage each halo once for twice the output channels of a
// 32-channel tile; no 64-channel tile is half empty; at W <= 16 no m16 tile
// runs on columns past W = 16.
//
// Staging. A phase is one (16-channel chunk c0, kd) pair: c0 ascending, then
// kd = 0, 1, 2. Two stages form a cp.async ring; a stage holds the phase's
// RAW halo plane, input plane d - 1 + kd in x's own order (16 channels x
// (TH + 2) rows x the tile's columns), and its 9 (kh, kw) taps of weights
// for the block's CO_T channels at stride WS = 24. Per phase: every thread
// waits for its own copies; __syncthreads (A) makes every thread's copies,
// and the end of the previous phase's MMAs, visible to all; the next
// phase's copies are issued into the other stage; the raw plane is
// transposed into one channel-innermost xs buffer ((TH + 2) x (TW + 2)
// positions at stride XS = 24); __syncthreads (B); the 9 taps run on xs and
// the stage's weights. No register is held across the MMAs.
//   Raw plane: each (row, channel) line as 8-column chunks, the interior
// columns w0 .. w0 + TW - 1 at raw[(row * 16 + swz(ch)) * TW + col] and the
// halo chunks w0 - 8 .. w0 - 1 and w0 + TW .. w0 + TW + 7 at
// raw_h[((row * 16 + swz(ch)) * 2 + side) * 8]; of those only columns w0 - 1
// and w0 + TW are read. A line's chunks are copied by neighbouring lanes of
// one instruction, so the halo columns share the interior's cache lines
// (a 4-byte copy of each halo column took a request of its own: 320 per
// phase, 11% of the kernel's time at 128^3 32->32). With VX (W % 8 == 0 and
// x 16-byte aligned) a chunk is one 16-byte cp.async, zero-filled (src-size
// 0) outside D, H or W and past C; without VX 8 masked element loads stored
// into the same cells. swz(ch) = ch ^ ((ch >> 2) & 3) places the four
// channel quads of a line on distinct banks for the transpose's reads.
//   Transpose: one unit is (row, 8-column chunk q, channel quad cq): four
// 16-byte reads of its channels' chunks, byte-permuted in registers into
// eight 8-byte stores of four channels each (conflict free), and the halo
// column on the lanes of the first and last chunk.
//
// Bits. Every accumulator receives its k-steps in the order c0, kd, kh, kw,
// one mma.m16n8k16 per tap on the same 16 channels, so y does not depend on
// the tile. Moments go to one slot per (d, 8-row tile, 32-column tile) in
// convk::store_tile's order: per thread over mt, then r; an xor-butterfly
// over the 8 row lanes; the slot's 8 rows summed in index order from 0.f.
// The Narrow tile keeps its two rows per warp apart and writes two slots.
//
// What bounds it on the H100: tensor-core throughput (2*27*C*Cout FLOP per
// output voxel). Bytes copied per MMA: 29.3 (Wide64), 42.7 (Wide32), 48.0
// (Narrow, every m16 tile on real columns), the halo chunks counted whole;
// shared-memory fragment loads per MMA: 1.5 (Wide64), 2.0 (Wide32, Narrow).
#pragma once

#include "conv3x3_common.cuh"

// The phases the kernel runs: 1 the halo copies and the transpose, 2 the
// weight copies, 4 the MMAs. A build that leaves one out computes a wrong
// y; it exists only to time the phase's share (utils/phase_probe.py
// --kernel v2m).
#ifndef V2M_PHASES
#define V2M_PHASES 7
#endif

namespace v2m {

using convk::bf16;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int KC = 16;    // input channels per chunk (MMA K)
constexpr int XS = 24;    // shared stride (bf16) of one transposed position
constexpr int WS = 24;    // shared stride (bf16) of one (tap, cout) weight row
constexpr int SLOT_H = 8, SLOT_W = 32;  // the moment slot: 8 rows x 32 columns

template <int TH_, int TW_, int CO_T_>
struct Tile : convk::Tile9<TH_, TW_, CO_T_, NWARPS> {
  using G = convk::Tile9<TH_, TW_, CO_T_, NWARPS>;
  static constexpr int XR = G::TH + 2;               // halo rows
  static constexpr int NQ = G::TW / 8;               // 8-column chunks per line
  static constexpr int RAW_I = XR * KC * G::TW;      // bf16 of the interior columns
  static constexpr int RAW = RAW_I + XR * KC * 16;   // + two 8-column halo chunks a line
  static constexpr int SMEM_W = 9 * G::CO_T * WS;    // bf16 of a stage's weights
  static constexpr int STAGE = RAW + SMEM_W;         // bf16 per stage
  static constexpr int SMEM_XS = XR * G::XC * XS;    // bf16 of the transposed plane
  static constexpr int SMEM_BYTES = (2 * STAGE + SMEM_XS) * 2;
  // Copy lanes per line: the left halo chunk, NQ interior chunks and the
  // right halo chunk, rounded up to a power of 2.
  static constexpr int LPL = NQ == 4 ? 8 : 4;
  static_assert(NQ + 2 <= LPL && NTHREADS % (LPL * KC) == 0, "whole lines per copy step");
  static_assert((RAW_I * 2) % 16 == 0 && (RAW * 2) % 16 == 0 && (STAGE * 2) % 16 == 0,
                "16-byte copy targets");
  // Transpose units (row, q, cq): one per lane of the first warps.
  static_assert(XR * NQ * 4 <= NTHREADS, "one transpose unit a thread");
};
using Wide64 = Tile<8, 32, 64>;   // W > 16, Cout_pad % 64 == 0
using Wide32 = Tile<8, 32, 32>;   // W > 16, Cout_pad % 64 != 0
using Narrow = Tile<16, 16, 32>;  // W <= 16
static_assert(Wide64::STAGE * 2 == 43008 && Wide32::STAGE * 2 == 29184
              && Narrow::STAGE * 2 == 32256, "the stage budget");

__device__ __forceinline__ int swz(int ch) { return ch ^ ((ch >> 2) & 3); }

// Issue (without committing) the raw halo plane dd into raw: rows h0 - 1 ..
// h0 + TH, channels c0 .. c0 + 15, 8-column chunks from w0 - 8 to w0 + TW
// (see the header). Lane j of a line's LPL takes chunk column w0 - 8 + 8 j:
// j = 0 the left halo chunk, 1..NQ the interior, NQ + 1 the right halo
// chunk; so one copy instruction covers whole lines. A thread's copies share
// their channel and chunk and step over rows.
template <class T, bool VX>
__device__ __forceinline__ void stage_raw(bf16* __restrict__ raw, const bf16* __restrict__ xb,
                                          int D, int C, int H, int W, int dd, int h0, int w0,
                                          int c0) {
  constexpr int RSTEP = NTHREADS / (T::LPL * KC);  // rows between a thread's copies
  const int j = threadIdx.x % T::LPL, ch = threadIdx.x / T::LPL % KC;
  const int row0 = threadIdx.x / (T::LPL * KC), c = c0 + ch, wq = w0 - 8 + 8 * j;
  if (j > T::NQ + 1) return;  // Wide: lanes 6 and 7 of a line copy nothing
  const int64_t HW = (int64_t)H * W;
  const bool cw_ok = (unsigned)dd < (unsigned)D && c < C && wq >= 0 && (!VX || wq < W);
  const bool inner = j >= 1 && j <= T::NQ;
  const bf16* src = xb + ((int64_t)dd * C + c) * HW + (int64_t)(h0 - 1 + row0) * W + wq;
  bf16* dst = inner ? raw + (row0 * KC + swz(ch)) * T::TW + 8 * (j - 1)
                    : raw + T::RAW_I + ((row0 * KC + swz(ch)) * 2 + (j != 0)) * 8;
  const int dstep = RSTEP * KC * (inner ? T::TW : 16);
  if constexpr (VX) {
#pragma unroll
    for (int row = row0; row < T::XR; row += RSTEP) {
      const bool ok = cw_ok && (unsigned)(h0 - 1 + row) < (unsigned)H;
      convk::cp_async16_zfill(dst, ok ? src : xb, ok);
      src += (int64_t)RSTEP * W;
      dst += dstep;
    }
  } else {
    // Element loads stored one bf16 at a time: the same cells, and no uint4
    // assembled in registers (which made the Wide64 instance spill).
#pragma unroll 1
    for (int row = row0; row < T::XR; row += RSTEP) {
      const bool ok = cw_ok && (unsigned)(h0 - 1 + row) < (unsigned)H;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dst[i] = __ushort_as_bfloat16(ok && wq + i < W ? __bfloat16_as_ushort(src[i])
                                                       : (unsigned short)0);
      src += (int64_t)RSTEP * W;
      dst += dstep;
    }
  }
}

// Transpose the raw plane into xs: input row h0 - 1 + row, column w0 - 1 +
// col, channel c0 + ci at xs[(row * XC + col) * XS + ci]. One unit a lane:
// Wide (4 chunks a line) lane -> (q = lane & 3, cq = (lane >> 2) & 3), one
// line per half-warp, row = 2 * warp + lane / 16 (warps 0-4); Narrow (2
// chunks a line) lane -> (q = lane & 1, cq = (lane >> 1) & 3), rows r and r
// + 2 per half-warp, row = 4 * warp + lane / 16 + 2 * ((lane >> 3) & 1)
// (warps 0-4). The byte-permutes and the 8-byte stores are those the
// synchronous stager used: within a half-warp the stores of one line cover
// 32 banks (Wide), and the two lines of a Narrow half-warp, 16 banks apart,
// do too.
template <class T>
__device__ __forceinline__ void transpose_plane(bf16* __restrict__ xs,
                                                const bf16* __restrict__ raw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int q, cq, row;
  if constexpr (T::NQ == 4) {
    q = lane & 3;
    cq = (lane >> 2) & 3;
    row = 2 * warp + (lane >> 4);
  } else {
    static_assert(T::NQ == 2, "Wide or Narrow");
    q = lane & 1;
    cq = (lane >> 1) & 3;
    row = 4 * warp + (lane >> 4) + 2 * ((lane >> 3) & 1);
  }
  if (row >= T::XR) return;
  // r[i][j]: word j ^ q of channel i's chunk (columns 2 (j ^ q), +1).
  uint32_t r[4][4];
  unsigned e[4];
  const bool halo = q == 0 || q == T::NQ - 1;
  const int side = q == 0 ? 0 : 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sc = swz(4 * cq + i);
    const uint4 c =
        *reinterpret_cast<const uint4*>(raw + (row * KC + sc) * T::TW + 8 * q);
    const bool s1 = q & 1, s2 = q & 2;
    const uint32_t a0 = s1 ? c.y : c.x, a1 = s1 ? c.x : c.y;
    const uint32_t a2 = s1 ? c.w : c.z, a3 = s1 ? c.z : c.w;
    r[i][0] = s2 ? a2 : a0;
    r[i][1] = s2 ? a3 : a1;
    r[i][2] = s2 ? a0 : a2;
    r[i][3] = s2 ? a1 : a3;
    // The halo column: the last of the left halo chunk (w0 - 8 .. w0 - 1),
    // the first of the right one (w0 + TW ..).
    e[i] = halo ? __bfloat16_as_ushort(
                      raw[T::RAW_I + ((row * KC + sc) * 2 + side) * 8 + (side ? 0 : 7)])
                : 0u;
  }
  bf16* dst = xs + (row * T::XC + 1 + 8 * q) * XS + 4 * cq;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // Column 2 (j ^ q) takes the low halves of word j, the next the high.
    const int col = 2 * (j ^ q);
    *reinterpret_cast<uint2*>(dst + col * XS) =
        make_uint2(__byte_perm(r[0][j], r[1][j], 0x5410), __byte_perm(r[2][j], r[3][j], 0x5410));
    *reinterpret_cast<uint2*>(dst + (col + 1) * XS) =
        make_uint2(__byte_perm(r[0][j], r[1][j], 0x7632), __byte_perm(r[2][j], r[3][j], 0x7632));
  }
  if (halo)
    *reinterpret_cast<uint2*>(xs + (row * T::XC + (q == 0 ? 0 : T::XC - 1)) * XS + 4 * cq) =
        make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
}

// The Narrow tile's epilogue: y as bf16 and the ROUNDED values folded into
// two moment slots, rows h0 .. h0 + 7 (slot pbase) and h0 + 8 .. h0 + 15
// (slot pbase + 1, written only where `second`), each in store_tile's order
// for its 8 rows: per thread over r; an xor-butterfly over the 8 row lanes;
// rows summed in index order from 0.f. Channel co0 + j's slot is
// psum[pbase + j * nblk]. Every thread of the block calls it.
__device__ __forceinline__ void store_narrow(
    const float (&acc)[Narrow::MT][Narrow::NT][4], bf16* __restrict__ ybase, int64_t HW, int H,
    int W, int h0, int w0, int co0, int Cout, float (*red_s)[Narrow::CO_T],
    float (*red_q)[Narrow::CO_T], float* __restrict__ psum, float* __restrict__ psq,
    int64_t pbase, int64_t nblk, bool second) {
  constexpr int MT = Narrow::MT, NT = Narrow::NT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float s[MT][NT][2], q[MT][NT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int h = h0 + warp * Narrow::RPW + mt;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[mt][nt][0] = s[mt][nt][1] = q[mt][nt][0] = q[mt][nt][1] = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int w = w0 + g + (r >= 2 ? 8 : 0);
        const int co = co0 + nt * 8 + 2 * t + (r & 1);
        if (h < H && w < W && co < Cout) {
          const bf16 v = __float2bfloat16_rn(acc[mt][nt][r]);
          ybase[(int64_t)co * HW + (int64_t)h * W + w] = v;
          const float f = __bfloat162float(v);
          s[mt][nt][r & 1] += f;
          q[mt][nt][r & 1] += f * f;
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s[mt][nt][j] += __shfl_xor_sync(0xffffffffu, s[mt][nt][j], off);
          q[mt][nt][j] += __shfl_xor_sync(0xffffffffu, q[mt][nt][j], off);
        }
  if (g == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          red_s[warp * Narrow::RPW + mt][nt * 8 + 2 * t + j] = s[mt][nt][j];
          red_q[warp * Narrow::RPW + mt][nt * 8 + 2 * t + j] = q[mt][nt][j];
        }
  }
  __syncthreads();
  const int slot = threadIdx.x / Narrow::CO_T, j = threadIdx.x % Narrow::CO_T;
  if (slot == 0 || (slot == 1 && second)) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int rw = 0; rw < SLOT_H; ++rw) {
      ts += red_s[slot * SLOT_H + rw][j];
      tq += red_q[slot * SLOT_H + rw][j];
    }
    psum[pbase + slot + (int64_t)j * nblk] = ts;
    psq[pbase + slot + (int64_t)j * nblk] = tq;
  }
}

// grid: (ceil(H/TH) * ceil(W/TW), D, B * Cout_pad / CO_T); psum/psq:
// (B, Cout_pad, nblk) f32 with nblk = D * ceil(H/8) * ceil(W/32), one slot
// per (d, 8-row tile, 32-column tile) whatever the tile. Two blocks per SM
// hold a thread to 128 registers.
template <class T, bool VX>
__global__ void __launch_bounds__(NTHREADS, 2)
conv3x3_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                     bf16* __restrict__ y, float* __restrict__ psum, float* __restrict__ psq,
                     int D, int C, int H, int W, int Cout, int Cin_pad, int Cout_pad,
                     int n_wtiles, int n_cotiles, int64_t nblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const stages = reinterpret_cast<bf16*>(smem_raw);
  bf16* const xs = stages + 2 * T::STAGE;
  __shared__ float red_s[T::TH][32], red_q[T::TH][32];

  const int ht = blockIdx.x / n_wtiles, wtile = blockIdx.x % n_wtiles;
  const int d = blockIdx.y;
  const int b = blockIdx.z / n_cotiles, cot = blockIdx.z % n_cotiles;
  const int h0 = ht * T::TH, w0 = wtile * T::TW, co0 = cot * T::CO_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
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
    if constexpr ((V2M_PHASES & 1) != 0)
      stage_raw<T, VX>(stage, xb, D, C, H, W, d - 1 + kd, h0, w0, c0);
    if constexpr ((V2M_PHASES & 2) != 0)
      convk::stage_weights_kd<NTHREADS, T::CO_T, WS>(stage + T::RAW, wt, Cout_pad, Cin_pad, co0,
                                                     c0, kd);
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
    if constexpr ((V2M_PHASES & 1) != 0) transpose_plane<T>(xs, stage);
    __syncthreads();  // (B) xs holds phase ph
    if constexpr ((V2M_PHASES & 4) != 0)
      convk::mma_9taps<T, XS, WS>(acc, xs, stage + T::RAW, warp, g, t);
  }

  bf16* ybase = y + ((int64_t)b * D + d) * Cout * HW;
  if constexpr (T::RPW == 1) {
    // 32 channels at a time (each channel's sums are its own), so that at
    // most 32 accumulators and 16 partial sums are live beside the stores.
    const int h = h0 + warp;
    const int64_t blk = (int64_t)d * gridDim.x + blockIdx.x;
#pragma unroll
    for (int part = 0; part < T::NT / 4; ++part) {
      float a[T::MT][4][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) a[mt][nt][r] = acc[mt][4 * part + nt][r];
      if (part > 0) __syncthreads();  // red_s of the previous part has been read
      const int c = co0 + 32 * part;
      convk::store_tile_and_moments<T::MT, 4, NWARPS>(
          a, ybase, HW, W, h, h < H, w0, c, Cout, red_s, red_q, psum, psq,
          ((int64_t)b * Cout_pad + c) * nblk + blk, nblk);
    }
  } else {
    // W <= 16: one 32-column slot tile; this block's rows are 8-row tiles
    // 2 ht and 2 ht + 1.
    static_assert(T::TH == 2 * SLOT_H && T::TW <= SLOT_W, "two 8-row slots a Narrow tile");
    const int nh8 = (H + SLOT_H - 1) / SLOT_H;
    const int64_t blk = (int64_t)d * nh8 + 2 * ht;
    store_narrow(acc, ybase, HW, H, W, h0, w0, co0, Cout, red_s, red_q, psum, psq,
                 ((int64_t)b * Cout_pad + co0) * nblk + blk, nblk, 2 * ht + 1 < nh8);
  }
}

// Moment slots per (sample, channel) for a (D, H, W) output.
static long long nblk(int D, int H, int W) {
  return (long long)D * ((H + SLOT_H - 1) / SLOT_H) * ((W + SLOT_W - 1) / SLOT_W);
}

// The launchers have internal linkage: a static local of an inline or
// template function with external linkage is one object per process
// (STB_GNU_UNIQUE), shared by every library built from this header.
template <class T, bool VX>
static int launch_tile(const bf16* x, const bf16* wt, bf16* y, float* psum, float* psq, int B,
                       int D, int C, int H, int W, int Cout, int Cin_pad, int Cout_pad,
                       cudaStream_t st) {
  static bool attr_done = false;
  if (!attr_done) {
    cudaError_t e = cudaFuncSetAttribute(conv3x3_stats_kernel<T, VX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(conv3x3_stats_kernel<T, VX>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    attr_done = true;
  }
  const int nh = (H + T::TH - 1) / T::TH, nw = (W + T::TW - 1) / T::TW;
  const int nco = Cout_pad / T::CO_T;
  dim3 grid(nh * nw, D, B * nco);
  conv3x3_stats_kernel<T, VX><<<grid, NTHREADS, T::SMEM_BYTES, st>>>(
      x, wt, y, psum, psq, D, C, H, W, Cout, Cin_pad, Cout_pad, nw, nco, nblk(D, H, W));
  return (int)cudaGetLastError();
}

}  // namespace v2m
