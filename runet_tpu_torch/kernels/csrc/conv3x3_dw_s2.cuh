// The stride-2 weight-gradient kernel (conv3x3_s2_dw.cu): conv3x3_dw_common.cuh's
// implicit GEMM with blocks of 16 input x 64 output channels, each K-tile
// (TH = 4 output rows x TW = 32 output columns of one (b, d)) staged whole
// in one of two stages.
//
// A block has 18 warps: warp w = half * 9 + kd * 3 + kh runs the three kw
// taps of its (kd, kh) for output channels co0 + 32 * half .. + 31, with the
// accumulators of a 32-channel block (acc[3][4][4]). The x of a K-tile is
// staged once for both halves.
//
// A stage holds one K-tile: its x (3 planes x XR = 9 input rows x 16
// channels, 69,120 B) and its g (4 rows x 64 channels, 20,480 B). Two stages
// take 179,200 B, one block per SM. The split count (dw_splits<2>, in
// 32-channel tiles), a split's K-tiles (wt fastest, then ht, d, b) and,
// within a K-tile, the order of the rows, then kb, kw and nt are those of one
// 9-warp block per 32 channels: every accumulator receives the same k-steps
// in the same order, so part and dw keep their bits.
//
// Shared layout of x: raw lines, one of XROW = 80 bf16 (160 B) per (kd, ci,
// row), line (kd * CI_T + ci) * XR + row, input column 2w0 + c at index c,
// zero outside D, H, C and W. A line is 40 words, and a channel's lines 9
// apart (360 words, 8 mod 32), so each half-warp's 64-bit fragment loads (4
// channels x 4 lanes) fall on 32 distinct banks. g keeps GROW = 40 (80 B),
// line r * 64 + co.
//
// Two ways to fill a stage, one K-tile ahead of the MMAs:
// - x and g 16-byte aligned, W % 8 == 0 and Wo % 8 == 0 (every main-path
//   launch): thread 0 issues seven TMA tensor copies per K-tile, one box of
//   80 columns x 9 rows x 16 channels per kd plane and one of 40 columns x
//   64 channels per g row, which complete on the stage's mbarrier; the TMA
//   unit zero-fills what lies past the tensor. The warps spend no
//   instructions on the copies:
//     prologue: K-tiles 0 and 1 into stages 0 and 1;
//     each i:   wait for stage i & 1's mbarrier (phase i / 2); MMAs;
//               __syncthreads (the stage has been read); thread 0 issues
//               K-tile i + 2 into it.
//   Columns 66-79 of x and 32-39 of g are copied and never read.
// - otherwise (an odd offset, or W % 8 != 0): a two-stage cp.async ring in
//   which every thread copies x's lines as eight 16-byte chunks (c = 0..63)
//   and the word (64, 65), and g's as four chunks, zero-filled past the
//   extents; an operand without 16-byte loads is staged by plain loads (8
//   masked element loads per chunk, an item's loads all issued before it
//   stores any) into the same stage at the same point of the loop:
//     prologue: issue K-tile 0 into stage 0, commit;
//     each i:   issue i + 1 into the other stage, commit;
//               cp.async.wait_group 1 (0 on the last); __syncthreads; MMAs;
//               __syncthreads (the stage is refilled next).
//   Index 65 is then not written, and reaches only a discarded half.
// Both put the same values where a fragment reads them.
//
// A fragments from the raw lines: for output columns k, k + 1 (k even), tap
// kw reads input columns 2k + kw and 2k + 2 + kw. Two 64-bit loads at the
// words k and k + 2 (bf16 indices 2k..2k+7) give W_a, W_b, W_c (and a
// fourth word that is dropped); kw = 0 is __byte_perm(W_a, W_b, 0x5410), kw
// = 1 __byte_perm(W_a, W_b, 0x7632), kw = 2 __byte_perm(W_b, W_c, 0x5410).
//
// Where w0 + 16 >= Wo, g's columns 16-31 and the x columns they read (2w0 +
// 32 + kw >= W = 2 Wo) are zero-filled: the kb = 16 k-step would add +0 * +0
// to accumulators that are never -0, and is skipped (uniform in the block),
// which keeps the bits whatever the inputs hold elsewhere.
#pragma once

#include "conv3x3_dw_common.cuh"

// The phases the kernel runs: 1 the x staging, 2 the g staging, 4 the MMAs.
// A build that leaves one out computes a wrong dw; it exists only to time the
// phase's share (utils/phase_probe.py --kernel dw2).
#ifndef DW2_PHASES
#define DW2_PHASES 7
#endif

namespace convk {

struct DwS2 {
  using G = DwGeom<2>;
  static constexpr int CO_B = 2 * G::CO_T;      // output channels per block: two halves
  static constexpr int NWARPS = 2 * G::NWARPS;  // warp = half * 9 + kd * 3 + kh
  static constexpr int NTHREADS = NWARPS * 32;
  static constexpr int XR = 2 * G::TH + 1;  // staged input rows per plane
  static constexpr int XROW = 80;           // shared stride of one raw line of x
  static constexpr int XHALO = 2 * G::TW;   // index of the word (64, 65)
  static constexpr int NLINES = 3 * G::CI_T * XR;
  static constexpr int SMEM_X = NLINES * XROW;
  static constexpr int SMEM_G = G::TH * CO_B * G::GROW;
  static constexpr int STAGE = SMEM_X + SMEM_G;  // bf16 per stage
  static constexpr int SMEM_BYTES = 2 * STAGE * 2 + 2 * 8;  // and the stages' mbarriers
  static constexpr int NCH_X = NLINES * 8;     // 16-byte chunks of x (c = 0..63)
  static constexpr int NCH_G = G::TH * CO_B * 4;  // 16-byte chunks of g
  static constexpr int U_X = NCH_X / NTHREADS;    // x chunks a thread
  static constexpr uint32_t TX_BYTES =            // bytes the TMA copies of a K-tile land
      ((DW2_PHASES & 1) != 0 ? SMEM_X * 2 : 0) + ((DW2_PHASES & 2) != 0 ? SMEM_G * 2 : 0);
  static_assert(G::TW == 32 && XROW % 8 == 0 && XROW / 2 % 32 == 8 && XR * XROW / 2 % 32 == 8,
                "16-byte chunk targets; 64-bit fragment loads on distinct banks");
  static_assert(XHALO + 2 <= XROW && (SMEM_X * 2) % 128 == 0 && (STAGE * 2) % 128 == 0 &&
                    (G::CI_T * XR * XROW * 2) % 128 == 0 && (CO_B * G::GROW * 2) % 128 == 0,
                "the halo word fits; TMA boxes 128-byte aligned");
  static_assert(NCH_X % NTHREADS == 0 && U_X % 2 == 0 && NLINES <= NTHREADS &&
                    NCH_G <= 2 * NTHREADS,
                "whole items per thread");
};

// Line of x holding input row `row` of plane kd and channel ci.
__host__ __device__ constexpr int dw2_line(int kd, int ci, int row) {
  return (kd * DwGeom<2>::CI_T + ci) * DwS2::XR + row;
}

// Stage the x of K-tile (d, h0, w0) for channels c0..c0+CI_T by the threads:
// line dw2_line(kd, ci, row) index c = x[2d+kd, c0+ci, 2h0+row, 2w0+c], zero
// outside the extent and past channel C. Chunk e covers c = 8q..8q+7 of line
// e / 8 (q = e % 8), U_X chunks a thread, eight lanes to a line; line e <
// NLINES also takes its halo (c = 64, with 65 under VX).
template <bool VX>
__device__ __forceinline__ void dw2_stage_x(bf16* __restrict__ xs, const bf16* __restrict__ xb,
                                            int D, int C, int H, int W, int d, int h0, int w0,
                                            int c0) {
  using G = DwGeom<2>;
  const int64_t HW = (int64_t)H * W;
  // The row of line `line` and whether it lies inside D, H and C.
  auto row_of = [&](int line, bool& ok) {
    const int row = line % DwS2::XR, r2 = line / DwS2::XR;
    const int ci = r2 % G::CI_T, kd = r2 / G::CI_T;
    const int dd = 2 * d + kd, hh = 2 * h0 + row, cc = c0 + ci;
    ok = dd < D && hh < H && cc < C;
    return xb + ((int64_t)dd * C + cc) * HW + (int64_t)hh * W;
  };
  const int line_h = threadIdx.x, ww_h = 2 * w0 + DwS2::XHALO;
  if constexpr (VX) {
#pragma unroll 1
    for (int u = 0; u < DwS2::U_X; ++u) {
      const int e = threadIdx.x + u * DwS2::NTHREADS;
      const int line = e >> 3, q = e & 7, ww = 2 * w0 + 8 * q;
      bool ok;
      const bf16* rowp = row_of(line, ok);
      ok = ok && ww < W;
      cp_async16_zfill(xs + line * DwS2::XROW + 8 * q, ok ? rowp + ww : xb, ok);
    }
    if (line_h < DwS2::NLINES) {
      bool ok;
      const bf16* rowp = row_of(line_h, ok);
      ok = ok && ww_h < W;
      cp_async4_zfill(xs + line_h * DwS2::XROW + DwS2::XHALO, ok ? rowp + ww_h : xb, ok);
    }
  } else {
#pragma unroll 1
    for (int u = 0; u < DwS2::U_X; u += 2) {
      uint4 v[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int e = threadIdx.x + (u + k) * DwS2::NTHREADS;
        const int q = e & 7, ww = 2 * w0 + 8 * q;
        bool ok;
        const bf16* rowp = row_of(e >> 3, ok);
        v[k] = ok ? ld_chunk<false>(rowp + ww, ww, W) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int e = threadIdx.x + (u + k) * DwS2::NTHREADS;
        *reinterpret_cast<uint4*>(xs + (e >> 3) * DwS2::XROW + 8 * (e & 7)) = v[k];
      }
    }
    if (line_h < DwS2::NLINES) {
      bool ok;
      const bf16* rowp = row_of(line_h, ok);
      xs[line_h * DwS2::XROW + DwS2::XHALO] =
          ok && ww_h < W ? rowp[ww_h] : __ushort_as_bfloat16((unsigned short)0);
    }
  }
}

// Stage the g of K-tile (d, h0, w0) by the threads: gs[(r * CO_B + co) *
// GROW + k] = g[b, d, co0+co, h0+r, w0+k], zero outside Ho and Wo and past
// Cout (a zero g voxel adds nothing, which also masks the ragged K edge).
// Chunk e covers k = 8q..8q+7 of line e / 4 (q = e % 4), at most two a
// thread.
template <bool VG>
__device__ __forceinline__ void dw2_stage_g(bf16* __restrict__ gs, const bf16* __restrict__ gb,
                                            int Cout, int Ho, int Wo, int h0, int w0, int co0) {
  using G = DwGeom<2>;
  const int64_t HWo = (int64_t)Ho * Wo;
  // The source of chunk e and whether it lies inside Ho, Wo and Cout.
  auto chunk = [&](int e, bool& ok) {
    const int q = e & 3, co = (e >> 2) % DwS2::CO_B, r = (e >> 2) / DwS2::CO_B;
    const int hh = h0 + r, cc = co0 + co, ww = w0 + 8 * q;
    ok = hh < Ho && cc < Cout && ww < Wo;
    return gb + (int64_t)cc * HWo + (int64_t)hh * Wo + ww;
  };
  if constexpr (VG) {
#pragma unroll 1
    for (int e = threadIdx.x; e < DwS2::NCH_G; e += DwS2::NTHREADS) {
      bool ok;
      const bf16* src = chunk(e, ok);
      cp_async16_zfill(gs + (e >> 2) * G::GROW + 8 * (e & 3), ok ? src : gb, ok);
    }
  } else {
    uint4 v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = threadIdx.x + u * DwS2::NTHREADS;
      bool ok;
      const bf16* src = chunk(e, ok);
      const int ww = w0 + 8 * (e & 3);
      v[u] = e < DwS2::NCH_G && ok ? ld_chunk<false>(src, ww, Wo) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = threadIdx.x + u * DwS2::NTHREADS;
      if (e < DwS2::NCH_G) *reinterpret_cast<uint4*>(gs + (e >> 2) * G::GROW + 8 * (e & 3)) = v[u];
    }
  }
}

// The MMAs of one staged K-tile: warp (half, kd, kh) runs its three kw taps
// (3 m16 tiles) against NT n8 tiles of its half's 32 channels, rows
// ascending, two 16-column k-steps per row, or only kb = 0 where the tile's
// columns 16-31 lie past Wo.
__device__ __forceinline__ void dw2_mma_tile(float (&acc)[3][DwGeom<2>::NT][4],
                                             const bf16* __restrict__ xs,
                                             const bf16* __restrict__ gs, bool kb16) {
  using G = DwGeom<2>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int half = warp / G::NWARPS, kd = warp % G::NWARPS / 3, kh = warp % 3;
#pragma unroll 1
  for (int rr = 0; rr < G::TH; ++rr) {
    const bf16* xr = xs + dw2_line(kd, 0, 2 * rr + kh) * DwS2::XROW;
    const bf16* gr = gs + (rr * DwS2::CO_B + half * G::CO_T) * G::GROW;
#pragma unroll
    for (int kb = 0; kb < G::TW; kb += 16) {
      if (kb > 0 && !kb16) break;
      // B[k][n] = g at column kb + k, output channel n.
      uint32_t bfr[G::NT][2];
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const bf16* p = gr + (nt * 8 + gq) * G::GROW + kb + 2 * t;
        bfr[nt][0] = ld32(p);
        bfr[nt][1] = ld32(p + 8);
      }
      // A[m][k] = x at input column 2 * (w0 + kb + k) + kw, input channel
      // m. Register i: channel gq (+8 for i odd), output columns k0, k0 + 1
      // with k0 = kb + 2t (+8 for i >= 2), the words k0..k0+2 of the line.
      uint32_t a[3][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bf16* p = xr + (gq + (i & 1) * 8) * DwS2::XR * DwS2::XROW +
                        2 * (kb + 2 * t + (i >> 1) * 8);
        const uint2 ab = *reinterpret_cast<const uint2*>(p);
        const uint2 cd = *reinterpret_cast<const uint2*>(p + 4);
        a[0][i] = __byte_perm(ab.x, ab.y, 0x5410);
        a[1][i] = __byte_perm(ab.x, ab.y, 0x7632);
        a[2][i] = __byte_perm(ab.y, cd.x, 0x5410);
      }
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) mma_16816(acc[kw][nt], a[kw], bfr[nt]);
    }
  }
}

// Write warp (half, kd, kh)'s accumulators, taps (kd, kh, 0..2) of channels
// co0 + 32 * half .., to the block's slot of part (n_splits, 27, C, Cout),
// skipping channels past C and Cout.
__device__ __forceinline__ void dw2_store_partial(float* __restrict__ part,
                                                  const float (&acc)[3][DwGeom<2>::NT][4],
                                                  int C, int Cout, int c0, int co0) {
  using G = DwGeom<2>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int half = warp / G::NWARPS;
  float* pb = part + (int64_t)blockIdx.y * 27 * C * Cout;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const int tap = warp % G::NWARPS * 3 + kw;
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ci = c0 + gq + (r >= 2 ? 8 : 0);
        const int co = co0 + half * G::CO_T + nt * 8 + 2 * t + (r & 1);
        if (ci < C && co < Cout) pb[((int64_t)tap * C + ci) * Cout + co] = acc[kw][nt][r];
      }
    }
  }
}

// x (B, D, C, H, W) bf16 input; g (B, Do, Cout, Ho, Wo) bf16 output
// cotangent; part (n_splits, 27, C, Cout) f32 partial weight gradients.
// VX / VG: x / g 16-byte aligned with W, Wo % 8 == 0; both: TMA copies
// through tmx (boxes of 80 columns x 9 rows x 16 channels) and tmg (40
// columns x 1 row x 64 channels), else the cp.async ring. One block of 18
// warps per SM; five warps on a sub-partition hold a thread to 96
// registers.
template <bool VX, bool VG>
__global__ void __launch_bounds__(DwS2::NTHREADS, 1)
conv3x3_dw_s2_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     float* __restrict__ part, int D, int C, int H, int W, int Do, int Ho,
                     int Wo, int Cout, int n_cotiles, int nh, int nw, int64_t n_ktiles,
                     int n_splits, const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmg) {
  using G = DwGeom<2>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const stages = reinterpret_cast<bf16*>(smem_raw);

  const int c0 = (blockIdx.x / n_cotiles) * G::CI_T;
  const int co0 = (blockIdx.x % n_cotiles) * DwS2::CO_B;
  const int split = blockIdx.y;
  // A half wholly past Cout (an odd number of 32-channel tiles) runs no MMAs
  // and stores nothing; the test is uniform in the warp.
  const bool live = co0 + (int)(threadIdx.x >> 5) / G::NWARPS * G::CO_T < Cout;

  float acc[3][G::NT][4];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[kw][nt][r] = 0.f;

  const int64_t kt_lo = n_ktiles * split / n_splits;
  const int n = (int)(n_ktiles * (split + 1) / n_splits - kt_lo);  // K-tiles of the split

  // K-tile i of the split: its (b, d) and first output row and column.
  struct Tile {
    int b, d, h0, w0;
  };
  auto tile = [&](int i) {
    const int64_t kt = kt_lo + i;
    const int wt = (int)(kt % nw);
    int64_t rest = kt / nw;
    const int ht = (int)(rest % nh);
    rest /= nh;
    return Tile{(int)(rest / Do), (int)(rest % Do), ht * G::TH, wt * G::TW};
  };

  if constexpr (VX && VG) {
    uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + 2 * DwS2::STAGE * 2);
    if (threadIdx.x == 0) {
      mbar_init(&full[0]);
      mbar_init(&full[1]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // Thread 0: the TMA copies of K-tile i into stage i & 1.
    auto load = [&](int i) {
      const Tile tl = tile(i);
      bf16* stage = stages + (i & 1) * DwS2::STAGE;
      uint64_t* bar = &full[i & 1];
      mbar_expect_tx(bar, DwS2::TX_BYTES);
      if constexpr ((DW2_PHASES & 1) != 0) {
#pragma unroll
        for (int kd = 0; kd < 3; ++kd)
          tma_load_5d(stage + dw2_line(kd, 0, 0) * DwS2::XROW, &tmx, bar, 2 * tl.w0, 2 * tl.h0,
                      c0, 2 * tl.d + kd, tl.b);
      }
      if constexpr ((DW2_PHASES & 2) != 0) {
#pragma unroll
        for (int r = 0; r < G::TH; ++r)
          tma_load_5d(stage + DwS2::SMEM_X + r * DwS2::CO_B * G::GROW, &tmg, bar, tl.w0,
                      tl.h0 + r, co0, tl.d, tl.b);
      }
    };
    if (threadIdx.x == 0) {
      load(0);
      if (n > 1) load(1);
    }
    for (int i = 0; i < n; ++i) {
      mbar_wait(&full[i & 1], (i >> 1) & 1);  // K-tile i has landed
      if constexpr ((DW2_PHASES & 4) != 0) {
        const bf16* xs = stages + (i & 1) * DwS2::STAGE;
        if (live) dw2_mma_tile(acc, xs, xs + DwS2::SMEM_X, tile(i).w0 + 16 < Wo);
      }
      if (i + 2 < n) {
        __syncthreads();  // stage i & 1 has been read before it is refilled
        if (threadIdx.x == 0) load(i + 2);
      }
    }
  } else {
    const int64_t HW = (int64_t)H * W, HWo = (int64_t)Ho * Wo;
    // Issue (without committing) the copies of K-tile i into stage i & 1.
    auto issue = [&](int i) {
      const Tile tl = tile(i);
      bf16* stage = stages + (i & 1) * DwS2::STAGE;
      if constexpr ((DW2_PHASES & 1) != 0)
        dw2_stage_x<VX>(stage, x + (int64_t)tl.b * D * C * HW, D, C, H, W, tl.d, tl.h0, tl.w0,
                        c0);
      if constexpr ((DW2_PHASES & 2) != 0)
        dw2_stage_g<VG>(stage + DwS2::SMEM_X, g + ((int64_t)tl.b * Do + tl.d) * Cout * HWo,
                        Cout, Ho, Wo, tl.h0, tl.w0, co0);
    };
    issue(0);
    cp_async_commit();
    for (int i = 0; i < n; ++i) {
      const bool more = i + 1 < n;
      if (more) issue(i + 1);
      cp_async_commit();
      if (more)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // K-tile i has landed for every thread
      if constexpr ((DW2_PHASES & 4) != 0) {
        const bf16* xs = stages + (i & 1) * DwS2::STAGE;
        if (live) dw2_mma_tile(acc, xs, xs + DwS2::SMEM_X, tile(i).w0 + 16 < Wo);
      }
      __syncthreads();  // its stage has been read before it is refilled
    }
  }

  if (live) dw2_store_partial(part, acc, C, Cout, c0, co0);
}

// The TMA map of a (B, D, C, H, W) bf16 tensor (W % 8 == 0, 16-byte aligned)
// as a rank-5 tensor with W innermost, boxes of bw columns x bh rows x bc
// channels of one plane, zero past the extents (convk::tensor_map_encoder).
// Returns a cudaError_t.
static int dw2_tensor_map(CUtensorMap* map, const void* base, int B, int D, int C, int H, int W,
                          int bw, int bh, int bc) {
  EncodeTiled encode;
  const int e = tensor_map_encoder(&encode);
  if (e != 0) return e;
  const cuuint64_t dims[5] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)C, (cuuint64_t)D,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)W * 2;  // bytes
  const cuuint64_t strides[4] = {row, row * H, row * H * C, row * H * C * D};
  const cuuint32_t box[5] = {(cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bc, 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The launchers have internal linkage, as conv3x3_dw_s1.cuh's: two libraries
// built from this header (the phase probe's) keep launch tables of their own.
template <bool VX, bool VG>
static int dw2_launch_kernel(const bf16* x, const bf16* g, float* part, int B, int D, int C,
                             int H, int W, int Cout, int n_splits, cudaStream_t st) {
  using G = DwGeom<2>;
  static bool attr_done[convk::MAX_DEVICES] = {};
  if (int e = convk::set_smem_attrs(conv3x3_dw_s2_kernel<VX, VG>, DwS2::SMEM_BYTES, attr_done))
    return e;
  const int Do = D / 2, Ho = H / 2, Wo = W / 2;
  const int nh = (Ho + G::TH - 1) / G::TH, nw = (Wo + G::TW - 1) / G::TW;
  const int nci = (C + G::CI_T - 1) / G::CI_T, nco = (Cout + DwS2::CO_B - 1) / DwS2::CO_B;
  CUtensorMap tmx{}, tmg{};
  if (VX && VG) {
    int e = dw2_tensor_map(&tmx, x, B, D, C, H, W, DwS2::XROW, DwS2::XR, G::CI_T);
    if (e == 0) e = dw2_tensor_map(&tmg, g, B, Do, Cout, Ho, Wo, G::GROW, 1, DwS2::CO_B);
    if (e != 0) return e;
  }
  dim3 grid(nci * nco, n_splits);
  conv3x3_dw_s2_kernel<VX, VG><<<grid, DwS2::NTHREADS, DwS2::SMEM_BYTES, st>>>(
      x, g, part, D, C, H, W, Do, Ho, Wo, Cout, nco, nh, nw, (int64_t)B * Do * nh * nw,
      n_splits, tmx, tmg);
  return (int)cudaGetLastError();
}

// Launch the stride-2 weight-gradient kernel and the split reduction on
// `stream`: D, H, W are the INPUT extents (even); part is (n_splits, 27, C,
// Cout) f32 scratch, out (27, C, Cout) f32. x takes the 16-byte copies when
// W % 8 == 0 and g when Wo % 8 == 0, each when its pointer is 16-byte
// aligned, and the TMA copies when both do. Returns cudaGetLastError().
static int dw2_launch(const void* x, const void* g, void* part, void* out, int B, int D, int C,
                      int H, int W, int Cout, int n_splits, void* stream) {
  typedef int (*Launch)(const bf16*, const bf16*, float*, int, int, int, int, int, int, int,
                        cudaStream_t);
  static const Launch launch[2][2] = {
      {dw2_launch_kernel<false, false>, dw2_launch_kernel<false, true>},
      {dw2_launch_kernel<true, false>, dw2_launch_kernel<true, true>}};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vx = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vg = (W / 2) % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const int e = launch[vx][vg](static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                               static_cast<float*>(part), B, D, C, H, W, Cout, n_splits, st);
  if (e != cudaSuccess) return e;
  return reduce_splits_launch(part, out, C, Cout, n_splits, st);
}

}  // namespace convk
