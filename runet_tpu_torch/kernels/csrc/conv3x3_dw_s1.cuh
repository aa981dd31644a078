// The stride-1 weight-gradient kernel (conv3x3_dw.cu): conv3x3_dw_common.cuh's
// implicit GEMM, each K-tile (TH = 8 rows x TW = 32 columns of one (b, d))
// staged as two half K-tiles of HT = 4 output rows through a two-stage
// cp.async ring.
//
// A stage holds one half K-tile: the input halo of its 4 output rows (3 planes
// x 6 input rows x 16 channels, 32,256 B) and their g (4 rows x 32 channels,
// 10,240 B). Two stages take 84,992 B, so two 9-warp blocks fit on an SM.
// Half-tile i + 1's copies are in flight while the warps run half-tile i's
// MMAs:
//   prologue: issue half-tile 0 into stage 0, commit;
//   each i:   issue i + 1 into stage (i + 1) & 1, commit; cp.async.wait_group
//             1 (0 on the last); __syncthreads; MMAs on stage i & 1;
//             __syncthreads (the stage is refilled next).
// The half-tiles follow the K-tiles in order (wt fastest, then ht, d, b), the
// upper half first, and within a half the rows ascend, then kb, kw and nt:
// every accumulator receives the k-steps of a one-tile-at-a-time walk, in
// the same order.
//
// Shared layout of x: one line of XROW = 56 bf16 per (kd, row, ci). Input
// column w0 + j, j in [-1, 32], sits at XOFF + j = 8 + j, so the 32 interior
// columns start on a 16-byte boundary: four 16-byte chunks, one cp.async each,
// zero-filled outside D, H, C or W. Each halo column comes with its aligned
// neighbour, one 4-byte cp.async: the word (j = -2, -1) into indices 6-7,
// (32, 33) into 40-41. Under VX (W % 8 == 0, x 16-byte aligned) a word lies
// wholly inside or outside its row. Indices 6 and 41 reach only fragment
// halves that the byte-permutes discard. 56 bf16 is 28 words, 4 * 7, so the
// words of one fragment load (8 lines x 4 lanes) fall in 32 distinct banks.
// g keeps GROW = 40 (80 B, a multiple of 16), one cp.async per 16-byte chunk.
//
// Without VX or VG (an odd offset, or W % 8 != 0; no main-path launch does
// either) that operand is staged by plain loads (8 masked element loads per
// chunk, an item's loads all issued before it stores any) and stores into
// the same stage at the same point of the loop; indices 6 and 41 are then
// not written. Both ways put the same values where a fragment reads them.
//
// Where w0 + 16 >= W, g's columns 16-31 are zero-filled and the kb = 16
// k-step would add exact zeros to accumulators that are never -0: it is
// skipped (the test is uniform in the block), which keeps the bits for
// finite inputs. x's column 16 is still staged: the kw = 2 tap of output
// column 15 reads it.
//
// A fragments: for output columns k, k + 1, tap kw = 1 reads input columns
// w0 + k, w0 + k + 1, the aligned word at XOFF + k; kw = 0 and kw = 2 are
// each one byte-permute of that word and the word before or after it.
#pragma once

#include "conv3x3_dw_common.cuh"

// The phases the kernel runs: 1 the x staging, 2 the g staging, 4 the MMAs.
// A build that leaves one out computes a wrong dw; it exists only to time the
// phase's share (utils/phase_probe.py --kernel dw1).
#ifndef DW1_PHASES
#define DW1_PHASES 7
#endif

namespace convk {

struct DwS1 {
  using G = DwGeom<1>;
  static constexpr int HT = G::TH / 2;  // output rows per stage: a half K-tile
  static constexpr int XR = HT + 2;     // staged input rows per plane
  static constexpr int XROW = 56;       // shared stride of one staged line of x
  static constexpr int XOFF = 8;        // index of input column w0
  static constexpr int NLINES = 3 * XR * G::CI_T;
  static constexpr int SMEM_X = NLINES * XROW;
  static constexpr int SMEM_G = HT * G::CO_T * G::GROW;
  static constexpr int STAGE = SMEM_X + SMEM_G;  // bf16 per stage
  static constexpr int SMEM_BYTES = 2 * STAGE * 2;
  // Staging items: two per line (four 16-byte chunks and two halo words).
  static constexpr int NIT_X = NLINES * 2, NIT_G = HT * G::CO_T * 2;
  static_assert(G::TW == 32 && XOFF % 8 == 0 && XROW % 8 == 0, "16-byte chunk targets");
  static_assert((SMEM_X * 2) % 16 == 0 && (STAGE * 2) % 16 == 0, "stages and g 16-byte aligned");
  static_assert(NIT_X % G::NTHREADS == 0 && NIT_G <= G::NTHREADS, "whole items per thread");
};

// Stage the input halo of half K-tile (d, h0, w0) for channels c0..c0+CI_T:
// xs[((kd * XR + row) * CI_T + ci) * XROW + XOFF + j] = x[d-1+kd, c0+ci,
// h0-1+row, w0+j], zero outside the extent and past channel C. Item (line,
// p), p = 0 or 1, covers the chunks q = p and p + 2 (j = 8q..8q+7) and the
// halo on side p (j = -1, with -2 under VX, or 32, with 33) of one line.
// Lanes 2k and 2k + 1 take the two items of one line, so each copy reads
// whole 32-byte sectors, and a thread works out two line addresses.
template <bool VX>
__device__ __forceinline__ void dw1_stage_x(bf16* __restrict__ xs, const bf16* __restrict__ xb,
                                            int D, int C, int H, int W, int d, int h0, int w0,
                                            int c0) {
  using G = DwGeom<1>;
  const int64_t HW = (int64_t)H * W;
#pragma unroll
  for (int u = 0; u < DwS1::NIT_X / G::NTHREADS; ++u) {
    const int it = threadIdx.x + u * G::NTHREADS;
    const int p = it & 1, line = it >> 1;
    const int ci = line % G::CI_T, r2 = line / G::CI_T;
    const int row = r2 % DwS1::XR, kd = r2 / DwS1::XR;
    const int dd = d - 1 + kd, hh = h0 - 1 + row, cc = c0 + ci;
    const bool ok = (unsigned)dd < (unsigned)D && (unsigned)hh < (unsigned)H && cc < C;
    const bf16* rowp = xb + ((int64_t)dd * C + cc) * HW + (int64_t)hh * W;
    bf16* dst = xs + line * DwS1::XROW + DwS1::XOFF;
    if constexpr (VX) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ww = w0 + 8 * (p + 2 * k);
        cp_async16_zfill(dst + 8 * (p + 2 * k), ok && ww < W ? rowp + ww : xb, ok && ww < W);
      }
      const int j = p ? G::TW : -2, ww = w0 + j;
      const bool in = ok && (unsigned)ww < (unsigned)W;
      cp_async4_zfill(dst + j, in ? rowp + ww : xb, in);
    } else {
      uint4 v[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ww = w0 + 8 * (p + 2 * k);
        v[k] = ok ? ld_chunk<false>(rowp + ww, ww, W) : make_uint4(0u, 0u, 0u, 0u);
      }
      const int j = p ? G::TW : -1, ww = w0 + j;
      const bf16 h = ok && (unsigned)ww < (unsigned)W ? rowp[ww]
                                                      : __ushort_as_bfloat16((unsigned short)0);
#pragma unroll
      for (int k = 0; k < 2; ++k) *reinterpret_cast<uint4*>(dst + 8 * (p + 2 * k)) = v[k];
      dst[j] = h;
    }
  }
}

// Stage the g of half K-tile (h0, w0): gs[(r * CO_T + co) * GROW + k] =
// g[b, d, co0+co, h0+r, w0+k], zero outside H and W and past Cout (a zero g
// voxel adds nothing, which also masks the ragged K edge). Item (line, p)
// of line = r * CO_T + co covers the chunks q = p and p + 2 (k = 8q..8q+7),
// as in dw1_stage_x; threads past the NIT_G items stage no g.
template <bool VG>
__device__ __forceinline__ void dw1_stage_g(bf16* __restrict__ gs, const bf16* __restrict__ gb,
                                            int Cout, int H, int W, int h0, int w0, int co0) {
  using G = DwGeom<1>;
  const int it = threadIdx.x;
  if (it >= DwS1::NIT_G) return;
  const int p = it & 1, line = it >> 1;
  const int co = line % G::CO_T, r = line / G::CO_T;
  const int hh = h0 + r, cc = co0 + co;
  const bool ok = hh < H && cc < Cout;
  const bf16* rowp = gb + (int64_t)cc * H * W + (int64_t)hh * W;
  bf16* dst = gs + line * G::GROW;
  uint4 v[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ww = w0 + 8 * (p + 2 * k);
    if constexpr (VG)
      cp_async16_zfill(dst + 8 * (p + 2 * k), ok && ww < W ? rowp + ww : gb, ok && ww < W);
    else
      v[k] = ok ? ld_chunk<false>(rowp + ww, ww, W) : make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (!VG) {
#pragma unroll
    for (int k = 0; k < 2; ++k) *reinterpret_cast<uint4*>(dst + 8 * (p + 2 * k)) = v[k];
  }
}

// The MMAs of one staged half K-tile: warp (kd, kh) runs its three kw taps
// (3 m16 tiles) against NT n8 tiles, rows ascending, two 16-column k-steps
// per row, or only kb = 0 where the tile's columns 16-31 lie past W. The
// four rows are unrolled, so a row's fragment loads can issue during the
// previous row's MMAs.
__device__ __forceinline__ void dw1_mma_half(float (&acc)[3][DwGeom<1>::NT][4],
                                             const bf16* __restrict__ xs,
                                             const bf16* __restrict__ gs, bool kb16) {
  using G = DwGeom<1>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int kd = warp / 3, kh = warp % 3;
#pragma unroll
  for (int rr = 0; rr < DwS1::HT; ++rr) {
    const bf16* xr = xs + ((kd * DwS1::XR + rr + kh) * G::CI_T) * DwS1::XROW + DwS1::XOFF;
    const bf16* gr = gs + (rr * G::CO_T) * G::GROW;
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
      // A[m][k] = x at input column w0 + kb + k + kw - 1, input channel m.
      // Register i: channel gq (+8 for i odd), voxels 2t (+8 for i >= 2).
      uint32_t a[3][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bf16* p = xr + (gq + (i & 1) * 8) * DwS1::XROW + kb + 2 * t + (i >> 1) * 8;
        const uint32_t lo = ld32(p - 2), mid = ld32(p), hi = ld32(p + 2);
        a[0][i] = __byte_perm(lo, mid, 0x5432);
        a[1][i] = mid;
        a[2][i] = __byte_perm(mid, hi, 0x5432);
      }
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) mma_16816(acc[kw][nt], a[kw], bfr[nt]);
    }
  }
}

// x (B, D, C, H, W) bf16 input; g (B, D, Cout, H, W) bf16 output cotangent;
// part (n_splits, 27, C, Cout) f32 partial weight gradients. VX / VG: x / g
// staged by 16-byte cp.async. Two blocks per SM put five warps on a
// sub-partition, so ptxas holds a thread to 96 registers (95-96, no spills).
template <bool VX, bool VG>
__global__ void __launch_bounds__(DwGeom<1>::NTHREADS, 2)
conv3x3_dw_s1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     float* __restrict__ part, int D, int C, int H, int W, int Cout,
                     int n_cotiles, int nh, int nw, int64_t n_ktiles, int n_splits) {
  using G = DwGeom<1>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const stages = reinterpret_cast<bf16*>(smem_raw);

  const int c0 = (blockIdx.x / n_cotiles) * G::CI_T;
  const int co0 = (blockIdx.x % n_cotiles) * G::CO_T;
  const int split = blockIdx.y;

  float acc[3][G::NT][4];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[kw][nt][r] = 0.f;

  // Half-tiles hx = 2 * kt + (0 upper, 1 lower half) of this split's K-tiles;
  // half-tile hx goes through stage hx & 1.
  const int hx_lo = (int)(2 * (n_ktiles * split / n_splits));
  const int hx_hi = (int)(2 * (n_ktiles * (split + 1) / n_splits));

  // Issue (without committing) the copies of half-tile hx into its stage;
  // returns whether its k-step at kb = 16 reaches into W.
  auto issue = [&](int hx) {
    const int kt = hx >> 1;
    const int wt = kt % nw;
    int rest = kt / nw;
    const int ht = rest % nh;
    rest /= nh;
    const int d = rest % D, b = rest / D;
    const int h0 = ht * G::TH + (hx & 1) * DwS1::HT, w0 = wt * G::TW;
    bf16* stage = stages + (hx & 1) * DwS1::STAGE;
    const int64_t HW = (int64_t)H * W;
    if constexpr ((DW1_PHASES & 1) != 0)
      dw1_stage_x<VX>(stage, x + (int64_t)b * D * C * HW, D, C, H, W, d, h0, w0, c0);
    if constexpr ((DW1_PHASES & 2) != 0)
      dw1_stage_g<VG>(stage + DwS1::SMEM_X, g + ((int64_t)b * D + d) * Cout * HW, Cout, H, W,
                      h0, w0, co0);
    return w0 + 16 < W;
  };

  bool kb16 = issue(hx_lo);
  cp_async_commit();
  for (int hx = hx_lo; hx < hx_hi; ++hx) {
    const bool more = hx + 1 < hx_hi;
    bool kb16_next = false;
    if (more) kb16_next = issue(hx + 1);
    cp_async_commit();
    if (more)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // half-tile hx has landed for every thread
    if constexpr ((DW1_PHASES & 4) != 0) {
      const bf16* xs = stages + (hx & 1) * DwS1::STAGE;
      dw1_mma_half(acc, xs, xs + DwS1::SMEM_X, kb16);
    }
    __syncthreads();  // its stage has been read before it is refilled
    kb16 = kb16_next;
  }

  dw_store_partial<1>(part, acc, C, Cout, c0, co0);
}

// The launchers have internal linkage: a static local of an inline or
// template function with external linkage is one object per process
// (STB_GNU_UNIQUE), so two libraries built from this header (the phase
// probe's) would share one launch table and launch one library's kernel.
template <bool VX, bool VG>
static int dw1_launch_kernel(const bf16* x, const bf16* g, float* part, int B, int D, int C, int H,
                      int W, int Cout, int n_splits, cudaStream_t st) {
  using G = DwGeom<1>;
  static bool attr_done[convk::MAX_DEVICES] = {};
  if (int e = convk::set_smem_attrs(conv3x3_dw_s1_kernel<VX, VG>, DwS1::SMEM_BYTES, attr_done))
    return e;
  const int nh = (H + G::TH - 1) / G::TH, nw = (W + G::TW - 1) / G::TW;
  const int nci = (C + G::CI_T - 1) / G::CI_T, nco = (Cout + G::CO_T - 1) / G::CO_T;
  const int64_t n_ktiles = (int64_t)B * D * nh * nw;
  if (2 * n_ktiles > INT32_MAX) return (int)cudaErrorInvalidValue;  // int half-tile index
  dim3 grid(nci * nco, n_splits);
  conv3x3_dw_s1_kernel<VX, VG><<<grid, G::NTHREADS, DwS1::SMEM_BYTES, st>>>(
      x, g, part, D, C, H, W, Cout, nco, nh, nw, n_ktiles, n_splits);
  return (int)cudaGetLastError();
}

// Launch the stride-1 weight-gradient kernel and the split reduction on
// `stream`: part is (n_splits, 27, C, Cout) f32 scratch, out (27, C, Cout)
// f32. x / g take the 16-byte copies when W % 8 == 0 and their pointer is
// 16-byte aligned. Returns cudaGetLastError().
static int dw1_launch(const void* x, const void* g, void* part, void* out, int B, int D, int C,
                      int H, int W, int Cout, int n_splits, void* stream) {
  typedef int (*Launch)(const bf16*, const bf16*, float*, int, int, int, int, int, int, int,
                        cudaStream_t);
  static const Launch launch[2][2] = {
      {dw1_launch_kernel<false, false>, dw1_launch_kernel<false, true>},
      {dw1_launch_kernel<true, false>, dw1_launch_kernel<true, true>}};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vx = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vg = W % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const int e = launch[vx][vg](static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                               static_cast<float*>(part), B, D, C, H, W, Cout, n_splits, st);
  if (e != cudaSuccess) return e;
  return reduce_splits_launch(part, out, C, Cout, n_splits, st);
}

}  // namespace convk
