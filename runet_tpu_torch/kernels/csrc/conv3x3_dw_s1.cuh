// The stride-1 weight-gradient kernel (conv3x3_dw.cu): conv3x3_dw_common.cuh's
// implicit GEMM with the K-tiles staged in 16-byte chunks.
//
// Shared layout of x: one line of XROW = 56 bf16 per (kd, row, ci). Input
// column w0 + j, j in [-1, 32], sits at XOFF + j = 8 + j, so the 32 interior
// columns start on a 16-byte boundary and are staged as four 16-byte chunks;
// the two halo columns (indices 7 and 40) are one masked element each.
// Indices 0-6 and 41-55 are never written: a fragment load that reaches
// index 6 discards that half. 56 bf16 is 28 words, 4 * 7, so the words of one
// fragment load (8 lines x 4 lanes) fall in 32 distinct banks. g keeps
// GROW = 40 (80 B, a multiple of 16).
//
// A chunk is one index computation and, when the launcher's VEC flag holds
// (the row length a multiple of 8 and the base pointer 16-byte aligned), one
// 16-byte load; otherwise 8 masked element loads packed into the same 16
// bytes. Each thread issues U chunk loads before it stores any.
//
// A fragments: for output columns k, k + 1, tap kw = 1 reads input columns
// w0 + k, w0 + k + 1, the aligned word at XOFF + k; kw = 0 and kw = 2 are
// each one byte-permute of that word and the word before or after it.
#pragma once

#include "conv3x3_dw_common.cuh"

namespace convk {

struct DwS1 {
  using G = DwGeom<1>;
  static constexpr int XROW = 56;  // shared stride of one staged line of x
  static constexpr int XOFF = 8;   // index of input column w0
  static constexpr int NLINES = 3 * G::XR * G::CI_T;
  static constexpr int SMEM_X = NLINES * XROW;
  static constexpr int SMEM_BYTES = (SMEM_X + G::SMEM_G) * 2;
  static_assert(G::TW == 32 && XOFF % 8 == 0 && XROW % 8 == 0, "16-byte chunk stores");
  static_assert((SMEM_X * 2) % 16 == 0, "g tile 16-byte aligned");
};

// Stage the input halo of K-tile (d, h0, w0) for channels c0..c0+CI_T:
// xs[((kd * XR + row) * CI_T + ci) * XROW + XOFF + j] = x[d-1+kd, c0+ci,
// h0-1+row, w0+j], zero outside the extent and past channel C. Chunk e covers
// j = 8q..8q+7 of line e / 4 (q = e % 4); halo element e is j = -1 or 32 of
// line e / 2.
template <bool VEC>
__device__ __forceinline__ void dw1_stage_x(bf16* __restrict__ xs, const bf16* __restrict__ xb,
                                            int D, int C, int H, int W, int d, int h0, int w0,
                                            int c0) {
  using G = DwGeom<1>;
  constexpr int NCH = DwS1::NLINES * 4, NHALO = DwS1::NLINES * 2, U = G::U;
  const int64_t HW = (int64_t)H * W;
  for (int base = threadIdx.x; base < NCH; base += G::NTHREADS * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * G::NTHREADS;
      const int q = e & 3, line = e >> 2;
      const int ci = line % G::CI_T, r2 = line / G::CI_T;
      const int row = r2 % G::XR, kd = r2 / G::XR;
      const int dd = d - 1 + kd, hh = h0 - 1 + row, cc = c0 + ci, ww = w0 + 8 * q;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < NCH && (unsigned)dd < (unsigned)D && (unsigned)hh < (unsigned)H && cc < C)
        v[u] = ld_chunk<VEC>(xb + ((int64_t)dd * C + cc) * HW + (int64_t)hh * W + ww, ww, W);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * G::NTHREADS;
      if (e < NCH)
        *reinterpret_cast<uint4*>(xs + (e >> 2) * DwS1::XROW + DwS1::XOFF + (e & 3) * 8) = v[u];
    }
  }
  const bf16 zero = __ushort_as_bfloat16((unsigned short)0);
  for (int base = threadIdx.x; base < NHALO; base += G::NTHREADS * U) {
    bf16 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * G::NTHREADS;
      const int j = (e & 1) ? G::TW : -1, line = e >> 1;
      const int ci = line % G::CI_T, r2 = line / G::CI_T;
      const int row = r2 % G::XR, kd = r2 / G::XR;
      const int dd = d - 1 + kd, hh = h0 - 1 + row, cc = c0 + ci, ww = w0 + j;
      v[u] = zero;
      if (e < NHALO && (unsigned)dd < (unsigned)D && (unsigned)hh < (unsigned)H && cc < C &&
          (unsigned)ww < (unsigned)W)
        v[u] = xb[((int64_t)dd * C + cc) * HW + (int64_t)hh * W + ww];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * G::NTHREADS;
      if (e < NHALO) xs[(e >> 1) * DwS1::XROW + DwS1::XOFF + ((e & 1) ? G::TW : -1)] = v[u];
    }
  }
}

// x (B, D, C, H, W) bf16 input; g (B, D, Cout, H, W) bf16 output cotangent;
// part (n_splits, 27, C, Cout) f32 partial weight gradients. VX / VG: x / g
// staged with 16-byte loads.
template <bool VX, bool VG>
__global__ void __launch_bounds__(DwGeom<1>::NTHREADS)
conv3x3_dw_s1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     float* __restrict__ part, int D, int C, int H, int W, int Cout,
                     int n_cotiles, int nh, int nw, int64_t n_ktiles, int n_splits) {
  using G = DwGeom<1>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = xs + DwS1::SMEM_X;

  const int c0 = (blockIdx.x / n_cotiles) * G::CI_T;
  const int co0 = (blockIdx.x % n_cotiles) * G::CO_T;
  const int split = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int kd = warp / 3, kh = warp % 3;
  const int64_t HW = (int64_t)H * W;

  float acc[3][G::NT][4];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[kw][nt][r] = 0.f;

  const int64_t kt_lo = n_ktiles * split / n_splits;
  const int64_t kt_hi = n_ktiles * (split + 1) / n_splits;
  for (int64_t kt = kt_lo; kt < kt_hi; ++kt) {
    const int wt = (int)(kt % nw);
    int64_t rest = kt / nw;
    const int ht = (int)(rest % nh);
    rest /= nh;
    const int d = (int)(rest % D);
    const int b = (int)(rest / D);
    const int h0 = ht * G::TH, w0 = wt * G::TW;
    __syncthreads();  // the previous tile's fragments have been read
    dw1_stage_x<VX>(xs, x + (int64_t)b * D * C * HW, D, C, H, W, d, h0, w0, c0);
    dw_stage_g<1, VG>(gs, g + ((int64_t)b * D + d) * Cout * HW, Cout, H, W, h0, w0, co0);
    __syncthreads();

#pragma unroll 1
    for (int rr = 0; rr < G::TH; ++rr) {
      const bf16* xr = xs + ((kd * G::XR + rr + kh) * G::CI_T) * DwS1::XROW + DwS1::XOFF;
      const bf16* gr = gs + (rr * G::CO_T) * G::GROW;
#pragma unroll
      for (int kb = 0; kb < G::TW; kb += 16) {
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

  dw_store_partial<1>(part, acc, C, Cout, c0, co0);
}

template <bool VX, bool VG>
int dw1_launch_kernel(const bf16* x, const bf16* g, float* part, int B, int D, int C, int H,
                      int W, int Cout, int n_splits, cudaStream_t st) {
  using G = DwGeom<1>;
  static bool attr_done = false;
  if (!attr_done) {
    cudaError_t e = cudaFuncSetAttribute(conv3x3_dw_s1_kernel<VX, VG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DwS1::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_done = true;
  }
  const int nh = (H + G::TH - 1) / G::TH, nw = (W + G::TW - 1) / G::TW;
  const int nci = (C + G::CI_T - 1) / G::CI_T, nco = (Cout + G::CO_T - 1) / G::CO_T;
  dim3 grid(nci * nco, n_splits);
  conv3x3_dw_s1_kernel<VX, VG><<<grid, G::NTHREADS, DwS1::SMEM_BYTES, st>>>(
      x, g, part, D, C, H, W, Cout, nco, nh, nw, (int64_t)B * D * nh * nw, n_splits);
  return (int)cudaGetLastError();
}

// Launch the stride-1 weight-gradient kernel and the split reduction on
// `stream`: part is (n_splits, 27, C, Cout) f32 scratch, out (27, C, Cout)
// f32. x / g take the 16-byte loads when W % 8 == 0 and their pointer is
// 16-byte aligned. Returns cudaGetLastError().
inline int dw1_launch(const void* x, const void* g, void* part, void* out, int B, int D, int C,
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
