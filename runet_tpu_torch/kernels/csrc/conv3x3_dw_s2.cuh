// The stride-2 weight-gradient kernel (conv3x3_s2_dw.cu): conv3x3_dw_common.cuh's
// implicit GEMM with the K-tiles staged in 16-byte chunks.
//
// Output voxel (d, h, w) tap (kd, kh, kw) reads input (2d+kd, 2h+kh, 2w+kw),
// so the input line of a K-tile at output columns w0..w0+31 spans the 65
// input columns 2w0..2w0+64. Shared layout of x: one line of XROW = 72 bf16
// per (kd, row, ci), the even column 2w0 + c at c / 2 (indices 0-32) and the
// odd one at XODD + c / 2 = 36 + c / 2 (indices 36-67). Indices 33-35 and
// 68-71 are never written: the one fragment load that reaches index 33
// discards that half. 72 bf16 is 36 words, 4 * 9, so the words of one
// fragment load (8 lines x 4 lanes) fall in 32 distinct banks.
//
// The 64 interior columns of a line are 8 chunks of 8 bf16; 2w0 = 64 * wt,
// so with the launcher's VX flag (W % 8 == 0 and x 16-byte aligned) each
// chunk is one 16-byte load, else 8 masked element loads packed the same
// way. Its four words are split in registers, two byte-permutes each, into
// the four even columns and the four odd ones, each stored as one 8-byte
// word at 4q and XODD + 4q. The 65th column (2w0 + 64, even, index 32) is
// one masked element per line. g is staged as in the stride-1 kernel, at
// the output extents. Each thread issues U chunk loads before it stores any.
//
// A fragments: for output columns k, k + 1, tap kw = 0 reads the even
// columns 2k, 2k + 2, the aligned word at k; kw = 1 the odd ones, the
// aligned word at XODD + k; kw = 2 the even columns 2k + 2, 2k + 4, one
// byte-permute of the words at k and k + 2.
#pragma once

#include "conv3x3_dw_common.cuh"

namespace convk {

struct DwS2 {
  using G = DwGeom<2>;
  static constexpr int XROW = 72;  // shared stride of one staged line of x
  static constexpr int XODD = 36;  // index of the odd columns
  static constexpr int NLINES = 3 * G::XR * G::CI_T;
  static constexpr int SMEM_X = NLINES * XROW;
  static constexpr int SMEM_BYTES = (SMEM_X + G::SMEM_G) * 2;
  static_assert(G::TW == 32 && XROW % 4 == 0 && XODD % 4 == 0, "8-byte chunk-half stores");
  static_assert((SMEM_X * 2) % 16 == 0, "g tile 16-byte aligned");
};

// Stage the input halo of K-tile (d, h0, w0) for channels c0..c0+CI_T: input
// (2d+kd, 2h0+row, 2w0+c) of channel c0+ci goes to line (kd * XR + row) *
// CI_T + ci at c / 2 (c even) or XODD + c / 2 (c odd), zero outside the
// extent and past channel C. Chunk e covers c = 8q..8q+7 of line e / 8
// (q = e % 8); halo element e is c = 64 of line e.
template <bool VEC>
__device__ __forceinline__ void dw2_stage_x(bf16* __restrict__ xs, const bf16* __restrict__ xb,
                                            int D, int C, int H, int W, int d, int h0, int w0,
                                            int c0) {
  using G = DwGeom<2>;
  constexpr int NCH = DwS2::NLINES * 8, NHALO = DwS2::NLINES, U = G::U;
  const int64_t HW = (int64_t)H * W;
  for (int base = threadIdx.x; base < NCH; base += G::NTHREADS * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * G::NTHREADS;
      const int q = e & 7, line = e >> 3;
      const int ci = line % G::CI_T, r2 = line / G::CI_T;
      const int row = r2 % G::XR, kd = r2 / G::XR;
      const int dd = 2 * d + kd, hh = 2 * h0 + row, cc = c0 + ci, ww = 2 * w0 + 8 * q;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < NCH && dd < D && hh < H && cc < C)
        v[u] = ld_chunk<VEC>(xb + ((int64_t)dd * C + cc) * HW + (int64_t)hh * W + ww, ww, W);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * G::NTHREADS;
      if (e < NCH) {
        // Columns 8q + 2j (low halves) and 8q + 2j + 1 (high halves).
        const uint2 even = make_uint2(__byte_perm(v[u].x, v[u].y, 0x5410),
                                      __byte_perm(v[u].z, v[u].w, 0x5410));
        const uint2 odd = make_uint2(__byte_perm(v[u].x, v[u].y, 0x7632),
                                     __byte_perm(v[u].z, v[u].w, 0x7632));
        bf16* dst = xs + (e >> 3) * DwS2::XROW + (e & 7) * 4;
        *reinterpret_cast<uint2*>(dst) = even;
        *reinterpret_cast<uint2*>(dst + DwS2::XODD) = odd;
      }
    }
  }
  const bf16 zero = __ushort_as_bfloat16((unsigned short)0);
  for (int base = threadIdx.x; base < NHALO; base += G::NTHREADS * U) {
    bf16 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int line = base + u * G::NTHREADS;
      const int ci = line % G::CI_T, r2 = line / G::CI_T;
      const int row = r2 % G::XR, kd = r2 / G::XR;
      const int dd = 2 * d + kd, hh = 2 * h0 + row, cc = c0 + ci, ww = 2 * w0 + 2 * G::TW;
      v[u] = zero;
      if (line < NHALO && dd < D && hh < H && cc < C && ww < W)
        v[u] = xb[((int64_t)dd * C + cc) * HW + (int64_t)hh * W + ww];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int line = base + u * G::NTHREADS;
      if (line < NHALO) xs[line * DwS2::XROW + G::TW] = v[u];
    }
  }
}

// x (B, D, C, H, W) bf16 input; g (B, Do, Cout, Ho, Wo) bf16 output
// cotangent; part (n_splits, 27, C, Cout) f32 partial weight gradients.
// VX / VG: x / g staged with 16-byte loads.
template <bool VX, bool VG>
__global__ void __launch_bounds__(DwGeom<2>::NTHREADS)
conv3x3_dw_s2_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     float* __restrict__ part, int D, int C, int H, int W, int Do, int Ho,
                     int Wo, int Cout, int n_cotiles, int nh, int nw, int64_t n_ktiles,
                     int n_splits) {
  using G = DwGeom<2>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = xs + DwS2::SMEM_X;

  const int c0 = (blockIdx.x / n_cotiles) * G::CI_T;
  const int co0 = (blockIdx.x % n_cotiles) * G::CO_T;
  const int split = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int kd = warp / 3, kh = warp % 3;
  const int64_t HW = (int64_t)H * W, HWo = (int64_t)Ho * Wo;

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
    const int d = (int)(rest % Do);
    const int b = (int)(rest / Do);
    const int h0 = ht * G::TH, w0 = wt * G::TW;
    __syncthreads();  // the previous tile's fragments have been read
    dw2_stage_x<VX>(xs, x + (int64_t)b * D * C * HW, D, C, H, W, d, h0, w0, c0);
    dw_stage_g<2, VG>(gs, g + ((int64_t)b * Do + d) * Cout * HWo, Cout, Ho, Wo, h0, w0, co0);
    __syncthreads();

#pragma unroll 1
    for (int rr = 0; rr < G::TH; ++rr) {
      const bf16* xr = xs + ((kd * G::XR + 2 * rr + kh) * G::CI_T) * DwS2::XROW;
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
        // A[m][k] = x at input column 2 * (w0 + kb + k) + kw, input channel
        // m. Register i: channel gq (+8 for i odd), voxels 2t (+8 for i >= 2).
        uint32_t a[3][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bf16* p = xr + (gq + (i & 1) * 8) * DwS2::XROW + kb + 2 * t + (i >> 1) * 8;
          const uint32_t lo = ld32(p), hi = ld32(p + 2);
          a[0][i] = lo;
          a[1][i] = ld32(p + DwS2::XODD);
          a[2][i] = __byte_perm(lo, hi, 0x5432);
        }
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int nt = 0; nt < G::NT; ++nt) mma_16816(acc[kw][nt], a[kw], bfr[nt]);
      }
    }
  }

  dw_store_partial<2>(part, acc, C, Cout, c0, co0);
}

template <bool VX, bool VG>
int dw2_launch_kernel(const bf16* x, const bf16* g, float* part, int B, int D, int C, int H,
                      int W, int Cout, int n_splits, cudaStream_t st) {
  using G = DwGeom<2>;
  static bool attr_done = false;
  if (!attr_done) {
    cudaError_t e = cudaFuncSetAttribute(conv3x3_dw_s2_kernel<VX, VG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DwS2::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_done = true;
  }
  const int Do = D / 2, Ho = H / 2, Wo = W / 2;
  const int nh = (Ho + G::TH - 1) / G::TH, nw = (Wo + G::TW - 1) / G::TW;
  const int nci = (C + G::CI_T - 1) / G::CI_T, nco = (Cout + G::CO_T - 1) / G::CO_T;
  dim3 grid(nci * nco, n_splits);
  conv3x3_dw_s2_kernel<VX, VG><<<grid, G::NTHREADS, DwS2::SMEM_BYTES, st>>>(
      x, g, part, D, C, H, W, Do, Ho, Wo, Cout, nco, nh, nw, (int64_t)B * Do * nh * nw,
      n_splits);
  return (int)cudaGetLastError();
}

// Launch the stride-2 weight-gradient kernel and the split reduction on
// `stream`: D, H, W are the INPUT extents (even); part is (n_splits, 27, C,
// Cout) f32 scratch, out (27, C, Cout) f32. x takes the 16-byte loads when
// W % 8 == 0 and g when Wo % 8 == 0, each when its pointer is 16-byte
// aligned. Returns cudaGetLastError().
inline int dw2_launch(const void* x, const void* g, void* part, void* out, int B, int D, int C,
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
