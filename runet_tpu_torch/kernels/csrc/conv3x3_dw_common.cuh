// Shared body of the 3x3x3 weight-gradient kernels (conv3x3_dw.cu stride 1,
// conv3x3_s2_dw.cu stride 2): an implicit GEMM on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate) of
//   dw[tap, ci, co] = sum over output voxels v of x[v + tap] * g[v, co]
// with M = (tap, ci), N = co and K = the output voxels (b, d, h, w).
//
// One block owns CI_T = 16 input channels x CO_T = 32 output channels of all
// 27 taps and a contiguous range of K-tiles (the split, blockIdx.y). A
// K-tile is TH output rows x TW = 32 output columns of one (b, d). For each
// K-tile the block stages the input halo (3 planes x XR rows x 16 channels x
// the columns the taps read, column innermost) and the g tile (TH rows x 32
// channels x 32 columns) in shared memory; warp (kd, kh) then runs the three
// kw taps of its (kd, kh) as 3 m16 tiles against 4 n8 tiles, two 16-voxel
// k-steps per row.
//
// An A fragment register holds two consecutive K voxels of one channel.
// Stride 1: tap kw reads columns k + kw, so kw = 1 is misaligned for a
// 32-bit load; it is assembled with one byte-permute from the kw = 0 and
// kw = 2 words, which are loaded anyway. Stride 2: the halo is staged with
// its even and odd columns apart, so kw = 0 and kw = 1 are aligned loads and
// kw = 2 is the byte-permute of two even-column words. Line strides of 40
// and 72 bf16 (20 and 36 words, 4 mod 8 with an odd quotient) make every
// fragment load bank-conflict free.
//
// Each block writes its f32 partial dw for its split to a slot of its own;
// reduce_splits then sums the slots of each weight in a fixed order. No
// float atomics, so a run gives the same bits every time.
#pragma once

#include "conv3x3_common.cuh"

namespace convk {

template <int S>
struct DwGeom {
  static constexpr int TH = S == 1 ? 8 : 4;  // output rows per K-tile
  static constexpr int TW = 32;              // output columns per K-tile
  static constexpr int CI_T = 16;            // input channels per block (MMA M)
  static constexpr int CO_T = 32;            // output channels per block
  static constexpr int NT = CO_T / 8;
  static constexpr int NWARPS = 9;  // warp = kd * 3 + kh
  static constexpr int NTHREADS = NWARPS * 32;
  static constexpr int XR = S * TH + (S == 1 ? 2 : 1);     // staged input rows per plane
  static constexpr int XCOLS = S * TW + (S == 1 ? 2 : 1);  // input columns the taps read
  static constexpr int XROW = S == 1 ? 40 : 72;  // shared stride of one staged line
  static constexpr int XODD = 36;                // stride 2: offset of the odd columns
  static constexpr int GROW = 40;                // shared stride of one (row, co) line of g
  static constexpr int SMEM_X = 3 * XR * CI_T * XROW;
  static constexpr int SMEM_G = TH * CO_T * GROW;
  static constexpr int SMEM_BYTES = (SMEM_X + SMEM_G) * 2;
};

// Stage the input halo of K-tile (d, h0, w0) for channels c0..c0+CI_T:
// xs[((kd * XR + row) * CI_T + ci) * XROW + col'], zero outside the extent and
// past channel C. Stride 1 reads input (d-1+kd, h0-1+row, w0-1+col), col' =
// col; stride 2 reads (2d+kd, 2h0+row, 2w0+col) with even columns at col/2
// and odd ones at XODD + col/2. Each thread issues U independent loads
// before it stores any.
template <int S>
__device__ __forceinline__ void dw_stage_x(bf16* __restrict__ xs, const bf16* __restrict__ xb,
                                           int D, int C, int H, int W, int d, int h0, int w0,
                                           int c0) {
  using G = DwGeom<S>;
  constexpr int NX = 3 * G::XR * G::CI_T * G::XCOLS;
  constexpr int U = 8;
  const int64_t HW = (int64_t)H * W;
  const int dbase = S == 1 ? d - 1 : 2 * d;
  const int hbase = S == 1 ? h0 - 1 : 2 * h0;
  const int wbase = S == 1 ? w0 - 1 : 2 * w0;
  const bf16 zero = __ushort_as_bfloat16((unsigned short)0);
  for (int base = threadIdx.x; base < NX; base += G::NTHREADS * U) {
    bf16 v[U];
    int off[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * G::NTHREADS;
      const int col = e % G::XCOLS, q = e / G::XCOLS;
      const int ci = q % G::CI_T, q2 = q / G::CI_T;
      const int row = q2 % G::XR, kd = q2 / G::XR;
      const int dd = dbase + kd, hh = hbase + row, ww = wbase + col, cc = c0 + ci;
      const int scol = S == 1 ? col : ((col & 1) ? G::XODD + (col >> 1) : (col >> 1));
      off[u] = e < NX ? ((kd * G::XR + row) * G::CI_T + ci) * G::XROW + scol : -1;
      v[u] = zero;
      if (e < NX && (unsigned)dd < (unsigned)D && (unsigned)hh < (unsigned)H &&
          (unsigned)ww < (unsigned)W && cc < C)
        v[u] = xb[((int64_t)dd * C + cc) * HW + (int64_t)hh * W + ww];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (off[u] >= 0) xs[off[u]] = v[u];
  }
}

// Stage the g tile: gs[(r * CO_T + co) * GROW + k] = g[b, d, co0+co, h0+r,
// w0+k], zero outside the output extent and past Cout (a zero g voxel adds
// nothing, which also masks the ragged K edge).
template <int S>
__device__ __forceinline__ void dw_stage_g(bf16* __restrict__ gs, const bf16* __restrict__ gb,
                                           int Cout, int Ho, int Wo, int h0, int w0, int co0) {
  using G = DwGeom<S>;
  constexpr int NG = G::TH * G::CO_T * G::TW;
  constexpr int U = 8;
  const int64_t HWo = (int64_t)Ho * Wo;
  const bf16 zero = __ushort_as_bfloat16((unsigned short)0);
  for (int base = threadIdx.x; base < NG; base += G::NTHREADS * U) {
    bf16 v[U];
    int off[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * G::NTHREADS;
      const int k = e % G::TW, q = e / G::TW;
      const int co = q % G::CO_T, r = q / G::CO_T;
      const int hh = h0 + r, ww = w0 + k, cc = co0 + co;
      off[u] = e < NG ? (r * G::CO_T + co) * G::GROW + k : -1;
      v[u] = zero;
      if (e < NG && hh < Ho && ww < Wo && cc < Cout)
        v[u] = gb[(int64_t)cc * HWo + (int64_t)hh * Wo + ww];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (off[u] >= 0) gs[off[u]] = v[u];
  }
}

// x (B, D, C, H, W) bf16 input; g (B, Do, Cout, Ho, Wo) bf16 output
// cotangent; part (n_splits, 27, C, Cout) f32 partial weight gradients.
template <int S>
__global__ void __launch_bounds__(DwGeom<S>::NTHREADS)
conv3x3_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  float* __restrict__ part, int D, int C, int H, int W, int Do, int Ho,
                  int Wo, int Cout, int n_cotiles, int nh, int nw, int64_t n_ktiles,
                  int n_splits) {
  using G = DwGeom<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = xs + G::SMEM_X;

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
    dw_stage_x<S>(xs, x + (int64_t)b * D * C * HW, D, C, H, W, d, h0, w0, c0);
    dw_stage_g<S>(gs, g + ((int64_t)b * Do + d) * Cout * HWo, Cout, Ho, Wo, h0, w0, co0);
    __syncthreads();

#pragma unroll 1
    for (int rr = 0; rr < G::TH; ++rr) {
      const bf16* xr = xs + ((kd * G::XR + S * rr + kh) * G::CI_T) * G::XROW;
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
        // A[m][k] = x at the column tap kw reads for output column kb + k,
        // input channel m. Register i: channel gq (+8 for i odd), voxels
        // 2t (+8 for i >= 2).
        uint32_t a[3][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bf16* p = xr + (gq + (i & 1) * 8) * G::XROW + kb + 2 * t + (i >> 1) * 8;
          const uint32_t lo = ld32(p), hi = ld32(p + 2);
          if (S == 1) {
            a[0][i] = lo;
            a[1][i] = __byte_perm(lo, hi, 0x5432);
            a[2][i] = hi;
          } else {
            a[0][i] = lo;
            a[1][i] = ld32(p + G::XODD);
            a[2][i] = __byte_perm(lo, hi, 0x5432);
          }
        }
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int nt = 0; nt < G::NT; ++nt) mma_16816(acc[kw][nt], a[kw], bfr[nt]);
      }
    }
  }

  float* pb = part + (int64_t)split * 27 * C * Cout;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const int tap = (kd * 3 + kh) * 3 + kw;
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ci = c0 + gq + (r >= 2 ? 8 : 0);
        const int co = co0 + nt * 8 + 2 * t + (r & 1);
        if (ci < C && co < Cout) pb[((int64_t)tap * C + ci) * Cout + co] = acc[kw][nt][r];
      }
    }
  }
}

// Second pass: out[e] = sum over splits of part[s, e], in split order.
__global__ void __launch_bounds__(256)
reduce_splits(const float* __restrict__ part, float* __restrict__ out, int64_t E,
              int n_splits) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < n_splits; ++i) s += part[(int64_t)i * E + e];
    out[e] = s;
  }
}

// Number of K splits for an (Do, Ho, Wo) output: enough blocks for about
// four per SM, at most one split per K-tile, and a partial buffer of at
// most 64 MB.
template <int S>
int dw_splits(int B, int Do, int Ho, int Wo, int C, int Cout, int num_sms) {
  using G = DwGeom<S>;
  const int64_t n_mn = (int64_t)((C + G::CI_T - 1) / G::CI_T) * ((Cout + G::CO_T - 1) / G::CO_T);
  const int64_t n_k = (int64_t)B * Do * ((Ho + G::TH - 1) / G::TH) * ((Wo + G::TW - 1) / G::TW);
  int64_t s = (4LL * num_sms + n_mn - 1) / n_mn;
  const int64_t cap = (64LL << 20) / (27LL * C * Cout * 4);
  if (s > cap) s = cap;
  if (s > n_k) s = n_k;
  if (s > 65535) s = 65535;
  return (int)(s < 1 ? 1 : s);
}

// Launch the weight-gradient kernel and the split reduction on `stream`.
// D, H, W are the INPUT extents; part is (n_splits, 27, C, Cout) f32 scratch,
// out (27, C, Cout) f32. Returns cudaGetLastError().
template <int S>
int dw_launch(const void* x, const void* g, void* part, void* out, int B, int D, int C, int H,
              int W, int Cout, int n_splits, void* stream) {
  using G = DwGeom<S>;
  static bool attr_done = false;
  if (!attr_done) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3x3_dw_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_done = true;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int Do = S == 1 ? D : D / 2, Ho = S == 1 ? H : H / 2, Wo = S == 1 ? W : W / 2;
  const int nh = (Ho + G::TH - 1) / G::TH, nw = (Wo + G::TW - 1) / G::TW;
  const int nci = (C + G::CI_T - 1) / G::CI_T, nco = (Cout + G::CO_T - 1) / G::CO_T;
  const int64_t n_k = (int64_t)B * Do * nh * nw;
  dim3 grid(nci * nco, n_splits);
  conv3x3_dw_kernel<S><<<grid, G::NTHREADS, G::SMEM_BYTES, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<float*>(part), D,
      C, H, W, Do, Ho, Wo, Cout, nco, nh, nw, n_k, n_splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t E = 27LL * C * Cout;
  int64_t nb = (E + 255) / 256;
  if (nb > 4096) nb = 4096;
  reduce_splits<<<(int)nb, 256, 0, st>>>(static_cast<const float*>(part),
                                         static_cast<float*>(out), E, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace convk
