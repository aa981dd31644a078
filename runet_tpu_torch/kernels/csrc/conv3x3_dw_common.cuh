// Shared pieces of the 3x3x3 weight-gradient kernels (conv3x3_dw_s1.cuh for
// conv3x3_dw.cu, stride 1; conv3x3_dw_s2.cuh for conv3x3_s2_dw.cu, stride 2).
// Both are an implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate) of
//   dw[tap, ci, co] = sum over output voxels v of x[v + tap] * g[v, co]
// with M = (tap, ci), N = co and K = the output voxels (b, d, h, w).
//
// One block owns CI_T = 16 input channels x CO_T = 32 output channels of all
// 27 taps and a contiguous range of K-tiles (the split, blockIdx.y). A
// K-tile is TH output rows x TW = 32 output columns of one (b, d). For each
// K-tile the block stages the input halo (3 planes x XR rows x 16 channels,
// column innermost, in the stride's own line layout) and the g tile (TH rows
// x 32 channels x 32 columns) in shared memory, both in 16-byte chunks (the
// stride-1 kernel in two halves through a cp.async ring); warp (kd, kh) then
// runs the three kw taps of its (kd, kh) as 3 m16 tiles against 4 n8 tiles,
// two 16-voxel k-steps per row.
//
// This file holds what the two kernels share: the tile geometry (DwGeom),
// the g stager of whole K-tiles (16-byte chunks, conv3x3_common.cuh's
// ld_chunk; the stride-1 kernel stages half K-tiles with its own), the write
// of a block's partial dw, and the split count and second pass. Each block
// writes its f32 partial dw for its split to a slot of its own;
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
  static constexpr int XR = S * TH + (S == 1 ? 2 : 1);  // staged input rows per plane
  static constexpr int GROW = 40;  // shared stride of one (row, co) line of g
  static constexpr int SMEM_G = TH * CO_T * GROW;
  static constexpr int U = 4;  // chunk loads in flight per thread
  static_assert(TW == 32 && GROW % 8 == 0, "g lines of four 16-byte chunks");
};

// Stage the g tile: gs[(r * CO_T + co) * GROW + k] = g[b, d, co0+co, h0+r,
// w0+k] for an output of Ho x Wo, zero outside it and past Cout (a zero g
// voxel adds nothing, which also masks the ragged K edge). Chunk e covers
// k = 8q..8q+7 of line e / 4 = r * CO_T + co.
template <int S, bool VEC>
__device__ __forceinline__ void dw_stage_g(bf16* __restrict__ gs, const bf16* __restrict__ gb,
                                           int Cout, int Ho, int Wo, int h0, int w0, int co0) {
  using G = DwGeom<S>;
  constexpr int NCH = G::TH * G::CO_T * 4, U = G::U;
  const int64_t HWo = (int64_t)Ho * Wo;
  for (int base = threadIdx.x; base < NCH; base += G::NTHREADS * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * G::NTHREADS;
      const int q = e & 3, co = (e >> 2) % G::CO_T, r = (e >> 2) / G::CO_T;
      const int hh = h0 + r, cc = co0 + co, ww = w0 + 8 * q;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < NCH && hh < Ho && cc < Cout)
        v[u] = ld_chunk<VEC>(gb + (int64_t)cc * HWo + (int64_t)hh * Wo + ww, ww, Wo);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * G::NTHREADS;
      if (e < NCH) *reinterpret_cast<uint4*>(gs + (e >> 2) * G::GROW + (e & 3) * 8) = v[u];
    }
  }
}

// Write warp (kd, kh)'s accumulators, taps (kd, kh, 0..2), to the block's
// slot of part (n_splits, 27, C, Cout), skipping channels past C and Cout.
template <int S>
__device__ __forceinline__ void dw_store_partial(float* __restrict__ part,
                                                 const float (&acc)[3][DwGeom<S>::NT][4],
                                                 int C, int Cout, int c0, int co0) {
  using G = DwGeom<S>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  float* pb = part + (int64_t)blockIdx.y * 27 * C * Cout;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const int tap = warp * 3 + kw;
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

// Launch reduce_splits for a (27, C, Cout) dw on `st`; returns cudaGetLastError().
inline int reduce_splits_launch(const void* part, void* out, int C, int Cout, int n_splits,
                                cudaStream_t st) {
  const int64_t E = 27LL * C * Cout;
  int64_t nb = (E + 255) / 256;
  if (nb > 4096) nb = 4096;
  reduce_splits<<<(int)nb, 256, 0, st>>>(static_cast<const float*>(part),
                                         static_cast<float*>(out), E, n_splits);
  return (int)cudaGetLastError();
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

}  // namespace convk
