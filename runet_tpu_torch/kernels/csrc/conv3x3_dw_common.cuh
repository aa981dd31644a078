// Shared pieces of the 3x3x3 weight-gradient kernels (conv3x3_dw_s1.cuh for
// conv3x3_dw.cu, stride 1; conv3x3_dw_s2.cuh for conv3x3_s2_dw.cu, stride 2).
// Both are an implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate) of
//   dw[tap, ci, co] = sum over output voxels v of x[v + tap] * g[v, co]
// with M = (tap, ci), N = co and K = the output voxels (b, d, h, w).
//
// The K dimension is cut into K-tiles of TH output rows x TW = 32 output
// columns of one (b, d), and the K-tiles into contiguous ranges, the splits
// (blockIdx.y). A block owns CI_T = 16 input channels of all 27 taps and
// one split's K-tiles, and stages each K-tile's input halo and g in shared
// memory in two stages, one being filled while the warps read the other
// (cp.async copies; TMA copies in the stride-2 kernel's aligned instance);
// warp (kd, kh) runs the three kw taps of its (kd, kh) as 3 m16 tiles
// against 4 n8 tiles of a CO_T = 32 channel group, two 16-voxel k-steps per
// row. The stride-1 kernel's 9-warp blocks own one such group and stage
// half K-tiles; the stride-2 kernel's 18-warp blocks own two and stage
// whole K-tiles.
//
// This file holds what the two kernels share: the tile geometry (DwGeom),
// the write of a stride-1 block's partial dw, and the split count (in
// 32-channel groups) and second pass. Each block writes its f32 partial dw
// for its split to a slot of its own; reduce_splits then sums the slots of
// each weight in a fixed order. No float atomics, so a run gives the same
// bits every time.
#pragma once

#include "conv3x3_common.cuh"

namespace convk {

template <int S>
struct DwGeom {
  static constexpr int TH = S == 1 ? 8 : 4;  // output rows per K-tile
  static constexpr int TW = 32;              // output columns per K-tile
  static constexpr int CI_T = 16;            // input channels per block (MMA M)
  static constexpr int CO_T = 32;            // output channels of a warp's N
  static constexpr int NT = CO_T / 8;
  static constexpr int NWARPS = 9;  // warp = kd * 3 + kh
  static constexpr int NTHREADS = NWARPS * 32;
  static constexpr int GROW = 40;  // shared stride of one (row, co) line of g
  static_assert(TW == 32 && GROW % 8 == 0, "g lines of four 16-byte chunks");
};

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

// Number of K splits for an (Do, Ho, Wo) output: enough (CI_T x CO_T
// channel tile, split) pairs for about four per SM, at most one split per
// K-tile, and a partial buffer of at most 64 MB.
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
