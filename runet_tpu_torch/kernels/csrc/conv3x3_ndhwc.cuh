// Stride-1 3x3x3 SAME convolution on channel-innermost (B, D, H, W, C)
// bf16 activations, f32 accumulation, bf16 output (B, D, H, W, Cout): the
// kernel of conv3x3_ndhwc.cu, which replaces
// runet_tpu/kernels/attic/conv3d.py::_conv_kernel. An mma.sync (m16n8k16
// bf16) implicit GEMM: M = output voxels, N = Cout, K = 27 taps x 16-channel
// chunks.
//
// Tiles: row 1's three (conv3x3_stats.cuh), picked by the launcher. A block
// of 8 warps owns one output depth d of one sample, TH rows x TW columns x
// CO_T output channels:
//   Wide64 (W > 16, Cout_pad % 64 == 0): 8 x 32 x 64; warp w computes row w
//          as 2 m16 tiles x 8 n8 tiles;
//   Wide32 (W > 16, Cout_pad % 64 == 32): 8 x 32 x 32, 2 m16 x 4 n8 a warp;
//   Narrow (W <= 16): 16 x 16 x 32; warp w computes rows 2w and 2w + 1, one
//          m16 tile each, x 4 n8 tiles.
//
// Phases. A phase is one (16-channel chunk c0, kd) pair: c0 ascending, then
// kd = 0, 1, 2. A stage holds the phase's input plane d - 1 + kd over the
// (TH + 2) x (TW + 2) halo, 16 channels (32 bytes) a position, and the 9
// (kh, kw) taps of that kd for the block's CO_T channels, 32 bytes a (tap,
// cout) row. NSTAGES = 2 stages form a ring, each with its own mbarrier.
//
// Copies. Where C % 8 == 0 and x is 16-byte aligned (every launch of the
// kernel bench), thread 0 fills a stage with two TMA tensor copies that
// complete on the stage's mbarrier: the halo plane, one box of {16, TW + 2,
// TH + 2, 1, 1} of x seen as a rank-5 tensor (C, W, H, D, B) at (c0, w0 - 1,
// h0 - 1, d - 1 + kd, b), and the taps, one box of {16, CO_T, 9} of the
// packed (27, Cout_pad, Cin_pad) weights at (c0, co0, 9 kd). The TMA unit
// zero-fills what lies outside the tensor, at negative coordinates and past
// C: that is the SAME padding, so no thread does bounds arithmetic. Per
// phase ph: every thread waits on stage ph % NSTAGES's mbarrier (parity ph /
// NSTAGES % 2); the 9 taps' MMAs; __syncthreads (the stage has been read);
// thread 0 arms the stage for phase ph + NSTAGES and issues its two copies.
// Otherwise (the element-load instance) the weights still come by TMA, and
// the threads fill the halo plane with masked element loads into the same
// cells, one phase ahead, before the __syncthreads that publishes it. Both
// put the same bits where a fragment reads them.
//
// Shared layout. Both maps use CU_TENSOR_MAP_SWIZZLE_32B: a position's or a
// weight row's 32 bytes are dense, and the unit swaps their 16-byte halves
// where bit 7 of the address is set (row r's half j lies at 32 r + 16 (j ^
// (r / 4 % 2))). Every stage region starts on a 1024-byte boundary (the
// dynamic shared base is rounded up to one at run time), so the pattern is
// that of the region's own offsets. The 8 rows of an ldmatrix phase (8
// consecutive positions or weight rows, one 16-byte half each) then fall on
// 32 distinct banks.
//
// Fragments: convk::ldmatrix_x4 at the swizzled addresses, one per m16 tile
// per tap (A) and one per pair of n8 tiles (B), the registers that 32-bit
// loads of the mma's fragment layout would fill: 0.375 (Wide64) or 0.5
// (Wide32, Narrow) shared-load instructions per MMA.
//
// Bits. Every accumulator receives its k-steps in the order c0, kd, kh, kw,
// one mma.m16n8k16 per tap on the same 16 channels, A[m][k] the input at
// column w0 + m + kw - 1, channel c0 + k, zero outside the extent and past
// C; B[k][n] the weight of tap (kd, kh, kw), output channel co0 + n, input
// channel c0 + k. So y does not depend on the tile or the instance, and
// equals that of the synchronous 8 x 32 x 32 kernel this design replaced
// (and conv3x3_ndhwc_stats.cu's) bit for bit. The epilogue rounds each
// accumulator to bf16 once (convk::store_tile, no moments).
//
// What bounds it on the H100: tensor-core throughput (2*27*C*Cout FLOP per
// output voxel; ~27*Cout*2 FLOP per input byte at the attic's widths, far
// above the ~295 FLOP/byte ridge). Bytes copied per MMA: 25.5 (Wide64),
// 34.9 (Wide32), 34.0 (Narrow); the copies cost the MMA warps no
// instructions where TMA fills the halo.
#pragma once

#include "conv3x3_common.cuh"

// The phases the kernel runs: 1 the halo copies, 2 the weight copies, 4 the
// MMAs. A build that leaves one out computes a wrong y; it exists only to
// time the phase's share (utils/phase_probe.py --kernel conv3d).
#ifndef CONV3D_PHASES
#define CONV3D_PHASES 7
#endif

namespace ndhwc {

using convk::bf16;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int KC = 16;        // input channels per chunk (MMA K)
constexpr int CO_T = 32;      // the packed weights' Cout multiple (conv_common.COUT_TILE)
constexpr int ALIGN = 1024;   // bytes: every stage region starts on such a boundary
constexpr int NSTAGES = 2;    // the ring's stages

template <int TH_, int TW_, int CO_T_>
struct Tile : convk::Tile9<TH_, TW_, CO_T_, NWARPS> {
  using G = convk::Tile9<TH_, TW_, CO_T_, NWARPS>;
  static constexpr int X_BYTES = G::NPOS * KC * 2;         // a halo plane's box
  static constexpr int W_BYTES = 9 * G::CO_T * KC * 2;     // a kd plane's taps' box
  static constexpr int SMEM_X = convk::round_up(X_BYTES, ALIGN);
  static constexpr int STAGE = SMEM_X + convk::round_up(W_BYTES, ALIGN);  // bytes
  static constexpr int SMEM_BYTES = NSTAGES * STAGE + ALIGN;  // + the base's rounding
  static_assert(G::XC <= 256 && G::TH + 2 <= 256 && G::CO_T <= 256, "TMA box extents");
};
using Wide64 = Tile<8, 32, 64>;   // W > 16, Cout_pad % 64 == 0
using Wide32 = Tile<8, 32, 32>;   // W > 16, Cout_pad % 64 == 32
using Narrow = Tile<16, 16, 32>;  // W <= 16

// The byte offset of 16-byte half j of 32-byte row r in a swizzled region.
__device__ __forceinline__ int swz(int r, int j) { return 32 * r + 16 * (j ^ ((r >> 2) & 1)); }

// Element-load instance: fill halo plane dd into xs (row r = position
// (row, col) of the halo, row-major over TW + 2 columns), zero outside the
// extent and past channel C, in the cells the TMA copy would fill. An item
// is 8 channels of one position.
template <class T>
__device__ __forceinline__ void fill_plane(unsigned char* __restrict__ xs,
                                           const bf16* __restrict__ xb, int D, int H, int W,
                                           int C, int dd, int h0, int w0, int c0) {
  const bool d_ok = (unsigned)dd < (unsigned)D;
  for (int e = threadIdx.x; e < 2 * T::NPOS; e += NTHREADS) {
    const int half = e & 1, pos = e >> 1;
    const int row = pos / T::XC, col = pos - row * T::XC;
    const int hh = h0 + row, ww = w0 + col, cb = c0 + half * 8;
    const bool ok = d_ok && (unsigned)hh < (unsigned)H && (unsigned)ww < (unsigned)W && cb < C;
    const bf16* src = ok ? xb + (((int64_t)dd * H + hh) * W + ww) * C + cb : xb;
    *reinterpret_cast<uint4*>(xs + swz(pos, half)) =
        ok ? convk::ld_chunk<false>(src, cb, C) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The 9 (kh, kw) taps of one staged phase: acc[mt][nt] += A * B, where m16
// tile mt of warp `warp` is output row warp * RPW + mt / MPR of the tile,
// columns (mt % MPR) * 16 + 0..15; A[m][k] is halo position (row + kh, col +
// m + kw), channel k, of xs; B[k][n] the weight of tap (kh, kw), output
// channel n, input channel k, of ws (row (kh * 3 + kw) * CO_T + n). Lane l
// supplies A's row m = l % 8 + 8 (l / 8 % 2), half l / 16, and B's row n = l
// % 8 + 8 (l / 16) of an n8 pair, half l / 8 % 2. A tap's A fragments are
// held while its B fragments come a pair of n8 tiles at a time.
template <class T>
__device__ __forceinline__ void mma_9taps(float (&acc)[T::MT][T::NT][4],
                                          const unsigned char* __restrict__ xs,
                                          const unsigned char* __restrict__ ws, int warp,
                                          int lane) {
  const int am = (lane & 7) + ((lane >> 3) & 1) * 8, ah = lane >> 4;
  const int bn = (lane & 7) + (lane >> 4) * 8;
  // Row n8-pair * 16 + bn has bn's swizzle bit: 16 rows are 512 bytes.
  const int boff = swz(bn, (lane >> 3) & 1);
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      uint32_t a[T::MT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        const int row = warp * T::RPW + mt / T::MPR, col = (mt % T::MPR) * 16;
        const int pos = (row + kh) * T::XC + col + am + kw;
        convk::ldmatrix_x4(a[mt], reinterpret_cast<const bf16*>(xs + swz(pos, ah)));
      }
#pragma unroll
      for (int np = 0; np < T::NT / 2; ++np) {
        uint32_t b[4];
        convk::ldmatrix_x4(b, reinterpret_cast<const bf16*>(
                                  ws + ((kh * 3 + kw) * T::CO_T + np * 16) * 32 + boff));
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) convk::mma_16816(acc[mt][2 * np], a[mt], b0);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) convk::mma_16816(acc[mt][2 * np + 1], a[mt], b1);
      }
    }
  }
}

// grid: (ceil(H/TH) * ceil(W/TW), D, B * Cout_pad / CO_T). TMA: the halo
// plane by tmx (VEC only) and the taps by tmw; otherwise element loads of
// the halo. Two blocks per SM hold a thread to 128 registers.
template <class T, bool VEC>
__global__ void __launch_bounds__(NTHREADS, 2)
conv3x3_ndhwc_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, int D, int H, int W,
                     int C, int Cout, int Cin_pad, int n_wtiles, int n_cotiles,
                     const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t full[NSTAGES];
  unsigned char* const stages =
      smem_raw + ((ALIGN - convk::smem_addr(smem_raw) % ALIGN) % ALIGN);

  const int ht = blockIdx.x / n_wtiles, wtile = blockIdx.x % n_wtiles;
  const int d = blockIdx.y;
  const int b = blockIdx.z / n_cotiles, cot = blockIdx.z % n_cotiles;
  const int h0 = ht * T::TH, w0 = wtile * T::TW, co0 = cot * T::CO_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  constexpr bool X_TMA = VEC && (CONV3D_PHASES & 1) != 0;
  constexpr uint32_t TX =
      (X_TMA ? T::X_BYTES : 0) + ((CONV3D_PHASES & 2) != 0 ? T::W_BYTES : 0);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NSTAGES; ++i) convk::mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Thread 0: arm stage ph % NSTAGES and issue phase ph's TMA copies into it.
  auto load = [&](int ph) {
    const int c0 = ph / 3 * KC, kd = ph % 3;
    unsigned char* stage = stages + ph % NSTAGES * T::STAGE;
    uint64_t* bar = &full[ph % NSTAGES];
    convk::mbar_expect_tx(bar, TX);
    if constexpr (X_TMA) convk::tma_load_5d(stage, &tmx, bar, c0, w0 - 1, h0 - 1, d - 1 + kd, b);
    if constexpr ((CONV3D_PHASES & 2) != 0)
      convk::tma_load_3d(stage + T::SMEM_X, &tmw, bar, c0, co0, 9 * kd);
  };
  // Element-load instance: every thread fills phase ph's halo plane.
  const bf16* xb = x + (int64_t)b * D * H * W * C;
  auto fill = [&](int ph) {
    if constexpr (!VEC && (CONV3D_PHASES & 1) != 0)
      fill_plane<T>(stages + ph % NSTAGES * T::STAGE, xb, D, H, W, C, d - 1 + ph % 3, h0 - 1,
                    w0 - 1, ph / 3 * KC);
  };

  const int n_phases = 3 * (Cin_pad / KC);
  if (threadIdx.x == 0) {
    for (int ph = 0; ph < NSTAGES && ph < n_phases; ++ph) load(ph);
  }
  if constexpr (!VEC) {
    fill(0);
    __syncthreads();  // phase 0's halo plane is published
  }
  for (int ph = 0; ph < n_phases; ++ph) {
    if constexpr (!VEC) {
      if (ph + 1 < n_phases) fill(ph + 1);  // its stage was last read before the barrier
    }
    // Phase ph's copies have landed: the (ph / NSTAGES)-th completion of its stage's barrier.
    convk::mbar_wait(&full[ph % NSTAGES], ph / NSTAGES & 1);
    if constexpr ((CONV3D_PHASES & 4) != 0) {
      const unsigned char* stage = stages + ph % NSTAGES * T::STAGE;
      mma_9taps<T>(acc, stage, stage + T::SMEM_X, warp, lane);
    }
    if (ph + 1 < n_phases && (!VEC || ph + NSTAGES < n_phases)) {
      __syncthreads();  // phase ph's stage has been read (and phase ph + 1's plane filled)
      if (threadIdx.x == 0 && ph + NSTAGES < n_phases) load(ph + NSTAGES);
    }
  }

  // Row by row of the warp, convk::store_tile's epilogue without moments.
  bf16* ybase = y + ((int64_t)b * D + d) * H * W * Cout;
#pragma unroll
  for (int r = 0; r < T::RPW; ++r) {
    float part[T::MPR][T::NT][4];
#pragma unroll
    for (int m = 0; m < T::MPR; ++m)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[m][nt][i] = acc[r * T::MPR + m][nt][i];
    const int h = h0 + warp * T::RPW + r;
    convk::store_tile<T::MPR, T::NT, NWARPS, false>(
        part, ybase, 1, (int64_t)W * Cout, Cout, W, h, h < H, w0, co0, Cout, nullptr, nullptr,
        nullptr, nullptr, 0, 0);
  }
}

// The TMA map of x (B, D, H, W, C) bf16 (C % 8 == 0, 16-byte aligned) as a
// rank-5 tensor (C, W, H, D, B), boxes of T's halo plane: {16, TW + 2, TH +
// 2, 1, 1}, 32-byte swizzle, zero outside. Returns a cudaError_t.
template <class T>
static int x_map(CUtensorMap* map, const void* x, int B, int D, int H, int W, int C) {
  convk::EncodeTiled encode;
  const int e = convk::tensor_map_encoder(&encode);
  if (e != 0) return e;
  const cuuint64_t dims[5] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D,
                              (cuuint64_t)B};
  const cuuint64_t pos = (cuuint64_t)C * 2;  // bytes
  const cuuint64_t strides[4] = {pos, pos * W, pos * W * H, pos * W * H * D};
  const cuuint32_t box[5] = {KC, (cuuint32_t)T::XC, (cuuint32_t)(T::TH + 2), 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The TMA map of the packed weights (27, Cout_pad, Cin_pad) bf16 as a
// rank-3 tensor (Cin_pad, Cout_pad, 27), boxes of one kd plane's taps for
// T's channels: {16, CO_T, 9}, 32-byte swizzle. Returns a cudaError_t.
template <class T>
static int w_map(CUtensorMap* map, const void* wt, int Cin_pad, int Cout_pad) {
  if (reinterpret_cast<uintptr_t>(wt) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  convk::EncodeTiled encode;
  const int e = convk::tensor_map_encoder(&encode);
  if (e != 0) return e;
  const cuuint64_t dims[3] = {(cuuint64_t)Cin_pad, (cuuint64_t)Cout_pad, 27};
  const cuuint64_t row = (cuuint64_t)Cin_pad * 2;  // bytes
  const cuuint64_t strides[2] = {row, row * Cout_pad};
  const cuuint32_t box[3] = {KC, (cuuint32_t)T::CO_T, 9};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(wt),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The launchers have internal linkage: a static local of an inline or
// template function with external linkage is one object per process
// (STB_GNU_UNIQUE), shared by every library built from this header.
template <class T, bool VEC>
static int launch_tile(const bf16* x, const bf16* wt, bf16* y, int B, int D, int C, int H, int W,
                       int Cout, int Cin_pad, int Cout_pad, cudaStream_t st) {
  static bool attr_done = false;
  if (!attr_done) {
    cudaError_t e = cudaFuncSetAttribute(conv3x3_ndhwc_kernel<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(conv3x3_ndhwc_kernel<T, VEC>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    attr_done = true;
  }
  CUtensorMap tmx{}, tmw{};
  int e = w_map<T>(&tmw, wt, Cin_pad, Cout_pad);
  if (e == 0 && VEC) e = x_map<T>(&tmx, x, B, D, H, W, C);
  if (e != 0) return e;
  const int nh = (H + T::TH - 1) / T::TH, nw = (W + T::TW - 1) / T::TW;
  const int nco = Cout_pad / T::CO_T;
  dim3 grid(nh * nw, D, B * nco);
  conv3x3_ndhwc_kernel<T, VEC><<<grid, NTHREADS, T::SMEM_BYTES, st>>>(
      x, y, D, H, W, C, Cout, Cin_pad, nw, nco, tmx, tmw);
  return (int)cudaGetLastError();
}

// Launch the conv kernel on `stream`: the tile that W and Cout_pad select,
// the TMA halo copies where C % 8 == 0 and x is 16-byte aligned. Returns
// cudaGetLastError(), or the error of a tensor map that could not be made.
static int launch(const void* x, const void* wt, void* y, int B, int D, int C, int H, int W,
                  int Cout, int Cin_pad, int Cout_pad, void* stream) {
  typedef int (*Launch)(const bf16*, const bf16*, bf16*, int, int, int, int, int, int, int, int,
                        cudaStream_t);
  static const Launch table[3][2] = {
      {launch_tile<Narrow, false>, launch_tile<Narrow, true>},
      {launch_tile<Wide32, false>, launch_tile<Wide32, true>},
      {launch_tile<Wide64, false>, launch_tile<Wide64, true>}};
  const int tile = W <= 16 ? 0 : Cout_pad % 64 == 0 ? 2 : 1;
  const bool vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return table[tile][vec](static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
                          static_cast<bf16*>(y), B, D, C, H, W, Cout, Cin_pad, Cout_pad,
                          reinterpret_cast<cudaStream_t>(stream));
}

}  // namespace ndhwc
