// The kernel of conv3x3_ndhwc_stats.cu: the stride-1 3x3x3 SAME convolution
// of channel-innermost (B, D, H, W, C) bf16 activations with the moments of
// its bf16-ROUNDED output, as an mma.sync (m16n8k16 bf16) implicit GEMM:
// M = output voxels, N = Cout, K = 27 taps x 16-channel chunks.
//
// Tiles. A block of 8 warps owns one output depth d of one sample, TH output
// rows by TW columns, and CO_T output channels. The launcher picks the tile
// from W:
//   W > 16:  Wide   = 8 rows x 32 columns x 64 channels; warp w computes row
//            w as 2 m16 tiles (columns 0-15 and 16-31) x 8 n8 tiles;
//   W <= 16: Narrow = 16 rows x 16 columns x 32 channels; warp w computes
//            rows 2w and 2w + 1, one m16 tile each, x 4 n8 tiles.
// 64 channels stage each halo once for twice the output channels of a
// 32-channel tile; at W <= 16 no m16 tile runs on columns past W = 16.
//
// Staging. A phase is one (16-channel chunk c0, kd) pair: c0 ascending, then
// kd = 0, 1, 2. A stage holds the phase's input plane d - 1 + kd over the
// (TH + 2) x (TW + 2) halo, 16 channels a position at stride XS = 24, and the
// 9 (kh, kw) taps of that kd for the block's CO_T channels at stride WS = 24.
// Two stages form a cp.async ring. Per phase every thread waits for its own
// copies; one __syncthreads makes every thread's copies, and the end of the
// previous phase's MMAs, visible to all; the next phase's copies are issued
// into the other stage; the 9 taps run on this one. Each 8-channel half of a
// position and each 16-byte half of a weight row is one 16-byte cp.async,
// zero-filled (src-size 0) outside D, H or W, past C and past Cout_pad.
// Without VEC (C % 8 != 0, or x not 16-byte aligned) a halo half is 8
// masked element loads stored into the same cells; the weights are copied
// as with VEC.
//
// Bits. Every accumulator receives its k-steps in the order c0, kd, kh, kw,
// one mma.m16n8k16 per tap on the same 16 channels (A[m][k] the input at
// column w0 + m + kw - 1, channel c0 + k), as conv3x3_ndhwc.cu's do, so y
// equals that kernel's bit for bit. The Wide tile's moment slots
// are one per (d, 8-row tile, 32-column tile), folded in store_tile's order,
// so its sums and sqs are those of an 8 x 32 tile epilogue; the Narrow
// tile folds two rows per warp into each slot, another f32 order.
//
// What bounds it on the H100: tensor-core throughput (2*27*C*Cout FLOP per
// output voxel, C >= 128 at the deep levels it was written for). Staged
// bytes per MMA: 25.4 (Wide), 34.0 (Narrow); shared-memory fragment loads
// per MMA: 1.5 (Wide), 2.0 (Narrow, every one feeding a real column).
#pragma once

#include "conv3x3_common.cuh"

// The phases the kernel runs: 1 the halo copies, 2 the weight copies, 4 the
// MMAs. A build that leaves one out computes a wrong y; it exists only to
// time the phase's share (utils/phase_probe.py --kernel v3).
#ifndef V3_PHASES
#define V3_PHASES 7
#endif

namespace v3 {

using convk::bf16;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int KC = 16;        // input channels per chunk (MMA K)
constexpr int XS = 24;        // shared stride (bf16) of one staged position
constexpr int WS = 24;        // shared stride (bf16) of one (tap, cout) weight row
constexpr int COUT_PAD = 32;  // the packed weights' Cout multiple (conv_common.COUT_TILE)

template <int TH_, int TW_, int CO_T_>
struct Tile : convk::Tile9<TH_, TW_, CO_T_, NWARPS> {
  using G = convk::Tile9<TH_, TW_, CO_T_, NWARPS>;
  static constexpr int SMEM_X = G::NPOS * XS;        // bf16 of a stage's halo
  static constexpr int SMEM_W = 9 * G::CO_T * WS;    // bf16 of a stage's weights
  static constexpr int STAGE = SMEM_X + SMEM_W;      // bf16 per stage
  static constexpr int SMEM_BYTES = 2 * STAGE * 2;
  static_assert((SMEM_X * 2) % 16 == 0 && (STAGE * 2) % 16 == 0, "16-byte copy targets");
};
using Wide = Tile<8, 32, 64>;    // W > 16
using Narrow = Tile<16, 16, 32>;  // W <= 16

// Stage halo plane dd: xs[(row * XC + col) * XS + ci] = x[dd, h0 + row,
// w0 + col, c0 + ci] (h0, w0: the halo's first row and column), zero outside
// the extent and past channel C. An item is 8 channels of one position.
template <class T, bool VEC>
__device__ __forceinline__ void stage_plane(bf16* __restrict__ xs, const bf16* __restrict__ xb,
                                            int D, int H, int W, int C, int dd, int h0, int w0,
                                            int c0) {
  const bool d_ok = (unsigned)dd < (unsigned)D;
  for (int e = threadIdx.x; e < 2 * T::NPOS; e += NTHREADS) {
    const int half = e & 1, pos = e >> 1;
    const int row = pos / T::XC, col = pos - row * T::XC;
    const int hh = h0 + row, ww = w0 + col, cb = c0 + half * 8;
    const bool ok = d_ok && (unsigned)hh < (unsigned)H && (unsigned)ww < (unsigned)W && cb < C;
    const bf16* src = ok ? xb + (((int64_t)dd * H + hh) * W + ww) * C + cb : xb;
    bf16* dst = xs + pos * XS + half * 8;
    if constexpr (VEC)
      convk::cp_async16_zfill(dst, src, ok);
    else
      *reinterpret_cast<uint4*>(dst) =
          ok ? convk::ld_chunk<false>(src, cb, C) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Store the warp's accumulators as bf16 y and fold the ROUNDED values into
// the block's moment partials in store_tile's order: per thread over mt,
// then r; an xor-butterfly over the 8 row lanes; warps summed in index
// order. Channel co0 + j's partial goes to psum[pbase + j * nblk] (and psq)
// for co0 + j < Cout_pad only. Every thread of the block calls it.
template <class T>
__device__ __forceinline__ void store_moments(
    const float (&acc)[T::MT][T::NT][4], bf16* __restrict__ yd, int H, int W, int Cout,
    int Cout_pad, int h0, int w0, int co0, float (*red_s)[T::CO_T], float (*red_q)[T::CO_T],
    float* __restrict__ psum, float* __restrict__ psq, int64_t pbase, int64_t nblk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float s[T::NT][2], q[T::NT][2];
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) s[nt][0] = s[nt][1] = q[nt][0] = q[nt][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
    const int h = h0 + warp * T::RPW + mt / T::MPR;
    const int wm = w0 + (mt % T::MPR) * 16 + g;
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int w = wm + (r >= 2 ? 8 : 0);
        const int co = co0 + nt * 8 + 2 * t + (r & 1);
        if (h < H && w < W && co < Cout) {
          const bf16 v = __float2bfloat16_rn(acc[mt][nt][r]);
          yd[((int64_t)h * W + w) * Cout + co] = v;
          const float f = __bfloat162float(v);
          s[nt][r & 1] += f;
          q[nt][r & 1] += f * f;
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s[nt][j] += __shfl_xor_sync(0xffffffffu, s[nt][j], off);
        q[nt][j] += __shfl_xor_sync(0xffffffffu, q[nt][j], off);
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        red_s[warp][nt * 8 + 2 * t + j] = s[nt][j];
        red_q[warp][nt * 8 + 2 * t + j] = q[nt][j];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < T::CO_T && co0 + (int)threadIdx.x < Cout_pad) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int wp = 0; wp < NWARPS; ++wp) {
      ts += red_s[wp][threadIdx.x];
      tq += red_q[wp][threadIdx.x];
    }
    psum[pbase + (int64_t)threadIdx.x * nblk] = ts;
    psq[pbase + (int64_t)threadIdx.x * nblk] = tq;
  }
}

// grid: (ceil(H/TH) * ceil(W/TW), D, B * ceil(Cout_pad/CO_T)); psum/psq:
// (B, Cout_pad, nblk) f32 with nblk = D * ceil(H/TH) * ceil(W/TW). Two
// blocks per SM hold a thread to 128 registers.
template <class T, bool VEC>
__global__ void __launch_bounds__(NTHREADS, 2)
conv3x3_v3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt, bf16* __restrict__ y,
                  float* __restrict__ psum, float* __restrict__ psq, int D, int H, int W, int C,
                  int Cout, int Cin_pad, int Cout_pad, int n_wtiles, int n_cotiles,
                  int64_t nblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const stages = reinterpret_cast<bf16*>(smem_raw);
  __shared__ float red_s[NWARPS][T::CO_T], red_q[NWARPS][T::CO_T];

  const int ht = blockIdx.x / n_wtiles, wtile = blockIdx.x % n_wtiles;
  const int d = blockIdx.y;
  const int b = blockIdx.z / n_cotiles, cot = blockIdx.z % n_cotiles;
  const int h0 = ht * T::TH, w0 = wtile * T::TW, co0 = cot * T::CO_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* xb = x + (int64_t)b * D * H * W * C;

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
    if constexpr ((V3_PHASES & 1) != 0)
      stage_plane<T, VEC>(stage, xb, D, H, W, C, d - 1 + kd, h0 - 1, w0 - 1, c0);
    if constexpr ((V3_PHASES & 2) != 0)
      convk::stage_weights_kd<NTHREADS, T::CO_T, WS>(stage + T::SMEM_X, wt, Cout_pad, Cin_pad,
                                                      co0, c0, kd);
  };

  const int n_phases = 3 * (Cin_pad / KC);
  issue(0);
  convk::cp_async_commit();
  for (int ph = 0; ph < n_phases; ++ph) {
    convk::cp_async_wait<0>();
    __syncthreads();  // phase ph has landed; phase ph - 1's stage has been read
    if (ph + 1 < n_phases) issue(ph + 1);
    convk::cp_async_commit();
    if constexpr ((V3_PHASES & 4) != 0) {
      const bf16* stage = stages + (ph & 1) * T::STAGE;
      convk::mma_9taps<T, XS, WS>(acc, stage, stage + T::SMEM_X, warp, g, t);
    }
  }

  const int64_t blk = (int64_t)d * gridDim.x + blockIdx.x;
  store_moments<T>(acc, y + ((int64_t)b * D + d) * H * W * Cout, H, W, Cout, Cout_pad, h0, w0,
                   co0, red_s, red_q, psum, psq, ((int64_t)b * Cout_pad + co0) * nblk + blk,
                   nblk);
}

template <class T>
static long long tile_nblk(int D, int H, int W) {
  return (long long)D * ((H + T::TH - 1) / T::TH) * ((W + T::TW - 1) / T::TW);
}

// Moment partials per (sample, channel) for a (D, H, W) output: one per block
// of the tile that W selects.
static long long nblk(int D, int H, int W) {
  return W > 16 ? tile_nblk<Wide>(D, H, W) : tile_nblk<Narrow>(D, H, W);
}

// The launchers have internal linkage: a static local of an inline or
// template function with external linkage is one object per process
// (STB_GNU_UNIQUE), shared by every library built from this header.
template <class T, bool VEC>
static int launch_tile(const bf16* x, const bf16* wt, bf16* y, float* psum, float* psq, int B,
                       int D, int C, int H, int W, int Cout, int Cin_pad, int Cout_pad,
                       cudaStream_t st) {
  static bool attr_done[convk::MAX_DEVICES] = {};
  if (int e = convk::set_smem_attrs(conv3x3_v3_kernel<T, VEC>, T::SMEM_BYTES, attr_done))
    return e;
  const int nh = (H + T::TH - 1) / T::TH, nw = (W + T::TW - 1) / T::TW;
  const int nco = (Cout_pad + T::CO_T - 1) / T::CO_T;
  dim3 grid(nh * nw, D, B * nco);
  conv3x3_v3_kernel<T, VEC><<<grid, NTHREADS, T::SMEM_BYTES, st>>>(
      x, wt, y, psum, psq, D, H, W, C, Cout, Cin_pad, Cout_pad, nw, nco, tile_nblk<T>(D, H, W));
  return (int)cudaGetLastError();
}

// Launch the conv kernel and the moment reduction on `stream`. psum/psq:
// (B, Cout_pad, nblk(D, H, W)) f32 scratch; sums/sqs: (B, Cout) f32. x takes
// the 16-byte copies when C % 8 == 0 and x is 16-byte aligned. Returns
// cudaGetLastError().
static int launch(const void* x, const void* wt, void* y, void* psum, void* psq, void* sums,
                  void* sqs, int B, int D, int C, int H, int W, int Cout, int Cin_pad,
                  int Cout_pad, void* stream) {
  typedef int (*Launch)(const bf16*, const bf16*, bf16*, float*, float*, int, int, int, int, int,
                        int, int, int, cudaStream_t);
  static const Launch table[2][2] = {
      {launch_tile<Narrow, false>, launch_tile<Narrow, true>},
      {launch_tile<Wide, false>, launch_tile<Wide, true>}};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int e = table[W > 16][vec](static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
                                   static_cast<bf16*>(y), static_cast<float*>(psum),
                                   static_cast<float*>(psq), B, D, C, H, W, Cout, Cin_pad,
                                   Cout_pad, st);
  if (e != cudaSuccess) return e;
  convk::reduce_moments<<<dim3(Cout, B), 256, 0, st>>>(
      static_cast<const float*>(psum), static_cast<const float*>(psq),
      static_cast<float*>(sums), static_cast<float*>(sqs), nblk(D, H, W), Cout, Cout_pad);
  return (int)cudaGetLastError();
}

}  // namespace v3
