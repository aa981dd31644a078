// Shared pieces of the 3x3x3 conv + InstanceNorm-moment kernels
// (conv3x3_stats.cu, conv3x3_stats_v2.cu, conv3x3_stats_v1.cu,
// conv3x3_s2_stats.cu, and the NDHWC kernels of conv3x3_ndhwc.cuh): the
// bf16 tensor-core MMA and the transposing ldmatrix, the staging of a
// chunk's weights, the 27-tap MMA loop over a channel-innermost halo, the
// epilogue that rounds the output to bf16 and folds it into per-block
// moment partials, and the second pass that reduces those partials (also
// the instance-norm statistics' second pass).
//
// Moments are deterministic: each block writes its per-channel partial sums
// to a scratch slot of its own (fixed-order in-block reduction: per-thread
// sums, an xor-butterfly over the 8 row lanes, then warps summed in index
// order), and reduce_moments sums the slots of one (sample, channel) in a
// fixed order. No float atomics, so a run gives the same bits every time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace convk {

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A(16x16, row) * B(16x8, col) + D with bf16 inputs and f32 accumulators.
// Fragment ownership (g = lane / 4, t = lane % 4):
//   a[0]: A[g][2t..2t+1]   a[1]: A[g+8][2t..2t+1]
//   a[2]: A[g][2t+8..+9]   a[3]: A[g+8][2t+8..+9]
//   b[0]: B[2t..2t+1][g]   b[1]: B[2t+8..+9][g]
//   c[0..1]: C[g][2t..2t+1]   c[2..3]: C[g+8][2t..2t+1]
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices from shared memory, each TRANSPOSED on the way into
// the fragment: lane l supplies the 16-byte-aligned address of row (l % 8) of
// matrix (l / 8). With the matrices stored K-major (row = k, 8 contiguous m)
// the four registers are the A fragment of mma_16816 when matrix 0 holds
// (m 0-7, k 0-7), 1 (m 8-15, k 0-7), 2 (m 0-7, k 8-15), 3 (m 8-15, k 8-15).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// Stage one chunk's weights: ws[(tap * CO_T + co) * WS + ci] =
// wt[tap, co0 + co, c0 + ci] for 16 input channels, two 16-byte vectors per
// (tap, cout) row.
template <int NTHREADS, int CO_T, int WS>
__device__ __forceinline__ void stage_weights(bf16* __restrict__ ws, const bf16* __restrict__ wt,
                                              int Cout_pad, int Cin_pad, int co0, int c0) {
  for (int e = threadIdx.x; e < 27 * CO_T * 2; e += NTHREADS) {
    const int half = e & 1, r = e >> 1;
    const int co = r % CO_T, tap = r / CO_T;
    const uint4* src = reinterpret_cast<const uint4*>(
        wt + ((int64_t)tap * Cout_pad + co0 + co) * Cin_pad + c0 + half * 8);
    *reinterpret_cast<uint4*>(ws + (tap * CO_T + co) * WS + half * 8) = *src;
  }
}

// Stage one KC-channel chunk of the input halo into shared memory, channel
// innermost: xs[((kd * XR + row) * XC + col) * XS + ci] =
// x[b, d0 + kd, c0 + ci, h0 + row, w0 + col], zero outside the extent and
// past channel C (the SAME / stride-2 padding and the channel padding).
// Consecutive threads read consecutive w (coalesced). Each thread issues U
// independent loads before it stores any: a load-then-store loop leaves one
// load in flight per thread and is latency-bound.
template <int NTHREADS, int KC, int XR, int XC, int XS>
__device__ __forceinline__ void stage_halo(bf16* __restrict__ xs, const bf16* __restrict__ xb,
                                           int D, int C, int H, int W, int d0, int h0,
                                           int w0, int c0) {
  constexpr int PLANE = XR * XC;  // (row, col) positions per (kd, ci)
  constexpr int NX = 3 * KC * PLANE;
  constexpr int U = 8;
  const int64_t HW = (int64_t)H * W;
  const bf16 zero = __ushort_as_bfloat16((unsigned short)0);
  for (int base = threadIdx.x; base < NX; base += NTHREADS * U) {
    bf16 v[U];
    int off[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * NTHREADS;
      const int q = e / PLANE, p = e - q * PLANE;  // q = kd * KC + ci
      const int row = p / XC, col = p - row * XC;
      const int kd = q / KC, ci = q - kd * KC;
      const int dd = d0 + kd, hh = h0 + row, ww = w0 + col, cc = c0 + ci;
      off[u] = e < NX ? ((kd * XR + row) * XC + col) * XS + ci : -1;
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

// The 27 taps of one staged KC = 16 channel chunk: acc += A * B, where warp
// `warp` computes output row `warp` of the block (halo row S * warp + kh)
// over MT*16 output columns (halo column S * m + kw) and NT*8 output
// channels. xs: the halo as stage_halo lays it out ((kd * XR + row) * XC +
// col) * XS + ci; ws: the chunk's weights as stage_weights lays them out.
// S is the conv stride (1 or 2). With XS = WS = 24 both fragment loads are
// bank-conflict free.
template <int S, int MT, int NT, int XR, int XC, int XS, int CO_T, int WS>
__device__ __forceinline__ void mma_27taps(float (&acc)[MT][NT][4], const bf16* __restrict__ xs,
                                           const bf16* __restrict__ ws, int warp, int g, int t) {
#pragma unroll 1
  for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const bf16* xrow = xs + ((kd * XR + S * warp + kh) * XC) * XS;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int tap = (kd * 3 + kh) * 3 + kw;
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // A[m][k] = input at halo column S * (mt*16 + m) + kw, channel k.
          const bf16* p = xrow + (S * (mt * 16 + g) + kw) * XS + 2 * t;
          a[mt][0] = ld32(p);
          a[mt][1] = ld32(p + S * 8 * XS);
          a[mt][2] = ld32(p + 8);
          a[mt][3] = ld32(p + S * 8 * XS + 8);
        }
        uint32_t bfr[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // B[k][n] = weight of tap, output channel n, input channel k.
          const bf16* p = ws + (tap * CO_T + nt * 8 + g) * WS + 2 * t;
          bfr[nt][0] = ld32(p);
          bfr[nt][1] = ld32(p + 8);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_16816(acc[mt][nt], a[mt], bfr[nt]);
      }
    }
  }
}

// Store one warp's (MT*16 w) x (NT*8 cout) accumulator tile of output row h
// as bf16, and with STATS fold the ROUNDED values into the block's moment
// partials. With STATS every thread of the block must call it (it holds a
// __syncthreads); without, red_s/red_q/psum/psq are not touched.
//   ybase: y at (b, d, channel 0, row 0, column 0); channel stride cstride,
//   row stride hstride, column stride wstride, Wo columns ((D, C, H, W): H*W,
//   W, 1; (D, H, C, W): W, C*W, 1; (D, H, W, C): 1, W*C, C).
//   partial slot of channel co0 + j: psum[pbase + j * nblk].
template <int MT, int NT, int NWARPS, bool STATS = true>
__device__ __forceinline__ void store_tile(
    const float (&acc)[MT][NT][4], bf16* __restrict__ ybase, int64_t cstride, int64_t hstride,
    int64_t wstride, int Wo, int h, bool h_ok, int w0, int co0, int Cout,
    float (*red_s)[NT * 8], float (*red_q)[NT * 8],
    float* __restrict__ psum, float* __restrict__ psq, int64_t pbase, int64_t nblk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float s[NT][2], q[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = q[nt][0] = q[nt][1] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int w = w0 + mt * 16 + g + (r >= 2 ? 8 : 0);
        const int co = co0 + nt * 8 + 2 * t + (r & 1);
        if (h_ok && w < Wo && co < Cout) {
          const bf16 v = __float2bfloat16_rn(acc[mt][nt][r]);
          ybase[(int64_t)co * cstride + (int64_t)h * hstride + (int64_t)w * wstride] = v;
          const float f = __bfloat162float(v);
          s[nt][r & 1] += f;
          q[nt][r & 1] += f * f;
        }
      }
    }
  }
  if constexpr (STATS) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
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
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          red_s[warp][nt * 8 + 2 * t + j] = s[nt][j];
          red_q[warp][nt * 8 + 2 * t + j] = q[nt][j];
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < NT * 8) {
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
}

// The (D, C, H, W) output: channel stride HWo, row stride Wo.
template <int MT, int NT, int NWARPS>
__device__ __forceinline__ void store_tile_and_moments(
    const float (&acc)[MT][NT][4], bf16* __restrict__ ybase, int64_t HWo, int Wo,
    int h, bool h_ok, int w0, int co0, int Cout,
    float (*red_s)[NT * 8], float (*red_q)[NT * 8],
    float* __restrict__ psum, float* __restrict__ psq, int64_t pbase, int64_t nblk) {
  store_tile<MT, NT, NWARPS>(acc, ybase, HWo, Wo, 1, Wo, h, h_ok, w0, co0, Cout, red_s, red_q,
                             psum, psq, pbase, nblk);
}

// Second pass: sums[b, co] = sum over blocks of psum[b, co, :] (and sqs),
// one block of 256 threads per (channel, sample), fixed-order tree.
// psum/psq: (B, Cout_pad, nblk) f32; sums/sqs: (B, Cout) f32.
__global__ void __launch_bounds__(256)
reduce_moments(const float* __restrict__ psum, const float* __restrict__ psq,
               float* __restrict__ sums, float* __restrict__ sqs,
               int64_t nblk, int Cout, int Cout_pad) {
  __shared__ float ss[256], sq[256];
  const int co = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int64_t base = ((int64_t)b * Cout_pad + co) * nblk;
  float s = 0.f, q = 0.f;
  for (int64_t i = tid; i < nblk; i += 256) {
    s += psum[base + i];
    q += psq[base + i];
  }
  ss[tid] = s;
  sq[tid] = q;
  __syncthreads();
  for (int st = 128; st > 0; st >>= 1) {
    if (tid < st) {
      ss[tid] += ss[tid + st];
      sq[tid] += sq[tid + st];
    }
    __syncthreads();
  }
  if (tid == 0) {
    sums[(int64_t)b * Cout + co] = ss[0];
    sqs[(int64_t)b * Cout + co] = sq[0];
  }
}

}  // namespace convk
