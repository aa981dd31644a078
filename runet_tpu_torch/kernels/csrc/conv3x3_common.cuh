// Shared pieces of the 3x3x3 conv kernels (conv3x3_stats{,_v2,_v1}.cu,
// conv3x3_s2_stats.cu, the NDHWC kernels of conv3x3_ndhwc{,_stats}.cuh, and
// the dw kernels through conv3x3_dw_common.cuh): the 16-byte chunk load
// along W, cp.async, the bf16 tensor-core MMA and ldmatrix (plain and
// transposing); the mbarriers and TMA tensor copies of the kernels that
// fill their stages by TMA (conv3x3_dw_s2.cuh, conv3x3_ndhwc.cuh) and the
// tensor-map encoder; for the kernels that stage one (chunk, kd
// plane) phase at a time (conv3x3_stats{,_v2}.cuh, conv3x3_ndhwc{,_stats}.cuh)
// their tile, the copies of a plane's 9 taps of weights and the 9-tap MMA
// loop; the epilogue that rounds the output to bf16 and folds it into
// per-block moment partials, and the second pass that reduces those
// partials (also the instance-norm statistics' second pass).
//
// Moments are deterministic: each block writes its per-channel partial sums
// to a scratch slot of its own (fixed-order in-block reduction: per-thread
// sums, an xor-butterfly over the 8 row lanes, then warps summed in index
// order), and reduce_moments sums the slots of one (sample, channel) in a
// fixed order. No float atomics, so a run gives the same bits every time.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace convk {

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 8 bf16 at src, columns w..w+7 of a row of n, as one uint4; zero past n.
// VEC: n % 8 == 0 and src 16-byte aligned, so the chunk is wholly in or out.
template <bool VEC>
__device__ __forceinline__ uint4 ld_chunk(const bf16* __restrict__ src, int w, int n) {
  if constexpr (VEC) {
    return w < n ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
  } else {
    unsigned short h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      h[j] = w + j < n ? __bfloat16_as_ushort(src[j]) : (unsigned short)0;
    return make_uint4(h[0] | ((unsigned)h[1] << 16), h[2] | ((unsigned)h[3] << 16),
                      h[4] | ((unsigned)h[5] << 16), h[6] | ((unsigned)h[7] << 16));
  }
}

// cp.async: a copy from global to shared memory that the issuing thread does
// not wait for. commit closes the copies it has issued so far into a group;
// cp_async_wait<N> returns once at most N of its groups are still in flight.
// The copies are visible to the other threads after the wait and a barrier.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// 16 bytes from gmem, or 16 zero bytes when !ok (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes from gmem, or 4 zero bytes when !ok; smem and gmem 4-byte aligned.
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

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

// Four 8x8 bf16 matrices from shared memory as they are stored: lane l
// supplies the 16-byte-aligned address of row (l % 8) of matrix (l / 8), and
// register j of lane (g = l / 4, t = l % 4) holds row g, columns 2t..2t+1 of
// matrix j. With the matrices stored row-major (m rows, 8 contiguous k) the
// four registers are the A fragment of mma_16816 when matrix 0 holds (m 0-7,
// k 0-7), 1 (m 8-15, k 0-7), 2 (m 0-7, k 8-15), 3 (m 8-15, k 8-15); stored
// n-major (n rows, 8 contiguous k), registers 0-1 and 2-3 are the B
// fragments of two n8 tiles when matrix 0 holds (n 0-7, k 0-7), 1 (n 0-7, k
// 8-15), 2 (n 8-15, k 0-7), 3 (n 8-15, k 8-15).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// The mbarrier of a stage: thread 0 arms it for a stage's bytes, the TMA
// copies complete it, every thread waits for its phase.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the mbarrier's phase of the given parity has completed; a copy
// that never lands traps (a launch error) after ~2^26 polls.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (long long polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1LL << 26)) __trap();
  }
}

// One TMA tensor copy of the box at (c0, .., c4) of a rank-5 map into dst.
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// One TMA tensor copy of the box at (c0, c1, c2) of a rank-3 map into dst.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no link against
// libcuda), into *encode. Returns a cudaError_t.
static int tensor_map_encoder(EncodeTiled* encode) {
  static EncodeTiled fn_ = nullptr;
  if (fn_ == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorNotSupported;
    fn_ = reinterpret_cast<EncodeTiled>(fn);
  }
  *encode = fn_;
  return 0;
}

// The tile of a kernel that stages one (16-channel chunk, kd plane) phase at
// a time (conv3x3_stats.cuh, conv3x3_ndhwc{,_stats}.cuh): a block of NWARPS
// warps owns TH output rows x TW columns x CO_T output channels; warp w
// computes rows w * RPW .. + RPW - 1, each as MPR m16 tiles of 16 columns,
// by NT n8 tiles. The staged halo plane is (TH + 2) x XC positions.
template <int TH_, int TW_, int CO_T_, int NWARPS_>
struct Tile9 {
  static constexpr int TH = TH_, TW = TW_, CO_T = CO_T_, NWARPS = NWARPS_;
  static constexpr int MPR = TW / 16;         // m16 tiles per output row
  static constexpr int RPW = TH / NWARPS;     // output rows per warp
  static constexpr int MT = MPR * RPW;        // m16 tiles per warp
  static constexpr int NT = CO_T / 8;         // n8 tiles per warp
  static constexpr int XC = TW + 2;           // halo columns
  static constexpr int NPOS = (TH + 2) * XC;  // positions of one halo plane
  static_assert(TW % 16 == 0 && TH % NWARPS == 0 && MT == 2, "two m16 tiles a warp");
};

// Stage the 9 (kh, kw) taps of plane kd by cp.async (commit not included):
// ws[((kh * 3 + kw) * CO_T + co) * WS + ci] = wt[(kd * 3 + kh) * 3 + kw,
// co0 + co, c0 + ci] for 16 input channels, zero past Cout_pad. A thread's
// copies share their channel and 16-byte half and step over the taps, so
// its addresses are one base and one stride.
template <int NTHREADS, int CO_T, int WS>
__device__ __forceinline__ void stage_weights_kd(bf16* __restrict__ ws,
                                                 const bf16* __restrict__ wt, int Cout_pad,
                                                 int Cin_pad, int co0, int c0, int kd) {
  constexpr int TSTEP = NTHREADS / (2 * CO_T);  // taps between a thread's copies
  static_assert(NTHREADS % (2 * CO_T) == 0, "whole taps per step");
  const int half = threadIdx.x & 1, co = (threadIdx.x >> 1) % CO_T;
  const int tap0 = (threadIdx.x >> 1) / CO_T;
  const bool ok = co0 + co < Cout_pad;
  const bf16* src =
      ok ? wt + ((int64_t)(kd * 9 + tap0) * Cout_pad + co0 + co) * Cin_pad + c0 + half * 8 : wt;
  const int64_t sstep = ok ? (int64_t)TSTEP * Cout_pad * Cin_pad : 0;
  bf16* dst = ws + (tap0 * CO_T + co) * WS + half * 8;
#pragma unroll
  for (int tap = tap0; tap < 9; tap += TSTEP) {
    cp_async16_zfill(dst, src, ok);
    src += sstep;
    dst += TSTEP * CO_T * WS;
  }
}

// The 9 (kh, kw) taps of one staged phase of a Tile9 T: acc[mt][nt] += A * B,
// where m16 tile mt of warp `warp` is output row warp * RPW + mt / MPR of the
// tile, columns (mt % MPR) * 16 + 0..15. xs: the halo plane, channel
// innermost (position (row, col) at (row * XC + col) * XS); ws: the taps as
// stage_weights_kd lays them out. A tap's A fragments are held and its B
// fragments loaded one n8 tile at a time. With XS = WS = 24 both fragment
// loads are free of bank conflicts. Each accumulator takes one mma per tap,
// so phases run in the order (c0, kd) give it its k-steps in the order (c0,
// kd, kh, kw), one mma.m16n8k16 per tap on the same 16 channels.
template <class T, int XS, int WS>
__device__ __forceinline__ void mma_9taps(float (&acc)[T::MT][T::NT][4],
                                          const bf16* __restrict__ xs,
                                          const bf16* __restrict__ ws, int warp, int g, int t) {
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      uint32_t a[T::MT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        // A[m][k] = input at halo row row + kh, column col + m + kw, channel k.
        const int row = warp * T::RPW + mt / T::MPR, col = (mt % T::MPR) * 16;
        const bf16* p = xs + ((row + kh) * T::XC + col + g + kw) * XS + 2 * t;
        a[mt][0] = ld32(p);
        a[mt][1] = ld32(p + 8 * XS);
        a[mt][2] = ld32(p + 8);
        a[mt][3] = ld32(p + 8 * XS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        // B[k][n] = weight of tap (kh, kw), output channel n, input channel k.
        const bf16* p = ws + ((kh * 3 + kw) * T::CO_T + nt * 8 + g) * WS + 2 * t;
        const uint32_t b[2] = {ld32(p), ld32(p + 8)};
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) mma_16816(acc[mt][nt], a[mt], b);
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
