// Stride-1 3x3x3 SAME convolution + InstanceNorm moments in the (D, H, C, W)
// layout, as ONE GEMM per output tile over an im2col tile built in shared
// memory: bf16 in/out, f32 accumulation, for Hopper (sm_90a).
//
// Replaces runet_tpu/kernels/fused_block.py::_conv_stats_kernel (v1, the
// Pallas kernel behind conv_in_stats_dhcw_batch). Contract:
//   x  (B, D, H, C, W) bf16, SAME zero padding on D, H and W;
//   wt (27, Cout_pad, Cin_pad) bf16: tap-major, channels zero-padded;
//   y  (B, D, H, Cout, W) bf16, written in that layout by the kernel;
//   sums, sqs (B, Cout) f32 of the bf16-ROUNDED output.
//
// v1's idea, carried to the card: materialise the im2col tile
//   col[k = tap * 16 + ci][v = row * TW + w] =
//       x[d + kd - 1, h0 + row + kh - 1, c0 + ci, w0 + w + kw - 1]
// (K = 27 * 16 = 432 rows per 16-channel chunk, 64 output voxels per block:
// 61 KB), then contract the whole K in one pass of 27 k16 steps with no
// address arithmetic left in the GEMM loop. A layer's full K = 27 * C (8640
// at C = 320) is looped in such chunks. The voxel index is innermost, as W is
// in the tensor, so the copy is coalesced both ways and every A fragment is
// one ldmatrix.x4.trans; the k stride of 72 bf16 (144 B = 16 mod 128) keeps
// its eight rows in distinct bank groups.
//
// Block = one output depth d, TH = 2 rows x TW = 32 columns, CO_T output
// channels; warp i owns row i / 2, columns 16 * (i % 2).. as one m16 tile by
// 4 n8 tiles. The output's (Cout, W)-innermost order makes a fragment's
// eight g-lanes write eight consecutive w of one channel (16 bytes).
// Moments as in conv3x3_stats.cu: from the rounded output, per-block
// partials, reduced in a fixed order, no float atomics.
//
// What bounds it on the H100: operations by the roofline, but this kernel
// pays 27 shared-memory copies of every input element (the im2col build:
// 216 scalar copies per thread per chunk against 108 MMAs per warp), so the
// build, not the tensor cores, sets its time. 104 KB of shared memory a
// block lets two blocks share an SM, one building while the other
// multiplies. Giving each thread one voxel and fixed channels, so that the
// tap loops unroll to constant offsets (no per-element index arithmetic),
// took the level-0 32->32 conv (B 2, 128^3) from 15.6 to 4.5 ms (H100 80GB
// HBM3, 700 W).
#include "conv3x3_common.cuh"

namespace {

using convk::bf16;

constexpr int TH = 2;      // output rows per block
constexpr int TW = 32;     // output columns per block
constexpr int CO_T = 32;   // output channels per block
constexpr int KC = 16;     // input channels per chunk
constexpr int WS = 24;     // shared stride (bf16) of one (tap, cout) weight row
constexpr int NT = CO_T / 8;
constexpr int NWARPS = TH * TW / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int NV = TH * TW;          // voxels per tile
constexpr int KS = NV + 8;           // shared stride (bf16) of one k row
constexpr int KROWS = 27 * KC;       // im2col rows per chunk
constexpr int SMEM_COL = KROWS * KS;
constexpr int SMEM_W = 27 * CO_T * WS;
constexpr int SMEM_BYTES = (SMEM_COL + SMEM_W) * 2;
static_assert(KS % 8 == 0 && (KS * 2) % 128 == 16, "ldmatrix rows: aligned and conflict-free");

// Build the chunk's im2col tile from the tensor (L1/L2 serve the 27-fold
// re-reads). A thread owns one voxel of the tile and CPT of the chunk's
// channels for all 27 taps, so the tap loops unroll to constant offsets and
// the bounds tests hoist out of the channel loop; consecutive threads copy
// consecutive w, and each thread has CPT independent loads in flight before
// it stores any.
__device__ __forceinline__ void build_im2col(bf16* __restrict__ col, const bf16* __restrict__ xb,
                                             int D, int H, int C, int W, int d, int h0,
                                             int w0, int c0) {
  constexpr int CPT = KC * NV / NTHREADS;  // channels per thread
  static_assert(NTHREADS % NV == 0 && CPT * NTHREADS == KC * NV, "threads tile the chunk");
  const int vox = threadIdx.x % NV, cbase = (threadIdx.x / NV) * CPT;
  const int row = vox / TW, j = vox - row * TW;
  const int64_t CW = (int64_t)C * W;
  const bf16 zero = __ushort_as_bfloat16((unsigned short)0);
#pragma unroll 1
  for (int kd = 0; kd < 3; ++kd) {
    const int dd = d + kd - 1;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int hh = h0 + row + kh - 1;
      const bool dh_ok = (unsigned)dd < (unsigned)D && (unsigned)hh < (unsigned)H;
      const int64_t base = ((int64_t)dd * H + hh) * CW + (int64_t)(c0 + cbase) * W;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int ww = w0 + j + kw - 1;
        const bool ok = dh_ok && (unsigned)ww < (unsigned)W;
        bf16 v[CPT];
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          v[i] = zero;
          if (ok && c0 + cbase + i < C) v[i] = xb[base + (int64_t)i * W + ww];
        }
        bf16* dst = col + (((kd * 3 + kh) * 3 + kw) * KC + cbase) * KS + vox;
#pragma unroll
        for (int i = 0; i < CPT; ++i) dst[i * KS] = v[i];
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
conv3x3_stats_v1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                        bf16* __restrict__ y, float* __restrict__ psum,
                        float* __restrict__ psq, int D, int C, int H, int W, int Cout,
                        int Cin_pad, int Cout_pad, int n_wtiles, int n_cotiles,
                        int64_t nblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* col = reinterpret_cast<bf16*>(smem_raw);
  bf16* ws = col + SMEM_COL;
  __shared__ float red_s[NWARPS][CO_T], red_q[NWARPS][CO_T];

  const int ht = blockIdx.x / n_wtiles, wtile = blockIdx.x % n_wtiles;
  const int d = blockIdx.y;
  const int b = blockIdx.z / n_cotiles, cot = blockIdx.z % n_cotiles;
  const int h0 = ht * TH, w0 = wtile * TW, co0 = cot * CO_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = warp / (TW / 16), mt = warp % (TW / 16);
  const bf16* xb = x + (int64_t)b * D * H * C * W;
  // This lane's row of the ldmatrix: matrix lane / 8, k row lane % 8.
  const int lm = lane >> 3;
  const bf16* a_base = col + ((lane & 7) + ((lm >> 1) << 3)) * KS + ((lm & 1) << 3) +
                       row * TW + mt * 16;

  float acc[1][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[0][nt][r] = 0.f;

  for (int c0 = 0; c0 < Cin_pad; c0 += KC) {
    __syncthreads();  // the previous chunk's fragments have been read
    build_im2col(col, xb, D, H, C, W, d, h0, w0, c0);
    convk::stage_weights<NTHREADS, CO_T, WS>(ws, wt, Cout_pad, Cin_pad, co0, c0);
    __syncthreads();

    // One GEMM over the chunk's whole K: 27 k16 steps.
#pragma unroll 3
    for (int ks = 0; ks < 27; ++ks) {
      uint32_t a[4];
      convk::ldmatrix_x4_trans(a, a_base + ks * KC * KS);
      uint32_t bfr[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* p = ws + (ks * CO_T + nt * 8 + g) * WS + 2 * t;
        bfr[nt][0] = convk::ld32(p);
        bfr[nt][1] = convk::ld32(p + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) convk::mma_16816(acc[0][nt], a, bfr[nt]);
    }
  }

  const int h = h0 + row;
  const int64_t blk = (int64_t)d * gridDim.x + blockIdx.x;
  bf16* ybase = y + ((int64_t)b * D + d) * H * Cout * W;
  convk::store_tile<1, NT, NWARPS>(
      acc, ybase, W, (int64_t)Cout * W, 1, W, h, h < H, w0 + mt * 16, co0, Cout, red_s, red_q,
      psum, psq, ((int64_t)b * Cout_pad + co0) * nblk + blk, nblk);
}

}  // namespace

extern "C" {

int conv3x3_stats_v1_cout_tile() { return CO_T; }

// Moment partials per (sample, channel) for a (D, H, W) output.
long long conv3x3_stats_v1_nblk(int D, int H, int W) {
  return (long long)D * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// Launch the conv kernel and the moment reduction on `stream`. x is
// (B, D, H, C, W) and y (B, D, H, Cout, W); the extents are passed in the
// order the sibling kernels take them. psum/psq: (B, Cout_pad, nblk) f32
// scratch. Returns cudaGetLastError().
int conv3x3_stats_v1_launch(const void* x, const void* wt, void* y, void* psum, void* psq,
                            void* sums, void* sqs, int B, int D, int C, int H, int W,
                            int Cout, int Cin_pad, int Cout_pad, void* stream) {
  static bool attr_done = false;
  if (!attr_done) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3x3_stats_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_done = true;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nh = (H + TH - 1) / TH, nw = (W + TW - 1) / TW, nco = Cout_pad / CO_T;
  const int64_t nblk = (int64_t)D * nh * nw;
  dim3 grid(nh * nw, D, B * nco);
  conv3x3_stats_v1_kernel<<<grid, NTHREADS, SMEM_BYTES, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt), static_cast<bf16*>(y),
      static_cast<float*>(psum), static_cast<float*>(psq), D, C, H, W, Cout, Cin_pad,
      Cout_pad, nw, nco, nblk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  convk::reduce_moments<<<dim3(Cout, B), 256, 0, st>>>(
      static_cast<const float*>(psum), static_cast<const float*>(psq),
      static_cast<float*>(sums), static_cast<float*>(sqs), nblk, Cout, Cout_pad);
  return (int)cudaGetLastError();
}

}  // extern "C"
