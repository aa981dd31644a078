// Stride-1 3x3x3 SAME convolution + InstanceNorm moments as nine accumulating
// (kh, kw) tap GEMMs with kd folded into K, read from W-shifted copies of the
// input slab: bf16 in/out, f32 accumulation, for Hopper (sm_90a).
//
// Replaces runet_tpu/kernels/fused_block.py::_conv_stats_kernel_v2 (the
// Pallas kernel behind conv_in_stats_dchw_batch(version="v2")). Contract, the
// same as conv3x3_stats.cu's:
//   x  (B, D, C, H, W) bf16, SAME zero padding on D, H and W;
//   wt (27, Cout_pad, Cin_pad) bf16: tap-major, channels zero-padded;
//   y  (B, D, Cout, H, W) bf16;
//   sums, sqs (B, Cout) f32 of the bf16-ROUNDED output.
//
// What makes it its own kernel is v2's formulation, carried to the card:
// - The halo slab is staged in the TENSOR'S OWN ORDER, W innermost and the
//   channels strided: xs[kw][kd][ci][row][w]. Nothing is transposed on the
//   way in; consecutive threads copy consecutive w.
// - The kw = 0 and kw = 2 operands are SHIFTED COPIES of the slab in shared
//   memory (copy kw holds x[w + kw - 1], the SAME pad in W being the zeroed
//   column), what the TPU kernel builds with pltpu.roll + mask. Every tap's
//   operand then starts at an aligned column, so an A fragment (M = 16 w
//   positions, K = 16 channels, K strided in memory) is ONE
//   ldmatrix.x4.trans of 16-byte rows instead of a per-thread gather.
// - kd folds into K: per 16-channel chunk K = 3 * 16, and each of the nine
//   (kh, kw) taps is one GEMM of three k16 steps into the same accumulators.
// A channel's plane is padded by 8 bf16 (stride 328 -> 656 B = 16 mod 128),
// so the eight rows of one ldmatrix phase fall in eight distinct 16-byte
// bank groups: no conflicts on the channel stride.
//
// Block = one output depth d, TH x TW (h, w) positions, CO_T output channels;
// warp i owns output row h0 + i as 2 m16 tiles x 4 n8 tiles, as in
// conv3x3_stats.cu, and shares its epilogue (moments from the rounded output,
// per-block partials reduced in a fixed order, no float atomics).
//
// What bounds it on the H100: operations (27*Cout FLOP per input byte). The
// three slab copies take 94 KB of shared memory beside 41 KB of weights, so
// one block is resident per SM and its staging does not overlap its MMAs;
// Cin = 1 pads K to 16 and W < 32 leaves columns of the tile idle. Staging
// by lines with running counters (no division per element) took the level-0
// 32->32 conv (B 2, 128^3) from 3.48 to 3.03 ms and the 128->128 conv at 32^3
// from 1.00 to 0.64 ms (H100 80GB HBM3, 700 W).
#include "conv3x3_common.cuh"

namespace {

using convk::bf16;

constexpr int TH = 8;      // output rows per block (one warp each)
constexpr int TW = 32;     // output columns per block
constexpr int CO_T = 32;   // output channels per block
constexpr int KC = 16;     // input channels per staged chunk
constexpr int WS = 24;     // shared stride (bf16) of one (tap, cout) weight row
constexpr int MT = TW / 16;
constexpr int NT = CO_T / 8;
constexpr int NTHREADS = TH * 32;
constexpr int XR = TH + 2;           // staged rows
constexpr int CS = XR * TW + 8;      // channel stride of one copy (bf16)
constexpr int KDS = KC * CS;         // kd stride
constexpr int COPY = 3 * KDS;        // one W-shifted copy of the slab
constexpr int SMEM_X = 3 * COPY;
constexpr int SMEM_W = 27 * CO_T * WS;
constexpr int SMEM_BYTES = (SMEM_X + SMEM_W) * 2;
static_assert(CS % 8 == 0 && (CS * 2) % 128 == 16, "ldmatrix rows: aligned and conflict-free");

// Stage the chunk's slab once from the tensor and write each element into the
// three shifted copies: copy kw, column j holds x[w0 + j + kw - 1]. A lane
// owns one of the tile's 32 columns and its warp walks the (kd, channel, row)
// lines with running counters, so no element costs a division; the two halo
// columns (w0 - 1 into copy 0, w0 + 32 into copy 2) follow. Each thread has U
// independent loads in flight before it stores any.
__device__ __forceinline__ void stage_shifted_slabs(bf16* __restrict__ xs,
                                                    const bf16* __restrict__ xb, int D, int C,
                                                    int H, int W, int d0, int h0, int w0,
                                                    int c0) {
  constexpr int NLINE = 3 * KC * XR;  // (kd, ci, row) lines of 32 columns
  constexpr int NWARP = NTHREADS / 32;
  constexpr int U = 6;
  static_assert(NLINE % (NWARP * U) == 0 && NWARP <= XR && KC == 16, "lines tile the warps");
  const int64_t HW = (int64_t)H * W;
  const bf16 zero = __ushort_as_bfloat16((unsigned short)0);
  const int lane = threadIdx.x & 31;
  const int ww = w0 + lane;
  int q = 0, row = threadIdx.x >> 5;  // line = q * XR + row, q = kd * KC + ci
  for (int i = 0; i < NLINE / NWARP; i += U) {
    bf16 v[U];
    int off[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kd = q >> 4, ci = q & 15;
      const int dd = d0 + kd, hh = h0 + row, ch = c0 + ci;
      off[u] = kd * KDS + ci * CS + row * TW + lane;
      v[u] = zero;
      if ((unsigned)dd < (unsigned)D && (unsigned)hh < (unsigned)H && ww < W && ch < C)
        v[u] = xb[((int64_t)dd * C + ch) * HW + (int64_t)hh * W + ww];
      row += NWARP;
      if (row >= XR) {
        row -= XR;
        ++q;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      xs[COPY + off[u]] = v[u];
      if (lane + 1 < TW) xs[off[u] + 1] = v[u];
      if (lane >= 1) xs[2 * COPY + off[u] - 1] = v[u];
    }
  }
  for (int e = threadIdx.x; e < 2 * NLINE; e += NTHREADS) {
    const int side = e & 1, line = e >> 1;
    const int lq = line / XR, lrow = line - lq * XR;
    const int kd = lq >> 4, ci = lq & 15;
    const int dd = d0 + kd, hh = h0 + lrow, ch = c0 + ci;
    const int we = side ? w0 + TW : w0 - 1;
    bf16 v = zero;
    if ((unsigned)dd < (unsigned)D && (unsigned)hh < (unsigned)H && (unsigned)we < (unsigned)W &&
        ch < C)
      v = xb[((int64_t)dd * C + ch) * HW + (int64_t)hh * W + we];
    const int o = kd * KDS + ci * CS + lrow * TW;
    xs[side ? 2 * COPY + o + TW - 1 : o] = v;
  }
}

__global__ void __launch_bounds__(NTHREADS)
conv3x3_stats_v2_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                        bf16* __restrict__ y, float* __restrict__ psum,
                        float* __restrict__ psq, int D, int C, int H, int W, int Cout,
                        int Cin_pad, int Cout_pad, int n_wtiles, int n_cotiles,
                        int64_t nblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ws = xs + SMEM_X;
  __shared__ float red_s[TH][CO_T], red_q[TH][CO_T];

  const int ht = blockIdx.x / n_wtiles, wtile = blockIdx.x % n_wtiles;
  const int d = blockIdx.y;
  const int b = blockIdx.z / n_cotiles, cot = blockIdx.z % n_cotiles;
  const int h0 = ht * TH, w0 = wtile * TW, co0 = cot * CO_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t HW = (int64_t)H * W;
  const bf16* xb = x + (int64_t)b * D * C * HW;
  // This lane's row of the ldmatrix: matrix lane / 8, channel row lane % 8.
  const int lm = lane >> 3;
  const int a_off = ((lane & 7) + ((lm >> 1) << 3)) * CS + ((lm & 1) << 3);

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  for (int c0 = 0; c0 < Cin_pad; c0 += KC) {
    __syncthreads();  // the previous chunk's fragments have been read
    stage_shifted_slabs(xs, xb, D, C, H, W, d - 1, h0 - 1, w0, c0);
    convk::stage_weights<NTHREADS, CO_T, WS>(ws, wt, Cout_pad, Cin_pad, co0, c0);
    __syncthreads();

#pragma unroll 1
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        // One tap GEMM: K = (kd, 16 channels), three k16 steps.
        const bf16* xtap = xs + kw * COPY + (warp + kh) * TW + a_off;
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
          const int tap = (kd * 3 + kh) * 3 + kw;
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            convk::ldmatrix_x4_trans(a[mt], xtap + kd * KDS + mt * 16);
          uint32_t bfr[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const bf16* p = ws + (tap * CO_T + nt * 8 + g) * WS + 2 * t;
            bfr[nt][0] = convk::ld32(p);
            bfr[nt][1] = convk::ld32(p + 8);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) convk::mma_16816(acc[mt][nt], a[mt], bfr[nt]);
        }
      }
    }
  }

  const int h = h0 + warp;
  const int64_t blk = (int64_t)d * gridDim.x + blockIdx.x;
  bf16* ybase = y + ((int64_t)b * D + d) * Cout * HW;
  convk::store_tile_and_moments<MT, NT, TH>(
      acc, ybase, HW, W, h, h < H, w0, co0, Cout, red_s, red_q, psum, psq,
      ((int64_t)b * Cout_pad + co0) * nblk + blk, nblk);
}

}  // namespace

extern "C" {

int conv3x3_stats_v2_cout_tile() { return CO_T; }

// Moment partials per (sample, channel) for a (D, H, W) output.
long long conv3x3_stats_v2_nblk(int D, int H, int W) {
  return (long long)D * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// Launch the conv kernel and the moment reduction on `stream`.
// psum/psq: (B, Cout_pad, nblk) f32 scratch. Returns cudaGetLastError().
int conv3x3_stats_v2_launch(const void* x, const void* wt, void* y, void* psum, void* psq,
                            void* sums, void* sqs, int B, int D, int C, int H, int W,
                            int Cout, int Cin_pad, int Cout_pad, void* stream) {
  static bool attr_done = false;
  if (!attr_done) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3x3_stats_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_done = true;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nh = (H + TH - 1) / TH, nw = (W + TW - 1) / TW, nco = Cout_pad / CO_T;
  const int64_t nblk = (int64_t)D * nh * nw;
  dim3 grid(nh * nw, D, B * nco);
  conv3x3_stats_v2_kernel<<<grid, NTHREADS, SMEM_BYTES, st>>>(
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
