// Stride-2 3x3x3 convolution (XLA SAME padding) + InstanceNorm moments,
// bf16 in/out with f32 accumulation, for Hopper (sm_90a).
//
// Replaces runet_tpu/kernels/strided_conv.py::_conv_s2_kernel (the Pallas
// kernel behind conv_s2_stats_dchw_batch). Contract:
//   x  (B, D, C, H, W) bf16 with D, H, W even;
//   wt (27, Cout_pad, Cin_pad) bf16, packed as for conv3x3_stats.cu;
//   y  (B, D/2, Cout, H/2, W/2) bf16 where output (d, h, w) reads input
//      (2d+kd, 2h+kh, 2w+kw), k = 0..2, and an index past the extent reads
//      zero: the asymmetric SAME padding (low 0, high 1) of a stride-2 conv
//      on an even extent;
//   sums, sqs (B, Cout) f32 moments of the bf16-ROUNDED output.
// Any B >= 1 (the Pallas gate accepts only B = 1).
//
// Design: the implicit GEMM of conv3x3_stats.cu with strided A fragments.
// A block owns one output depth, TH x TW output (h, w) positions and CO_T
// output channels. For each 16-channel K-tile it stages the input halo,
// 3 planes x (2TH+1) rows x (2TW+1) columns, channel innermost:
// xs[((kd * XR + row) * XC + col) * XS + ci]. The MMA loop reads A[m][k] at
// column 2m + kw, so the stride costs nothing there, and the stride of 20
// bf16 per position keeps those fragment loads bank-conflict free.
// Channels 16-19 of a position are padding that nothing writes or reads.
// The Pallas kernel decimated W with 0/1 selection matmuls because the TPU
// cannot stride its lanes; a GPU thread simply addresses the strided
// element.
//
// Staging. x is W-innermost in global memory and channel-innermost in
// shared memory, so the halo moves in units of 4 channels x 8 columns: one
// line L = kd * XR + row, chunk q (columns 2w0 + 8q .. +7) and channel quad
// cq (channels c0 + 4cq .. +3). One warp stages a whole line per step (lane
// -> q = (lane & 3) | (lane >> 4) << 2, cq = (lane >> 2) & 3), so each load
// instruction reads four channel rows of 128 contiguous bytes. A unit is
// four ld_chunk<VX> loads, one per channel: with the launcher's VX flag
// (W % 8 == 0 and x 16-byte aligned) each is one 16-byte load, since 2w0 =
// 64 * wtile puts every chunk on a 16-byte boundary wholly inside or past
// W; else 8 masked element loads. The four chunks are transposed in
// registers by byte-permutes (column 2j takes the low halves of word j of
// channels 0-1 and 2-3, column 2j + 1 the high halves) and each column goes
// to shared memory as one 8-byte store of its four channels. Chunks with
// (q >> 1) odd swap their halves and store columns 4-7 first, so each
// half-warp's 16 stores cover 32 distinct banks. Each thread issues two
// units (8 loads) before it stores any. The 65th column (2w0 + 64, even)
// is one masked element per (line, channel). The weights are staged as
// before, two 16-byte vectors per (tap, cout) row.
//
// What bounds it on the H100: each output reads 8x its own volume of input,
// so at the main path's widths the least time is the HBM bytes of reading
// the input once (~27 * Cout / 8 FLOP per input byte, below the ~295
// FLOP/byte ridge). The kernel is far from that bound: every output-channel
// tile re-stages the whole halo, staging is synchronous (no overlap with
// the MMAs), and at Wo <= 16 half or more of the TW = 32 tile is padding.
#include "conv3x3_common.cuh"

namespace {

using convk::bf16;

constexpr int TH = 4;      // output rows per block (one warp each)
constexpr int TW = 32;     // output columns per block
constexpr int CO_T = 32;   // output channels per block
constexpr int KC = 16;     // input channels per staged chunk (MMA K)
constexpr int XS = 20;     // shared stride (bf16) of one staged input position
constexpr int WS = 24;     // shared stride (bf16) of one (tap, cout) weight row
constexpr int MT = TW / 16;
constexpr int NT = CO_T / 8;
constexpr int NTHREADS = TH * 32;
constexpr int NWARPS = TH;
constexpr int XR = 2 * TH + 1, XC = 2 * TW + 1;
constexpr int NLINES = 3 * XR;  // staged (kd, row) lines of a K-tile
constexpr int SMEM_X = convk::round_up(3 * XR * XC * XS, 8);
constexpr int SMEM_W = 27 * CO_T * WS;
constexpr int SMEM_BYTES = (SMEM_X + SMEM_W) * 2;
static_assert(TW == 32 && KC == 16 && XS % 4 == 0, "8 chunks x 4 quads per line; 8-byte stores");

// Stage the input halo of K-tile c0 for output depth d, rows h0.., columns
// w0..: input (2d + kd, 2h0 + row, 2w0 + col) of channel c0 + ci goes to
// xs[((kd * XR + row) * XC + col) * XS + ci], zero past the extent (the
// (0, 1) SAME pad) and past channel C.
template <bool VX>
__device__ __forceinline__ void stage_x(bf16* __restrict__ xs, const bf16* __restrict__ xb,
                                        int D, int C, int H, int W, int d, int h0, int w0,
                                        int c0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = (lane & 3) | ((lane >> 4) << 2), cq = (lane >> 2) & 3;
  const int ww = 2 * w0 + 8 * q, cc = c0 + 4 * cq;
  const bool rot = (q >> 1) & 1;
  const int64_t HW = (int64_t)H * W;
#pragma unroll 1
  for (int l0 = warp; l0 < NLINES; l0 += 2 * NWARPS) {
    uint4 v[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int line = l0 + u * NWARPS;
      const int kd = line / XR, row = line - kd * XR;
      const int dd = 2 * d + kd, hh = 2 * h0 + row;
      const bool ok = line < NLINES && dd < D && hh < H;
      const bf16* src = xb + ((int64_t)dd * C + cc) * HW + (int64_t)hh * W + ww;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[u][i] = make_uint4(0u, 0u, 0u, 0u);
        if (ok && cc + i < C) v[u][i] = convk::ld_chunk<VX>(src + i * HW, ww, W);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int line = l0 + u * NWARPS;
      if (line < NLINES) {
        // r[i][j]: word j of channel i's chunk, halves swapped when rot.
        uint32_t r[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint4 c = v[u][i];
          r[i][0] = rot ? c.z : c.x;
          r[i][1] = rot ? c.w : c.y;
          r[i][2] = rot ? c.x : c.z;
          r[i][3] = rot ? c.y : c.w;
        }
        bf16* dst = xs + (line * XC + 8 * q) * XS + 4 * cq;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = (2 * j) ^ (rot ? 4 : 0);
          *reinterpret_cast<uint2*>(dst + col * XS) =
              make_uint2(__byte_perm(r[0][j], r[1][j], 0x5410),
                         __byte_perm(r[2][j], r[3][j], 0x5410));
          *reinterpret_cast<uint2*>(dst + (col + 1) * XS) =
              make_uint2(__byte_perm(r[0][j], r[1][j], 0x7632),
                         __byte_perm(r[2][j], r[3][j], 0x7632));
        }
      }
    }
  }
  // The 65th column: element e is channel e % KC of line e / KC.
  constexpr int NHALO = NLINES * KC, U = (NHALO + NTHREADS - 1) / NTHREADS;
  const int wl = 2 * w0 + 2 * TW;
  bf16 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = threadIdx.x + u * NTHREADS;
    const int ci = e % KC, line = e / KC;
    const int kd = line / XR, row = line - kd * XR;
    const int dd = 2 * d + kd, hh = 2 * h0 + row, ch = c0 + ci;
    v[u] = __ushort_as_bfloat16((unsigned short)0);
    if (e < NHALO && dd < D && hh < H && ch < C && wl < W)
      v[u] = xb[((int64_t)dd * C + ch) * HW + (int64_t)hh * W + wl];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = threadIdx.x + u * NTHREADS;
    if (e < NHALO) xs[((e / KC) * XC + 2 * TW) * XS + e % KC] = v[u];
  }
}

// Two blocks per SM, as shared memory allows. Without the 2, ptxas holds the
// kernel to 128 registers and the VX instance spills; with it, 139-140 and
// no spills.
template <bool VX>
__global__ void __launch_bounds__(NTHREADS, 2)
conv3x3_s2_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                        bf16* __restrict__ y, float* __restrict__ psum,
                        float* __restrict__ psq, int D, int C, int H, int W, int Cout,
                        int Cin_pad, int Cout_pad, int n_wtiles, int n_cotiles,
                        int64_t nblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ws = xs + SMEM_X;
  __shared__ float red_s[TH][CO_T], red_q[TH][CO_T];

  const int Do = D / 2, Ho = H / 2, Wo = W / 2;
  const int ht = blockIdx.x / n_wtiles, wtile = blockIdx.x % n_wtiles;
  const int d = blockIdx.y;
  const int b = blockIdx.z / n_cotiles, cot = blockIdx.z % n_cotiles;
  const int h0 = ht * TH, w0 = wtile * TW, co0 = cot * CO_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t HW = (int64_t)H * W;
  const bf16* xb = x + (int64_t)b * D * C * HW;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  for (int c0 = 0; c0 < Cin_pad; c0 += KC) {
    __syncthreads();
    stage_x<VX>(xs, xb, D, C, H, W, d, h0, w0, c0);
    convk::stage_weights<NTHREADS, CO_T, WS>(ws, wt, Cout_pad, Cin_pad, co0, c0);
    __syncthreads();

    convk::mma_27taps<2, MT, NT, XR, XC, XS, CO_T, WS>(acc, xs, ws, warp, g, t);
  }

  const int h = h0 + warp;
  const int64_t HWo = (int64_t)Ho * Wo;
  const int64_t blk = (int64_t)d * gridDim.x + blockIdx.x;
  bf16* ybase = y + ((int64_t)b * Do + d) * Cout * HWo;
  convk::store_tile_and_moments<MT, NT, TH>(
      acc, ybase, HWo, Wo, h, h < Ho, w0, co0, Cout, red_s, red_q, psum, psq,
      ((int64_t)b * Cout_pad + co0) * nblk + blk, nblk);
}

template <bool VX>
int launch_kernel(const bf16* x, const bf16* wt, bf16* y, float* psum, float* psq, int B,
                  int D, int C, int H, int W, int Cout, int Cin_pad, int Cout_pad,
                  cudaStream_t st) {
  static bool attr_done = false;
  if (!attr_done) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3x3_s2_stats_kernel<VX>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_done = true;
  }
  const int Do = D / 2, Ho = H / 2, Wo = W / 2;
  const int nh = (Ho + TH - 1) / TH, nw = (Wo + TW - 1) / TW, nco = Cout_pad / CO_T;
  dim3 grid(nh * nw, Do, B * nco);
  conv3x3_s2_stats_kernel<VX><<<grid, NTHREADS, SMEM_BYTES, st>>>(
      x, wt, y, psum, psq, D, C, H, W, Cout, Cin_pad, Cout_pad, nw, nco,
      (int64_t)Do * nh * nw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int conv3x3_s2_stats_cout_tile() { return CO_T; }

// Moment partials per (sample, channel) for an (Do, Ho, Wo) OUTPUT.
long long conv3x3_s2_stats_nblk(int Do, int Ho, int Wo) {
  return (long long)Do * ((Ho + TH - 1) / TH) * ((Wo + TW - 1) / TW);
}

// D, H, W are the INPUT extents (even). psum/psq: (B, Cout_pad, nblk) f32.
int conv3x3_s2_stats_launch(const void* x, const void* wt, void* y, void* psum, void* psq,
                            void* sums, void* sqs, int B, int D, int C, int H, int W,
                            int Cout, int Cin_pad, int Cout_pad, void* stream) {
  typedef int (*Launch)(const bf16*, const bf16*, bf16*, float*, float*, int, int, int, int,
                        int, int, int, int, cudaStream_t);
  // x takes the 16-byte loads when W % 8 == 0 and x is 16-byte aligned.
  const bool vx = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const Launch launch = vx ? launch_kernel<true> : launch_kernel<false>;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int e = launch(static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
                       static_cast<bf16*>(y), static_cast<float*>(psum),
                       static_cast<float*>(psq), B, D, C, H, W, Cout, Cin_pad, Cout_pad, st);
  if (e != cudaSuccess) return e;
  const int64_t nblk = conv3x3_s2_stats_nblk(D / 2, H / 2, W / 2);
  convk::reduce_moments<<<dim3(Cout, B), 256, 0, st>>>(
      static_cast<const float*>(psum), static_cast<const float*>(psq),
      static_cast<float*>(sums), static_cast<float*>(sqs), nblk, Cout, Cout_pad);
  return (int)cudaGetLastError();
}

}  // extern "C"
