// Stride-1 3x3x3 SAME convolution + InstanceNorm moments, bf16 in/out with
// f32 accumulation, for Hopper (sm_90a).
//
// Replaces runet_tpu/kernels/fused_block.py::_conv_stats_kernel_v2m (the
// Pallas kernel behind conv_in_stats_dchw_batch). Contract:
//   x  (B, D, C, H, W) bf16, SAME zero padding on D, H and W;
//   wt (27, Cout_pad, Cin_pad) bf16: tap-major, channels zero-padded
//      (Cin_pad % 16 == 0, Cout_pad % CO_T == 0; packed once at load);
//   y  (B, D, Cout, H, W) bf16;
//   sums, sqs (B, Cout) f32: per-(sample, channel) sum of y and of y^2,
//      taken from the bf16-ROUNDED output (what the XLA fallback computes).
//
// Design: an implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16).
// One block owns one output depth d, a TH x TW patch of (h, w) and CO_T
// output channels; warp i computes output row h0 + i as M = TW positions
// (2 m16 tiles) by N = CO_T channels (4 n8 tiles). K runs over 16 input
// channels at a time times the 27 taps: for each 16-channel chunk the block
// stages the zero-padded input halo (3 x (TH+2) x (TW+2) x 16, channel
// innermost so an A fragment register is one 32-bit shared load) and the
// chunk's weights (27 x CO_T x 16) in shared memory, then runs 27 taps of
// MMAs from it. Padding the per-position stride to 24 bf16 makes both
// fragment loads bank-conflict free.
//
// Staging. x is W-innermost in global memory and the halo channel-innermost
// in shared memory, so the halo moves in units of 4 channels x 8 columns
// (load_units<VX>, store_units): one line L = kd * XR + row, one chunk q
// (input columns w0 + 8q .. +7) and one channel quad cq (channels c0 + 4cq
// .. +3), 480 units per chunk, two per thread. A unit is four ld_chunk<VX>
// loads, one per channel: with the launcher's VX flag (W % 8 == 0 and x
// 16-byte aligned) each is one 16-byte load, since w0 + 8q is a multiple of
// 8 and the chunk lies wholly inside or past W; else 8 masked element
// loads. The four chunks are transposed in registers by byte-permutes and
// each column goes to shared memory as one 8-byte store of its four
// channels. The halo columns w0 - 1 and w0 + TW are four masked element
// loads on the lanes of chunks 0 and 3. A thread issues all its loads, then
// the block stages the weights, then the thread stores its units, so the
// two global reads overlap. xs holds the same bytes as an element-wise
// copy, so y and the moments do not depend on which loads built it.
//
// What bounds it on the H100: at the U-Net's level-0 widths (C = 24..64) the
// arithmetic intensity is ~27*Cout FLOP per input byte, far above the
// ~295 FLOP/byte ridge, so the bound is tensor-core throughput. The kernel
// is far from it: 192-210 TFLOP/s at 128^3 with C 32-64 (a fifth of the
// 989 TFLOP/s bf16 peak), 76.8-77.1 ms over the 92 shapes of the main
// paths against 116.8-117.2 for cuDNN + sums, but 21.4 against 13.3 ms at
// the 49 deep-level shapes (Cin >= 128, W < 128) (chip_smoke.py's kernels
// phase; NVIDIA H100 80GB HBM3, 700.00 W). 124-125 registers, two blocks
// per SM. What holds it there: staging is synchronous, so a block's loads,
// stores and MMAs run one after another between the two __syncthreads() of
// a chunk and only the second block on the SM overlaps them; every block
// re-stages its chunk's 27 x 32 x 16 weights, and every CO_T = 32
// output-channel tile re-stages the whole halo (10 times at Cout 320); at
// W <= 16 half or more of the TW = 32 tile is padding; the GEMM is
// mma.sync, not wgmma.
#include "conv3x3_common.cuh"

namespace {

using convk::bf16;

constexpr int TH = 8;      // output rows per block (one warp each)
constexpr int TW = 32;     // output columns per block
constexpr int CO_T = 32;   // output channels per block
constexpr int KC = 16;     // input channels per staged chunk (MMA K)
constexpr int XS = 24;     // shared stride (bf16) of one staged input position
constexpr int WS = 24;     // shared stride (bf16) of one (tap, cout) weight row
constexpr int MT = TW / 16;
constexpr int NT = CO_T / 8;
constexpr int NTHREADS = TH * 32;
constexpr int NWARPS = TH;
constexpr int XR = TH + 2, XC = TW + 2;
constexpr int NLINES = 3 * XR;  // staged (kd, row) lines of a chunk
constexpr int SMEM_X = convk::round_up(3 * XR * XC * XS, 8);
constexpr int SMEM_W = 27 * CO_T * WS;
constexpr int SMEM_BYTES = (SMEM_X + SMEM_W) * 2;

// The halo of a chunk, input (d - 1 + kd, h0 - 1 + row, w0 - 1 + col) of
// channel c0 + ci at xs[((kd * XR + row) * XC + col) * XS + ci], zero past
// the extent (the SAME padding) and past channel C. Lane -> (q = lane & 3,
// cq = (lane >> 2) & 3), so one half-warp stages one line; warp `warp` takes
// line L = 2 * (warp + NWARPS * u) + lane / 16 at step u = 0, 1, and the
// 15 line pairs take two steps over 8 warps (warp 7 has no pair at step 1,
// a warp-uniform guard).
//
// Bank conflicts: an 8-byte store is served per half-warp, one line of 4 q
// x 4 cq. A position is XS / 2 = 12 words and 12 * 8 = 0 (mod 32), so
// store j of chunk q (column 1 + 8q + 2 (j ^ q)) lands at bank offset
// 24 (j ^ q) + 2 cq + const (mod 32): over the four q that is {0, 8, 16,
// 24} + 0..7, 32 distinct banks. The halo stores land at 0..7 (column 0)
// and 12..19 (column 33).
static_assert(TW == 32 && KC == 16 && XS == 24 && NTHREADS == 256,
              "4 chunks x 4 quads per line, two lines per warp and step, 8-byte stores");
static_assert(NLINES == 2 * (2 * NWARPS - 1), "15 line pairs over two steps of 8 warps");

// One thread's units of a chunk, loaded and not yet stored.
struct Units {
  uint4 v[2][4];  // [step][channel of the quad]: the chunk's 8 columns
  uint2 e[2];     // [step]: the halo column's 4 channels (lanes of q 0 and 3)
};

template <bool VX>
__device__ __forceinline__ void load_units(Units& un, const bf16* __restrict__ xb, int D, int C,
                                           int H, int W, int d, int h0, int w0, int c0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane & 3, cc = c0 + 4 * ((lane >> 2) & 3);
  const int wq = w0 + 8 * q, wh = q == 0 ? w0 - 1 : w0 + TW;
  const bool halo = (q == 0 || q == 3) && (unsigned)wh < (unsigned)W;
  const int64_t HW = (int64_t)H * W;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int line = 2 * (warp + NWARPS * u) + (lane >> 4);
    const int kd = line / XR, row = line - kd * XR;
    const int dd = d - 1 + kd, hh = h0 - 1 + row;
    const bool ok = line < NLINES && (unsigned)dd < (unsigned)D && (unsigned)hh < (unsigned)H;
    const bf16* src = xb + ((int64_t)dd * C + cc) * HW + (int64_t)hh * W;
    unsigned e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      un.v[u][i] = make_uint4(0u, 0u, 0u, 0u);
      e[i] = 0u;
      if (ok && cc + i < C) {
        un.v[u][i] = convk::ld_chunk<VX>(src + i * HW + wq, wq, W);
        if (halo) e[i] = __bfloat16_as_ushort(src[i * HW + wh]);
      }
    }
    un.e[u] = make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
  }
}

__device__ __forceinline__ void store_units(bf16* __restrict__ xs, const Units& un) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane & 3, cq = (lane >> 2) & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int line = 2 * (warp + NWARPS * u) + (lane >> 4);
    if (line < NLINES) {
      // r[i][j]: word j ^ q of channel i's chunk (columns 2 (j ^ q), +1).
      uint32_t r[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 c = un.v[u][i];
        const bool s1 = q & 1, s2 = q & 2;
        const uint32_t a0 = s1 ? c.y : c.x, a1 = s1 ? c.x : c.y;
        const uint32_t a2 = s1 ? c.w : c.z, a3 = s1 ? c.z : c.w;
        r[i][0] = s2 ? a2 : a0;
        r[i][1] = s2 ? a3 : a1;
        r[i][2] = s2 ? a0 : a2;
        r[i][3] = s2 ? a1 : a3;
      }
      bf16* dst = xs + (line * XC + 1 + 8 * q) * XS + 4 * cq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // Column 2 (j ^ q) takes the low halves of word j, the next the high.
        const int col = 2 * (j ^ q);
        *reinterpret_cast<uint2*>(dst + col * XS) =
            make_uint2(__byte_perm(r[0][j], r[1][j], 0x5410),
                       __byte_perm(r[2][j], r[3][j], 0x5410));
        *reinterpret_cast<uint2*>(dst + (col + 1) * XS) =
            make_uint2(__byte_perm(r[0][j], r[1][j], 0x7632),
                       __byte_perm(r[2][j], r[3][j], 0x7632));
      }
      if (q == 0 || q == 3)
        *reinterpret_cast<uint2*>(xs + (line * XC + (q == 0 ? 0 : XC - 1)) * XS + 4 * cq) =
            un.e[u];
    }
  }
}

// Two blocks per SM, as shared memory allows (2 x ~92.5 KB); ptxas fits either
// instance in 124-125 registers under it, no spills.
template <bool VX>
__global__ void __launch_bounds__(NTHREADS, 2)
conv3x3_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
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

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  for (int c0 = 0; c0 < Cin_pad; c0 += KC) {
    __syncthreads();  // the previous chunk's fragments have been read
    // The chunk's loads are in flight while the weights are staged (16
    // contiguous input channels per (tap, cout) row, two 16-byte vectors).
    Units un;
    load_units<VX>(un, xb, D, C, H, W, d, h0, w0, c0);
    convk::stage_weights<NTHREADS, CO_T, WS>(ws, wt, Cout_pad, Cin_pad, co0, c0);
    store_units(xs, un);
    __syncthreads();

    convk::mma_27taps<1, MT, NT, XR, XC, XS, CO_T, WS>(acc, xs, ws, warp, g, t);
  }

  const int h = h0 + warp;
  const int64_t blk = (int64_t)d * gridDim.x + blockIdx.x;
  bf16* ybase = y + ((int64_t)b * D + d) * Cout * HW;
  convk::store_tile_and_moments<MT, NT, TH>(
      acc, ybase, HW, W, h, h < H, w0, co0, Cout, red_s, red_q, psum, psq,
      ((int64_t)b * Cout_pad + co0) * nblk + blk, nblk);
}

template <bool VX>
int launch_kernel(const bf16* x, const bf16* wt, bf16* y, float* psum, float* psq, int B,
                  int D, int C, int H, int W, int Cout, int Cin_pad, int Cout_pad,
                  cudaStream_t st) {
  static bool attr_done = false;
  if (!attr_done) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3x3_stats_kernel<VX>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_done = true;
  }
  const int nh = (H + TH - 1) / TH, nw = (W + TW - 1) / TW, nco = Cout_pad / CO_T;
  dim3 grid(nh * nw, D, B * nco);
  conv3x3_stats_kernel<VX><<<grid, NTHREADS, SMEM_BYTES, st>>>(
      x, wt, y, psum, psq, D, C, H, W, Cout, Cin_pad, Cout_pad, nw, nco,
      (int64_t)D * nh * nw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Geometry the caller needs to size the scratch: the output-channel tile
// (Cout_pad must be a multiple of it) and the number of moment partials
// per (sample, channel) for a (D, H, W) output.
int conv3x3_stats_cout_tile() { return CO_T; }

long long conv3x3_stats_nblk(int D, int H, int W) {
  return (long long)D * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// Launch the conv kernel and the moment reduction on `stream`.
// psum/psq: (B, Cout_pad, nblk) f32 scratch. Returns cudaGetLastError().
int conv3x3_stats_launch(const void* x, const void* wt, void* y, void* psum, void* psq,
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
  convk::reduce_moments<<<dim3(Cout, B), 256, 0, st>>>(
      static_cast<const float*>(psum), static_cast<const float*>(psq),
      static_cast<float*>(sums), static_cast<float*>(sqs), conv3x3_stats_nblk(D, H, W),
      Cout, Cout_pad);
  return (int)cudaGetLastError();
}

}  // extern "C"
