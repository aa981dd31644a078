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
//   way in: each 16-byte chunk along W is loaded once and stored once into
//   every copy (load_units, store_units below).
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
// What bounds it on the H100: operations by the roofline (27*Cout FLOP per
// input byte). Staging from 16-byte chunks in place of element copies took
// the kernel from 211.2-211.3 to 116.0-116.2 ms over the 62 shapes the renal
// serve and train paths launch (cuDNN bf16 conv + sums: 132.1-132.2) and
// the level-0 32->32 conv (B 2, 128^3) from 2.93 to 1.64 ms, 141 TFLOP/s,
// with bit-identical output (chip_smoke.py's kernels phase; NVIDIA H100
// 80GB HBM3, 700.00 W). Still bounding it: the three slab copies take 94 KB
// of shared memory beside 41 KB of weights, so one block is resident per SM
// and its staging does not overlap its MMAs; every block re-stages its
// chunk's weights; at W <= 16 half or more of the TW = 32 tile is padding
// (the 320->320 conv at 8^3 takes 0.24 ms against cuDNN's 0.06-0.14), and
// Cin = 1 pads K to 16.
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

// The chunk's slab and its two W-shifted copies from 16-byte chunks along
// W. The chunk reads 3 kd x 16 channels x XR rows = 480 input lines, line
// L = (kd * 16 + ci) * XR + row, each over columns w0 - 1 .. w0 + TW. A unit
// is one line and one 8-column chunk q (columns w0 + 8q .. +7): 1920 units,
// each stored at kdci * CS + row * TW + 8q of every copy (kdci = kd * 16 +
// ci). Lane -> (q = lane & 3, line L = 8 * (u * NWARP + warp) + lane / 4):
// at step u a warp takes one group of 8 lines, 60 groups over 8 warps, so
// step 7 runs on warps 0-3 only (a warp-uniform guard; the shuffles keep
// the full mask). XR is even and a group starts at a multiple of 8, so the
// two lines of an 8-lane 16-byte store phase are consecutive rows of one
// (kd, ci): 128 contiguous bytes, no bank conflict.
//
// load_units issues a thread's (up to 8) chunk loads (ld_chunk<VX>: one
// 16-byte load under VX, else 8 masked element loads) and its halo
// elements, all before store_units stores anything: lanes with q == 0 also
// load column w0 - 1, lanes with q == 3 column w0 + TW. Copy 1 takes the
// chunk; copies 0 and 2 the chunk shifted by one column either way: a
// shuffle brings the left neighbour's last word and the right neighbour's
// first (the edge lanes take their halo element instead), and
// __byte_perm(a, b, 0x5432) = (high half of a, low half of b) joins two
// adjacent words. Zero outside D, H and W and past channel C, as in an
// element-wise copy, so the copies hold the same bytes.
constexpr int NWARP = NTHREADS / 32;
constexpr int NLINE = 3 * KC * XR;            // (kd, ci, row) lines of a chunk
constexpr int NGROUP = NLINE / 8;             // groups of 8 lines
constexpr int UNITS = (NGROUP + NWARP - 1) / NWARP;  // steps per thread
static_assert(TW == 32 && KC == 16 && XR % 2 == 0 && NLINE % 8 == 0 && NWARP == 8 &&
                  NGROUP > (UNITS - 1) * NWARP,
              "lane and warp maps: four 8-column chunks, two rows of one (kd, ci) per "
              "store phase, only the last step partial");

// One thread's units of a chunk, loaded and not yet stored: its chunks and
// halo elements.
struct Units {
  uint4 v[UNITS];
  uint32_t e[UNITS];
};

// The unit's line: (kd * 16 + ci, row).
__device__ __forceinline__ void unit_line(int u, int warp, int lane, int& kdci, int& row) {
  const int L = 8 * (u * NWARP + warp) + (lane >> 2);
  kdci = L / XR;
  row = L - kdci * XR;
}

template <bool VX>
__device__ __forceinline__ void load_units(Units& un, const bf16* __restrict__ xb, int D, int C,
                                           int H, int W, int d, int h0, int w0, int c0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int wq = w0 + 8 * q, wh = q == 0 ? w0 - 1 : w0 + TW;
  const bool halo = (q == 0 || q == 3) && (unsigned)wh < (unsigned)W;
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    un.v[u] = make_uint4(0u, 0u, 0u, 0u);
    un.e[u] = 0u;
    if (u * NWARP + warp < NGROUP) {
      int kdci, row;
      unit_line(u, warp, lane, kdci, row);
      const int dd = d - 1 + (kdci >> 4), hh = h0 - 1 + row, ch = c0 + (kdci & 15);
      if ((unsigned)dd < (unsigned)D && (unsigned)hh < (unsigned)H && ch < C) {
        const bf16* line = xb + (((int64_t)dd * C + ch) * H + hh) * W;
        un.v[u] = convk::ld_chunk<VX>(line + wq, wq, W);
        if (halo) un.e[u] = __bfloat16_as_ushort(line[wh]);
      }
    }
  }
}

__device__ __forceinline__ void store_units(bf16* __restrict__ xs, const Units& un) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane & 3;
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    if (u * NWARP + warp < NGROUP) {
      int kdci, row;
      unit_line(u, warp, lane, kdci, row);
      // x[1..4]: the chunk's words; x[0] holds column w0 + 8q - 1 in its high
      // half, x[5] column w0 + 8q + 8 in its low half.
      const uint4 v = un.v[u];
      uint32_t x[6] = {0u, v.x, v.y, v.z, v.w, 0u};
      const uint32_t left = __shfl_up_sync(0xffffffffu, x[4], 1);
      const uint32_t right = __shfl_down_sync(0xffffffffu, x[1], 1);
      x[0] = q == 0 ? un.e[u] << 16 : left;
      x[5] = q == 3 ? un.e[u] : right;
      uint32_t p[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) p[j] = __byte_perm(x[j], x[j + 1], 0x5432);
      bf16* dst = xs + kdci * CS + row * TW + 8 * q;
      *reinterpret_cast<uint4*>(dst) = make_uint4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<uint4*>(dst + COPY) = v;
      *reinterpret_cast<uint4*>(dst + 2 * COPY) = make_uint4(p[1], p[2], p[3], p[4]);
    }
  }
}

// One block per SM: the three slab copies and the weights take 135 KB.
template <bool VX>
__global__ void __launch_bounds__(NTHREADS, 1)
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
    // The chunk's loads are in flight while the weights are staged.
    Units un;
    load_units<VX>(un, xb, D, C, H, W, d, h0, w0, c0);
    convk::stage_weights<NTHREADS, CO_T, WS>(ws, wt, Cout_pad, Cin_pad, co0, c0);
    store_units(xs, un);
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

template <bool VX>
int launch_kernel(const bf16* x, const bf16* wt, bf16* y, float* psum, float* psq, int B,
                  int D, int C, int H, int W, int Cout, int Cin_pad, int Cout_pad,
                  cudaStream_t st) {
  static bool attr_done = false;
  if (!attr_done) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3x3_stats_v2_kernel<VX>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_done = true;
  }
  const int nh = (H + TH - 1) / TH, nw = (W + TW - 1) / TW, nco = Cout_pad / CO_T;
  dim3 grid(nh * nw, D, B * nco);
  conv3x3_stats_v2_kernel<VX><<<grid, NTHREADS, SMEM_BYTES, st>>>(
      x, wt, y, psum, psq, D, C, H, W, Cout, Cin_pad, Cout_pad, nw, nco,
      (int64_t)D * nh * nw);
  return (int)cudaGetLastError();
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
      static_cast<float*>(sums), static_cast<float*>(sqs), conv3x3_stats_v2_nblk(D, H, W),
      Cout, Cout_pad);
  return (int)cudaGetLastError();
}

}  // extern "C"
