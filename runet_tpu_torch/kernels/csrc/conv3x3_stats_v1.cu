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
// The im2col tile is built from 16-byte chunks along W (load_units<VX>,
// store_units): each (line, 8-column chunk) unit is one 16-byte load under
// the launcher's VX flag (W % 8 == 0 and x 16-byte aligned; else 8 masked
// element loads), and fills 3 to 6 runs of col with 16-byte stores, its
// kw = 0 and kw = 2 runs made by shuffles and byte-permutes: 27 16-byte
// stores per thread and chunk. col holds the same bytes as an element-wise
// copy, so y and the moments do not depend on which loads built it. The
// chunk's loads are issued before the weights are staged and stored after,
// so the two global reads overlap.
//
// What bounds it on the H100: operations by the roofline, but the kernel
// runs at ~85 TFLOP/s at full tiles (chip_smoke.py's kernels phase; NVIDIA
// H100 80GB HBM3, 700.00 W; PERF.md §6). A probe that left out one phase at
// a time found the build, the weight staging and the 27-step GEMM of
// similar cost: every block of 64 voxels re-stages a chunk's 27 x 32 x 16
// weights (a load-then-store loop, ~14 rounds per thread) as well as
// building the tile. Left: the weight staging; every CO_T = 32
// output-channel tile rebuilds the whole im2col tile (10 builds at Cout
// 320); at W <= 16 half or more of the TW = 32 tile is padding; staging is
// synchronous, with no overlap of the staging and the MMAs beyond the
// second block on the SM.
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

// The chunk's im2col tile from 16-byte chunks along W. The chunk reads
// 3 kd x (TH + 2) input rows r x 16 channels = 192 lines, input
// (d + kd - 1, h0 + r - 1, c0 + ci), each over columns w0 - 1 .. w0 + TW. A
// unit is one line and one 8-column chunk q (columns w0 + 8q .. +7), and
// every unit fills a 16-byte run of col for each (row, kh) with row + kh = r
// and each kw. Lane -> (ci % 8 = lane & 7, q = lane >> 3), so the eight
// threads of one 16-byte store phase write eight channel rows of one q, 144
// B apart: eight distinct bank groups. Warp `warp` takes, at step u, the
// line group L = u * NWARPS + warp of the 24 groups L = (kd * 4 + r) * 2 +
// ci / 8, so kd = u / 2 and r = 2 * (u % 2) + warp / 2.
//
// load_units issues a thread's six chunk loads (ld_chunk<VX>: one 16-byte
// load under VX, else 8 masked element loads) and its halo elements, all
// before store_units stores anything: lanes with q == 0 also load column
// w0 - 1, lanes with q == 3 column w0 + TW. The kw = 0 and kw = 2 runs are
// the chunk shifted by one column either way: a shuffle brings the left
// neighbour's last word and the right neighbour's first (the edge lanes take
// their halo element instead), and __byte_perm(a, b, 0x5432) = (high half
// of a, low half of b) joins two adjacent words. Zero outside D and H, past
// W and past channel C, as in an element-wise copy, so col holds the same
// bytes.
constexpr int UNITS = 3 * (TH + 2) * 2 / NWARPS;  // units per thread and chunk
static_assert(TH == 2 && NWARPS == 4 && TW == 32 && KC == 16,
              "lane and warp maps: four 8-column chunks, two channel halves");

// One thread's units of a chunk, loaded and not yet stored: its chunks and
// halo elements.
struct Units {
  uint4 v[UNITS];
  uint32_t e[UNITS];
};

template <bool VX>
__device__ __forceinline__ void load_units(Units& un, const bf16* __restrict__ xb, int D, int H,
                                           int C, int W, int d, int h0, int w0, int c0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 3, ci = (warp & 1) * 8 + (lane & 7), r0 = warp >> 1;
  const int wq = w0 + 8 * q, wh = q == 0 ? w0 - 1 : w0 + TW;
  const bool halo = (q == 0 || q == 3) && (unsigned)wh < (unsigned)W;
  const bool c_ok = c0 + ci < C;
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    const int kd = u >> 1, r = r0 + 2 * (u & 1);
    const int dd = d + kd - 1, hh = h0 + r - 1;
    const bf16* line = xb + (((int64_t)dd * H + hh) * C + c0 + ci) * W;
    un.v[u] = make_uint4(0u, 0u, 0u, 0u);
    un.e[u] = 0u;
    if (c_ok && (unsigned)dd < (unsigned)D && (unsigned)hh < (unsigned)H) {
      un.v[u] = convk::ld_chunk<VX>(line + wq, wq, W);
      if (halo) un.e[u] = __bfloat16_as_ushort(line[wh]);
    }
  }
}

__device__ __forceinline__ void store_units(bf16* __restrict__ col, const Units& un) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 3, ci = (warp & 1) * 8 + (lane & 7), r0 = warp >> 1;
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    const int kd = u >> 1, r = r0 + 2 * (u & 1);
    // x[1..4]: the chunk's words; x[0] holds column w0 + 8q - 1 in its high
    // half, x[5] column w0 + 8q + 8 in its low half.
    const uint4 v = un.v[u];
    uint32_t x[6] = {0u, v.x, v.y, v.z, v.w, 0u};
    const uint32_t left = __shfl_up_sync(0xffffffffu, x[4], 8);
    const uint32_t right = __shfl_down_sync(0xffffffffu, x[1], 8);
    x[0] = q == 0 ? un.e[u] << 16 : left;
    x[5] = q == 3 ? un.e[u] : right;
    uint32_t p[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) p[j] = __byte_perm(x[j], x[j + 1], 0x5432);
    const uint4 kw0 = make_uint4(p[0], p[1], p[2], p[3]);
    const uint4 kw2 = make_uint4(p[1], p[2], p[3], p[4]);
#pragma unroll
    for (int row = 0; row < TH; ++row) {
      const int kh = r - row;
      if (kh >= 0 && kh < 3) {
        bf16* dst = col + ((kd * 3 + kh) * 3 * KC + ci) * KS + row * TW + 8 * q;
        *reinterpret_cast<uint4*>(dst) = kw0;
        *reinterpret_cast<uint4*>(dst + KC * KS) = v;
        *reinterpret_cast<uint4*>(dst + 2 * KC * KS) = kw2;
      }
    }
  }
}

// Two blocks per SM, as shared memory allows.
template <bool VX>
__global__ void __launch_bounds__(NTHREADS, 2)
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
    // The chunk's loads are in flight while the weights are staged.
    Units un;
    load_units<VX>(un, xb, D, H, C, W, d, h0, w0, c0);
    convk::stage_weights<NTHREADS, CO_T, WS>(ws, wt, Cout_pad, Cin_pad, co0, c0);
    store_units(col, un);
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

template <bool VX>
int launch_kernel(const bf16* x, const bf16* wt, bf16* y, float* psum, float* psq, int B,
                  int D, int C, int H, int W, int Cout, int Cin_pad, int Cout_pad,
                  cudaStream_t st) {
  static bool attr_done = false;
  if (!attr_done) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3x3_stats_v1_kernel<VX>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_done = true;
  }
  const int nh = (H + TH - 1) / TH, nw = (W + TW - 1) / TW, nco = Cout_pad / CO_T;
  dim3 grid(nh * nw, D, B * nco);
  conv3x3_stats_v1_kernel<VX><<<grid, NTHREADS, SMEM_BYTES, st>>>(
      x, wt, y, psum, psq, D, C, H, W, Cout, Cin_pad, Cout_pad, nw, nco,
      (int64_t)D * nh * nw);
  return (int)cudaGetLastError();
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
      static_cast<float*>(sums), static_cast<float*>(sqs), conv3x3_stats_v1_nblk(D, H, W),
      Cout, Cout_pad);
  return (int)cudaGetLastError();
}

}  // extern "C"
