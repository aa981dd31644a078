// Stride-1 3x3x3 SAME convolution + InstanceNorm moments in the (D, H, C, W)
// layout, as a GEMM per output tile over an im2col tile built in shared
// memory: bf16 in/out, f32 accumulation, for Hopper (sm_90a).
//
// Replaces runet_tpu/kernels/fused_block.py::_conv_stats_kernel (v1, the
// Pallas kernel behind conv_in_stats_dhcw_batch). Contract:
//   x  (B, D, H, C, W) bf16, SAME zero padding on D, H and W;
//   wt (27, Cout_pad, Cin_pad) bf16: tap-major, channels zero-padded, 16-byte
//      aligned (cp.async; the launcher refuses another address);
//   y  (B, D, H, Cout, W) bf16, written in that layout by the kernel;
//   sums, sqs (B, Cout) f32 of the bf16-ROUNDED output.
//
// v1's idea, carried to the card: materialise the im2col tile
//   col[k = tap * 16 + ci][v = row * TW + w] =
//       x[d + kd - 1, h0 + row + kh - 1, c0 + ci, w0 + w + kw - 1]
// and contract K with no address arithmetic left in the GEMM loop. The voxel
// index is innermost, as W is in the tensor, so the copy is coalesced both
// ways and every A fragment is one ldmatrix.x4.trans. A layer's full
// K = 27 * C (8640 at C = 320) is looped in 16-channel chunks, and each
// chunk in three phases, one kd plane each: a phase builds only its 9 taps
// (144 k rows x 128 voxels, k stride KS = 136 bf16 = 272 B = 16 mod 128, so
// the eight rows of an ldmatrix lie in distinct bank groups) and stages only
// their weights, then runs 9 k16 steps. The k steps run kd-major, chunks in
// ascending c0, as a single 27-tap pass would, so every accumulator sees the
// same sequence of MMAs on the same operands.
//
// Block = one output depth d, TH = 4 rows x TW = 32 columns x CO_T = 32
// output channels, 4 warps; warp w owns output row w: two m16 tiles (both
// 16-column halves) by four n8 tiles, so the eight B fragments a k step
// loads from shared memory feed 8 MMAs. Shared memory: 39,168 B of im2col
// and 13,824 B of weights, 53 KB with the moment arrays, so four blocks
// (16 warps) fit on an SM. A phase: __syncthreads; the weights' cp.async
// copies issued; the tile's global loads (load_units<VX>); their shared
// stores (store_units); cp.async.wait_group 0; __syncthreads; 9 k steps.
// The weight copies and the loads are in flight together, and the other
// three blocks on the SM fill each block's waits.
//
// The im2col tile is built from 16-byte chunks along W: each (line,
// 8-column chunk) unit is one 16-byte load under the launcher's VX flag
// (W % 8 == 0 and x 16-byte aligned; else 8 masked element loads), and fills
// up to 9 runs of col with 16-byte stores, its kw = 0 and kw = 2 runs made
// by shuffles and byte-permutes: 18 16-byte stores per thread and phase. col
// holds the same bytes as an element-wise copy, so y and the moments do not
// depend on which loads built it.
//
// Moments as in conv3x3_stats.cu: from the rounded output, per-block
// partials, reduced in a fixed order, no float atomics. The partial slots
// keep a 2-row grouping (conv3x3_stats_v1_nblk): a 4-row block writes one
// slot per 2-row half that lies in the output, each summed in the order of
// a 2-row, 4-warp block, so the sums keep their bits whatever TH is.
//
// What bounds it on the H100: operations by the roofline (7.18 ms over the
// 42 shapes the renal_anatomy v1 paths launch), but it runs those shapes in
// ~50 ms (chip_smoke.py's kernels phase; NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md §6): 142-157 TFLOP/s at level 0, up to 188 at the deep levels,
// 108 registers, no spills, 4 blocks per SM. V1_PHASES (below) leaves out a
// phase at compile time, and utils/phase_probe.py times each share: at
// 32³ 128->128 and 8³ 320->320 the GEMM ~0.42, the build ~0.37 and the
// weight copies 0.12-0.19 of the time; at 128³ 32->32 (two chunks) the
// three shares sum to ~0.4, and the rest (overlap between phases, and the
// epilogue, barriers and moment pass) is not split yet. Left: the im2col
// rebuilt for each 32-channel output tile (10 times at Cout 320); padding
// at W <= 16, where cuDNN still leads; one phase buffer, so a block's
// staging and its MMAs do not overlap; mma.sync rather than wgmma.
#include "conv3x3_common.cuh"

// The phases the kernel runs: 1 the im2col build, 2 the weight staging,
// 4 the GEMM. A build that leaves one out computes a wrong y; it exists only
// to time the phase's share (utils/phase_probe.py).
#ifndef V1_PHASES
#define V1_PHASES 7
#endif

namespace {

using convk::bf16;

constexpr int TH = 4;      // output rows per block
constexpr int TW = 32;     // output columns per block
constexpr int CO_T = 32;   // output channels per block
constexpr int KC = 16;     // input channels per chunk
constexpr int WS = 24;     // shared stride (bf16) of one (tap, cout) weight row
constexpr int MT = TW / 16;          // m16 tiles per warp: one output row
constexpr int NT = CO_T / 8;
constexpr int NWARPS = TH;           // warp w owns output row w
constexpr int NTHREADS = NWARPS * 32;
constexpr int NV = TH * TW;          // voxels per tile
constexpr int KS = NV + 8;           // shared stride (bf16) of one k row
constexpr int TAPS = 9;              // taps of one kd plane
constexpr int KROWS = TAPS * KC;     // im2col rows per phase
constexpr int SMEM_COL = KROWS * KS;
constexpr int SMEM_W = TAPS * CO_T * WS;
constexpr int SMEM_BYTES = (SMEM_COL + SMEM_W) * 2;
constexpr int SLOT_TH = 2;           // output rows per moment-partial slot
constexpr int SLOTS = TH / SLOT_TH;  // slots per block
static_assert(KS % 8 == 0 && (KS * 2) % 128 == 16, "ldmatrix rows: aligned and conflict-free");
static_assert((SMEM_COL * 2) % 16 == 0 && (WS * 2) % 16 == 0, "cp.async targets: 16-byte aligned");

// Issue the copies of plane kd's weights for one 16-channel chunk:
// ws[(tap * CO_T + co) * WS + ci] = wt[kd * 9 + tap, co0 + co, c0 + ci], two
// 16-byte cp.async per (tap, cout) row, 4.5 per thread, as one group.
__device__ __forceinline__ void stage_weights_async(bf16* __restrict__ ws,
                                                    const bf16* __restrict__ wt, int Cout_pad,
                                                    int Cin_pad, int co0, int c0, int kd) {
  for (int e = threadIdx.x; e < TAPS * CO_T * 2; e += NTHREADS) {
    const int half = e & 1, r = e >> 1;
    const int co = r % CO_T, tap = r / CO_T;
    const bf16* src =
        wt + ((int64_t)(kd * TAPS + tap) * Cout_pad + co0 + co) * Cin_pad + c0 + half * 8;
    convk::cp_async16(ws + (tap * CO_T + co) * WS + half * 8, src);
  }
  convk::cp_async_commit();
}

// One phase's im2col tile from 16-byte chunks along W. The phase reads
// (TH + 2) input rows r x 16 channels = 96 lines, input
// (dd, h0 + r - 1, c0 + ci) with dd = d + kd - 1, each over columns
// w0 - 1 .. w0 + TW. A unit is one line and one 8-column chunk q (columns
// w0 + 8q .. +7), and every unit fills a 16-byte run of col for each
// (row, kh) with row + kh = r and each kw. Lane -> (ci % 8 = lane & 7,
// q = lane >> 3), so the eight threads of one 16-byte store phase write
// eight channel rows of one q, 272 B apart: eight distinct bank groups.
// Warp `warp` takes, at step u, the line group L = u * NWARPS + warp of the
// 12 groups L = r * 2 + ci / 8, so r = 2 * u + warp / 2.
//
// load_units issues a thread's three chunk loads (ld_chunk<VX>: one 16-byte
// load under VX, else 8 masked element loads) and its halo elements, all
// before store_units stores anything: lanes with q == 0 also load column
// w0 - 1, lanes with q == 3 column w0 + TW. The kw = 0 and kw = 2 runs are
// the chunk shifted by one column either way: a shuffle brings the left
// neighbour's last word and the right neighbour's first (the edge lanes take
// their halo element instead), and __byte_perm(a, b, 0x5432) = (high half
// of a, low half of b) joins two adjacent words. Zero outside D and H, past
// W and past channel C, as in an element-wise copy, so col holds the same
// bytes.
constexpr int UNITS = (TH + 2) * 2 / NWARPS;  // units per thread and phase
static_assert(TH == 4 && NWARPS == 4 && TW == 32 && KC == 16,
              "lane and warp maps: four 8-column chunks, two channel halves");

// One thread's units of a phase, loaded and not yet stored: its chunks and
// halo elements.
struct Units {
  uint4 v[UNITS];
  uint32_t e[UNITS];
};

template <bool VX>
__device__ __forceinline__ void load_units(Units& un, const bf16* __restrict__ xb, int D, int H,
                                           int C, int W, int dd, int h0, int w0, int c0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 3, ci = (warp & 1) * 8 + (lane & 7), r0 = warp >> 1;
  const int wq = w0 + 8 * q, wh = q == 0 ? w0 - 1 : w0 + TW;
  const bool halo = (q == 0 || q == 3) && (unsigned)wh < (unsigned)W;
  const bool ok = c0 + ci < C && (unsigned)dd < (unsigned)D;
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    const int hh = h0 + r0 + 2 * u - 1;
    const bf16* line = xb + (((int64_t)dd * H + hh) * C + c0 + ci) * W;
    un.v[u] = make_uint4(0u, 0u, 0u, 0u);
    un.e[u] = 0u;
    if (ok && (unsigned)hh < (unsigned)H) {
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
    const int r = r0 + 2 * u;
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
        bf16* dst = col + (kh * 3 * KC + ci) * KS + row * TW + 8 * q;
        *reinterpret_cast<uint4*>(dst) = kw0;
        *reinterpret_cast<uint4*>(dst + KC * KS) = v;
        *reinterpret_cast<uint4*>(dst + 2 * KC * KS) = kw2;
      }
    }
  }
}

// Store warp `warp`'s output row as bf16 and write the block's moment
// partials. Each 2-row slot gets the bits a 2-row, 4-warp block gives it:
// per-thread sums over the fragment's four values in order, kept apart per
// m16 tile; an xor-butterfly over the 8 row lanes; then the slot's four
// (row, m tile) partials summed in the order (row 0, cols 0-15), (row 0,
// 16-31), (row 1, 0-15), (row 1, 16-31).
__device__ __forceinline__ void store_output(
    const float (&acc)[MT][NT][4], bf16* __restrict__ ybase, int H, int W, int Cout, int h0,
    int w0, int co0, float (*red_s)[CO_T], float (*red_q)[CO_T], float* __restrict__ psum,
    float* __restrict__ psq, int64_t pbase, int64_t nblk, int64_t blk0, int64_t blk_stride,
    int slot0, int n_slots) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = h0 + warp;
  const bool h_ok = h < H;
  float s[MT][NT][2], q[MT][NT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[mt][nt][0] = s[mt][nt][1] = q[mt][nt][0] = q[mt][nt][1] = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int w = w0 + mt * 16 + g + (r >= 2 ? 8 : 0);
        const int co = co0 + nt * 8 + 2 * t + (r & 1);
        if (h_ok && w < W && co < Cout) {
          const bf16 v = __float2bfloat16_rn(acc[mt][nt][r]);
          ybase[(int64_t)co * W + (int64_t)h * Cout * W + w] = v;
          const float f = __bfloat162float(v);
          s[mt][nt][r & 1] += f;
          q[mt][nt][r & 1] += f * f;
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s[mt][nt][j] += __shfl_xor_sync(0xffffffffu, s[mt][nt][j], off);
          q[mt][nt][j] += __shfl_xor_sync(0xffffffffu, q[mt][nt][j], off);
        }
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          red_s[warp * MT + mt][nt * 8 + 2 * t + j] = s[mt][nt][j];
          red_q[warp * MT + mt][nt * 8 + 2 * t + j] = q[mt][nt][j];
        }
      }
    }
  }
  __syncthreads();
  constexpr int PER_SLOT = SLOT_TH * MT;  // (row, m tile) partials per slot
  const int slot = threadIdx.x / CO_T, ch = threadIdx.x % CO_T;
  if (slot < SLOTS && slot0 + slot < n_slots) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int i = 0; i < PER_SLOT; ++i) {
      ts += red_s[slot * PER_SLOT + i][ch];
      tq += red_q[slot * PER_SLOT + i][ch];
    }
    const int64_t p = pbase + (int64_t)ch * nblk + blk0 + slot * blk_stride;
    psum[p] = ts;
    psq[p] = tq;
  }
}

// Four blocks per SM, as shared memory allows.
template <bool VX>
__global__ void __launch_bounds__(NTHREADS, 4)
conv3x3_stats_v1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                        bf16* __restrict__ y, float* __restrict__ psum,
                        float* __restrict__ psq, int D, int C, int H, int W, int Cout,
                        int Cin_pad, int Cout_pad, int n_wtiles, int n_cotiles,
                        int64_t nblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* col = reinterpret_cast<bf16*>(smem_raw);
  bf16* ws = col + SMEM_COL;
  __shared__ float red_s[NWARPS * MT][CO_T], red_q[NWARPS * MT][CO_T];

  const int ht = blockIdx.x / n_wtiles, wtile = blockIdx.x % n_wtiles;
  const int d = blockIdx.y;
  const int b = blockIdx.z / n_cotiles, cot = blockIdx.z % n_cotiles;
  const int h0 = ht * TH, w0 = wtile * TW, co0 = cot * CO_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* xb = x + (int64_t)b * D * H * C * W;
  // This lane's row of the ldmatrix: matrix lane / 8, k row lane % 8; m tile
  // mt of the warp's row at a_base + mt * 16.
  const int lm = lane >> 3;
  const bf16* a_base =
      col + ((lane & 7) + ((lm >> 1) << 3)) * KS + ((lm & 1) << 3) + warp * TW;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  for (int c0 = 0; c0 < Cin_pad; c0 += KC) {
#pragma unroll 1
    for (int kd = 0; kd < 3; ++kd) {
      __syncthreads();  // the previous phase's fragments have been read
      // The weight copies are in flight while the tile is loaded and stored.
      if constexpr ((V1_PHASES & 2) != 0)
        stage_weights_async(ws, wt, Cout_pad, Cin_pad, co0, c0, kd);
      if constexpr ((V1_PHASES & 1) != 0) {
        Units un;
        load_units<VX>(un, xb, D, H, C, W, d + kd - 1, h0, w0, c0);
        store_units(col, un);
      }
      convk::cp_async_wait_all();
      __syncthreads();

      // The plane's 9 k16 steps; B fragments loaded once for both m tiles.
      if constexpr ((V1_PHASES & 4) != 0) {
#pragma unroll
        for (int ks = 0; ks < TAPS; ++ks) {
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            convk::ldmatrix_x4_trans(a[mt], a_base + ks * KC * KS + mt * 16);
          uint32_t bfr[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const bf16* p = ws + (ks * CO_T + nt * 8 + g) * WS + 2 * t;
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

  // The block's 2-row slots: (d, ht * SLOTS + i, wtile) in a (D, n_slots,
  // n_wtiles) grid of partials.
  const int n_slots = (H + SLOT_TH - 1) / SLOT_TH, slot0 = ht * SLOTS;
  const int64_t blk0 = ((int64_t)d * n_slots + slot0) * n_wtiles + wtile;
  bf16* ybase = y + ((int64_t)b * D + d) * H * Cout * W;
  store_output(acc, ybase, H, W, Cout, h0, w0, co0, red_s, red_q, psum, psq,
             ((int64_t)b * Cout_pad + co0) * nblk, nblk, blk0, n_wtiles, slot0, n_slots);
}

template <bool VX>
int launch_kernel(const bf16* x, const bf16* wt, bf16* y, float* psum, float* psq, int B,
                  int D, int C, int H, int W, int Cout, int Cin_pad, int Cout_pad,
                  cudaStream_t st) {
  static bool attr_done[convk::MAX_DEVICES] = {};
  if (int e = convk::set_smem_attrs(conv3x3_stats_v1_kernel<VX>, SMEM_BYTES, attr_done))
    return e;
  const int nh = (H + TH - 1) / TH, nw = (W + TW - 1) / TW, nco = Cout_pad / CO_T;
  dim3 grid(nh * nw, D, B * nco);
  conv3x3_stats_v1_kernel<VX><<<grid, NTHREADS, SMEM_BYTES, st>>>(
      x, wt, y, psum, psq, D, C, H, W, Cout, Cin_pad, Cout_pad, nw, nco,
      (int64_t)D * ((H + SLOT_TH - 1) / SLOT_TH) * nw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int conv3x3_stats_v1_cout_tile() { return CO_T; }

// Moment partials per (sample, channel) for a (D, H, W) output: one per
// 2-row, 32-column slot of each depth.
long long conv3x3_stats_v1_nblk(int D, int H, int W) {
  return (long long)D * ((H + SLOT_TH - 1) / SLOT_TH) * ((W + TW - 1) / TW);
}

// Launch the conv kernel and the moment reduction on `stream`. x is
// (B, D, H, C, W) and y (B, D, H, Cout, W); the extents are passed in the
// order the sibling kernels take them. psum/psq: (B, Cout_pad, nblk) f32
// scratch. wt must be 16-byte aligned (cudaErrorInvalidValue otherwise).
// Returns cudaGetLastError().
int conv3x3_stats_v1_launch(const void* x, const void* wt, void* y, void* psum, void* psq,
                            void* sums, void* sqs, int B, int D, int C, int H, int W,
                            int Cout, int Cin_pad, int Cout_pad, void* stream) {
  typedef int (*Launch)(const bf16*, const bf16*, bf16*, float*, float*, int, int, int, int,
                        int, int, int, int, cudaStream_t);
  // The weights' cp.async copies take 16-byte-aligned sources.
  if (reinterpret_cast<uintptr_t>(wt) % 16 != 0) return (int)cudaErrorInvalidValue;
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
