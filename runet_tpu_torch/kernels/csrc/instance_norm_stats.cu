// Per-(sample, channel) sum and sum of squares of a (B, S, C) activation,
// bf16 or f32, accumulated in f32, for Hopper (sm_90a).
//
// Replaces runet_tpu/kernels/attic/fused_norm.py::_stats_kernel (pass 1 of
// the Pallas fused InstanceNorm + LeakyReLU). Contract:
//   x  (B, S, C), channels innermost, S = D*H*W;
//   sums, sqs (B, C) f32: sum over S of x and of x^2.
// Bound on the H100: the bytes of one read of x (3 FLOP per element against
// 2 or 4 bytes: far below the ridge). Design: grid (n_tiles, B); each block
// sums one S-tile for every channel with 16-byte vector loads, each thread
// on fixed channels, U rows in flight per thread (instance_norm_common.cuh),
// then reduces its row lanes in index order into per-tile partials
// (B, C, n_tiles); convk::reduce_moments sums those in a fixed order. No
// float atomics: a run gives the same bits every time.
#include "conv3x3_common.cuh"
#include "instance_norm_common.cuh"

namespace {

using normk::NTHREADS;
using normk::U;

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
instance_norm_stats_kernel(const T* __restrict__ x, float* __restrict__ psum,
                           float* __restrict__ psq, int64_t S, int C, int TS, int n_tiles) {
  __shared__ float red_s[NTHREADS * VEC], red_q[NTHREADS * VEC];
  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nv = C / VEC;
  const int cols = nv < NTHREADS ? nv : NTHREADS, rows = NTHREADS / cols;
  const int row = tid / cols, col = tid % cols;
  const int64_t r0 = (int64_t)tile * TS;
  const int64_t r1 = r0 + TS < S ? r0 + TS : S;
  const T* xb = x + (int64_t)b * S * C;
  for (int vc0 = 0; vc0 < nv; vc0 += cols) {
    const int vc = vc0 + col;
    float s[VEC], q[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
    if (row < rows && vc < nv) {
      for (int64_t r = r0 + row; r < r1; r += (int64_t)rows * U) {
        normk::Vec<T, VEC> v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t rr = r + (int64_t)u * rows;
          if (rr < r1) {
            v[u] = *reinterpret_cast<const normk::Vec<T, VEC>*>(xb + rr * C + (int64_t)vc * VEC);
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j) v[u].v[j] = T(0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float f = normk::to_f(v[u].v[j]);
            s[j] += f;
            q[j] += f * f;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      red_s[tid * VEC + j] = s[j];
      red_q[tid * VEC + j] = q[j];
    }
    __syncthreads();
    // Channel k of this chunk: vector column k / VEC, element k % VEC;
    // its row lanes summed in index order.
    const int nch = (nv - vc0 < cols ? nv - vc0 : cols) * VEC;
    for (int k = tid; k < nch; k += NTHREADS) {
      const int c = k / VEC, j = k % VEC;
      float ts = 0.f, tq = 0.f;
      for (int rl = 0; rl < rows; ++rl) {
        ts += red_s[(rl * cols + c) * VEC + j];
        tq += red_q[(rl * cols + c) * VEC + j];
      }
      const int64_t slot = ((int64_t)b * C + vc0 * VEC + k) * n_tiles + tile;
      psum[slot] = ts;
      psq[slot] = tq;
    }
    __syncthreads();
  }
}

template <typename T, int VEC>
void launch_kernel(const void* x, void* psum, void* psq, int B, int64_t S, int C, int TS,
                   int n_tiles, cudaStream_t st) {
  instance_norm_stats_kernel<T, VEC><<<dim3(n_tiles, B), NTHREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<float*>(psum), static_cast<float*>(psq), S, C, TS,
      n_tiles);
}

template <typename T>
void launch_typed(const void* x, void* psum, void* psq, int B, int64_t S, int C, int TS,
                  int n_tiles, cudaStream_t st) {
  switch (normk::pick_vec(C, sizeof(T), x, x)) {
    case 8: launch_kernel<T, 8>(x, psum, psq, B, S, C, TS, n_tiles, st); break;
    case 4: launch_kernel<T, 4>(x, psum, psq, B, S, C, TS, n_tiles, st); break;
    case 2: launch_kernel<T, 2>(x, psum, psq, B, S, C, TS, n_tiles, st); break;
    default: launch_kernel<T, 1>(x, psum, psq, B, S, C, TS, n_tiles, st); break;
  }
}

}  // namespace

extern "C" {

// Rows of one S-tile; the caller allocates (B, C, ceil(S / rows)) partials.
int instance_norm_stats_tile_rows(long long B, long long S) { return normk::tile_rows(B, S); }

// x (B, S, C) bf16 (is_bf16 != 0) or f32; psum/psq (B, C, n_tiles) f32
// scratch; sums/sqs (B, C) f32. Returns cudaGetLastError().
int instance_norm_stats_launch(const void* x, void* psum, void* psq, void* sums, void* sqs,
                               int B, long long S, int C, int is_bf16, int TS, int n_tiles,
                               void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_typed<normk::bf16>(x, psum, psq, B, S, C, TS, n_tiles, st);
  else
    launch_typed<float>(x, psum, psq, B, S, C, TS, n_tiles, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  convk::reduce_moments<<<dim3(C, B), 256, 0, st>>>(
      static_cast<const float*>(psum), static_cast<const float*>(psq),
      static_cast<float*>(sums), static_cast<float*>(sqs), n_tiles, C, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
