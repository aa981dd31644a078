// InstanceNorm apply + affine + LeakyReLU on a (B, S, C) activation, bf16
// or f32 in and out, f32 arithmetic, for Hopper (sm_90a).
//
// Replaces runet_tpu/kernels/attic/fused_norm.py::_apply_kernel (pass 2 of
// the Pallas fused InstanceNorm + LeakyReLU). Contract:
//   x, y  (B, S, C), channels innermost, the same dtype;
//   mean, rstd (B, C) f32; scale, bias (C,) f32; slope f32;
//   y = z >= 0 ? z : z * slope, z = ((x - mean) * rstd) * scale + bias,
//   each operation rounded once in f32 in that order (no contraction into
//   FMAs), so it equals the plain torch version op for op.
// Bound on the H100: the bytes of one read of x and one write of y (6 FLOP
// per element: far below the ridge). Design: grid (n_tiles, B) over S-tiles
// with the layout of instance_norm_common.cuh: 16-byte vector loads and
// stores, each thread on fixed channels whose mean, rstd, scale and bias
// stay in registers for the whole tile, U rows in flight per thread.
#include "instance_norm_common.cuh"

namespace {

using normk::NTHREADS;
using normk::U;

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
instance_norm_lrelu_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                                 const float* __restrict__ rstd, const float* __restrict__ scale,
                                 const float* __restrict__ bias, float slope, T* __restrict__ y,
                                 int64_t S, int C, int TS) {
  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nv = C / VEC;
  const int cols = nv < NTHREADS ? nv : NTHREADS, rows = NTHREADS / cols;
  const int row = tid / cols, col = tid % cols;
  if (row >= rows) return;
  const int64_t r0 = (int64_t)tile * TS;
  const int64_t r1 = r0 + TS < S ? r0 + TS : S;
  const int64_t base = (int64_t)b * S * C;
  for (int vc = col; vc < nv; vc += cols) {
    float m[VEC], rs[VEC], sc[VEC], bi[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c = vc * VEC + j;
      m[j] = mean[(int64_t)b * C + c];
      rs[j] = rstd[(int64_t)b * C + c];
      sc[j] = scale[c];
      bi[j] = bias[c];
    }
    for (int64_t r = r0 + row; r < r1; r += (int64_t)rows * U) {
      normk::Vec<T, VEC> v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t rr = r + (int64_t)u * rows;
        if (rr < r1)
          v[u] = *reinterpret_cast<const normk::Vec<T, VEC>*>(x + base + rr * C + (int64_t)vc * VEC);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t rr = r + (int64_t)u * rows;
        if (rr >= r1) continue;
        normk::Vec<T, VEC> o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xv = normk::to_f(v[u].v[j]);
          const float z = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xv, m[j]), rs[j]), sc[j]), bi[j]);
          normk::from_f(o.v[j], z >= 0.f ? z : __fmul_rn(z, slope));
        }
        *reinterpret_cast<normk::Vec<T, VEC>*>(y + base + rr * C + (int64_t)vc * VEC) = o;
      }
    }
  }
}

template <typename T, int VEC>
void launch_kernel(const void* x, const void* mean, const void* rstd, const void* scale,
                   const void* bias, float slope, void* y, int B, int64_t S, int C, int TS,
                   int n_tiles, cudaStream_t st) {
  instance_norm_lrelu_apply_kernel<T, VEC><<<dim3(n_tiles, B), NTHREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(scale),
      static_cast<const float*>(bias), slope, static_cast<T*>(y), S, C, TS);
}

template <typename T>
void launch_typed(const void* x, const void* mean, const void* rstd, const void* scale,
                  const void* bias, float slope, void* y, int B, int64_t S, int C, int TS,
                  int n_tiles, cudaStream_t st) {
  switch (normk::pick_vec(C, sizeof(T), x, y)) {
    case 8: launch_kernel<T, 8>(x, mean, rstd, scale, bias, slope, y, B, S, C, TS, n_tiles, st); break;
    case 4: launch_kernel<T, 4>(x, mean, rstd, scale, bias, slope, y, B, S, C, TS, n_tiles, st); break;
    case 2: launch_kernel<T, 2>(x, mean, rstd, scale, bias, slope, y, B, S, C, TS, n_tiles, st); break;
    default: launch_kernel<T, 1>(x, mean, rstd, scale, bias, slope, y, B, S, C, TS, n_tiles, st); break;
  }
}

}  // namespace

extern "C" {

// Rows of one S-tile (the grid is (ceil(S / rows), B)).
int instance_norm_lrelu_apply_tile_rows(long long B, long long S) {
  return normk::tile_rows(B, S);
}

// x, y (B, S, C) bf16 (is_bf16 != 0) or f32; mean, rstd (B, C) f32; scale,
// bias (C,) f32. Returns cudaGetLastError().
int instance_norm_lrelu_apply_launch(const void* x, const void* mean, const void* rstd,
                                     const void* scale, const void* bias, float slope, void* y,
                                     int B, long long S, int C, int is_bf16, int TS,
                                     int n_tiles, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_typed<normk::bf16>(x, mean, rstd, scale, bias, slope, y, B, S, C, TS, n_tiles, st);
  else
    launch_typed<float>(x, mean, rstd, scale, bias, slope, y, B, S, C, TS, n_tiles, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
