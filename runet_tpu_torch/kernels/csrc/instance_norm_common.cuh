// Shared pieces of the two instance-norm kernels (instance_norm_stats.cu,
// instance_norm_lrelu_apply.cu) on a channels-innermost (B, S, C)
// activation, bf16 or f32.
//
// Thread layout: a block of NTHREADS threads walks one S-tile of one sample.
// The tile's rows are C contiguous elements, read as C / VEC vectors of VEC
// channels (VEC the largest of 8, 4, 2, 1 elements, at most 16 bytes, that
// divides C and keeps the vectors aligned, so C = 20 or 320, not a power of
// two, still needs no ragged edge). Thread `tid` owns vector column
// col = tid % cols and row lane row = tid / cols, cols = min(C / VEC,
// NTHREADS), rows = NTHREADS / cols: it always touches the same VEC
// channels (their parameters stay in registers) and neighbouring threads
// read neighbouring 16-byte vectors. C / VEC above NTHREADS runs in chunks
// of NTHREADS columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace normk {

typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 256;
constexpr int U = 4;  // rows each thread loads before it uses any

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float& o, float v) { o = v; }
__device__ __forceinline__ void from_f(bf16& o, float v) { o = __float2bfloat16_rn(v); }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// Rows of one S-tile: enough tiles for ~4 blocks per SM of the H100 (132
// SMs) where S allows, at most 1024 rows a tile.
inline int tile_rows(long long B, long long S) {
  int ts = 1024;
  while (ts > 64 && B * ((S + ts - 1) / ts) < 4 * 132) ts /= 2;
  return ts;
}

// The vector width for C channels of `elt`-byte elements at the given
// addresses: the largest VEC <= 16 / elt dividing C with every pointer
// aligned to VEC * elt bytes.
inline int pick_vec(int C, int elt, const void* a, const void* b) {
  for (int vec = 16 / elt; vec > 1; vec /= 2) {
    const uintptr_t m = (uintptr_t)(vec * elt) - 1;
    if (C % vec == 0 && ((uintptr_t)a & m) == 0 && ((uintptr_t)b & m) == 0) return vec;
  }
  return 1;
}

}  // namespace normk
