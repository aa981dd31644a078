// InstanceNorm apply + affine + LeakyReLU from given moments, on the
// U-Net's own planar layouts, bf16 or f32 in and out, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is XLA's fusion of the norm's apply in
// runet_tpu/models/norm.py (plus the LeakyReLU that follows it in
// runet_tpu/models/unet3d.py::ConvNormAct), written by hand, because
// PyTorch runs the same arithmetic as seven activation-sized launches
// (48 bytes an element in bf16). Contract:
//   y, out  contiguous, the same dtype, a sequence of planes of P elements,
//           each belonging to one (sample, channel): (B, D, C, H, W) with
//           P = H * W, or (B, D, H, C, W) with P = W; plane p has channel
//           p % C and sample p / planes_per_sample;
//   mean, sqmean (B, C) f32 (the conv kernels' moments); scale, bias (C,)
//   f32; eps, slope f32;
//   var  = max(sqmean - mean * mean, 0), rstd = rsqrt(var + eps),
//   z    = ((y - mean) * rstd) * scale + bias,
//   v    = z rounded to the dtype, out = (v > 0 ? v : v * slope) rounded,
// each operation rounded once in f32 in that order (no contraction into
// FMAs), the LeakyReLU on the already-rounded value: op for op the plain
// torch chain (InstanceNorm.forward + F.leaky_relu), so bit for bit.
// Bound on the H100: the bytes of one read of y and one write of out
// (~13 FLOP an element: far below the ridge). Design: the activation is a
// flat run of 16-byte vectors (VEC elements; narrower where P or an
// address does not allow 16 bytes, so no vector crosses a plane); each
// thread loads U vectors, a block apart so a warp's loads are contiguous,
// before it uses any; a thread recomputes its (sample, channel) parameters
// only when its next vector lies past the plane it last saw, so on the
// large planes (P up to 40,960) it divides and loads them once. The grid
// takes U = 4, 2 or 1 and then 256, 128 or 64 threads, the first that
// gives at least 4 blocks per SM, so the deepest levels (P = 160) still
// fill the card. 32-bit indices below 2^31 elements.
#include "instance_norm_common.cuh"

namespace {

using normk::bf16;

template <typename T, int VEC, int U, typename Idx>
__global__ void __launch_bounds__(256)
norm_lrelu_planes_kernel(const T* __restrict__ y, const float* __restrict__ mean,
                         const float* __restrict__ sqmean, const float* __restrict__ scale,
                         const float* __restrict__ bias, float eps, float slope,
                         T* __restrict__ out, Idx n_vec, Idx plane_vecs, Idx planes_per_sample,
                         int C) {
  typedef normk::Vec<T, VEC> V;
  const Idx step = blockDim.x;
  const Idx v0 = (Idx)blockIdx.x * step * U + threadIdx.x;
  V v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const Idx i = v0 + (Idx)u * step;
    if (i < n_vec) v[u] = reinterpret_cast<const V*>(y)[i];
  }
  Idx plane_end = 0;  // first vector past the plane whose parameters are held
  float m = 0.f, rs = 0.f, sc = 0.f, bi = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const Idx i = v0 + (Idx)u * step;
    if (i >= n_vec) break;
    if (i >= plane_end) {
      const Idx plane = i / plane_vecs;
      plane_end = (plane + 1) * plane_vecs;
      const int c = (int)(plane % C);
      const Idx bc = plane / planes_per_sample * C + c;
      m = mean[bc];
      const float d = __fsub_rn(sqmean[bc], __fmul_rn(m, m));
      rs = rsqrtf(__fadd_rn(d < 0.f ? 0.f : d, eps));
      sc = scale[c];
      bi = bias[c];
    }
    V o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float z = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(normk::to_f(v[u].v[j]), m), rs),
                                          sc), bi);
      T r;
      normk::from_f(r, z);
      const float a = normk::to_f(r);
      normk::from_f(o.v[j], a > 0.f ? a : __fmul_rn(a, slope));
    }
    reinterpret_cast<V*>(out)[i] = o;
  }
}

// One launch's arguments, as the C entry point received them.
struct Args {
  const void *y, *mean, *sqmean, *scale, *bias;
  float eps, slope;
  void* out;
  long long n, plane, planes_per_sample;
  int C, sms;
  cudaStream_t st;
};

template <typename T, int VEC, int U, typename Idx>
void launch_kernel(const Args& a, int threads) {
  const long long n_vec = a.n / VEC, per_block = (long long)threads * U;
  norm_lrelu_planes_kernel<T, VEC, U, Idx>
      <<<(unsigned)((n_vec + per_block - 1) / per_block), threads, 0, a.st>>>(
          static_cast<const T*>(a.y), static_cast<const float*>(a.mean),
          static_cast<const float*>(a.sqmean), static_cast<const float*>(a.scale),
          static_cast<const float*>(a.bias), a.eps, a.slope, static_cast<T*>(a.out),
          (Idx)n_vec, (Idx)(a.plane / VEC), (Idx)a.planes_per_sample, a.C);
}

template <typename T, int VEC>
void launch_vec(const Args& a) {
  if (a.n >= (1LL << 31)) {  // 64-bit indices; such a tensor fills the card at U = 4
    launch_kernel<T, VEC, 4, long long>(a, 256);
    return;
  }
  // The first of (U 4, 2, 1 at 256 threads, then 128 and 64 threads at
  // U 1) that gives 4 blocks per SM.
  static const int grids[5][2] = {{4, 256}, {2, 256}, {1, 256}, {1, 128}, {1, 64}};
  int k = 0;
  while (k < 4 && a.n / VEC < 4LL * a.sms * grids[k][0] * grids[k][1]) ++k;
  switch (grids[k][0]) {
    case 4: launch_kernel<T, VEC, 4, unsigned>(a, grids[k][1]); break;
    case 2: launch_kernel<T, VEC, 2, unsigned>(a, grids[k][1]); break;
    default: launch_kernel<T, VEC, 1, unsigned>(a, grids[k][1]); break;
  }
}

template <typename T>
void launch_typed(const Args& a) {
  // The widest vector of at most 16 bytes that divides the plane, with y
  // and out aligned to it (pick_vec tests divisibility by 8, 4 and 2 only,
  // which plane % 16 + 16 shares with the plane).
  constexpr int MAXV = 16 / sizeof(T);
  switch (normk::pick_vec((int)(a.plane % 16) + 16, sizeof(T), a.y, a.out)) {
    case MAXV: launch_vec<T, MAXV>(a); break;
    case MAXV / 2: launch_vec<T, MAXV / 2>(a); break;
    case MAXV / 4: launch_vec<T, MAXV / 4>(a); break;
    default: launch_vec<T, 1>(a); break;
  }
}

}  // namespace

extern "C" {

// y, out: n elements, bf16 (is_bf16 != 0) or f32, planes of `plane`
// elements; mean, sqmean (B, C) f32; scale, bias (C,) f32; `sms` the
// device's SM count. Returns cudaGetLastError().
int norm_lrelu_planes_launch(const void* y, const void* mean, const void* sqmean,
                             const void* scale, const void* bias, float eps, float slope,
                             void* out, long long n, long long plane,
                             long long planes_per_sample, int C, int is_bf16, int sms,
                             void* stream) {
  const Args a{y, mean, sqmean, scale, bias, eps, slope, out, n, plane, planes_per_sample, C,
               sms, reinterpret_cast<cudaStream_t>(stream)};
  if (is_bf16)
    launch_typed<bf16>(a);
  else
    launch_typed<float>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
