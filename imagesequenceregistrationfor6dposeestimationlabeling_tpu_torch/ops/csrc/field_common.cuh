// Device helpers of the NeRF field kernels K1 (density.cu), K4
// (bundle_loss.cu) and K5/K6 (field_color.cu, through field_tc.cuh): the
// harmonic embedding, the activations with the reference kernel's
// numerics, and `sum_slices`, which adds per-block f32 slices in a fixed
// order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace field {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// (max(y, 0) + log1p(exp(-|y|))) / beta with y = beta * x: the stable form
// of the reference kernel's _softplus_b
__device__ __forceinline__ float softplus_b(float x, float beta) {
  const float y = x * beta;
  return (fmaxf(y, 0.f) + log1pf(expf(-fabsf(y)))) / beta;
}

// sigmoid(beta x) from h = softplus_b(x)
__device__ __forceinline__ float sig_from_act(float h, float beta) { return 1.f - expf(-beta * h); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Harmonic embedding of `rows` points (x, rows of 3; rows >= n_valid read
// as 0) into sin / cos blocks of width E = n_base * max(ladder, 1), rung-
// major for the grouped ladder (column l * n_base + cb), rounded to bf16;
// ld is the row stride of es and ec.  The block's NTH threads share the work.
template <typename T, int NTH = 256>
__device__ __forceinline__ void embed(const float* __restrict__ x, int n_valid, int rows,
                                      const float* __restrict__ fmat, int n_base, int ladder, int ld, T* es,
                                      T* ec) {
  for (int i = threadIdx.x; i < rows * n_base; i += NTH) {
    const int p = i / n_base;
    const int cb = i % n_base;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f;
    if (p < n_valid) {
      x0 = x[p * 3];
      x1 = x[p * 3 + 1];
      x2 = x[p * 3 + 2];
    }
    // one nonzero frequency per column: the sum is exact, as the TPU kernel's
    const float ang = __fadd_rn(__fadd_rn(__fmul_rn(x0, fmat[cb]), __fmul_rn(x1, fmat[n_base + cb])),
                                __fmul_rn(x2, fmat[2 * n_base + cb]));
    float s, c;
    sincosf(ang, &s, &c);
    store(es + p * ld + cb, bf16_round(s));
    store(ec + p * ld + cb, bf16_round(c));
    for (int l = 1; l < ladder; ++l) {
      const float s2 = __fmul_rn(__fmul_rn(2.f, s), c);
      const float c2 = __fsub_rn(1.f, __fmul_rn(2.f, __fmul_rn(s, s)));
      s = s2;
      c = c2;
      store(es + p * ld + l * n_base + cb, bf16_round(s));
      store(ec + p * ld + l * n_base + cb, bf16_round(c));
    }
  }
}

// out[h][i] = sum_b work[h][b][i], b in order.  static: each source that
// includes this header has its own copy.
static __global__ void sum_slices(const float* __restrict__ work, int n_blocks, int64_t width, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= width) return;
  const float* base = work + (int64_t)blockIdx.y * n_blocks * width + i;
  float sum = 0.f;
  for (int b = 0; b < n_blocks; ++b) sum += base[(int64_t)b * width];
  out[(int64_t)blockIdx.y * width + i] = sum;
}

}  // namespace field
