// Device helpers shared by the point kernels K2 (nn_min.cu) and K3
// (corr_argmax.cu): 4-byte cp.async staging into shared memory, and the
// base-2 exponential of the special-function unit.
#pragma once

#include <cuda_runtime.h>

namespace point {

// threads per block of both kernels, and queries each thread keeps in
// registers: a block covers QPB queries (point_queries_per_block(), which
// the wrappers' split planner reads)
constexpr int NT = 128;
constexpr int QPT = 4;
constexpr int QPB = NT * QPT;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lanes that merge one query's partials: the least power of two >= the
// split count, at most a warp (csrc merge kernels, 256 threads a block).
inline int merge_lanes(int n_splits) {
  int lanes = 1;
  while (lanes < n_splits && lanes < 32) lanes <<= 1;
  return lanes;
}

// 2^x (ex2.approx: ~2 ulp, 0 for -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace point
