// K3: dense correspondence, argmax and log-softmax value of q . k^T.
//
// Replaces the Pallas TPU kernel _corr_kernel (imagesequenceregistration-
// for6dposeestimationlabeling_tpu/ops/pallas_kernels.py, via
// correspondence_argmax).  For each query pixel: idx = argmax_j q . k_j
// (first occurrence wins) and conf = max_logit - logsumexp_j(q . k_j), the
// logits in plain f32 (no TF32), never materialized.
//
// What bounds it on the card: 2E FLOP (E FFMAs) and one exponential a
// (query, key) pair (E = 12), the FFMAs on the f32 lanes, the exponential
// on the special-function unit (16 a clock an SM).  The serving path gives
// it 8 crops x 5,625 queries against ~1k baked keys (80,000 for real
// objects).  Design:
// - grid: query tiles (QPB = 512 queries, 4 a thread in registers, so one
//   shared read of a key feeds four independent chains) x key splits,
//   planned as K2's (ops/point_kernels.py split_plan); each block keeps a
//   partial (best logit, its first index, sum of exp(logit - best)) a
//   query (the running max of the softmax is the best logit itself) and
//   corr_argmax_merge_kernel merges the splits in a fixed order, up to 32
//   threads a query: a larger logit, or an equal one at a lower key index,
//   wins the argmax, and s = sum_j s_j exp(best_j - best) in f64.  One
//   split: no workspace, no merge, the block emits;
// - each logit is the same fmaf chain over k in increasing order whatever
//   the split (zero-padded to EP = 16 columns for E != 12, and
//   fmaf(0, 0, l) = l), so the indices do not depend on the partition;
// - keys staged in shared memory, double-buffered with cp.async, read as
//   float4s; a sub-tile of 8 keys at a time: the thread's logits, the
//   argmax on the unscaled f32 logits in key order (strict '>'), one
//   rescale of the running sum by exp(old best - new best), one
//   exponential a pair, 2^((l - best) log2 e) through ex2.approx, with no
//   per-pair branch; the sub-tile's 8 terms sum in f32, the running sum
//   across sub-tiles in f64.  A running sum in f32 measured conf errors of
//   1.907e-06, 1.907e-06 and 1.335e-05 at 45,000 x 1,024, 5,625 x 80,000
//   and 45,000 x 80,000 (the f64 sum: 1.907e-06 at each), for 4 % less
//   time at the largest (2.890 against 3.017 ms; one H100 80GB HBM3 at
//   700 W).
// No tensor cores: with E = 12, TF32 would round the inputs to 10 bits and
// flip argmaxes; 3xTF32 would remove only a pair's 12 FFMAs, while the
// exponential, the compares and the sum (about half of a pair's
// instructions) remain, and the logits would no longer be bit-stable
// across splits.
#include <cuda_runtime.h>

#include <cmath>

#include <c10/cuda/CUDAException.h>

#include "kernels.h"
#include "point_common.cuh"

namespace {

using point::NT;
using point::QPB;
using point::QPT;

constexpr int TILE = 256;  // keys per shared tile
constexpr int SUB = 8;     // keys per sub-tile (logits in registers, one rescale)
constexpr int EMAX = 16;   // widest embedding the kernel takes
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// A query block's running state: best logit (= the softmax's running max),
// its first key index, and the sum of exp(logit - best) in f64.
struct State {
  float best[QPT];
  int32_t arg[QPT];
  double s[QPT];
};

// One sub-tile of keys kp[0, SUB) (rows of EP floats in shared memory),
// global index i0; with kTail only the first lim keys count.
template <int EP, bool kTail>
__device__ __forceinline__ void sub_tile(const float (&qv)[QPT][EP], const float* kp, int32_t i0, int lim, State& st) {
  float l[QPT][SUB], prev[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) prev[j] = st.best[j];
#pragma unroll
  for (int u = 0; u < SUB; ++u) {
    float kv[EP];
#pragma unroll
    for (int c = 0; c < EP / 4; ++c) {
      const float4 v = reinterpret_cast<const float4*>(kp + u * EP)[c];
      kv[4 * c] = v.x;
      kv[4 * c + 1] = v.y;
      kv[4 * c + 2] = v.z;
      kv[4 * c + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < EP; ++k) acc = fmaf(qv[j][k], kv[k], acc);
      if (kTail && u >= lim) acc = -INFINITY;
      l[j][u] = acc;
      if (acc > st.best[j]) {
        st.best[j] = acc;
        st.arg[j] = i0 + u;
      }
    }
  }
  float r[QPT], sum[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    r[j] = point::ex2((prev[j] - st.best[j]) * LOG2E);
    sum[j] = 0.f;
#pragma unroll
    for (int u = 0; u < SUB; ++u) sum[j] += point::ex2((l[j][u] - st.best[j]) * LOG2E);
  }
#pragma unroll
  for (int j = 0; j < QPT; ++j) st.s[j] = fma(st.s[j], (double)r[j], (double)sum[j]);
}

// Issue the cp.async copies of keys [base, base + tn) into buf (rows of EP
// floats; columns e..EP-1 stay as zeroed at the start).
template <int EP>
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ keys, int e, int64_t base, int tn) {
  const float* src = keys + base * e;
  for (int i = threadIdx.x; i < tn * e; i += NT) {
    const int row = i / e;
    point::cp_async4(buf + row * EP + (i - row * e), src + i);
  }
  point::cp_async_commit();
}

template <int EP>
__device__ __forceinline__ void corr_scan(float* tiles, const float* __restrict__ queries, int64_t n,
                                          const float* __restrict__ keys, int64_t m, int e_in, int64_t split_len,
                                          double* __restrict__ part_s, float* __restrict__ part_b,
                                          int32_t* __restrict__ part_a, int32_t* __restrict__ idx,
                                          float* __restrict__ conf) {
  const int e = EP == 12 ? 12 : e_in;  // a constant divisor on the E = 12 path
  const int64_t q0 = (int64_t)blockIdx.x * QPB + threadIdx.x;
  const int64_t start = (int64_t)blockIdx.y * split_len;
  const int64_t stop = start + split_len < m ? start + split_len : m;
  float qv[QPT][EP];
  State st;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int64_t q = q0 + j * NT;
#pragma unroll
    for (int k = 0; k < EP; ++k) qv[j][k] = (q < n && k < e) ? queries[q * e + k] : 0.f;
    st.best[j] = NEG;
    st.arg[j] = 0;
    st.s[j] = 0.0;
  }
  if (EP > e)
    for (int i = threadIdx.x; i < 2 * TILE * EMAX; i += NT)
      if (i % EP >= e) tiles[i] = 0.f;
  const int n_tiles = stop > start ? (int)((stop - start + TILE - 1) / TILE) : 0;
  auto tile_len = [&](int t) {
    const int64_t left = stop - start - (int64_t)t * TILE;
    return (int)(left < TILE ? left : TILE);
  };
  if (n_tiles > 0) stage<EP>(tiles, keys, e, start, tile_len(0));
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t base = start + (int64_t)t * TILE;
    if (t + 1 < n_tiles) {
      stage<EP>(tiles + ((t + 1) & 1) * TILE * EMAX, keys, e, base + TILE, tile_len(t + 1));
      point::cp_async_wait<1>();
    } else {
      point::cp_async_wait<0>();
    }
    __syncthreads();
    const float* buf = tiles + (t & 1) * TILE * EMAX;
    const int tn = tile_len(t);
    int i = 0;
    for (; i + SUB <= tn; i += SUB) sub_tile<EP, false>(qv, buf + i * EP, (int32_t)(base + i), SUB, st);
    if (i < tn) sub_tile<EP, true>(qv, buf + i * EP, (int32_t)(base + i), tn - i, st);
    __syncthreads();  // before the next stage overwrites this buffer
  }
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int64_t q = q0 + j * NT;
    if (q >= n) continue;
    const double s = st.s[j];
    if (part_b != nullptr) {
      part_s[blockIdx.y * n + q] = s;
      part_b[blockIdx.y * n + q] = st.best[j];
      part_a[blockIdx.y * n + q] = st.arg[j];
    } else {
      idx[q] = st.arg[j];
      conf[q] = st.best[j] - (st.best[j] + (float)log(fmax(s, 1e-30)));
    }
  }
}

// at most 128 registers, so that an SM holds 4 blocks (16 warps); ptxas
// spills none
__global__ void __launch_bounds__(NT, 4)
corr_argmax_kernel(const float* __restrict__ queries, int64_t n, const float* __restrict__ keys, int64_t m, int e,
                   int64_t split_len, double* __restrict__ part_s, float* __restrict__ part_b,
                   int32_t* __restrict__ part_a, int32_t* __restrict__ idx, float* __restrict__ conf) {
  __shared__ __align__(16) float tiles[2 * TILE * EMAX];
  if (e == 12)
    corr_scan<12>(tiles, queries, n, keys, m, e, split_len, part_s, part_b, part_a, idx, conf);
  else
    corr_scan<16>(tiles, queries, n, keys, m, e, split_len, part_s, part_b, part_a, idx, conf);
}

// (b, a) wins the argmax over (best, arg): a larger logit, or an equal one
// at a lower key index (a total order: the first occurrence of the max).
__device__ __forceinline__ void take_max(float b, int32_t a, float& best, int32_t& arg) {
  if (b > best || (b == best && a < arg)) {
    best = b;
    arg = a;
  }
}

// A query's partials, merged by `lanes` neighbouring threads, each over
// splits lane, lane + lanes, ... in increasing order: the argmax, combined
// by a butterfly of shuffles, then each lane's sums rescaled to the
// overall best and added in f64, the lanes' sums added by a fixed
// butterfly (every lane ends with the same bits).
__global__ void __launch_bounds__(256)
corr_argmax_merge_kernel(const double* __restrict__ part_s, const float* __restrict__ part_b,
                         const int32_t* __restrict__ part_a, int64_t n, int n_splits, int lanes,
                         int32_t* __restrict__ idx, float* __restrict__ conf) {
  const int64_t q = ((int64_t)blockIdx.x * 256 + threadIdx.x) / lanes;
  const int lane = threadIdx.x & (lanes - 1);
  float best = -INFINITY;
  int32_t arg = INT32_MAX;
  if (q < n)
    for (int s = lane; s < n_splits; s += lanes) take_max(part_b[s * n + q], part_a[s * n + q], best, arg);
  for (int off = lanes >> 1; off > 0; off >>= 1)
    take_max(__shfl_xor_sync(0xffffffffu, best, off), __shfl_xor_sync(0xffffffffu, arg, off), best, arg);
  double sum = 0.0;
  if (q < n)
    for (int s = lane; s < n_splits; s += lanes)
      sum += part_s[s * n + q] * exp((double)part_b[s * n + q] - (double)best);
  for (int off = lanes >> 1; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (q < n && lane == 0) {
    idx[q] = arg;
    conf[q] = best - (best + (float)log(fmax(sum, 1e-30)));
  }
}

}  // namespace

void launch_corr_argmax(const float* queries, int64_t n, const float* keys, int64_t m, int e, int n_splits,
                        int64_t split_len, void* work, int32_t* idx, float* conf, void* stream) {
  if (n <= 0) return;
  TORCH_CHECK(e > 0 && e <= EMAX, "corr_argmax kernel: embedding width must be in [1, 16]");
  TORCH_CHECK(m > 0 && m <= INT32_MAX, "corr_argmax kernel: the key count must be in [1, 2^31)");
  TORCH_CHECK(n_splits >= 1 && n_splits <= 65535 && split_len >= 1 && (int64_t)n_splits * split_len >= m,
              "corr_argmax kernel: the splits must cover the keys, at most 65535 of them");
  TORCH_CHECK(n_splits == 1 || work != nullptr, "corr_argmax kernel: a split run needs its workspace");
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // workspace: s (f64), best (f32), arg (i32), each (n_splits, n)
  double* part_s = n_splits > 1 ? static_cast<double*>(work) : nullptr;
  float* part_b = n_splits > 1 ? reinterpret_cast<float*>(part_s + (int64_t)n_splits * n) : nullptr;
  int32_t* part_a = n_splits > 1 ? reinterpret_cast<int32_t*>(part_b + (int64_t)n_splits * n) : nullptr;
  const dim3 grid((unsigned)((n + QPB - 1) / QPB), (unsigned)n_splits);
  corr_argmax_kernel<<<grid, NT, 0, s>>>(queries, n, keys, m, e, split_len, part_s, part_b, part_a, idx, conf);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  if (n_splits > 1) {
    const int lanes = point::merge_lanes(n_splits);
    corr_argmax_merge_kernel<<<(unsigned)((n * lanes + 255) / 256), 256, 0, s>>>(part_s, part_b, part_a, n, n_splits,
                                                                                 lanes, idx, conf);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
}

int corr_argmax_blocks_per_sm() {
  int blocks = 0;
  C10_CUDA_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, corr_argmax_kernel, NT, 0));
  return blocks;
}
