// K2: nearest neighbour of each query point in a masked reference cloud.
//
// Replaces the Pallas TPU kernel _nn_kernel (imagesequenceregistration-
// for6dposeestimationlabeling_tpu/ops/pallas_kernels.py, via nn_min).
// For each query: the squared distance to every reference point from exact
// per-coordinate differences, d = ((dx*dx) + dy*dy) + dz*dz with every
// product and sum rounded on its own (no FMA contraction, never the
// |a|^2 + |b|^2 - 2ab expansion); masked references read 1e30; the running
// minimum takes a strict '<' in increasing reference order, so ties go to
// the lowest index; the square root is taken at emit.
//
// What bounds it on the card: 9 unfused f32 operations a (query,
// reference) pair, one issue slot each (no FMA to pair them), and nothing
// else once the blocks fill the SMs.  The serving path gives it a few
// hundred queries against up to tens of thousands of references: one
// query a thread would give a handful of blocks for 132 SMs.  Design:
// - grid: query tiles (QPB = 512 queries, 4 a thread, so one shared read
//   of a reference feeds four independent chains) x reference splits, the
//   split count planned by the wrapper (ops/point_kernels.py split_plan)
//   so that the blocks fill the card; each block writes a partial (d^2,
//   index) a query to a workspace, and nn_min_merge_kernel merges a
//   query's partials (a smaller d^2, or an equal one at a lower index,
//   wins: a total order), up to 32 threads a query, each over its splits
//   in increasing order, then a shuffle butterfly; so the result does not
//   depend on the split: bit-identical to nn_min_plain.  One split: no
//   workspace, no merge, the block emits;
// - references staged in shared memory as 16-byte (x, y, z, -) records,
//   double-buffered with cp.async so the next tile loads while this one is
//   scanned; a masked reference (and the padding of a ragged tile) gets
//   x = +inf, so its distance is inf or NaN and never wins a strict '<':
//   the mask costs nothing a pair.
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include "kernels.h"
#include "point_common.cuh"

namespace {

using point::NT;
using point::QPB;
using point::QPT;

constexpr int TILE = 256;          // reference records per shared tile
constexpr int RPT = TILE / NT;     // records each thread stages a tile
constexpr float BIG = 1e30f;

// Issue the cp.async copies of tile [base, base + TILE) of the split ending
// at stop into buf, padding past stop with x = +inf; returns each staged
// record's mask value (1 where there is no mask or no record).
__device__ __forceinline__ void stage(float4* buf, const float* __restrict__ ref, const float* __restrict__ mask,
                                      int64_t base, int64_t stop, float (&mk)[RPT]) {
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int i = threadIdx.x + k * NT;
    const int64_t r = base + i;
    mk[k] = 1.f;
    if (r < stop) {
      point::cp_async4(&buf[i].x, ref + r * 3);
      point::cp_async4(&buf[i].y, ref + r * 3 + 1);
      point::cp_async4(&buf[i].z, ref + r * 3 + 2);
      if (mask != nullptr) mk[k] = mask[r];
    } else {
      buf[i].x = __int_as_float(0x7f800000);
    }
  }
  point::cp_async_commit();
}

__global__ void __launch_bounds__(NT)
nn_min_kernel(const float* __restrict__ query, int64_t n, const float* __restrict__ ref,
              const float* __restrict__ mask, int64_t m, int64_t split_len, float* __restrict__ part_d,
              int32_t* __restrict__ part_i, float* __restrict__ dist, int32_t* __restrict__ idx) {
  __shared__ __align__(16) float4 tile[2][TILE];
  const int64_t q0 = (int64_t)blockIdx.x * QPB + threadIdx.x;
  const int64_t start = (int64_t)blockIdx.y * split_len;
  const int64_t stop = start + split_len < m ? start + split_len : m;
  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
  int32_t arg[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int64_t q = q0 + j * NT;
    qx[j] = q < n ? query[q * 3] : 0.f;
    qy[j] = q < n ? query[q * 3 + 1] : 0.f;
    qz[j] = q < n ? query[q * 3 + 2] : 0.f;
    best[j] = BIG;
    arg[j] = 0;
  }
  const int n_tiles = stop > start ? (int)((stop - start + TILE - 1) / TILE) : 0;
  float mk_next[RPT], mk[RPT];
  if (n_tiles > 0) stage(tile[0], ref, mask, start, stop, mk_next);
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t base = start + (int64_t)t * TILE;
    float4* buf = tile[t & 1];
#pragma unroll
    for (int k = 0; k < RPT; ++k) mk[k] = mk_next[k];
    if (t + 1 < n_tiles) {
      stage(tile[(t + 1) & 1], ref, mask, base + TILE, stop, mk_next);
      point::cp_async_wait<1>();
    } else {
      point::cp_async_wait<0>();
    }
    // this thread's own records of the tile have landed: mask them
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      if (!(mk[k] > 0.f)) buf[threadIdx.x + k * NT].x = __int_as_float(0x7f800000);
    __syncthreads();
    const int tn = (int)(stop - base < TILE ? stop - base : TILE);
    const int tn8 = (tn + 7) & ~7;  // records past tn are +inf padding
    for (int i = 0; i < tn8; i += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 p = buf[i + u];
        const int32_t r = (int32_t)(base + i + u);
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          const float dx = __fsub_rn(qx[j], p.x);
          const float dy = __fsub_rn(qy[j], p.y);
          const float dz = __fsub_rn(qz[j], p.z);
          float d = __fmul_rn(dx, dx);
          d = __fadd_rn(d, __fmul_rn(dy, dy));
          d = __fadd_rn(d, __fmul_rn(dz, dz));
          if (d < best[j]) {
            best[j] = d;
            arg[j] = r;
          }
        }
      }
    }
    __syncthreads();  // before the next stage overwrites this buffer
  }
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int64_t q = q0 + j * NT;
    if (q >= n) continue;
    if (part_d != nullptr) {
      part_d[blockIdx.y * n + q] = best[j];
      part_i[blockIdx.y * n + q] = arg[j];
    } else {
      dist[q] = sqrtf(best[j]);
      idx[q] = arg[j];
    }
  }
}

// (d, i) wins over (best, arg): a smaller d^2, or an equal one at a lower
// index.  A total order, so the merged minimum is the lowest index of the
// global minimum whatever the order of the merge.
__device__ __forceinline__ void take_min(float d, int32_t i, float& best, int32_t& arg) {
  if (d < best || (d == best && i < arg)) {
    best = d;
    arg = i;
  }
}

// A query's partials, merged by `lanes` neighbouring threads: each takes
// splits lane, lane + lanes, ... in increasing order, then a butterfly of
// shuffles combines the lanes.
__global__ void __launch_bounds__(256)
nn_min_merge_kernel(const float* __restrict__ part_d, const int32_t* __restrict__ part_i, int64_t n,
                    int n_splits, int lanes, float* __restrict__ dist, int32_t* __restrict__ idx) {
  const int64_t q = ((int64_t)blockIdx.x * 256 + threadIdx.x) / lanes;
  const int lane = threadIdx.x & (lanes - 1);
  float best = __int_as_float(0x7f800000);
  int32_t arg = INT32_MAX;
  if (q < n)
    for (int s = lane; s < n_splits; s += lanes) take_min(part_d[s * n + q], part_i[s * n + q], best, arg);
  for (int off = lanes >> 1; off > 0; off >>= 1)
    take_min(__shfl_xor_sync(0xffffffffu, best, off), __shfl_xor_sync(0xffffffffu, arg, off), best, arg);
  if (q < n && lane == 0) {
    dist[q] = sqrtf(best);
    idx[q] = arg;
  }
}

}  // namespace

void launch_nn_min(const float* query, int64_t n, const float* ref, const float* mask, int64_t m, int n_splits,
                   int64_t split_len, void* work, float* dist, int32_t* idx, void* stream) {
  if (n <= 0) return;
  TORCH_CHECK(m > 0 && m <= INT32_MAX, "nn_min kernel: the reference count must be in [1, 2^31)");
  TORCH_CHECK(n_splits >= 1 && n_splits <= 65535 && split_len >= 1 && (int64_t)n_splits * split_len >= m,
              "nn_min kernel: the splits must cover the references, at most 65535 of them");
  TORCH_CHECK(n_splits == 1 || work != nullptr, "nn_min kernel: a split run needs its workspace");
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part_d = n_splits > 1 ? static_cast<float*>(work) : nullptr;
  int32_t* part_i = n_splits > 1 ? reinterpret_cast<int32_t*>(part_d + (int64_t)n_splits * n) : nullptr;
  const dim3 grid((unsigned)((n + QPB - 1) / QPB), (unsigned)n_splits);
  nn_min_kernel<<<grid, NT, 0, s>>>(query, n, ref, mask, m, split_len, part_d, part_i, dist, idx);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  if (n_splits > 1) {
    const int lanes = point::merge_lanes(n_splits);
    nn_min_merge_kernel<<<(unsigned)((n * lanes + 255) / 256), 256, 0, s>>>(part_d, part_i, n, n_splits, lanes, dist,
                                                                            idx);
    C10_CUDA_KERNEL_LAUNCH_CHECK();
  }
}

int nn_min_blocks_per_sm() {
  int blocks = 0;
  C10_CUDA_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, nn_min_kernel, NT, 0));
  return blocks;
}

int point_queries_per_block() { return QPB; }
