// Tensor-core tile helpers of the NeRF field kernels K1 (density.cu) and
// K4-K6 (field_tc.cuh, field_tc.cu): bf16 x bf16 -> f32 products with mma.sync.m16n8k16,
// operands read from shared memory with ldmatrix, weights streamed from
// device memory (L2) through a double-buffered cp.async ring.
//
// Why mma.sync and not wgmma: a tile here is 64 points x 256 units, one
// warpgroup's worth, but every product is followed by an epilogue (softplus,
// masks, per-point and per-unit sums in a fixed order) that reads the
// accumulators by row and column, and the same warps run the sin/cos
// embedding and the composite between products.  mma.sync keeps the
// accumulator layout plain (every thread knows its rows and columns) and
// the code one warp-synchronous step at a time; wgmma's asynchronous
// pipeline would pay off only once the kernels overlap loads, products and
// epilogues across warpgroups, which is later work.
//
// A product tile is 64 rows (points) x 256 columns (units); Tile<NTH>
// spreads it over a block of 256 or 512 threads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int MT = 64;          // points per product tile
constexpr int WN = 256;         // columns of every product (hidden units, zero-padded)
constexpr int KS = 32;          // weight rows a ring slab
constexpr int LDW = WN + 8;     // shared row stride of a slab and of a 256-wide tile (bank-conflict-free ldmatrix)
constexpr int SLAB = KS * LDW;  // bf16 per ring slot

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulation
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The value at (row, col) of a shared bf16 tile of stride LDW, as f32.
__device__ __forceinline__ float tile_at(const bf16* T, int row, int col) {
  return __bfloat162float(T[row * LDW + col]);
}

// A block of NTH threads (256 or 512) over the 64 x 256 tile: its warps
// as 2 (rows) x NTH / 64 (columns); warp (wm, wn) owns rows 32 wm .. 32 wm
// + 31 and WC = 256 / (NTH / 64) columns from WC wn, as 2 x JN mma tiles of
// 16 x 8.  acc[i][j][e] holds row 32 wm + 16 i + g + 8 (e >> 1), column
// WC wn + 8 j + 2 q + (e & 1), with g = lane / 4, q = lane % 4 (the mma's
// C fragment).
template <int NTH>
struct Tile {
  static_assert(NTH == 256 || NTH == 512, "a tile block has 256 or 512 threads");
  static constexpr int NWC = NTH / 64;  // warps along the columns
  static constexpr int WC = WN / NWC;   // columns a warp
  static constexpr int JN = WC / 8;     // mma tiles a warp along the columns
  typedef float Acc[2][JN][4];

  static __device__ __forceinline__ int warp_m() { return (threadIdx.x >> 5) / NWC; }
  static __device__ __forceinline__ int warp_n() { return (threadIdx.x >> 5) % NWC; }

  static __device__ __forceinline__ void zero(Acc acc) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // The row / column of acc[i][j][e] in the tile.
  static __device__ __forceinline__ int row(int i, int e) {
    return 32 * warp_m() + 16 * i + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
  }
  static __device__ __forceinline__ int col(int j, int e) {
    return WC * warp_n() + 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
  }

  // acc += A[:, k0 .. k0 + 32) * S, S a 32 x 256 slab (row stride LDW) in
  // shared memory.  A is row-major (MT x K, stride lda) in shared memory,
  // or, with a_trans, stored transposed (K x MT, stride lda: row k holds
  // the tile's 64 rows' k-th values), as the weight-grad contractions read
  // it.
  template <bool a_trans>
  static __device__ __forceinline__ void slab_mma(const bf16* A, int lda, int k0, const bf16* S, Acc acc) {
    const int wm = warp_m(), wn = warp_n();
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m0 = 32 * wm + 16 * i;
        if (a_trans)
          ldsm_x4_t(a[i], A + (size_t)(k0 + kk + (lane & 7) + ((lane >> 4) << 3)) * lda + m0 + ((lane >> 3) & 1) * 8);
        else
          ldsm_x4(a[i], A + (size_t)(m0 + (lane & 15)) * lda + k0 + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int j2 = 0; j2 < JN / 2; ++j2) {
        uint32_t b[4];
        ldsm_x4_t(b, S + (kk + (lane & 15)) * LDW + WC * wn + 16 * j2 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma16816(acc[i][2 * j2], a[i], b[0], b[1]);
          mma16816(acc[i][2 * j2 + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  // Request rows [0, KS) of W (row-major, 256 bf16 a row, 16-byte aligned)
  // into ring slot dst: 1,024 16-byte copies, one commit group.
  static __device__ __forceinline__ void issue_slab(const bf16* W, bf16* dst) {
    for (int c = threadIdx.x; c < KS * WN / 8; c += NTH) {
      const int r = c >> 5, q = c & 31;
      cp_async16(dst + r * LDW + q * 8, W + (size_t)r * WN + q * 8, true);
    }
    cp_async_commit();
  }

  // acc += A (MT x K, row-major in shared memory, stride lda) * W (K x 256,
  // row-major bf16 in device memory), K a multiple of KS.  The weight rows
  // stream through the two ring slots: on entry the first slab of W has
  // been requested into slot `slot`; while the last slab is multiplied the
  // first slab of `next` (when not null) is requested into the other slot,
  // and `slot` is left pointing at it, so a chain of products keeps one
  // slab in flight across its epilogues.  Every thread of the block calls
  // this; it starts and ends with a barrier, so A may have just been
  // written and may be overwritten right after.
  static __device__ __forceinline__ void stream_mma(const bf16* A, int lda, const bf16* W, int K, const bf16* next,
                                                    bf16* ring, int& slot, Acc acc) {
    const int ns = K / KS;
    for (int s = 0; s < ns; ++s) {
      const bf16* nxt = s + 1 < ns ? W + (size_t)(s + 1) * KS * WN : next;
      if (nxt) {
        issue_slab(nxt, ring + (slot ^ 1) * SLAB);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // slab s has landed for every thread; A is written
      slab_mma<false>(A, lda, s * KS, ring + slot * SLAB, acc);
      __syncthreads();  // slot is free for the request two slabs on
      slot ^= 1;
    }
  }

  // Per-row sums of v over the tile's columns, in a fixed order: each
  // thread's columns, the 4 lanes of a row, then the NWC column warps
  // through red (NWC x MT floats).  Returns the full sum of row threadIdx.x
  // for threads < MT (0 elsewhere).  Starts and ends with a barrier.
  static __device__ __forceinline__ float row_sum(const Acc v, float* red) {
    const int lane = threadIdx.x & 31;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < JN; ++j) s += v[i][j][2 * h] + v[i][j][2 * h + 1];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if ((lane & 3) == 0) red[warp_n() * MT + row(i, 2 * h)] = s;
      }
    __syncthreads();
    float out = 0.f;
    if (threadIdx.x < MT) {
#pragma unroll
      for (int w = 0; w < NWC; ++w) out += red[w * MT + threadIdx.x];
    }
    __syncthreads();
    return out;
  }

  // Per-column sums of v over the tile's rows, in a fixed order: each
  // thread's 4 rows, the 8 lanes of a column, then the 2 row warps through
  // red (2 x WN floats).  Returns the full sum of column threadIdx.x for
  // threads < WN (0 elsewhere).  Starts and ends with a barrier.
  static __device__ __forceinline__ float col_sum(const Acc v, float* red) {
    const int lane = threadIdx.x & 31;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < JN; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float s = v[0][j][c] + v[0][j][c + 2] + v[1][j][c] + v[1][j][c + 2];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane < 4) red[warp_m() * WN + col(j, c)] = s;
      }
    __syncthreads();
    const float out = threadIdx.x < WN ? red[threadIdx.x] + red[WN + threadIdx.x] : 0.f;
    __syncthreads();
    return out;
  }

  // Store v as bf16 pairs into a 64 x 256 shared tile (row stride LDW).
  static __device__ __forceinline__ void store_tile(const Acc v, bf16* T) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(T + row(i, 2 * h) * LDW + col(j, 2 * h)) =
              __floats2bfloat162_rn(v[i][j][2 * h], v[i][j][2 * h + 1]);
  }

  // Copy rows [0, rows) x columns [0, width) of a shared bf16 tile (stride
  // lds) to device memory (stride ldg), 16 bytes a thread per step; width
  // a multiple of 8.
  static __device__ __forceinline__ void to_global(const bf16* T, int lds, int rows, int width, bf16* G,
                                                   int64_t ldg) {
    const int per_row = width / 8;
    for (int c = threadIdx.x; c < rows * per_row; c += NTH) {
      const int r = c / per_row, q = c % per_row;
      *reinterpret_cast<uint4*>(G + r * ldg + q * 8) = *reinterpret_cast<const uint4*>(T + r * lds + q * 8);
    }
  }
};

}  // namespace mma
