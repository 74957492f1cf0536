// Device helpers shared by the NeRF field kernels K4 (bundle_loss.cu) and
// K5/K6 (field_color.cu): the harmonic embedding, the bf16-operand products
// with f32 accumulation on CUDA cores, the hand backward of the field from
// the cotangents of its two heads, and the per-block f32 grad slices that
// `sum_slices` adds in a fixed order.
//
// Every helper runs on a block of NT threads = 8 point groups x 32 unit
// lanes over a tile of TP points: thread (g, lane) owns points 8 g .. 8 g + 7
// and hidden units lane + 32 c, c < 8, in an 8 x 8 register tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace field {

constexpr int TP = 64;     // points per tile
constexpr int NT = 256;    // threads per block: 8 point groups x 32 unit lanes
constexpr int HMAX = 256;  // widest hidden layer a block covers
constexpr int KT = 16;     // weight rows staged per shared tile

using bf16 = __nv_bfloat16;

// offsets of the 13 grads in a slice, in the order w1s w1c b1 w2 b2 wd bd
// wc1h wc1ds wc1dc bc1 wc2 bc2
struct GradOffsets {
  int64_t w1s, w1c, b1, w2, b2, wd, bd, wc1h, wc1ds, wc1dc, bc1, wc2, bc2, total;
  __host__ __device__ GradOffsets(int64_t E, int64_t C) {
    w1s = 0;
    w1c = w1s + E * C;
    b1 = w1c + E * C;
    w2 = b1 + C;
    b2 = w2 + C * C;
    wd = b2 + C;
    bd = wd + C;
    wc1h = bd + 1;
    wc1ds = wc1h + C * C;
    wc1dc = wc1ds + E * C;
    bc1 = wc1dc + E * C;
    wc2 = bc1 + C;
    bc2 = wc2 + 3 * C;
    total = bc2 + 3;
  }
};

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
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
// E is the row stride of es and ec.  The block's NTH threads share the work.
template <typename T, int NTH = NT>
__device__ __forceinline__ void embed(const float* __restrict__ x, int n_valid, int rows,
                                      const float* __restrict__ fmat, int n_base, int ladder, int E, T* es,
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
    store(es + p * E + cb, bf16_round(s));
    store(ec + p * E + cb, bf16_round(c));
    for (int l = 1; l < ladder; ++l) {
      const float s2 = __fmul_rn(__fmul_rn(2.f, s), c);
      const float c2 = __fsub_rn(1.f, __fmul_rn(2.f, __fmul_rn(s, s)));
      s = s2;
      c = c2;
      store(es + p * E + l * n_base + cb, bf16_round(s));
      store(ec + p * E + l * n_base + cb, bf16_round(c));
    }
  }
}

// The colour head's per-ray direction part, dpart = ds Wc1ds + dc Wc1dc +
// bc1, for threads < nh; ds / dc (the ray's embedding, f32 holding bf16
// values) are left in dsr / dcr.  Ends without a barrier.
__device__ __forceinline__ void dir_part(const float* dir, const float* __restrict__ fmat, int n_base, int ladder,
                                         int E, const float* __restrict__ wc1ds, const float* __restrict__ wc1dc,
                                         const float* __restrict__ bc1, int nh, float* dsr, float* dcr,
                                         float* dpart) {
  embed(dir, 1, 1, fmat, n_base, ladder, E, dsr, dcr);
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < nh) {
    float ps = 0.f, pc = 0.f;
    for (int k = 0; k < E; ++k) {
      ps += dsr[k] * wc1ds[(int64_t)k * nh + tid];
      pc += dcr[k] * wc1dc[(int64_t)k * nh + tid];
    }
    dpart[tid] = ps + pc + bc1[tid];
  }
}

// acc[r][c] += sum_k A[(8 g + r) * lda + k] * W[k * nh + lane + 32 c], k < K,
// with g = threadIdx.x / 32, lane = threadIdx.x % 32; W streams through a
// shared tile.  Starts with a barrier, so A may have just been written.
__device__ __forceinline__ void gemm_acc(const bf16* A, int lda, int K, const float* __restrict__ W, int nh,
                                         float* wtile, float acc[8][8]) {
  const int tid = threadIdx.x;
  const int g = tid >> 5;
  const int lane = tid & 31;
  for (int k0 = 0; k0 < K; k0 += KT) {
    const int kn = min(KT, K - k0);
    __syncthreads();  // the previous tile is consumed and A is written
    for (int i = tid; i < KT * HMAX; i += NT) {
      const int kk = i / HMAX;
      const int j = i % HMAX;
      wtile[i] = (kk < kn && j < nh) ? W[(size_t)(k0 + kk) * nh + j] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      float a[8], w[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = to_f(A[(g * 8 + r) * lda + k0 + kk]);
#pragma unroll
      for (int c = 0; c < 8; ++c) w[c] = wtile[kk * HMAX + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
    }
  }
}

// out[k * N + j] += sum_{t < tn} A[t * lda + k] * D[t * HMAX + j] for k < K,
// j < N: a weight grad contracted over the tile's points, added to this
// block's slice.  Each output belongs to one thread.
__device__ __forceinline__ void contract(const bf16* A, int lda, int K, const bf16* D, int N, int tn, float* out) {
  const int tid = threadIdx.x;
  const int g = tid >> 5;
  const int lane = tid & 31;
  for (int k0 = 0; k0 < K; k0 += 64) {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    for (int t = 0; t < tn; ++t) {
      float a[8], d[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int k = k0 + g * 8 + r;
        a[r] = k < K ? to_f(A[t * lda + k]) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) d[c] = to_f(D[t * HMAX + lane + 32 * c]);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], d[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int k = k0 + g * 8 + r;
      if (k >= K) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = lane + 32 * c;
        if (j < N) out[(size_t)k * N + j] += acc[r][c];
      }
    }
  }
}

// out[j] (+ also[j]) += sum over the tile's points of acc's column j, summed
// per point group first, then over the eight groups in a fixed order.
__device__ __forceinline__ void column_sum(const float acc[8][8], float* red, int nh, float* out, float* also) {
  const int tid = threadIdx.x;
  const int g = tid >> 5;
  const int lane = tid & 31;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) part += acc[r][c];
    red[g * HMAX + lane + 32 * c] = part;
  }
  __syncthreads();
  if (tid < nh) {
    float s = 0.f;
    for (int gg = 0; gg < NT / 32; ++gg) s += red[gg * HMAX + tid];
    out[tid] += s;
    if (also) also[tid] += s;
  }
  __syncthreads();
}

// What the hand backward of one tile reads and overwrites in shared memory.
struct TileGrad {
  bf16 *es, *ec;      // (TP, E) embedding of the tile's points
  bf16 *h1, *h2, *c1;  // (TP, HMAX) stored activations; replaced by their cotangents
  const float *dc2p, *dc2pb;  // (TP, 3) cotangent of the colour output's pre-activation, and bf16-rounded
  const float* du;            // (TP) cotangent of the density head's pre-activation
  float *red, *wtile;         // scratch: (8, HMAX) column sums, (KT, HMAX) weight tile
  float* ddpart;              // (HMAX) the ray's summed dc1p, added to
};

// The reference's _grad_math for tn points, after the caller has written
// dc2p / dc2pb / du and passed a barrier: cotangents through the colour
// head, the trunk and the density head, and every weight grad but the
// direction part's contracted over these points into the slice ws.  Every
// product operand is bf16; dwd is contracted on the rounded h2 with an f32
// du; sigmoid' comes from the stored bf16 activations.  wc1ht and w2t are
// Wc1h and W2 transposed.
__device__ __forceinline__ void tile_backward(const TileGrad& s, const float* __restrict__ wc2,
                                              const float* __restrict__ wd, const float* __restrict__ wc1ht,
                                              const float* __restrict__ w2t, int E, int nh, float beta,
                                              const GradOffsets& o, float* ws, int tn, float acc[8][8]) {
  const int tid = threadIdx.x;
  const int g = tid >> 5;
  const int lane = tid & 31;
  if (tid < nh) {
    float g0 = 0.f, g1 = 0.f, g2 = 0.f, gd = 0.f;
    for (int t = 0; t < tn; ++t) {
      const float c1 = to_f(s.c1[t * HMAX + tid]);
      g0 += c1 * s.dc2pb[t * 3];
      g1 += c1 * s.dc2pb[t * 3 + 1];
      g2 += c1 * s.dc2pb[t * 3 + 2];
      gd += to_f(s.h2[t * HMAX + tid]) * s.du[t];  // density head, rounded h2, f32
    }
    ws[o.wc2 + tid * 3] += g0;
    ws[o.wc2 + tid * 3 + 1] += g1;
    ws[o.wc2 + tid * 3 + 2] += g2;
    ws[o.wd + tid] += gd;
  }
  if (tid < 3) {
    float sum = 0.f;
    for (int t = 0; t < tn; ++t) sum += s.dc2p[t * 3 + tid];
    ws[o.bc2 + tid] += sum;
  }
  if (tid == 3) {
    float sum = 0.f;
    for (int t = 0; t < tn; ++t) sum += s.du[t];
    ws[o.bd] += sum;
  }
  __syncthreads();
  // dc1p = (dc2pb Wc2^T) sigmoid'(c1b); dc1pb replaces c1b in place
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = g * 8 + r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = lane + 32 * c;
      float v = 0.f;
      if (j < nh && t < tn) {
        const float dc1 = s.dc2pb[t * 3] * wc2[j * 3] + s.dc2pb[t * 3 + 1] * wc2[j * 3 + 1] +
                          s.dc2pb[t * 3 + 2] * wc2[j * 3 + 2];
        v = dc1 * sig_from_act(to_f(s.c1[t * HMAX + j]), beta);
      }
      acc[r][c] = v;
      s.c1[t * HMAX + j] = __float2bfloat16_rn(v);
    }
  }
  column_sum(acc, s.red, nh, ws + o.bc1, s.ddpart);
  contract(s.h2, HMAX, nh, s.c1, nh, tn, ws + o.wc1h);
  // dh2p = (dc1pb Wc1h^T + du wd) sigmoid'(h2b); dh2pb replaces h2b
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  gemm_acc(s.c1, HMAX, nh, wc1ht, nh, s.wtile, acc);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = g * 8 + r;
    const float du = t < tn ? s.du[t] : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = lane + 32 * c;
      float v = 0.f;
      if (j < nh && t < tn) v = (acc[r][c] + du * wd[j]) * sig_from_act(to_f(s.h2[t * HMAX + j]), beta);
      acc[r][c] = v;
      s.h2[t * HMAX + j] = __float2bfloat16_rn(v);
    }
  }
  column_sum(acc, s.red, nh, ws + o.b2, nullptr);
  contract(s.h1, HMAX, nh, s.h2, nh, tn, ws + o.w2);
  // dh1p = (dh2pb W2^T) sigmoid'(h1b); dh1pb replaces h1b
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  gemm_acc(s.h2, HMAX, nh, w2t, nh, s.wtile, acc);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = g * 8 + r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = lane + 32 * c;
      float v = 0.f;
      if (j < nh && t < tn) v = acc[r][c] * sig_from_act(to_f(s.h1[t * HMAX + j]), beta);
      acc[r][c] = v;
      s.h1[t * HMAX + j] = __float2bfloat16_rn(v);
    }
  }
  column_sum(acc, s.red, nh, ws + o.b1, nullptr);
  contract(s.es, E, E, s.h1, nh, tn, ws + o.w1s);
  contract(s.ec, E, E, s.h1, nh, tn, ws + o.w1c);
  __syncthreads();  // the next tile overwrites es, ec and h1
}

// The direction-part grads of one ray, after its last tile: its summed
// dc1p, rounded to bf16 once, against its embedding (dsr / dcr).
__device__ __forceinline__ void dir_grads(const float* dsr, const float* dcr, const float* ddpart, int E, int nh,
                                          const GradOffsets& o, float* ws) {
  const int64_t EC = (int64_t)E * nh;
  for (int64_t i = threadIdx.x; i < EC; i += NT) {
    const int k = (int)(i / nh);
    const int j = (int)(i % nh);
    const float dd = bf16_round(ddpart[j]);
    ws[o.wc1ds + i] += dsr[k] * dd;
    ws[o.wc1dc + i] += dcr[k] * dd;
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
