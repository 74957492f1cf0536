// K4: the NeRF train step's bundle loss and its backward, for H fields.
//
// Replaces the Pallas TPU kernel _loss_kernel (imagesequenceregistration-
// for6dposeestimationlabeling_tpu/ops/field_kernel.py:701, pallas_call at
// :882, via _make_loss_op / bundle_loss_grads).  Per half h and ray r, with
// the rounding points of the TPU kernel:
//   field   es/ec = bf16(sincos(exact f32 angles)) (+ double-angle rungs)
//           h1 = softplus_b(es W1s + ec W1c + b1), h2 = softplus_b(bf16(h1) W2 + b2)
//           raw = softplus_b(h2 . wd + bd) on the unrounded h2, in f32
//           c1 = softplus_b(bf16(h2) Wc1h + dpart), dpart = ds Wc1ds + dc Wc1dc + bc1 once per ray
//           rgb = sigmoid(bf16(c1) Wc2 + bc2)
//   composite  Q = inclusive prefix sum of raw, A = exp(raw - Q), w = (1 - exp(-raw)) A,
//              feat = sum w rgb, opacity = 1 - exp(-sum raw)
//   loss    ce = v mean_c huber(feat - col), se = v huber(opacity - sil)
//   backward   exactly the reference's composite backward and _grad_math:
//              sigmoid' recovered from the stored bf16 activations, every
//              product operand rounded to bf16, dwd on the rounded h2.
// Outputs: the 13 weight grads and (ce_sum, se_sum) per half, and the EA
// weights w (H, R, P) when asked.  Rows with valid = 0 contribute nothing.
//
// What bounds it: arithmetic.  The function's work is ~1.15 MFLOP of bf16
// products a point at the reference width (H = 60, 256 hidden): the
// forward (0.45 MFLOP), the backward's two products (0.26) and the four
// weight-grad contractions (0.45); a train step (2 halves x 1,200 rays x
// (64 + 320) points) is ~1.06 TFLOP, ~1.1 ms at the tensor cores' 989
// TFLOP/s, against ~2 MB of inputs and outputs.  Every product runs on the
// tensor cores (mma.sync m16n8k16, field_mma.cuh), with E = 180
// zero-padded to 192.  One fine ray's activations (~720 KB) cannot stay on
// chip and the composite couples every point of a ray, so a block of 16
// warps (one an SM) owns one ray at a time in two passes of 64-point
// tiles: pass A runs the forward, keeps raw and rgb per point in shared
// memory and writes each point's bf16 es, ec, h1, h2 and c1 to a device
// workspace; warp 0 composites the ray, takes the loss and runs the
// composite's backward (a real prefix scan); pass B reads each tile's h1,
// h2 and c1 back (no recompute: the same bits) and runs the backward's
// products, writing the cotangents dh1, dh2 and dc1 beside them (3.8 KB a
// point in all).  The bf16 weights (W1 184 KB, W2, Wc1h and their
// transposes 128 KB each) stream from L2 through a double-buffered cp.async
// ring.  The weight-grad contractions are not summed tile by tile into a
// per-block slice of device memory (0.89 MB read and written per 64-point
// tile, ~25.7 GB a step, which misses the 50 MB L2): a second kernel,
// dw_kernel, computes the six matrix grads from the workspace (and each
// ray's ds, dc and rounded ddpart) as output-stationary tensor-core
// products over all of a half's points, each block owning a 64 x 256 tile
// of one grad and one of S fixed slices of the points.  The vector grads
// (biases, wd, wc2) stay in per-block f32 slices.  sum_slices adds slices
// in a fixed order: no float atomics, and two launches give bit-identical
// results.  Build without --use_fast_math: sincosf keeps its full range
// reduction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include <algorithm>

#include "field_common.cuh"
#include "field_mma.cuh"
#include "kernels.h"

using field::bf16_round;
using field::sig_from_act;
using field::softplus_b;
using field::warp_sum;
using mma::bf16;
using mma::LDW;
using mma::MT;
using mma::WN;

namespace {

constexpr int NTH = 512;  // threads of the loss kernel: one block of 16 warps an SM
using T = mma::Tile<NTH>;
using TD = mma::Tile<256>;  // the contraction kernel: two blocks of 8 warps an SM

// Per-point workspace record (bf16): es | ec (Ep each) | h1 | h2 | c1 | dh1 | dh2 | dc1 (256 each).
__host__ __device__ inline int rec_width(int Ep) { return 2 * Ep + 6 * WN; }
// Per-ray record (bf16): ds | dc (Ep each) | bf16(ddpart) (256).
__host__ __device__ inline int ray_rec_width(int Ep) { return 2 * Ep + WN; }
// Vector grads of a slice (f32): b1 b2 wd (nh each), bd, bc1 (nh), wc2 (nh x 3), bc2 (3), then ce_sum, se_sum.
struct VecOffsets {
  int b1, b2, wd, bd, bc1, wc2, bc2, ce, se, total;
  __host__ __device__ explicit VecOffsets(int nh) {
    b1 = 0;
    b2 = nh;
    wd = 2 * nh;
    bd = 3 * nh;
    bc1 = 3 * nh + 1;
    wc2 = 4 * nh + 1;
    bc2 = 7 * nh + 1;
    ce = 7 * nh + 4;
    se = 7 * nh + 5;
    total = 7 * nh + 6;
  }
};

struct LossArgs {
  const float* pts;   // (H, R, P, 3)
  const float* dirs;  // (H, R, 3), unit
  const float* tgt;   // (H, R, 8): col(3), sil, valid
  int R, P;
  const float* fmat;  // (3, n_base)
  int n_base, ladder, E, Ep, nh;
  // per half (leading H): the products' bf16 weights, zero-padded to 256
  // columns: w1 = [W1s; W1c] (2 Ep rows), w2, wc1h, and the transposes
  // wc1ht, w2t for the backward (256 rows)
  const bf16 *w1, *w2, *wc1h, *wc1ht, *w2t;
  // per half, f32 (the product blocks as bf16 values): b1, b2, wd (nh), bd
  // (1), wc1ds, wc1dc (E, nh), bc1 (nh), wc2 (nh, 3), bc2 (3)
  const float *b1, *b2, *wd, *bd, *wc1ds, *wc1dc, *bc1, *wc2, *bc2;
  float beta, hs, hs2, scale, scale3;
  float* vwork;  // (H, n_blocks, V) per-block slices of the vector grads
  int n_blocks;
  bf16* rec;   // (H, R, P, rec_width) per-point contraction operands
  bf16* rrec;  // (H, R, ray_rec_width) per-ray
  float* w_out;  // (H, R, P) or null
};

struct HalfWeights {
  const bf16 *w1, *w2, *wc1h, *wc1ht, *w2t;
  const float *b1, *b2, *wd, *bd, *wc1ds, *wc1dc, *bc1, *wc2, *bc2;
};

struct Smem {
  bf16* ring;    // 2 weight slabs
  bf16* X;       // (MT, lda) es | ec, then (MT, LDW) c1 and its cotangent
  bf16 *h1, *h2; // (MT, LDW) activations, then their cotangents
  float *red, *dpart, *ddpart, *dsr, *dcr, *raw, *A, *w, *du, *rgb, *dc2p, *dc2pb, *misc;
};

__host__ __device__ inline int64_t padded_points(int P) { return ((int64_t)P + MT - 1) / MT * MT; }
__host__ __device__ inline int x_width(int Ep) { return 2 * Ep + 8 > LDW ? 2 * Ep + 8 : LDW; }

__host__ __device__ inline size_t smem_bytes(int Ep, int P) {
  const int64_t Pp = padded_points(P);
  const int64_t halves = 2 * mma::SLAB + (int64_t)MT * x_width(Ep) + 2 * MT * LDW;
  const int64_t floats = 2 * WN + 2 * WN + 2 * Ep + 7 * Pp + 6 * MT + 8;
  return sizeof(bf16) * halves + sizeof(float) * floats;
}

__device__ Smem carve(unsigned char* base, int Ep, int P) {
  const int64_t Pp = padded_points(P);
  Smem s;
  s.ring = reinterpret_cast<bf16*>(base);
  s.X = s.ring + 2 * mma::SLAB;
  s.h1 = s.X + MT * x_width(Ep);
  s.h2 = s.h1 + MT * LDW;
  s.red = reinterpret_cast<float*>(s.h2 + MT * LDW);
  s.dpart = s.red + 2 * WN;
  s.ddpart = s.dpart + WN;
  s.dsr = s.ddpart + WN;
  s.dcr = s.dsr + Ep;
  s.raw = s.dcr + Ep;
  s.A = s.raw + Pp;
  s.w = s.A + Pp;
  s.du = s.w + Pp;
  s.rgb = s.du + Pp;
  s.dc2p = s.rgb + 3 * Pp;
  s.dc2pb = s.dc2p + 3 * MT;
  s.misc = s.dc2pb + 3 * MT;  // the ray's gf[3], then the block's ce_sum, se_sum
  return s;
}

// Forward of points [p0, p0 + tn) of one ray (pass A), the products on the
// tensor cores: stores raw and rgb per point and writes the tile's bf16
// embedding, h1, h2 and c1 to its workspace rows rec, from which pass B
// runs the backward and the contraction kernel the weight grads.
__device__ __forceinline__ void tile_forward(const LossArgs& a, const HalfWeights& hw, const Smem& s,
                                             const float* pts_ray, int p0, int tn, bf16* rec, int& slot,
                                             T::Acc acc) {
  const int tid = threadIdx.x;
  const int E = a.E, Ep = a.Ep, nh = a.nh;
  const int lda = 2 * Ep + 8;
  const int RW = rec_width(Ep);
  __syncthreads();  // the previous tile's copies out of X are done
  T::issue_slab(hw.w1, s.ring + slot * mma::SLAB);
  field::embed<bf16, NTH>(pts_ray + (size_t)p0 * 3, tn, MT, a.fmat, a.n_base, a.ladder, lda, s.X, s.X + Ep);
  for (int i = tid; i < MT * (Ep - E); i += NTH) {  // the K padding reads as zeros
    const int p = i / (Ep - E), c = E + i % (Ep - E);
    s.X[p * lda + c] = __float2bfloat16_rn(0.f);
    s.X[p * lda + Ep + c] = __float2bfloat16_rn(0.f);
  }
  T::zero(acc);
  T::stream_mma(s.X, lda, hw.w1, 2 * Ep, hw.w2, s.ring, slot, acc);
  T::to_global(s.X, lda, tn, 2 * Ep, rec, RW);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::JN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = T::col(j, e);
        acc[i][j][e] = c < nh ? softplus_b(acc[i][j][e] + hw.b1[c], a.beta) : 0.f;
      }
  T::store_tile(acc, s.h1);
  T::zero(acc);
  T::stream_mma(s.h1, LDW, hw.w2, WN, hw.wc1h, s.ring, slot, acc);
  T::to_global(s.h1, LDW, tn, WN, rec + 2 * Ep, RW);
  // h2: bf16 to its tile; the density head reads it unrounded, in f32
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::JN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = T::col(j, e);
        acc[i][j][e] = c < nh ? softplus_b(acc[i][j][e] + hw.b2[c], a.beta) : 0.f;
      }
  T::store_tile(acc, s.h2);
  {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < T::JN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = T::col(j, e);
          acc[i][j][e] = c < nh ? acc[i][j][e] * hw.wd[c] : 0.f;
        }
    const float part = T::row_sum(acc, s.red);
    if (tid < tn) s.raw[p0 + tid] = softplus_b(part + hw.bd[0], a.beta);
  }
  T::zero(acc);
  T::stream_mma(s.h2, LDW, hw.wc1h, WN, nullptr, s.ring, slot, acc);
  T::to_global(s.h2, LDW, tn, WN, rec + 2 * Ep + WN, RW);
  // c1, rounded: to X (the embedding is consumed)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::JN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = T::col(j, e);
        acc[i][j][e] = c < nh ? bf16_round(softplus_b(acc[i][j][e] + s.dpart[c], a.beta)) : 0.f;
      }
  T::store_tile(acc, s.X);
  // rgb = sigmoid(c1b . wc2 + bc2), per point over the tile's units; each
  // thread reads back its own rounded c1 values
#pragma unroll
  for (int m = 0; m < 3; ++m) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < T::JN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = T::col(j, e);
          acc[i][j][e] = c < nh ? mma::tile_at(s.X, T::row(i, e), c) * hw.wc2[c * 3 + m] : 0.f;
        }
    const float part = T::row_sum(acc, s.red);
    if (tid < tn) s.rgb[(p0 + tid) * 3 + m] = 1.f / (1.f + expf(-(part + hw.bc2[m])));
  }
  T::to_global(s.X, LDW, tn, WN, rec + 2 * Ep + 2 * WN, RW);  // the row sums' barriers made c1 visible
}

// Inclusive scan of v over the warp's lanes.
__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// Warp 0: composite of one ray from raw / rgb, its loss, and the
// composite's backward to du per point.  Lane l owns a contiguous segment
// of the ray's points; prefix sums are segment sums scanned over lanes.
__device__ __forceinline__ void composite_ray(const LossArgs& a, const Smem& s, const float* tgt, float* w_out) {
  const int lane = threadIdx.x & 31;
  const int P = a.P;
  const int L = (P + 31) / 32;
  const int lo = min(P, lane * L);
  const int hi = min(P, lo + L);
  // forward: Q, A, w, feat, total raw
  float seg = 0.f;
  for (int p = lo; p < hi; ++p) seg += s.raw[p];
  const float incl = warp_inclusive_scan(seg, lane);
  float q = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) q = 0.f;
  const float S = __shfl_sync(0xffffffffu, incl, 31);
  float f0 = 0.f, f1 = 0.f, f2 = 0.f;
  for (int p = lo; p < hi; ++p) {
    const float raw = s.raw[p];
    q += raw;
    const float A = expf(raw - q);
    const float w = (1.f - expf(-raw)) * A;
    s.A[p] = A;
    s.w[p] = w;
    if (w_out) w_out[p] = w;
    f0 += w * s.rgb[p * 3];
    f1 += w * s.rgb[p * 3 + 1];
    f2 += w * s.rgb[p * 3 + 2];
  }
  const float feat[3] = {warp_sum(f0), warp_sum(f1), warp_sum(f2)};
  const float eS = expf(-S);
  const float opac = 1.f - eS;
  // loss and its cotangents (every lane computes the same values)
  const float v = tgt[4];
  float ce = 0.f, gf[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float dcol = feat[m] - tgt[m];
    const float rc = sqrtf(1.f + dcol * dcol / a.hs2);
    ce += (rc - 1.f) * a.hs * v;
    gf[m] = a.scale3 * v * dcol / (a.hs * rc);
  }
  const float dsil = opac - tgt[3];
  const float rs = sqrtf(1.f + dsil * dsil / a.hs2);
  const float gO = a.scale * v * dsil / (a.hs * rs);
  if (lane == 0) {
    s.misc[3] += ce / 3.f;
    s.misc[4] += (rs - 1.f) * a.hs * v;
    s.misc[0] = gf[0];
    s.misc[1] = gf[1];
    s.misc[2] = gf[2];
  }
  // backward: T = gw w, rev_excl = sum_{j > p} T_j, du = g_raw * sigmoid'
  float tseg = 0.f;
  for (int p = lo; p < hi; ++p) {
    const float gw = gf[0] * s.rgb[p * 3] + gf[1] * s.rgb[p * 3 + 1] + gf[2] * s.rgb[p * 3 + 2];
    tseg += gw * s.w[p];
  }
  const float tincl = warp_inclusive_scan(tseg, lane);
  float tc = __shfl_up_sync(0xffffffffu, tincl, 1);
  if (lane == 0) tc = 0.f;
  const float Ttot = __shfl_sync(0xffffffffu, tincl, 31);
  for (int p = lo; p < hi; ++p) {
    const float gw = gf[0] * s.rgb[p * 3] + gf[1] * s.rgb[p * 3 + 1] + gf[2] * s.rgb[p * 3 + 2];
    const float w = s.w[p];
    tc += gw * w;
    const float g_raw = gw * (s.A[p] - w) - (Ttot - tc) + gO * eS;
    s.du[p] = g_raw * sig_from_act(s.raw[p], a.beta);
  }
}

// Backward of points [p0, p0 + tn) (pass B), from the bf16 h1, h2 and c1
// that pass A wrote to the tile's workspace rows rec: the colour output's
// cotangent from the composite, the vector grads over the tile's points
// into the block's slice vs, and the cotangents dc1, dh2, dh1 (their two
// products on the tensor cores), each written to the workspace beside
// the activations.
__device__ __forceinline__ void tile_backward(const LossArgs& a, const HalfWeights& hw, const Smem& s, float* vs,
                                              int p0, int tn, bf16* rec, int& slot, T::Acc acc) {
  const int tid = threadIdx.x;
  const int Ep = a.Ep, nh = a.nh;
  const int RW = rec_width(Ep);
  const float beta = a.beta;
  const VecOffsets o(nh);
  __syncthreads();  // the previous tile's copies out of the tiles are done
  T::issue_slab(hw.wc1ht, s.ring + slot * mma::SLAB);
  // the tile's activations; rows past tn read as zeros, and every output masks them
  bf16* const tiles[3] = {s.h1, s.h2, s.X};
  for (int c = tid; c < 3 * MT * (WN / 8); c += NTH) {
    const int k = c / (MT * (WN / 8)), r = (c / (WN / 8)) % MT, q = c % (WN / 8);
    const bf16* src = rec + (r < tn ? r : 0) * (int64_t)RW + 2 * Ep + k * WN + q * 8;
    mma::cp_async16(tiles[k] + r * LDW + q * 8, src, r < tn);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  // colour output: dc2p = grgb rgb (1 - rgb), grgb = w gf
  if (tid < 3 * MT) {
    const int t = tid / 3;
    const int m = tid % 3;
    float d = 0.f;
    if (t < tn) {
      const float rg = s.rgb[(p0 + t) * 3 + m];
      d = s.w[p0 + t] * s.misc[m] * rg * (1.f - rg);
    }
    s.dc2p[tid] = d;
    s.dc2pb[tid] = bf16_round(d);
  }
  __syncthreads();
  // the heads' grads over the tile's points: wc2 on the rounded c1, wd on
  // the rounded h2 with an f32 du, and their biases
  const float* du = s.du + p0;
  if (tid < nh) {
    float g0 = 0.f, g1 = 0.f, g2 = 0.f, gd = 0.f;
    for (int t = 0; t < tn; ++t) {
      const float c1 = mma::tile_at(s.X, t, tid);
      g0 += c1 * s.dc2pb[t * 3];
      g1 += c1 * s.dc2pb[t * 3 + 1];
      g2 += c1 * s.dc2pb[t * 3 + 2];
      gd += mma::tile_at(s.h2, t, tid) * du[t];
    }
    vs[o.wc2 + tid * 3] += g0;
    vs[o.wc2 + tid * 3 + 1] += g1;
    vs[o.wc2 + tid * 3 + 2] += g2;
    vs[o.wd + tid] += gd;
  }
  if (tid < 3) {
    float sum = 0.f;
    for (int t = 0; t < tn; ++t) sum += s.dc2p[t * 3 + tid];
    vs[o.bc2 + tid] += sum;
  }
  if (tid == 3) {
    float sum = 0.f;
    for (int t = 0; t < tn; ++t) sum += du[t];
    vs[o.bd] += sum;
  }
  __syncthreads();  // c1b is read before dc1pb replaces it
  // dc1p = (dc2pb Wc2^T) sigmoid'(c1b); dc1pb replaces c1b in X
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::JN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = T::row(i, e), c = T::col(j, e);
        float v = 0.f;
        if (t < tn && c < nh) {
          const float dc1 = s.dc2pb[t * 3] * hw.wc2[c * 3] + s.dc2pb[t * 3 + 1] * hw.wc2[c * 3 + 1] +
                            s.dc2pb[t * 3 + 2] * hw.wc2[c * 3 + 2];
          v = dc1 * sig_from_act(mma::tile_at(s.X, t, c), beta);
        }
        acc[i][j][e] = v;
      }
  T::store_tile(acc, s.X);
  float cs = T::col_sum(acc, s.red);
  if (tid < nh) {
    vs[o.bc1 + tid] += cs;
    s.ddpart[tid] += cs;
  }
  // dh2p = (dc1pb Wc1h^T + du wd) sigmoid'(h2b); dh2pb replaces h2b
  T::zero(acc);
  T::stream_mma(s.X, LDW, hw.wc1ht, WN, hw.w2t, s.ring, slot, acc);
  T::to_global(s.X, LDW, tn, WN, rec + 2 * Ep + 5 * WN, RW);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::JN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = T::row(i, e), c = T::col(j, e);
        acc[i][j][e] = t < tn && c < nh ? (acc[i][j][e] + du[t] * hw.wd[c]) * sig_from_act(mma::tile_at(s.h2, t, c), beta)
                                        : 0.f;
      }
  T::store_tile(acc, s.h2);
  cs = T::col_sum(acc, s.red);
  if (tid < nh) vs[o.b2 + tid] += cs;
  // dh1p = (dh2pb W2^T) sigmoid'(h1b); dh1pb replaces h1b
  T::zero(acc);
  T::stream_mma(s.h2, LDW, hw.w2t, WN, nullptr, s.ring, slot, acc);
  T::to_global(s.h2, LDW, tn, WN, rec + 2 * Ep + 4 * WN, RW);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::JN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = T::row(i, e), c = T::col(j, e);
        acc[i][j][e] = t < tn && c < nh ? acc[i][j][e] * sig_from_act(mma::tile_at(s.h1, t, c), beta) : 0.f;
      }
  T::store_tile(acc, s.h1);
  cs = T::col_sum(acc, s.red);
  if (tid < nh) vs[o.b1 + tid] += cs;
  T::to_global(s.h1, LDW, tn, WN, rec + 2 * Ep + 3 * WN, RW);
}

// Block b of half h walks rays b, b + n_blocks, ...
// The colour head's direction part of one ray, dpart = ds Wc1ds + dc Wc1dc +
// bc1, with the sums of field::dir_part (each in order over k, then ps + pc
// + bc1): the block's two halves take ds and dc; ds / dc (the ray's
// embedding, f32 holding bf16 values) are left in dsr / dcr.
__device__ __forceinline__ void ray_dir_part(const LossArgs& a, const HalfWeights& hw, const Smem& s,
                                             const float* dir) {
  const int tid = threadIdx.x;
  field::embed<float, NTH>(dir, 1, 1, a.fmat, a.n_base, a.ladder, a.E, s.dsr, s.dcr);
  __syncthreads();
  const int half = tid / WN, j = tid % WN;
  if (j < a.nh) {
    const float* e = half ? s.dcr : s.dsr;
    const float* w = (half ? hw.wc1dc : hw.wc1ds) + j;
    float p = 0.f;
#pragma unroll 4
    for (int k = 0; k < a.E; ++k) p += e[k] * w[(int64_t)k * a.nh];
    s.red[half * WN + j] = p;
  }
  __syncthreads();
  if (tid < a.nh) s.dpart[tid] = s.red[tid] + s.red[WN + tid] + hw.bc1[tid];
  __syncthreads();
}

__global__ void __launch_bounds__(NTH, 1) bundle_loss_kernel(LossArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve(smem_raw, a.Ep, a.P);
  const int h = blockIdx.y;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int E = a.E, Ep = a.Ep, nh = a.nh, R = a.R, P = a.P;
  const int64_t EC = (int64_t)E * nh, W1 = (int64_t)2 * Ep * WN, WW = (int64_t)WN * WN;
  const HalfWeights hw{a.w1 + h * W1,    a.w2 + h * WW,    a.wc1h + h * WW,     a.wc1ht + h * WW,
                       a.w2t + h * WW,   a.b1 + h * nh,    a.b2 + h * nh,       a.wd + h * nh,
                       a.bd + h,         a.wc1ds + h * EC, a.wc1dc + h * EC,    a.bc1 + h * nh,
                       a.wc2 + h * nh * 3, a.bc2 + h * 3};
  const VecOffsets o(nh);
  float* vs = a.vwork + ((int64_t)h * a.n_blocks + b) * o.total;
  for (int i = tid; i < o.total; i += NTH) vs[i] = 0.f;
  if (tid < 8) s.misc[tid] = 0.f;
  __syncthreads();
  const int RW = rec_width(Ep), RRW = ray_rec_width(Ep);
  int slot = 0;
  T::Acc acc;

  for (int r = b; r < R; r += a.n_blocks) {
    const int64_t ray = (int64_t)h * R + r;
    const float* pts_ray = a.pts + ray * P * 3;
    // the ray's direction part of the colour head, once per ray
    ray_dir_part(a, hw, s, a.dirs + ray * 3);
    if (tid < WN) s.ddpart[tid] = 0.f;
    // pass A: raw and rgb of every point of the ray
    for (int p0 = 0; p0 < P; p0 += MT)
      tile_forward(a, hw, s, pts_ray, p0, min(MT, P - p0), a.rec + (ray * P + p0) * RW, slot, acc);
    __syncthreads();
    if (tid < 32) composite_ray(a, s, a.tgt + ray * 8, a.w_out ? a.w_out + ray * P : nullptr);
    __syncthreads();
    // pass B: each tile's backward from its stored activations
    for (int p0 = 0; p0 < P; p0 += MT)
      tile_backward(a, hw, s, vs, p0, min(MT, P - p0), a.rec + (ray * P + p0) * RW, slot, acc);
    // the ray's record: its embedding and its summed dc1p, rounded once
    __syncthreads();
    bf16* rr = a.rrec + ray * RRW;
    for (int i = tid; i < RRW; i += NTH) {
      float v = 0.f;
      if (i < Ep)
        v = i < E ? s.dsr[i] : 0.f;
      else if (i < 2 * Ep)
        v = i - Ep < E ? s.dcr[i - Ep] : 0.f;
      else
        v = i - 2 * Ep < nh ? s.ddpart[i - 2 * Ep] : 0.f;
      rr[i] = __float2bfloat16_rn(v);
    }
    __syncthreads();
  }
  if (tid == 0) {
    vs[o.ce] = s.misc[3];
    vs[o.se] = s.misc[4];
  }
}

// ------------------------------------------------ the weight-grad contractions
//
// Six products per half, out = A^T B summed over the workspace's rows: A's
// columns [a_col, a_col + M) are the grad's rows, B's 256 columns its
// columns (units past nh dropped).  Over the points: dW1s = es^T dh1, dW1c =
// ec^T dh1, dW2 = h1^T dh2, dWc1h = h2^T dc1; over the rays: dWc1ds = ds^T
// ddp, dWc1dc = dc^T ddp.  Their flat order in a slice: w1s w1c w2 wc1h
// wc1ds wc1dc (4 E nh + 2 nh^2 floats).

constexpr int KD = 64;           // workspace rows a slab
constexpr int LDA_T = MT + 8;    // shared row stride of an A slab

struct Product {
  int a_col, b_col, M;
  bool rays;
  int64_t out;
};

__host__ __device__ inline Product product(int i, int E, int Ep, int nh) {
  const int64_t EC = (int64_t)E * nh, CC = (int64_t)nh * nh;
  switch (i) {
    case 0: return {0, 2 * Ep + 3 * WN, E, false, 0};
    case 1: return {Ep, 2 * Ep + 3 * WN, E, false, EC};
    case 2: return {2 * Ep, 2 * Ep + 4 * WN, nh, false, 2 * EC};
    case 3: return {2 * Ep + WN, 2 * Ep + 5 * WN, nh, false, 2 * EC + CC};
    case 4: return {0, 2 * Ep, E, true, 2 * EC + 2 * CC};
    default: return {Ep, 2 * Ep, E, true, 3 * EC + 2 * CC};
  }
}

__host__ __device__ inline int dw_tiles(int E, int nh) { return 4 * ((E + MT - 1) / MT) + 2 * ((nh + MT - 1) / MT); }

struct DwArgs {
  const bf16 *rec, *rrec;
  int R, P, E, Ep, nh, n_splits;
  float* part;  // (H, n_splits, G)
  int64_t G;
};

// Block (tile t, split sp) of half h: a 64 x 256 tile of one grad over the
// sp-th of n_splits fixed, contiguous ranges of the rows.
__global__ void __launch_bounds__(256, 2) dw_kernel(DwArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // 2 x (KD, LDA_T)
  bf16* Bs = As + 2 * KD * LDA_T;                // 2 x (KD, LDW)
  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int T = dw_tiles(a.E, a.nh);
  int m0 = blockIdx.x % T;
  const int sp = blockIdx.x / T;
  int pi = 0;
  for (; pi < 5; ++pi) {
    const int nt = (product(pi, a.E, a.Ep, a.nh).M + MT - 1) / MT;
    if (m0 < nt) break;
    m0 -= nt;
  }
  m0 *= MT;
  const Product pr = product(pi, a.E, a.Ep, a.nh);
  const int ld = pr.rays ? ray_rec_width(a.Ep) : rec_width(a.Ep);
  const int64_t K = pr.rays ? (int64_t)a.R : (int64_t)a.R * a.P;
  const bf16* base = (pr.rays ? a.rrec : a.rec) + (int64_t)h * K * ld;
  const bf16* Ag = base + pr.a_col + m0;
  const bf16* Bg = base + pr.b_col;
  const int64_t per = ((K + a.n_splits - 1) / a.n_splits + KD - 1) / KD * KD;
  const int64_t k0 = sp * per, k1 = k0 + per < K ? k0 + per : K;
  const int ns = k1 > k0 ? (int)((k1 - k0 + KD - 1) / KD) : 0;

  auto issue = [&](int st, int buf) {
    const int64_t kb = k0 + (int64_t)st * KD;
    for (int c = tid; c < KD * 8; c += 256) {
      const int r = c >> 3, q = c & 7;
      const bool in = kb + r < k1;
      mma::cp_async16(As + buf * KD * LDA_T + r * LDA_T + q * 8, Ag + (in ? kb + r : 0) * ld + q * 8, in);
    }
    for (int c = tid; c < KD * 32; c += 256) {
      const int r = c >> 5, q = c & 31;
      const bool in = kb + r < k1;
      mma::cp_async16(Bs + buf * KD * LDW + r * LDW + q * 8, Bg + (in ? kb + r : 0) * ld + q * 8, in);
    }
    mma::cp_async_commit();
  };

  TD::Acc acc;
  TD::zero(acc);
  if (ns) issue(0, 0);
  for (int st = 0; st < ns; ++st) {
    if (st + 1 < ns) {
      issue(st + 1, (st + 1) & 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* A_ = As + (st & 1) * KD * LDA_T;
    const bf16* B_ = Bs + (st & 1) * KD * LDW;
    TD::slab_mma<true>(A_, LDA_T, 0, B_, acc);
    TD::slab_mma<true>(A_, LDA_T, mma::KS, B_ + mma::KS * LDW, acc);
    __syncthreads();
  }
  float* out = a.part + ((int64_t)h * a.n_splits + sp) * a.G + pr.out;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < TD::JN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + TD::row(i, e), c = TD::col(j, e);
        if (row < pr.M && c < a.nh) out[(int64_t)row * a.nh + c] = acc[i][j][e];
      }
}

}  // namespace

int64_t bundle_loss_rec_width(int ep) { return rec_width(ep); }
int64_t bundle_loss_ray_rec_width(int ep) { return ray_rec_width(ep); }
int64_t bundle_loss_vec_width(int n_hidden) { return VecOffsets(n_hidden).total; }
int bundle_loss_dw_tiles(int e, int n_hidden) { return dw_tiles(e, n_hidden); }

void launch_bundle_loss(const float* pts, const float* dirs, const float* tgt, int n_halves, int n_rays, int n_pts,
                        const float* fmat, int n_base, int ladder, int ep, const void* const* mats,
                        const float* const* vecs, int n_hidden, float beta, float hs, float hs2, float scale,
                        float scale3, float* vwork, int n_blocks, void* rec, void* rrec, float* part, int n_splits,
                        float* vec_out, float* mat_out, float* w_out, void* stream) {
  if (n_halves <= 0 || n_rays <= 0 || n_pts <= 0) return;
  TORCH_CHECK(n_hidden > 0 && n_hidden <= WN, "bundle-loss kernel: n_hidden must be in [1, 256]");
  TORCH_CHECK(n_blocks > 0 && n_splits > 0, "bundle-loss kernel: n_blocks and n_splits must be positive");
  const int E = n_base * (ladder > 1 ? ladder : 1);
  TORCH_CHECK(ep >= E && ep % 16 == 0, "bundle-loss kernel: the padded embedding width must be a multiple of 16 >= ",
              E);
  const size_t smem = smem_bytes(ep, n_pts);
  TORCH_CHECK(smem <= 232448, "bundle-loss kernel: ", smem, " bytes of shared memory for ", n_pts,
              " points per ray exceed the block's 227 KB");
  C10_CUDA_CHECK(cudaFuncSetAttribute(bundle_loss_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  LossArgs a;
  a.pts = pts;
  a.dirs = dirs;
  a.tgt = tgt;
  a.R = n_rays;
  a.P = n_pts;
  a.fmat = fmat;
  a.n_base = n_base;
  a.ladder = ladder;
  a.E = E;
  a.Ep = ep;
  a.nh = n_hidden;
  const bf16** mdst[5] = {&a.w1, &a.w2, &a.wc1h, &a.wc1ht, &a.w2t};
  for (int i = 0; i < 5; ++i) *mdst[i] = static_cast<const bf16*>(mats[i]);
  const float** vdst[9] = {&a.b1, &a.b2, &a.wd, &a.bd, &a.wc1ds, &a.wc1dc, &a.bc1, &a.wc2, &a.bc2};
  for (int i = 0; i < 9; ++i) *vdst[i] = vecs[i];
  a.beta = beta;
  a.hs = hs;
  a.hs2 = hs2;
  a.scale = scale;
  a.scale3 = scale3;
  a.vwork = vwork;
  a.n_blocks = n_blocks;
  a.rec = static_cast<bf16*>(rec);
  a.rrec = static_cast<bf16*>(rrec);
  a.w_out = w_out;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bundle_loss_kernel<<<dim3(n_blocks, n_halves), NTH, smem, st>>>(a);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  const int64_t V = VecOffsets(n_hidden).total;
  field::sum_slices<<<dim3((unsigned)((V + 255) / 256), n_halves), 256, 0, st>>>(vwork, n_blocks, V, vec_out);
  C10_CUDA_KERNEL_LAUNCH_CHECK();

  DwArgs d;
  d.rec = a.rec;
  d.rrec = a.rrec;
  d.R = n_rays;
  d.P = n_pts;
  d.E = E;
  d.Ep = ep;
  d.nh = n_hidden;
  d.n_splits = n_splits;
  d.part = part;
  d.G = 4 * (int64_t)E * n_hidden + 2 * (int64_t)n_hidden * n_hidden;
  const size_t dsmem = sizeof(bf16) * 2 * KD * (LDA_T + LDW);
  C10_CUDA_CHECK(cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dsmem));
  dw_kernel<<<dim3((unsigned)(dw_tiles(E, n_hidden) * n_splits), n_halves), 256, dsmem, st>>>(d);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  field::sum_slices<<<dim3((unsigned)((d.G + 255) / 256), n_halves), 256, 0, st>>>(part, n_splits, d.G, mat_out);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}
