// The NeRF field on the tensor cores, one 64-point tile at a time: the
// device code that K4 (bundle_loss.cu), K5 and K6 (field_color.cu) share.
//
//   tile_forward   the field forward of a tile (embedding, trunk, density
//                  head, colour head; every product on mma.sync through
//                  field_mma.cuh), writing each point's bf16 es | ec | h1 |
//                  h2 | c1 to its workspace record (and, with f32
//                  activations, its f32 h1 | h2 | c1 to a second record);
//   tile_backward  the reference's _grad_math for a tile from the h1, h2 and
//                  c1 in its records (no recompute: the same bits), its two
//                  products on the tensor cores, writing the cotangents dh1 |
//                  dh2 | dc1 beside them and adding the vector grads to the
//                  block's f32 slice;
//   ray_dir_part, write_ray_record   the per-ray direction part and record;
//   launch_weight_grads   (field_tc.cu) dw_kernel, the six matrix grads
//                  contracted from the records as output-stationary
//                  tensor-core products over fixed slices of the points, and
//                  sum_slices over the slices in a fixed order.
//
// The two kernels differ only in where the heads meet the rest of the step,
// a compile-time choice (kLoss):
//   K4 (kLoss = true)    raw and rgb stay in shared memory for the ray's
//                        composite; pass B's cotangents du and grgb come
//                        from the composite's backward;
//   K5 / K6 (false)      dens = 1 - exp(-raw) and rgb go to device memory;
//                        du = gdens (1 - dens) (1 - exp(beta log1p(-dens))),
//                        dc2p = grgb rgb (1 - rgb) from device memory.
//
// A second compile-time choice (kAct32) is the field's activation storage.
// The forward does not depend on it: every stored activation feeds a bf16
// product but h2 into the density head, which reads it unrounded either way.
// The backward reads h1, h2 and c1 outside a product in sigmoid'(x) = 1 -
// exp(-beta h) and in the density head's weight grad (dwd = h2 . du):
//   bf16 activations (kAct32 = false)  from the bf16 values in the record;
//   f32 activations (kAct32 = true)    from the f32 values tile_forward
//                        keeps, unrounded, in a second per-point record.
// The f32 values are kept, not sigmoid' (h2 is needed as well) and not
// recomputed (that is the forward again): 3 x 256 f32 a point (3,072 B),
// written from the accumulators in pass A.  Pass B reads each slot from
// shared memory, at a row stride of LDW floats in the space of the bf16 h1 |
// h2 tiles that this variant does not stage, so the shared-memory budget is
// the bf16 variant's: c1 by cp.async at the tile's entry, beside the rounded
// c1 tile; h2 over c1, then h1 (its rows 32-63 in X), by bulk copies (TMA,
// one row a thread, completing on an mbarrier) requested before the product
// that precedes their epilogue, so they land behind it.  Every read evicts
// first from L2.  The products' operands stay the bf16 record's.  On an H100
// K4's train step takes 20.9 ms against 22.1 ms reading each slot from
// device memory at its epilogue, and the bf16 variant's 16.4: most of what
// is left is pass A's f32 stores.
//
// The per-point record (bf16, rec_width(Ep) values a point, Ep = E padded to
// a multiple of 16, columns past E and units past nh zero):
//   es | ec (Ep each)        written by tile_forward (K4 pass A, K5)
//   h1 | h2 | c1 (256 each)  written by tile_forward, read by tile_backward
//                            (the products' operands, and with bf16
//                            activations sigmoid' and dwd)
//   dh1 | dh2 | dc1 (256)    written by tile_backward (K4 pass B, K6)
// dw_kernel reads es, ec, h1, h2 against dh1, dh1, dh2, dc1.  With f32
// activations, the f32 record (ACT_W = 3 x 256 f32 a point): h1 | h2 | c1
// unrounded, written by tile_forward, read by tile_backward.  The per-ray
// record (ray_rec_width(Ep)): ds | dc (Ep each) | bf16(ddpart) (256), the
// ray's direction embedding and its dc1p summed over all its points in f32,
// rounded once; written by write_ray_record (K4, K6).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "field_common.cuh"
#include "field_mma.cuh"

namespace field_tc {

using field::bf16_round;
using field::sig_from_act;
using field::softplus_b;
using mma::bf16;
using mma::LDW;
using mma::MT;
using mma::WN;

constexpr int NTH = 512;  // threads of a tile kernel: one block of 16 warps an SM
using T = mma::Tile<NTH>;

__host__ __device__ inline int rec_width(int Ep) { return 2 * Ep + 6 * WN; }
constexpr int ACT_W = 3 * WN;  // f32 values a point of the f32 activation record: h1 | h2 | c1
__host__ __device__ inline int ray_rec_width(int Ep) { return 2 * Ep + WN; }
// Vector grads of a slice (f32): b1 b2 wd (nh each), bd, bc1 (nh), wc2 (nh x 3), bc2 (3), then K4's ce_sum, se_sum.
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

// The six matrix grads' tiles of 64 rows: 4 of E rows, 2 of nh.
__host__ __device__ inline int dw_tiles(int E, int nh) { return 4 * ((E + MT - 1) / MT) + 2 * ((nh + MT - 1) / MT); }

// What the tile code reads: shapes, embedding, weights (each with a leading
// half axis) and the workspace.  Pointers a kernel does not use are null.
struct FieldArgs {
  const float* pts;   // (H, R, P, 3)
  const float* dirs;  // (H, R, 3), unit
  int R, P;
  const float* fmat;  // (3, n_base)
  int n_base, ladder, E, Ep, nh;
  // the products' bf16 weights, zero-padded to 256 columns: w1 = [W1s; W1c]
  // (2 Ep rows), w2, wc1h, and the transposes wc1ht, w2t for the backward
  const bf16 *w1, *w2, *wc1h, *wc1ht, *w2t;
  // f32 (the product blocks as bf16 values): b1, b2, wd (nh), bd (1), wc1ds,
  // wc1dc (E, nh), bc1 (nh), wc2 (nh, 3), bc2 (3)
  const float *b1, *b2, *wd, *bd, *wc1ds, *wc1dc, *bc1, *wc2, *bc2;
  float beta;
  float* vwork;  // (H, n_blocks, V) per-block slices of the vector grads
  int n_blocks;
  bf16* rec;   // (H, R, P, rec_width) per-point records
  bf16* rrec;  // (H, R, ray_rec_width) per-ray records
  float* act;  // (H, R, P, ACT_W) f32 activations of the kAct32 variant, else null
};

// The FieldArgs of a launch: mats[5] = w1 w2 wc1h wc1ht w2t, vecs[9] = b1 b2
// wd bd wc1ds wc1dc bc1 wc2 bc2 (null where the kernel does not read them).
inline FieldArgs field_args(const float* pts, const float* dirs, int R, int P, const float* fmat, int n_base,
                            int ladder, int Ep, const void* const* mats, const float* const* vecs, int nh, float beta) {
  FieldArgs a;
  a.pts = pts;
  a.dirs = dirs;
  a.R = R;
  a.P = P;
  a.fmat = fmat;
  a.n_base = n_base;
  a.ladder = ladder;
  a.E = n_base * (ladder > 1 ? ladder : 1);
  a.Ep = Ep;
  a.nh = nh;
  const bf16** mdst[5] = {&a.w1, &a.w2, &a.wc1h, &a.wc1ht, &a.w2t};
  for (int i = 0; i < 5; ++i) *mdst[i] = static_cast<const bf16*>(mats[i]);
  const float** vdst[9] = {&a.b1, &a.b2, &a.wd, &a.bd, &a.wc1ds, &a.wc1dc, &a.bc1, &a.wc2, &a.bc2};
  for (int i = 0; i < 9; ++i) *vdst[i] = vecs[i];
  a.beta = beta;
  a.vwork = nullptr;
  a.n_blocks = 0;
  a.rec = nullptr;
  a.rrec = nullptr;
  a.act = nullptr;
  return a;
}

struct HalfWeights {
  const bf16 *w1, *w2, *wc1h, *wc1ht, *w2t;
  const float *b1, *b2, *wd, *bd, *wc1ds, *wc1dc, *bc1, *wc2, *bc2;
};

template <typename P>
__device__ __forceinline__ P* at_half(P* p, int h, int64_t n) {
  return p ? p + h * n : p;
}

__device__ __forceinline__ HalfWeights half_weights(const FieldArgs& a, int h) {
  const int nh = a.nh;
  const int64_t EC = (int64_t)a.E * nh, W1 = (int64_t)2 * a.Ep * WN, WW = (int64_t)WN * WN;
  return HalfWeights{at_half(a.w1, h, W1),    at_half(a.w2, h, WW),    at_half(a.wc1h, h, WW),
                     at_half(a.wc1ht, h, WW), at_half(a.w2t, h, WW),   at_half(a.b1, h, nh),
                     at_half(a.b2, h, nh),    at_half(a.wd, h, nh),    at_half(a.bd, h, 1),
                     at_half(a.wc1ds, h, EC), at_half(a.wc1dc, h, EC), at_half(a.bc1, h, nh),
                     at_half(a.wc2, h, 3 * nh), at_half(a.bc2, h, 3)};
}

// K5's outputs and K6's inputs at a tile's first point: dens, gdens (tile, 1)
// and rgb, grgb (tile, 3) rows of (H, R, P, .) arrays; unused by K4.
struct Heads {
  float *dens, *rgb;
  const float *gdens, *grgb;
};

struct Smem {
  bf16* ring;    // 2 weight slabs
  bf16* X;       // (MT, lda) es | ec, then (MT, LDW) c1 and its cotangent
  bf16 *h1, *h2; // (MT, LDW) activations, then their cotangents
  float *red, *dpart, *ddpart, *dsr, *dcr, *raw, *A, *w, *du, *rgb, *dc2p, *dc2pb, *misc;
};

__host__ __device__ inline int64_t padded_points(int P) { return ((int64_t)P + MT - 1) / MT * MT; }
__host__ __device__ inline int x_width(int Ep) { return 2 * Ep + 8 > LDW ? 2 * Ep + 8 : LDW; }

// Shared memory of a tile kernel whose per-point arrays (raw, A, w, du, rgb)
// hold P points: a whole ray for K4's composite, one tile (P = MT) for K5 / K6.
__host__ __device__ inline size_t smem_bytes(int Ep, int P) {
  const int64_t Pp = padded_points(P);
  const int64_t halves = 2 * mma::SLAB + (int64_t)MT * x_width(Ep) + 2 * MT * LDW;
  const int64_t floats = 2 * WN + 2 * WN + 2 * Ep + 7 * Pp + 6 * MT + 8;
  return sizeof(bf16) * halves + sizeof(float) * floats;
}

__device__ inline Smem carve(unsigned char* base, int Ep, int P) {
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
  s.misc = s.dc2pb + 3 * MT;  // K4: the ray's gf[3], then the block's ce_sum, se_sum; kAct32: 6-7 stage_bar
  return s;
}

// Rows [0, tn) of the f32 accumulators v (units past nh hold 0) to one
// 256-wide slot of the f32 activation record act (row stride ACT_W).
__device__ __forceinline__ void store_act(const T::Acc v, int tn, float* act) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::JN; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = T::row(i, 2 * h);
        if (r < tn)
          *reinterpret_cast<float2*>(act + (int64_t)r * ACT_W + T::col(j, 2 * h)) =
              make_float2(v[i][j][2 * h], v[i][j][2 * h + 1]);
      }
}

// kAct32: the mbarrier that tile_backward's staged f32 slots complete on,
// 8 bytes of misc that no kernel uses otherwise.  init_stage_bar (thread 0,
// once a launch, before a barrier) sets it to MT arrivals a phase.
__device__ __forceinline__ uint32_t stage_bar(const Smem& s) { return mma::smem_addr(s.misc + 6); }
__device__ __forceinline__ void init_stage_bar(const Smem& s) {
  if (threadIdx.x == 0)
    asm volatile(
        "mbarrier.init.shared::cta.b64 [%0], %1;\n"
        "fence.mbarrier_init.release.cluster;\n" ::"r"(stage_bar(s)),
        "r"(MT)
        : "memory");
}

// kAct32: an L2 policy that evicts first the lines it reads: pass B reads
// each f32 activation once, and L2 keeps the weights and records instead.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// kAct32: mma::cp_async16 under the L2 policy pol.
__device__ __forceinline__ void cp_async16_policy(void* dst, const void* src, bool valid, uint64_t pol) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(mma::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0), "l"(pol)
               : "memory");
}

// kAct32: one 256-wide slot of a tile's f32 activation record (src, row
// stride ACT_W) to shared memory at a row stride of LDW floats, rows [0, 32)
// from lo and [32, MT) from hi, completing one phase of the mbarrier bar.
// Thread r < MT copies row r by one bulk copy (TMA) under the L2 policy pol,
// or zeroes it when r >= tn.  Issued after a barrier that follows every
// thread's fence_async_shared, so the copies land after the rows' earlier
// accesses.
__device__ __forceinline__ void stage_slot(float* lo, float* hi, const float* src, int tn, uint32_t bar,
                                           uint64_t pol) {
  const int r = threadIdx.x;
  if (r >= MT) return;
  float* const dst = r < 32 ? lo + r * LDW : hi + (r - 32) * LDW;
  constexpr uint32_t kRow = WN * sizeof(float);
  if (r < tn) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(kRow) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], "
        "%4;\n" ::"r"(mma::smem_addr(dst)),
        "l"(src + (int64_t)r * ACT_W), "r"(kRow), "r"(bar), "l"(pol)
        : "memory");
  } else {
    for (int q = 0; q < WN / 4; ++q) reinterpret_cast<float4*>(dst)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
  }
}

// kAct32: waits until the phase of bar with this parity has completed.
__device__ __forceinline__ void wait_stage(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// kAct32: orders this thread's earlier accesses to shared memory before the
// bulk copies' writes.
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// The bf16 values at (row, col) and (row, col + 1) of a shared tile.
__device__ __forceinline__ float2 tile_pair(const bf16* tile, int row, int col) {
  return make_float2(mma::tile_at(tile, row, col), mma::tile_at(tile, row, col + 1));
}

// Forward of points [p0, p0 + tn) of one ray, the products on the tensor
// cores: writes the tile's bf16 embedding, h1, h2 and c1 to its records
// rec (kAct32: its f32 h1, h2 and c1 to its records act too), and raw and
// rgb per point to shared memory (kLoss) or dens and rgb to hd (else).
// dpart holds the ray's direction part (ray_dir_part).
template <bool kLoss, bool kAct32>
__device__ __forceinline__ void tile_forward(const FieldArgs& a, const HalfWeights& hw, const Smem& s,
                                             const float* pts_ray, int p0, int tn, bf16* rec, float* act, int& slot,
                                             T::Acc acc, const Heads& hd) {
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
  if constexpr (kAct32) store_act(acc, tn, act);
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
  if constexpr (kAct32) store_act(acc, tn, act + WN);
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
    if (tid < tn) {
      const float raw = softplus_b(part + hw.bd[0], a.beta);
      if constexpr (kLoss)
        s.raw[p0 + tid] = raw;
      else
        hd.dens[tid] = 1.f - expf(-raw);
    }
  }
  T::zero(acc);
  T::stream_mma(s.h2, LDW, hw.wc1h, WN, nullptr, s.ring, slot, acc);
  T::to_global(s.h2, LDW, tn, WN, rec + 2 * Ep + WN, RW);
  // c1, rounded: to X (the embedding is consumed); kAct32: unrounded to
  // act first, rounded by store_tile
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::JN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = T::col(j, e);
        const float v = softplus_b(acc[i][j][e] + s.dpart[c], a.beta);
        acc[i][j][e] = c < nh ? (kAct32 ? v : bf16_round(v)) : 0.f;
      }
  if constexpr (kAct32) store_act(acc, tn, act + 2 * WN);
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
    if (tid < tn) {
      const float rgb = 1.f / (1.f + expf(-(part + hw.bc2[m])));
      if constexpr (kLoss)
        s.rgb[(p0 + tid) * 3 + m] = rgb;
      else
        hd.rgb[tid * 3 + m] = rgb;
    }
  }
  T::to_global(s.X, LDW, tn, WN, rec + 2 * Ep + 2 * WN, RW);  // the row sums' barriers made c1 visible
}

// Backward of points [p0, p0 + tn) of one ray, from the bf16 h1, h2 and c1
// that tile_forward wrote to the tile's records rec (kAct32: sigmoid' and
// dwd from the f32 ones in act, staged in shared memory): the heads'
// cotangents (kLoss: from the
// composite's backward in shared memory, du over the ray and the ray's gf
// in misc; else: from hd), the vector grads over the tile's points into the
// block's slice vs, the ray's summed dc1p into ddpart, and the cotangents
// dc1, dh2, dh1 (their two products on the tensor cores), each written to
// the records beside the activations.
template <bool kLoss, bool kAct32>
__device__ __forceinline__ void tile_backward(const FieldArgs& a, const HalfWeights& hw, const Smem& s, float* vs,
                                              int p0, int tn, bf16* rec, const float* act, int& slot, T::Acc acc,
                                              const Heads& hd) {
  const int tid = threadIdx.x;
  const int Ep = a.Ep, nh = a.nh;
  const int RW = rec_width(Ep);
  const float beta = a.beta;
  const VecOffsets o(nh);
  __syncthreads();  // the previous tile's copies out of the tiles are done
  T::issue_slab(hw.wc1ht, s.ring + slot * mma::SLAB);
  // the tile's activations; rows past tn read as zeros, and every output masks them.
  // kAct32: each f32 slot at a row stride of LDW floats (the epilogues'
  // float2 reads free of bank conflicts) over the bf16 h1 | h2 tiles (fa),
  // h1's rows 32-63 in X (fx) once dc1pb is copied out
  float* const fa = reinterpret_cast<float*>(s.h1);
  float* const fx = reinterpret_cast<float*>(s.X);
  const uint32_t bar = stage_bar(s);
  uint64_t pol = 0;
  if constexpr (kAct32) pol = evict_first();
  if constexpr (kAct32) {
    // the rounded c1 (the wc2 grad's operand) to X and the f32 c1 to fa
    for (int c = tid; c < MT * (WN / 8); c += NTH) {
      const int r = c / (WN / 8), q = c % (WN / 8);
      const bf16* src = rec + (r < tn ? r : 0) * (int64_t)RW + 2 * Ep + 2 * WN + q * 8;
      mma::cp_async16(s.X + r * LDW + q * 8, src, r < tn);
    }
    for (int c = tid; c < MT * (WN / 4); c += NTH) {
      const int r = c / (WN / 4), q = c % (WN / 4);
      cp_async16_policy(fa + r * LDW + q * 4, act + (r < tn ? r : 0) * (int64_t)ACT_W + 2 * WN + q * 4, r < tn, pol);
    }
  } else {
    bf16* const tiles[3] = {s.h1, s.h2, s.X};
    for (int c = tid; c < 3 * MT * (WN / 8); c += NTH) {
      const int k = c / (MT * (WN / 8)), r = (c / (WN / 8)) % MT, q = c % (WN / 8);
      const bf16* src = rec + (r < tn ? r : 0) * (int64_t)RW + 2 * Ep + k * WN + q * 8;
      mma::cp_async16(tiles[k] + r * LDW + q * 8, src, r < tn);
    }
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  if constexpr (kLoss) {
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
  } else {
    // the heads' cotangents pulled back to their pre-activations: dc2p =
    // grgb rgb (1 - rgb); du from the stored density, sigmoid(beta x) = 1 -
    // exp(-beta raw) = 1 - (1 - dens)^beta
    if (tid < 3 * MT) {
      float d = 0.f;
      if (tid / 3 < tn) {
        const float rg = hd.rgb[tid];
        d = hd.grgb[tid] * rg * (1.f - rg);
      }
      s.dc2p[tid] = d;
      s.dc2pb[tid] = bf16_round(d);
    } else if (tid < 4 * MT) {
      const int t = tid - 3 * MT;
      float du = 0.f;
      if (t < tn) {
        const float d = hd.dens[t];
        du = hd.gdens[t] * (1.f - d) * (1.f - expf(beta * log1pf(-d)));
      }
      s.du[t] = du;
    }
  }
  __syncthreads();
  // the heads' grads over the tile's points: wc2 on the rounded c1, wd on
  // the stored h2 (rounded, or kAct32 f32) with an f32 du, and their biases
  const float* du = kLoss ? s.du + p0 : s.du;
  if (tid < nh) {
    float g0 = 0.f, g1 = 0.f, g2 = 0.f, gd = 0.f;
    for (int t = 0; t < tn; ++t) {
      const float c1 = mma::tile_at(s.X, t, tid);
      g0 += c1 * s.dc2pb[t * 3];
      g1 += c1 * s.dc2pb[t * 3 + 1];
      g2 += c1 * s.dc2pb[t * 3 + 2];
      if constexpr (!kAct32) gd += mma::tile_at(s.h2, t, tid) * du[t];  // kAct32: once the f32 h2 is staged
    }
    vs[o.wc2 + tid * 3] += g0;
    vs[o.wc2 + tid * 3 + 1] += g1;
    vs[o.wc2 + tid * 3 + 2] += g2;
    if constexpr (!kAct32) vs[o.wd + tid] += gd;
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
  // dc1p = (dc2pb Wc2^T) sigmoid'(c1); dc1pb replaces c1b in X.  The
  // epilogues take a column pair (e = 2 h + q) of the stored activations.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::JN; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = T::row(i, 2 * h), c0 = T::col(j, 2 * h);
        float2 c1;
        if constexpr (kAct32)
          c1 = *reinterpret_cast<const float2*>(fa + t * LDW + c0);
        else
          c1 = tile_pair(s.X, t, c0);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = c0 + q;
          float v = 0.f;
          if (t < tn && c < nh) {
            const float dc1 = s.dc2pb[t * 3] * hw.wc2[c * 3] + s.dc2pb[t * 3 + 1] * hw.wc2[c * 3 + 1] +
                              s.dc2pb[t * 3 + 2] * hw.wc2[c * 3 + 2];
            v = dc1 * sig_from_act(q ? c1.y : c1.x, beta);
          }
          acc[i][j][2 * h + q] = v;
        }
      }
  T::store_tile(acc, s.X);
  if constexpr (kAct32) fence_async_shared();
  float cs = T::col_sum(acc, s.red);
  // kAct32: the f32 h2 over the f32 c1, behind the next product
  if constexpr (kAct32) stage_slot(fa, fa + 32 * LDW, act + WN, tn, bar, pol);
  if (tid < nh) {
    vs[o.bc1 + tid] += cs;
    s.ddpart[tid] += cs;
  }
  // dh2p = (dc1pb Wc1h^T + du wd) sigmoid'(h2); dh2pb replaces h2b
  T::zero(acc);
  T::stream_mma(s.X, LDW, hw.wc1ht, WN, hw.w2t, s.ring, slot, acc);
  T::to_global(s.X, LDW, tn, WN, rec + 2 * Ep + 5 * WN, RW);
  if constexpr (kAct32) {
    wait_stage(bar, 0);
    if (tid < nh) {
      float gd = 0.f;
      for (int t = 0; t < tn; ++t) gd += fa[t * LDW + tid] * du[t];
      vs[o.wd + tid] += gd;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::JN; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = T::row(i, 2 * h), c0 = T::col(j, 2 * h);
        float2 h2;
        if constexpr (kAct32)
          h2 = *reinterpret_cast<const float2*>(fa + t * LDW + c0);
        else
          h2 = tile_pair(s.h2, t, c0);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = c0 + q, e = 2 * h + q;
          acc[i][j][e] = t < tn && c < nh ? (acc[i][j][e] + du[t] * hw.wd[c]) * sig_from_act(q ? h2.y : h2.x, beta)
                                          : 0.f;
        }
      }
  if constexpr (kAct32) {
    // every thread has read its f32 h2 and its share of dc1pb before the f32
    // h1 lands over rows 0-31 of fa and over X, behind the next product
    fence_async_shared();
    __syncthreads();
    stage_slot(fa, fx, act, tn, bar, pol);
  }
  T::store_tile(acc, s.h2);
  cs = T::col_sum(acc, s.red);
  if (tid < nh) vs[o.b2 + tid] += cs;
  // dh1p = (dh2pb W2^T) sigmoid'(h1); dh1pb replaces h1b
  T::zero(acc);
  T::stream_mma(s.h2, LDW, hw.w2t, WN, nullptr, s.ring, slot, acc);
  T::to_global(s.h2, LDW, tn, WN, rec + 2 * Ep + 4 * WN, RW);
  if constexpr (kAct32) wait_stage(bar, 1);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::JN; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = T::row(i, 2 * h), c0 = T::col(j, 2 * h);
        float2 h1;
        if constexpr (kAct32)
          h1 = *reinterpret_cast<const float2*>((t < 32 ? fa + t * LDW : fx + (t - 32) * LDW) + c0);
        else
          h1 = tile_pair(s.h1, t, c0);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = c0 + q, e = 2 * h + q;
          acc[i][j][e] = t < tn && c < nh ? acc[i][j][e] * sig_from_act(q ? h1.y : h1.x, beta) : 0.f;
        }
      }
  if constexpr (kAct32) __syncthreads();  // every thread has read its f32 h1 before dh1pb lands over it
  T::store_tile(acc, s.h1);
  cs = T::col_sum(acc, s.red);
  if (tid < nh) vs[o.b1 + tid] += cs;
  T::to_global(s.h1, LDW, tn, WN, rec + 2 * Ep + 3 * WN, RW);
}

// The colour head's direction part of one ray, dpart = ds Wc1ds + dc Wc1dc +
// bc1 (each sum in order over k, then ps + pc + bc1): the block's two halves
// take ds and dc; ds / dc (the ray's embedding, f32 holding bf16 values) are
// left in dsr / dcr.  Every tile of a ray, in whichever block, gets the same
// dpart bits.
__device__ __forceinline__ void ray_dir_part(const FieldArgs& a, const HalfWeights& hw, const Smem& s,
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

// The ray's record rr after its last tile_backward: its embedding (dsr, dcr)
// and its summed dc1p (ddpart), rounded once.  Ends with a barrier.
__device__ __forceinline__ void write_ray_record(const FieldArgs& a, const Smem& s, bf16* rr) {
  const int E = a.E, Ep = a.Ep, nh = a.nh;
  __syncthreads();
  for (int i = threadIdx.x; i < ray_rec_width(Ep); i += NTH) {
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

// The six matrix grads of each half from its records (field_tc.cu): dw_kernel
// into part (H, n_splits, G), G = 4 E nh + 2 nh^2, then sum_slices into
// mat_out (H, G) = w1s w1c w2 wc1h wc1ds wc1dc, flat.
void launch_weight_grads(const bf16* rec, const bf16* rrec, int n_halves, int R, int P, int E, int Ep, int nh,
                         float* part, int n_splits, float* mat_out, cudaStream_t stream);

}  // namespace field_tc
