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
//              sigmoid' recovered from the stored activations, every
//              product operand rounded to bf16, dwd on the stored h2.
// Outputs: the 13 weight grads and (ce_sum, se_sum) per half, and the EA
// weights w (H, R, P) when asked.  Rows with valid = 0 contribute nothing.
//
// Two variants by the field's activation storage (field_tc.cuh, kAct32):
// bundle_loss_kernel stores bf16 activations (the backward reads the
// rounded h1, h2, c1); bundle_loss_act32_kernel stores f32 activations, as
// FieldConfig()'s act_dtype float32 does: the forward is the same, and the
// backward's sigmoid' and dwd read the unrounded h1, h2, c1 from an f32
// record of 3,072 B a point beside the bf16 one (~2.8 GB a train step more
// written and read back), each slot staged in shared memory ahead of the
// epilogue that reads it (field_tc.cuh).
//
// What bounds it: arithmetic.  The function's work is ~1.15 MFLOP of bf16
// products a point at the reference width (H = 60, 256 hidden): the
// forward (0.45 MFLOP), the backward's two products (0.26) and the four
// weight-grad contractions (0.45); a train step (2 halves x 1,200 rays x
// (64 + 320) points) is ~1.06 TFLOP, ~1.1 ms at the tensor cores' 989
// TFLOP/s, against ~2 MB of inputs and outputs.  Every product runs on the
// tensor cores, in the tile code K4 shares with K5 / K6 (field_tc.cuh, with
// kLoss = true).  One fine ray's activations (~720 KB) cannot stay on chip
// and the composite couples every point of a ray, so a block of 16 warps
// (one an SM) owns one ray at a time in two passes of 64-point tiles: pass
// A (tile_forward) runs the forward, keeps raw and rgb per point in shared
// memory and writes each point's bf16 es, ec, h1, h2 and c1 to its record
// in a device workspace; warp 0 composites the ray, takes the loss and
// runs the composite's backward (a real prefix scan); pass B
// (tile_backward) reads each tile's h1, h2 and c1 back (no recompute: the
// same bits) and runs the backward's products, writing the cotangents dh1,
// dh2 and dc1 beside them (3.8 KB a point in all).  The weight-grad
// contractions are not summed tile by tile into a per-block slice of device
// memory (0.89 MB read and written per 64-point tile, ~25.7 GB a step,
// which misses the 50 MB L2): dw_kernel (field_tc.cu) computes the six
// matrix grads from the workspace as output-stationary tensor-core products
// over fixed slices of the points.  The vector grads (biases, wd, wc2) stay
// in per-block f32 slices.  sum_slices adds slices in a fixed order: no
// float atomics, and two launches give bit-identical results.  Build
// without --use_fast_math: sincosf keeps its full range reduction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include "field_common.cuh"
#include "field_mma.cuh"
#include "field_tc.cuh"
#include "kernels.h"

using field::sig_from_act;
using field::warp_sum;
using field_tc::NTH;
using field_tc::T;
using mma::bf16;
using mma::MT;
using mma::WN;

namespace {

struct LossArgs : field_tc::FieldArgs {
  const float* tgt;  // (H, R, 8): col(3), sil, valid
  float hs, hs2, scale, scale3;
  float* w_out;  // (H, R, P) or null
};

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
__device__ __forceinline__ void composite_ray(const LossArgs& a, const field_tc::Smem& s, const float* tgt,
                                              float* w_out) {
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

// Block b of half h walks rays b, b + n_blocks, ...
template <bool kAct32>
__device__ __forceinline__ void bundle_loss_blocks(const LossArgs& a, unsigned char* smem_raw) {
  const field_tc::Smem s = field_tc::carve(smem_raw, a.Ep, a.P);
  const int h = blockIdx.y;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int Ep = a.Ep, R = a.R, P = a.P;
  const field_tc::HalfWeights hw = field_tc::half_weights(a, h);
  const field_tc::VecOffsets o(a.nh);
  float* vs = a.vwork + ((int64_t)h * a.n_blocks + b) * o.total;
  for (int i = tid; i < o.total; i += NTH) vs[i] = 0.f;
  if (tid < 8) s.misc[tid] = 0.f;
  __syncthreads();
  if constexpr (kAct32) field_tc::init_stage_bar(s);  // over misc[6..7], zeroed above
  const int RW = field_tc::rec_width(Ep), RRW = field_tc::ray_rec_width(Ep);
  const field_tc::Heads none{};
  int slot = 0;
  T::Acc acc;

  for (int r = b; r < R; r += a.n_blocks) {
    const int64_t ray = (int64_t)h * R + r;
    const float* pts_ray = a.pts + ray * P * 3;
    // the ray's direction part of the colour head, once per ray
    field_tc::ray_dir_part(a, hw, s, a.dirs + ray * 3);
    if (tid < WN) s.ddpart[tid] = 0.f;
    // pass A: raw and rgb of every point of the ray
    for (int p0 = 0; p0 < P; p0 += MT)
      field_tc::tile_forward<true, kAct32>(a, hw, s, pts_ray, p0, min(MT, P - p0), a.rec + (ray * P + p0) * RW,
                                           kAct32 ? a.act + (ray * P + p0) * field_tc::ACT_W : nullptr, slot, acc,
                                           none);
    __syncthreads();
    if (tid < 32) composite_ray(a, s, a.tgt + ray * 8, a.w_out ? a.w_out + ray * P : nullptr);
    __syncthreads();
    // pass B: each tile's backward from its stored activations
    for (int p0 = 0; p0 < P; p0 += MT)
      field_tc::tile_backward<true, kAct32>(a, hw, s, vs, p0, min(MT, P - p0), a.rec + (ray * P + p0) * RW,
                                            kAct32 ? a.act + (ray * P + p0) * field_tc::ACT_W : nullptr, slot, acc,
                                            none);
    field_tc::write_ray_record(a, s, a.rrec + ray * RRW);
  }
  if (tid == 0) {
    vs[o.ce] = s.misc[3];
    vs[o.se] = s.misc[4];
  }
}

// The two variants, each under its own name in a trace.
__global__ void __launch_bounds__(NTH, 1) bundle_loss_kernel(LossArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bundle_loss_blocks<false>(a, smem_raw);
}

__global__ void __launch_bounds__(NTH, 1) bundle_loss_act32_kernel(LossArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bundle_loss_blocks<true>(a, smem_raw);
}

}  // namespace

int64_t field_rec_width(int ep) { return field_tc::rec_width(ep); }
int64_t field_ray_rec_width(int ep) { return field_tc::ray_rec_width(ep); }
int64_t field_vec_width(int n_hidden) { return field_tc::VecOffsets(n_hidden).total; }
int field_dw_tiles(int e, int n_hidden) { return field_tc::dw_tiles(e, n_hidden); }

void launch_bundle_loss(const float* pts, const float* dirs, const float* tgt, int n_halves, int n_rays, int n_pts,
                        const float* fmat, int n_base, int ladder, int ep, const void* const* mats,
                        const float* const* vecs, int n_hidden, float beta, float hs, float hs2, float scale,
                        float scale3, float* vwork, int n_blocks, void* rec, void* rrec, float* act, float* part,
                        int n_splits, float* vec_out, float* mat_out, float* w_out, void* stream) {
  if (n_halves <= 0 || n_rays <= 0 || n_pts <= 0) return;
  TORCH_CHECK(n_hidden > 0 && n_hidden <= WN, "bundle-loss kernel: n_hidden must be in [1, 256]");
  TORCH_CHECK(n_blocks > 0 && n_splits > 0, "bundle-loss kernel: n_blocks and n_splits must be positive");
  const int E = n_base * (ladder > 1 ? ladder : 1);
  TORCH_CHECK(ep >= E && ep % 16 == 0, "bundle-loss kernel: the padded embedding width must be a multiple of 16 >= ",
              E);
  const size_t smem = field_tc::smem_bytes(ep, n_pts);
  TORCH_CHECK(smem <= 232448, "bundle-loss kernel: ", smem, " bytes of shared memory for ", n_pts,
              " points per ray exceed the block's 227 KB");
  const auto kernel = act ? bundle_loss_act32_kernel : bundle_loss_kernel;
  C10_CUDA_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  LossArgs a;
  static_cast<field_tc::FieldArgs&>(a) =
      field_tc::field_args(pts, dirs, n_rays, n_pts, fmat, n_base, ladder, ep, mats, vecs, n_hidden, beta);
  a.tgt = tgt;
  a.hs = hs;
  a.hs2 = hs2;
  a.scale = scale;
  a.scale3 = scale3;
  a.vwork = vwork;
  a.n_blocks = n_blocks;
  a.rec = static_cast<bf16*>(rec);
  a.rrec = static_cast<bf16*>(rrec);
  a.act = act;
  a.w_out = w_out;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(n_blocks, n_halves), NTH, smem, st>>>(a);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  const int64_t V = field_tc::VecOffsets(n_hidden).total;
  field::sum_slices<<<dim3((unsigned)((V + 255) / 256), n_halves), 256, 0, st>>>(vwork, n_blocks, V, vec_out);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  field_tc::launch_weight_grads(a.rec, a.rrec, n_halves, n_rays, n_pts, E, ep, n_hidden, part, n_splits, mat_out, st);
}
