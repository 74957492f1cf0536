// K5 and K6: the NeRF field's colour forward with its residuals stored,
// and the backward from those residuals into the 13 weight grads, for H
// fields (the two half-sequence NeRFs) in one launch each.
//
// Replace the Pallas TPU kernels _fwd_kernel (imagesequenceregistration-
// for6dposeestimationlabeling_tpu/ops/field_kernel.py:248, pallas_call at
// :587) and _bwd_kernel (:481, pallas_call at :643, math in _grad_math
// :420), the custom-VJP pair behind field_color (via _make_op), which runs
// every chunk of a NeRF step with more rays than one chunk.  Per half h,
// ray r and point p, with the rounding points of the TPU kernels:
//   K5  es/ec = bf16(sincos(exact f32 angles)) (+ double-angle rungs)
//       h1 = softplus_b(es W1s + ec W1c + b1), h2 = softplus_b(bf16(h1) W2 + b2)
//       dens = 1 - exp(-softplus_b(h2 . wd + bd)) on the unrounded h2, in f32
//       c1 = softplus_b(bf16(h2) Wc1h + dpart), dpart = ds Wc1ds + dc Wc1dc + bc1 once per ray
//       rgb = sigmoid(bf16(c1) Wc2 + bc2)
//       out: dens, rgb (f32); es, ec, h1, h2, c1 (bf16) in each point's record
//   K6  du = gdens (1 - dens) (1 - exp(beta log1p(-dens))), dc2p = grgb rgb (1 - rgb),
//       then exactly the reference's _grad_math: bf16 product operands, dwd
//       on the stored h2, sigmoid' from the stored activations; a
//       ray's ddpart is summed over all its points in f32 and rounded to
//       bf16 once before its contraction with the direction embedding,
//       which is recomputed per ray.
//
// Both are K4's tile code (field_tc.cuh) with kLoss = false: K5 is K4's
// pass A without the composite, K6 is K4's pass B with the heads'
// cotangents from gdens / grgb, then K4's contraction kernel.  The
// residuals are K4's per-point record (rec_width(Ep) bf16 a point, E
// zero-padded to Ep = 192 at the reference width):
//   es | ec | h1 | h2 | c1   written by K5 (2 (2 Ep + 3 x 256) = 2,304 B a point)
//   dh1 | dh2 | dc1          written by K6's pass kernel, read by dw_kernel
// The wrapper allocates the whole record (3,840 B a point, ~5 GB for the
// 4,096-ray fine chunk) with K5 and hands it to K6, which fills the
// cotangent slots and runs dw_kernel on it unchanged; K6 allocates the
// per-ray records (ds | dc | bf16(ddpart)).
//
// What bounds them (counted at a chunked step, 4,800 rays x
// (64 + 320) points, reference width): K5 moves 2,332 B a point (points in,
// dens, rgb and the residual row out), 4.3 GB, 1.28 ms at 3.35 TB/s,
// against 0.45 MFLOP a point of products, 0.84 ms at 989 TFLOP/s: bytes.
// K6 reads the residual row, writes and reads the 3 x 512 B of cotangents
// and reads dens, rgb, gdens, grgb: 5,408 B a point, 3.0 ms, against 0.71
// MFLOP a point (the two cotangent products and the four contractions),
// 1.3 ms: bytes.  Design: every product on the tensor cores (mma.sync,
// field_mma.cuh) in 64-point tiles, one block of 16 warps an SM, the bf16
// weights streamed from L2 through the cp.async ring.  K5: a persistent
// grid whose blocks walk whole rays (dpart once a ray; a block per tile,
// dpart once a tile, was 9 % slower at a chunked step).  K6: a persistent
// grid of blocks walking
// whole rays (so a ray's ddpart is complete before it is rounded) runs
// each tile's backward from its record and writes the cotangents; its
// vector grads go into per-block f32 slices; dw_kernel (field_tc.cu)
// contracts the six matrix grads over fixed slices of the points;
// sum_slices adds the slices in a fixed order.  No float atomics: two
// launches give bit-identical results.  Build without --use_fast_math:
// sincosf keeps its full range reduction.
//
// Two variants of each by the field's activation storage (field_tc.cuh,
// kAct32): field_color_fwd_kernel / field_color_bwd_kernel store bf16
// activations; field_color_fwd_act32_kernel / field_color_bwd_act32_kernel
// f32 ones: K5 also writes each point's unrounded h1 | h2 | c1 to an f32
// record (3,072 B a point, ~8 GB for the 4,096-ray fine chunk), from which
// K6 takes sigmoid' and dwd.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include "field_common.cuh"
#include "field_mma.cuh"
#include "field_tc.cuh"
#include "kernels.h"

using field_tc::NTH;
using field_tc::T;
using mma::bf16;
using mma::MT;
using mma::WN;

namespace {

struct ColorArgs : field_tc::FieldArgs {
  float *dens, *rgb;             // (H, R, P, 1), (H, R, P, 3): K5's outputs, K6's inputs
  const float *gdens, *grgb;     // (H, R, P, 1), (H, R, P, 3): K6's cotangents
};

// K5: block b of half h walks rays b, b + n_blocks, ... tile by tile,
// computing the ray's direction part once.
template <bool kAct32>
__device__ __forceinline__ void color_fwd_blocks(const ColorArgs& a, unsigned char* smem_raw) {
  const field_tc::Smem s = field_tc::carve(smem_raw, a.Ep, MT);
  const int h = blockIdx.y;
  const int P = a.P;
  const field_tc::HalfWeights hw = field_tc::half_weights(a, h);
  const int RW = field_tc::rec_width(a.Ep);
  int slot = 0;
  T::Acc acc;

  for (int r = blockIdx.x; r < a.R; r += a.n_blocks) {
    const int64_t ray = (int64_t)h * a.R + r;
    const float* pts_ray = a.pts + ray * P * 3;
    __syncthreads();  // the previous ray's last tile is done with dpart and red
    field_tc::ray_dir_part(a, hw, s, a.dirs + ray * 3);
    for (int p0 = 0; p0 < P; p0 += MT) {
      const int64_t pt = ray * P + p0;
      const field_tc::Heads hd{a.dens + pt, a.rgb + pt * 3, nullptr, nullptr};
      field_tc::tile_forward<false, kAct32>(a, hw, s, pts_ray, p0, min(MT, P - p0), a.rec + pt * RW,
                                            kAct32 ? a.act + pt * field_tc::ACT_W : nullptr, slot, acc, hd);
    }
  }
}

// K6's pass: block b of half h walks rays b, b + n_blocks, ... tile by tile.
template <bool kAct32>
__device__ __forceinline__ void color_bwd_blocks(const ColorArgs& a, unsigned char* smem_raw) {
  const field_tc::Smem s = field_tc::carve(smem_raw, a.Ep, MT);
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int P = a.P;
  const field_tc::HalfWeights hw = field_tc::half_weights(a, h);
  const field_tc::VecOffsets o(a.nh);
  float* vs = a.vwork + ((int64_t)h * a.n_blocks + blockIdx.x) * o.total;
  for (int i = tid; i < o.total; i += NTH) vs[i] = 0.f;
  if constexpr (kAct32) field_tc::init_stage_bar(s);
  const int RW = field_tc::rec_width(a.Ep), RRW = field_tc::ray_rec_width(a.Ep);
  int slot = 0;
  T::Acc acc;

  for (int r = blockIdx.x; r < a.R; r += a.n_blocks) {
    const int64_t ray = (int64_t)h * a.R + r;
    // the ray's direction embedding, for its record
    field::embed<float, NTH>(a.dirs + ray * 3, 1, 1, a.fmat, a.n_base, a.ladder, a.E, s.dsr, s.dcr);
    if (tid < WN) s.ddpart[tid] = 0.f;
    for (int p0 = 0; p0 < P; p0 += MT) {
      const int64_t pt = ray * P + p0;
      const field_tc::Heads hd{a.dens + pt, a.rgb + pt * 3, a.gdens + pt, a.grgb + pt * 3};
      field_tc::tile_backward<false, kAct32>(a, hw, s, vs, p0, min(MT, P - p0), a.rec + pt * RW,
                                             kAct32 ? a.act + pt * field_tc::ACT_W : nullptr, slot, acc, hd);
    }
    field_tc::write_ray_record(a, s, a.rrec + ray * RRW);
  }
}

// The variants, each under its own name in a trace.
__global__ void __launch_bounds__(NTH, 1) field_color_fwd_kernel(ColorArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  color_fwd_blocks<false>(a, smem_raw);
}

__global__ void __launch_bounds__(NTH, 1) field_color_fwd_act32_kernel(ColorArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  color_fwd_blocks<true>(a, smem_raw);
}

__global__ void __launch_bounds__(NTH, 1) field_color_bwd_kernel(ColorArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  color_bwd_blocks<false>(a, smem_raw);
}

__global__ void __launch_bounds__(NTH, 1) field_color_bwd_act32_kernel(ColorArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  color_bwd_blocks<true>(a, smem_raw);
}

void check_shapes(const char* what, int n_hidden, int E, int ep) {
  TORCH_CHECK(n_hidden > 0 && n_hidden <= WN, what, ": n_hidden must be in [1, 256]");
  TORCH_CHECK(ep >= E && ep % 16 == 0, what, ": the padded embedding width must be a multiple of 16 >= ", E);
}

}  // namespace

void launch_field_color_fwd(const float* pts, const float* dirs, int n_halves, int n_rays, int n_pts,
                            const float* fmat, int n_base, int ladder, int ep, const void* const* mats,
                            const float* const* vecs, int n_hidden, float beta, void* rec, float* act, float* dens,
                            float* rgb, int n_blocks, void* stream) {
  if (n_halves <= 0 || n_rays <= 0 || n_pts <= 0) return;
  ColorArgs a;
  static_cast<field_tc::FieldArgs&>(a) =
      field_tc::field_args(pts, dirs, n_rays, n_pts, fmat, n_base, ladder, ep, mats, vecs, n_hidden, beta);
  check_shapes("field-colour forward kernel", n_hidden, a.E, ep);
  TORCH_CHECK(n_blocks > 0, "field-colour forward kernel: n_blocks must be positive");
  const size_t smem = field_tc::smem_bytes(ep, MT);
  const auto kernel = act ? field_color_fwd_act32_kernel : field_color_fwd_kernel;
  C10_CUDA_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  a.rec = static_cast<bf16*>(rec);
  a.act = act;
  a.dens = dens;
  a.rgb = rgb;
  a.gdens = nullptr;
  a.grgb = nullptr;
  a.n_blocks = n_blocks;
  kernel<<<dim3(n_blocks, n_halves), NTH, smem, static_cast<cudaStream_t>(stream)>>>(a);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void launch_field_color_bwd(const float* dirs, int n_halves, int n_rays, int n_pts, const float* fmat, int n_base,
                            int ladder, int ep, const void* const* mats, const float* const* vecs, int n_hidden,
                            float beta, void* rec, const float* act, const float* dens, const float* rgb,
                            const float* gdens, const float* grgb, float* vwork, int n_blocks, void* rrec, float* part,
                            int n_splits, float* vec_out, float* mat_out, void* stream) {
  if (n_halves <= 0 || n_rays <= 0 || n_pts <= 0) return;
  ColorArgs a;
  static_cast<field_tc::FieldArgs&>(a) =
      field_tc::field_args(nullptr, dirs, n_rays, n_pts, fmat, n_base, ladder, ep, mats, vecs, n_hidden, beta);
  check_shapes("field-colour backward kernel", n_hidden, a.E, ep);
  TORCH_CHECK(n_blocks > 0 && n_splits > 0, "field-colour backward kernel: n_blocks and n_splits must be positive");
  const size_t smem = field_tc::smem_bytes(ep, MT);
  const auto kernel = act ? field_color_bwd_act32_kernel : field_color_bwd_kernel;
  C10_CUDA_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  a.vwork = vwork;
  a.n_blocks = n_blocks;
  a.rec = static_cast<bf16*>(rec);
  a.rrec = static_cast<bf16*>(rrec);
  a.act = const_cast<float*>(act);
  a.dens = const_cast<float*>(dens);
  a.rgb = const_cast<float*>(rgb);
  a.gdens = gdens;
  a.grgb = grgb;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(n_blocks, n_halves), NTH, smem, st>>>(a);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  const int64_t V = field_tc::VecOffsets(n_hidden).total;
  field::sum_slices<<<dim3((unsigned)((V + 255) / 256), n_halves), 256, 0, st>>>(vwork, n_blocks, V, vec_out);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  field_tc::launch_weight_grads(a.rec, a.rrec, n_halves, n_rays, n_pts, a.E, ep, n_hidden, part, n_splits, mat_out,
                                st);
}
