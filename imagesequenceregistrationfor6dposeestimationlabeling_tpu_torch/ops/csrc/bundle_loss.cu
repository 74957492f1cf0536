// K4: the NeRF train step's bundle loss and its backward, for H fields.
//
// Replaces the Pallas TPU kernel _loss_kernel (imagesequenceregistration-
// for6dposeestimationlabeling_tpu/ops/field_kernel.py:701, via
// _make_loss_op / bundle_loss_grads).  Per half h and ray r, with the
// rounding points of the TPU kernel:
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
// What bounds it: arithmetic.  A point costs ~1.6 MFLOP at the reference
// width (H = 60, 256 hidden): the forward twice, the backward products and
// the weight-grad contractions, all on CUDA cores (no tensor cores yet).
// One fine ray's activations (320 x (2*180 + 3*256) bf16, ~720 KB) cannot
// stay on chip, and the composite couples every point of a ray, so a block
// owns one ray at a time and makes two passes over it in 64-point chunks:
// pass A runs the forward and keeps only raw and rgb per point in shared
// memory; warp 0 then composites the ray, takes the loss and runs the
// composite's backward (a real prefix scan, not a triangular product);
// pass B recomputes each chunk's forward, keeping es, ec, h1, h2 and c1 as
// bf16 in shared memory (~144 KB), and runs the backward and the
// contractions over the chunk's points.  Nothing per point goes to device
// memory.  The TPU grid ran in order and carried the grads in resident
// outputs; here a persistent grid of one block per SM walks the rays, each
// block accumulating into its own f32 slice of a workspace, and a second
// kernel sums the slices in a fixed order: no float atomics, and two
// launches give bit-identical results.  Build without --use_fast_math:
// sincosf keeps its full range reduction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include "field_common.cuh"
#include "kernels.h"

using namespace field;

namespace {

struct LossArgs {
  const float* pts;   // (H, R, P, 3)
  const float* dirs;  // (H, R, 3), unit
  const float* tgt;   // (H, R, 8): col(3), sil, valid
  int R, P;
  const float* fmat;  // (3, n_base)
  int n_base, ladder, E, nh;
  // per-half blocks, each with the leading half axis; the product weights
  // arrive as bf16 values stored in f32
  const float *w1s, *w1c, *b1, *w2, *b2, *wd, *bd, *wc1h, *wc1ds, *wc1dc, *bc1, *wc2, *bc2;
  const float *w2t, *wc1ht;  // W2 and Wc1h transposed, for the backward's products
  float beta, hs, hs2, scale, scale3;
  float* work;  // (H, n_blocks, G + 2) per-block slices
  int n_blocks;
  int64_t G;
  float* w_out;  // (H, R, P) or null
};

struct Smem {
  float *wtile, *red, *dpart, *ddpart, *dsr, *dcr, *raw, *A, *w, *du, *rgb, *dc2p, *dc2pb, *misc;
  bf16 *es, *ec, *h1, *h2, *c1;
};

__host__ __device__ inline int64_t padded_points(int P) { return ((int64_t)P + TP - 1) / TP * TP; }

__host__ __device__ inline size_t smem_bytes(int E, int P) {
  const int64_t Pp = padded_points(P);
  const int64_t floats = KT * HMAX + 8 * HMAX + 2 * HMAX + 2 * E + 7 * Pp + 6 * TP + 8;
  const int64_t halves = 2 * TP * E + 3 * TP * HMAX;
  return sizeof(float) * floats + sizeof(bf16) * halves;
}

__device__ Smem carve(float* base, int E, int P) {
  const int64_t Pp = padded_points(P);
  Smem s;
  s.wtile = base;
  s.red = s.wtile + KT * HMAX;
  s.dpart = s.red + 8 * HMAX;
  s.ddpart = s.dpart + HMAX;
  s.dsr = s.ddpart + HMAX;
  s.dcr = s.dsr + E;
  s.raw = s.dcr + E;
  s.A = s.raw + Pp;
  s.w = s.A + Pp;
  s.du = s.w + Pp;
  s.rgb = s.du + Pp;
  s.dc2p = s.rgb + 3 * Pp;
  s.dc2pb = s.dc2p + 3 * TP;
  s.misc = s.dc2pb + 3 * TP;  // the ray's gf[3], then the block's ce_sum, se_sum
  s.es = reinterpret_cast<bf16*>(s.misc + 8);
  s.ec = s.es + TP * E;
  s.h1 = s.ec + TP * E;
  s.h2 = s.h1 + TP * HMAX;
  s.c1 = s.h2 + TP * HMAX;
  return s;
}

// The per-half weights.
struct HalfWeights {
  const float *w1s, *w1c, *b1, *w2, *b2, *wd, *bd, *wc1h, *wc1ds, *wc1dc, *bc1, *wc2, *bc2, *w2t, *wc1ht;
};

// Forward of points [p0, p0 + tn) of one ray.  Leaves bf16 es, ec, h1, h2
// and c1 in shared memory and the rounded c1 in acc; pass A also stores
// raw and rgb per point.
__device__ __forceinline__ void chunk_forward(const LossArgs& a, const HalfWeights& hw, const Smem& s,
                                              const float* pts_ray, int p0, int tn, bool pass_a,
                                              float acc[8][8]) {
  const int tid = threadIdx.x;
  const int g = tid >> 5;
  const int lane = tid & 31;
  const int nh = a.nh;
  embed(pts_ray + (size_t)p0 * 3, tn, TP, a.fmat, a.n_base, a.ladder, a.E, s.es, s.ec);
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  gemm_acc(s.es, a.E, a.E, hw.w1s, nh, s.wtile, acc);
  gemm_acc(s.ec, a.E, a.E, hw.w1c, nh, s.wtile, acc);
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = lane + 32 * c;
      s.h1[(g * 8 + r) * HMAX + j] = __float2bfloat16_rn(j < nh ? softplus_b(acc[r][c] + hw.b1[j], a.beta) : 0.f);
      acc[r][c] = 0.f;
    }
  gemm_acc(s.h1, HMAX, nh, hw.w2, nh, s.wtile, acc);
  // h2: bf16 to shared memory; the density head reads it unrounded, in f32
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = lane + 32 * c;
      float h2 = 0.f;
      if (j < nh) {
        h2 = softplus_b(acc[r][c] + hw.b2[j], a.beta);
        part += h2 * hw.wd[j];
      }
      s.h2[(g * 8 + r) * HMAX + j] = __float2bfloat16_rn(h2);
      acc[r][c] = 0.f;
    }
    if (pass_a) {
      part = warp_sum(part);
      const int t = g * 8 + r;
      if (lane == 0 && t < tn) s.raw[p0 + t] = softplus_b(part + hw.bd[0], a.beta);
    }
  }
  gemm_acc(s.h2, HMAX, nh, hw.wc1h, nh, s.wtile, acc);
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = lane + 32 * c;
      const float c1 = j < nh ? bf16_round(softplus_b(acc[r][c] + s.dpart[j], a.beta)) : 0.f;
      s.c1[(g * 8 + r) * HMAX + j] = __float2bfloat16_rn(c1);
      acc[r][c] = c1;
    }
  if (!pass_a) return;
  // rgb = sigmoid(c1b . wc2 + bc2), per point over the 32 lanes' units
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = g * 8 + r;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = lane + 32 * c;
        if (j < nh) part += acc[r][c] * hw.wc2[j * 3 + m];
      }
      part = warp_sum(part);
      if (lane == 0 && t < tn) s.rgb[(p0 + t) * 3 + m] = 1.f / (1.f + expf(-(part + hw.bc2[m])));
    }
  }
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
__device__ __forceinline__ void composite_ray(const LossArgs& a, const Smem& s, const float* tgt,
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
  }
  if (lane == 0) {
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

// Backward of points [p0, p0 + tn) after chunk_forward (pass B): the
// colour output's cotangent from the composite, then the shared hand
// backward of the field and its contractions into the block's slice.
__device__ __forceinline__ void chunk_backward(const LossArgs& a, const HalfWeights& hw, const Smem& s,
                                               const GradOffsets& o, float* ws, int p0, int tn,
                                               float acc[8][8]) {
  const int tid = threadIdx.x;
  // colour output: dc2p = grgb rgb (1 - rgb), grgb = w gf
  if (tid < 3 * TP) {
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
  const TileGrad tg{s.es, s.ec, s.h1, s.h2, s.c1, s.dc2p, s.dc2pb, s.du + p0, s.red, s.wtile, s.ddpart};
  tile_backward(tg, hw.wc2, hw.wd, hw.wc1ht, hw.w2t, a.E, a.nh, a.beta, o, ws, tn, acc);
}

__global__ void __launch_bounds__(NT, 1) bundle_loss_kernel(LossArgs a) {
  extern __shared__ float smem[];
  const Smem s = carve(smem, a.E, a.P);
  const int h = blockIdx.y;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int E = a.E, nh = a.nh, R = a.R, P = a.P;
  const int64_t EC = (int64_t)E * nh, CC = (int64_t)nh * nh;
  const HalfWeights hw{a.w1s + h * EC, a.w1c + h * EC, a.b1 + h * nh,  a.w2 + h * CC,     a.b2 + h * nh,
                       a.wd + h * nh,  a.bd + h,       a.wc1h + h * CC, a.wc1ds + h * EC, a.wc1dc + h * EC,
                       a.bc1 + h * nh, a.wc2 + h * nh * 3, a.bc2 + h * 3, a.w2t + h * CC, a.wc1ht + h * CC};
  const GradOffsets o(E, nh);
  float* ws = a.work + ((int64_t)h * a.n_blocks + b) * (a.G + 2);
  for (int64_t i = tid; i < a.G + 2; i += NT) ws[i] = 0.f;
  if (tid < 8) s.misc[tid] = 0.f;
  __syncthreads();
  float acc[8][8];

  for (int r = b; r < R; r += a.n_blocks) {
    const int64_t ray = (int64_t)h * R + r;
    const float* pts_ray = a.pts + ray * P * 3;
    // the ray's direction part of the colour head, once per ray
    dir_part(a.dirs + ray * 3, a.fmat, a.n_base, a.ladder, E, hw.wc1ds, hw.wc1dc, hw.bc1, nh, s.dsr, s.dcr, s.dpart);
    if (tid < nh) s.ddpart[tid] = 0.f;
    // pass A: raw and rgb of every point of the ray
    for (int p0 = 0; p0 < P; p0 += TP) chunk_forward(a, hw, s, pts_ray, p0, min(TP, P - p0), true, acc);
    __syncthreads();
    if (tid < 32) composite_ray(a, s, a.tgt + ray * 8, a.w_out ? a.w_out + ray * P : nullptr);
    __syncthreads();
    // pass B: recompute each chunk, then its backward
    for (int p0 = 0; p0 < P; p0 += TP) {
      const int tn = min(TP, P - p0);
      chunk_forward(a, hw, s, pts_ray, p0, tn, false, acc);
      chunk_backward(a, hw, s, o, ws, p0, tn, acc);
    }
    // direction-part grads: the ray's summed dc1p, rounded, against its embedding
    dir_grads(s.dsr, s.dcr, s.ddpart, E, nh, o, ws);
    __syncthreads();
  }
  if (tid == 0) {
    ws[a.G] = s.misc[3];
    ws[a.G + 1] = s.misc[4];
  }
}

}  // namespace

void launch_bundle_loss(const float* pts, const float* dirs, const float* tgt, int n_halves, int n_rays,
                        int n_pts, const float* fmat, int n_base, int ladder, const float* const* weights,
                        const float* w2t, const float* wc1ht, int n_hidden, float beta, float hs, float hs2,
                        float scale, float scale3, float* work, int n_blocks, float* out, float* w_out,
                        void* stream) {
  if (n_halves <= 0 || n_rays <= 0 || n_pts <= 0) return;
  TORCH_CHECK(n_hidden > 0 && n_hidden <= HMAX, "bundle-loss kernel: n_hidden must be in [1, 256]");
  TORCH_CHECK(n_blocks > 0, "bundle-loss kernel: n_blocks must be positive");
  const int E = n_base * (ladder > 1 ? ladder : 1);
  const size_t smem = smem_bytes(E, n_pts);
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
  a.nh = n_hidden;
  const float** dst[13] = {&a.w1s, &a.w1c, &a.b1, &a.w2, &a.b2, &a.wd, &a.bd,
                           &a.wc1h, &a.wc1ds, &a.wc1dc, &a.bc1, &a.wc2, &a.bc2};
  for (int i = 0; i < 13; ++i) *dst[i] = weights[i];
  a.w2t = w2t;
  a.wc1ht = wc1ht;
  a.beta = beta;
  a.hs = hs;
  a.hs2 = hs2;
  a.scale = scale;
  a.scale3 = scale3;
  a.work = work;
  a.n_blocks = n_blocks;
  a.G = GradOffsets(E, n_hidden).total;
  a.w_out = w_out;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bundle_loss_kernel<<<dim3(n_blocks, n_halves), NT, smem, st>>>(a);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  const int64_t width = a.G + 2;
  sum_slices<<<dim3((unsigned)((width + 255) / 256), n_halves), 256, 0, st>>>(work, n_blocks, width, out);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}
