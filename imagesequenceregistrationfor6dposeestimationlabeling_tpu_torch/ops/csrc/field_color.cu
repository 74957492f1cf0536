// K5 and K6: the NeRF field's colour forward with its residuals stored,
// and the backward from those residuals into the 13 weight grads, for H
// fields (the two half-sequence NeRFs) in one launch each.
//
// Replace the Pallas TPU kernels _fwd_kernel (imagesequenceregistration-
// for6dposeestimationlabeling_tpu/ops/field_kernel.py:248) and _bwd_kernel
// (:481), the custom-VJP pair behind field_color (via _make_op), which runs
// every chunk of a NeRF step with more rays than one chunk.  Per half h,
// ray r and point p, with the rounding points of the TPU kernels:
//   K5  es/ec = bf16(sincos(exact f32 angles)) (+ double-angle rungs)
//       h1 = softplus_b(es W1s + ec W1c + b1), h2 = softplus_b(bf16(h1) W2 + b2)
//       dens = 1 - exp(-softplus_b(h2 . wd + bd)) on the unrounded h2, in f32
//       c1 = softplus_b(bf16(h2) Wc1h + dpart), dpart = ds Wc1ds + dc Wc1dc + bc1 once per ray
//       rgb = sigmoid(bf16(c1) Wc2 + bc2)
//       out: dens, rgb (f32); es, ec, h1, h2, c1 (bf16), all in device memory
//   K6  du = gdens (1 - dens) (1 - exp(beta log1p(-dens))), dc2p = grgb rgb (1 - rgb),
//       then exactly the reference's _grad_math (field_common.cuh tile_backward):
//       bf16 product operands, dwd on the rounded h2, sigmoid' from the stored
//       bf16 activations; a ray's ddpart is summed over all its points in f32
//       and rounded to bf16 once before its contraction with the direction
//       embedding, which is recomputed per ray.
//
// What bounds them: arithmetic, on CUDA cores (no tensor cores yet), ~0.45
// MFLOP a point forward and ~0.7 MFLOP backward at the reference width
// (H = 60, 256 hidden).  The residuals are what the split pair exists for:
// 2,272 bytes a point at that width (~3 GB for a 4,096-ray fine chunk), a
// few ms of device-memory traffic against ~100 ms of products.  K5 is K1's
// tile (64 points of one ray a block, embedding and activations as bf16 in
// shared memory, weights through a 16-row shared tile, an 8 x 8 register
// tile of FMAs a thread) with the colour head added; each tile's residual
// rows are contiguous in device memory, and a warp stores contiguous row
// segments.  K6 reads a tile's residuals back into shared memory, where
// K4 recomputes them, and runs K4's backward and contractions.  The TPU
// grid accumulated grads in order in resident outputs; here a persistent
// grid (one block per SM, split over the halves) walks whole rays, so a
// ray's ddpart is complete before it is rounded, each block adds into its
// own f32 slice of a workspace, and sum_slices adds the slices in a fixed
// order: no float atomics, and two launches give bit-identical grads.
// Build without --use_fast_math: sincosf keeps its full range reduction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include "field_common.cuh"
#include "kernels.h"

using namespace field;

namespace {

struct FwdArgs {
  const float* pts;   // (H, R, P, 3)
  const float* dirs;  // (H, R, 3), unit
  int R, P, n_tiles;  // n_tiles = ceil(P / TP) tiles per ray
  const float* fmat;  // (3, n_base)
  int n_base, ladder, E, nh;
  // per-half blocks with the leading half axis; the product weights arrive
  // as bf16 values stored in f32
  const float *w1s, *w1c, *b1, *w2, *b2, *wd, *bd, *wc1h, *wc1ds, *wc1dc, *bc1, *wc2, *bc2;
  float beta;
  float *dens, *rgb;             // (H, R, P, 1), (H, R, P, 3)
  bf16 *h1, *h2, *c1, *es, *ec;  // (H, R, P, nh) and (H, R, P, E)
};

size_t fwd_smem_bytes(int E) {
  return sizeof(float) * (KT * HMAX + HMAX + 2 * E) + sizeof(bf16) * ((size_t)2 * TP * E + TP * HMAX);
}

// One block: tile p0 / TP of ray r of half h.
__global__ void __launch_bounds__(NT) field_color_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  const int E = a.E, nh = a.nh, P = a.P;
  float* wtile = smem;
  float* dpart = wtile + KT * HMAX;
  float* dsr = dpart + HMAX;
  float* dcr = dsr + E;
  bf16* es = reinterpret_cast<bf16*>(dcr + E);
  bf16* ec = es + TP * E;
  bf16* hb = ec + TP * E;  // h1, then h2
  const int h = blockIdx.y;
  const int r = blockIdx.x / a.n_tiles;
  const int p0 = (blockIdx.x % a.n_tiles) * TP;
  const int tn = min(TP, P - p0);
  const int tid = threadIdx.x;
  const int g = tid >> 5;
  const int lane = tid & 31;
  const int64_t EC = (int64_t)E * nh, CC = (int64_t)nh * nh;
  const float *w1s = a.w1s + h * EC, *w1c = a.w1c + h * EC, *b1 = a.b1 + h * nh, *w2 = a.w2 + h * CC,
              *b2 = a.b2 + h * nh, *wd = a.wd + h * nh, *bd = a.bd + h, *wc1h = a.wc1h + h * CC,
              *wc2 = a.wc2 + h * nh * 3, *bc2 = a.bc2 + h * 3;
  const int64_t ray = (int64_t)h * a.R + r;
  const int64_t pt0 = ray * P + p0;  // the tile's first point, flat

  dir_part(a.dirs + ray * 3, a.fmat, a.n_base, a.ladder, E, a.wc1ds + h * EC, a.wc1dc + h * EC, a.bc1 + h * nh,
           nh, dsr, dcr, dpart);
  embed(a.pts + pt0 * 3, tn, TP, a.fmat, a.n_base, a.ladder, E, es, ec);
  __syncthreads();
  // the tile's embedding rows are contiguous here and in device memory
  for (int i = tid; i < tn * E; i += NT) {
    a.es[pt0 * E + i] = es[i];
    a.ec[pt0 * E + i] = ec[i];
  }
  float acc[8][8];
#pragma unroll
  for (int rr = 0; rr < 8; ++rr)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[rr][c] = 0.f;
  gemm_acc(es, E, E, w1s, nh, wtile, acc);
  gemm_acc(ec, E, E, w1c, nh, wtile, acc);
  // h1, stored as bf16
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    const int t = g * 8 + rr;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = lane + 32 * c;
      const bf16 v = __float2bfloat16_rn(j < nh ? softplus_b(acc[rr][c] + b1[j], a.beta) : 0.f);
      hb[t * HMAX + j] = v;
      if (t < tn && j < nh) a.h1[(pt0 + t) * nh + j] = v;
      acc[rr][c] = 0.f;
    }
  }
  gemm_acc(hb, HMAX, nh, w2, nh, wtile, acc);
  __syncthreads();  // every read of h1 is done before h2 replaces it
  // h2: bf16 to shared and device memory; the density head reads it unrounded, in f32
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    const int t = g * 8 + rr;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = lane + 32 * c;
      float h2 = 0.f;
      if (j < nh) {
        h2 = softplus_b(acc[rr][c] + b2[j], a.beta);
        part += h2 * wd[j];
      }
      const bf16 v = __float2bfloat16_rn(h2);
      hb[t * HMAX + j] = v;
      if (t < tn && j < nh) a.h2[(pt0 + t) * nh + j] = v;
      acc[rr][c] = 0.f;
    }
    part = warp_sum(part);
    if (lane == 0 && t < tn) a.dens[pt0 + t] = 1.f - expf(-softplus_b(part + bd[0], a.beta));
  }
  gemm_acc(hb, HMAX, nh, wc1h, nh, wtile, acc);
  // c1, rounded and stored as bf16
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    const int t = g * 8 + rr;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = lane + 32 * c;
      const float c1 = j < nh ? bf16_round(softplus_b(acc[rr][c] + dpart[j], a.beta)) : 0.f;
      if (t < tn && j < nh) a.c1[(pt0 + t) * nh + j] = __float2bfloat16_rn(c1);
      acc[rr][c] = c1;
    }
  }
  // rgb = sigmoid(c1b . wc2 + bc2), per point over the 32 lanes' units
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    const int t = g * 8 + rr;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = lane + 32 * c;
        if (j < nh) part += acc[rr][c] * wc2[j * 3 + m];
      }
      part = warp_sum(part);
      if (lane == 0 && t < tn) a.rgb[(pt0 + t) * 3 + m] = 1.f / (1.f + expf(-(part + bc2[m])));
    }
  }
}

struct BwdArgs {
  const float* dirs;  // (H, R, 3), unit
  int R, P;
  const float* fmat;  // (3, n_base)
  int n_base, ladder, E, nh;
  const float *wd, *wc2, *w2t, *wc1ht;  // per half: wd, Wc2 (bf16 values), W2^T, Wc1h^T (bf16 values)
  const bf16 *h1, *h2, *c1, *es, *ec;   // K5's residuals
  const float *dens, *rgb, *gdens, *grgb;
  float beta;
  float* work;  // (H, n_blocks, G) per-block slices
  int n_blocks;
  int64_t G;
};

struct BwdSmem {
  float *wtile, *red, *ddpart, *dsr, *dcr, *du, *dc2p, *dc2pb;
  bf16 *es, *ec, *h1, *h2, *c1;
};

size_t bwd_smem_bytes(int E) {
  return sizeof(float) * (KT * HMAX + 8 * HMAX + HMAX + 2 * E + 7 * TP) +
         sizeof(bf16) * ((size_t)2 * TP * E + 3 * TP * HMAX);
}

__device__ BwdSmem bwd_carve(float* base, int E) {
  BwdSmem s;
  s.wtile = base;
  s.red = s.wtile + KT * HMAX;
  s.ddpart = s.red + 8 * HMAX;
  s.dsr = s.ddpart + HMAX;
  s.dcr = s.dsr + E;
  s.du = s.dcr + E;
  s.dc2p = s.du + TP;
  s.dc2pb = s.dc2p + 3 * TP;
  s.es = reinterpret_cast<bf16*>(s.dc2pb + 3 * TP);
  s.ec = s.es + TP * E;
  s.h1 = s.ec + TP * E;
  s.h2 = s.h1 + TP * HMAX;
  s.c1 = s.h2 + TP * HMAX;
  return s;
}

// Block b of half h walks rays b, b + n_blocks, ... tile by tile.
__global__ void __launch_bounds__(NT, 1) field_color_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const BwdSmem s = bwd_carve(smem, a.E);
  const int h = blockIdx.y;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int E = a.E, nh = a.nh, P = a.P;
  const float beta = a.beta;
  const int64_t CC = (int64_t)nh * nh;
  const float *wd = a.wd + h * nh, *wc2 = a.wc2 + h * nh * 3, *w2t = a.w2t + h * CC, *wc1ht = a.wc1ht + h * CC;
  const GradOffsets o(E, nh);
  float* ws = a.work + ((int64_t)h * a.n_blocks + b) * a.G;
  for (int64_t i = tid; i < a.G; i += NT) ws[i] = 0.f;
  float acc[8][8];

  for (int r = b; r < a.R; r += a.n_blocks) {
    const int64_t ray = (int64_t)h * a.R + r;
    embed(a.dirs + ray * 3, 1, 1, a.fmat, a.n_base, a.ladder, E, s.dsr, s.dcr);
    if (tid < nh) s.ddpart[tid] = 0.f;
    for (int p0 = 0; p0 < P; p0 += TP) {
      const int tn = min(TP, P - p0);
      const int64_t pt0 = ray * P + p0;
      // the tile's residuals; rows past tn and units past nh read as 0
      for (int i = tid; i < TP * E; i += NT) {
        const bool in = i < tn * E;
        s.es[i] = in ? a.es[pt0 * E + i] : __float2bfloat16_rn(0.f);
        s.ec[i] = in ? a.ec[pt0 * E + i] : __float2bfloat16_rn(0.f);
      }
      for (int i = tid; i < TP * HMAX; i += NT) {
        const int t = i / HMAX;
        const int j = i % HMAX;
        const bool in = t < tn && j < nh;
        const int64_t q = (pt0 + t) * nh + j;
        s.h1[i] = in ? a.h1[q] : __float2bfloat16_rn(0.f);
        s.h2[i] = in ? a.h2[q] : __float2bfloat16_rn(0.f);
        s.c1[i] = in ? a.c1[q] : __float2bfloat16_rn(0.f);
      }
      // the heads' cotangents pulled back to their pre-activations
      if (tid < TP) {
        float du = 0.f;
        if (tid < tn) {
          const float d = a.dens[pt0 + tid];
          du = a.gdens[pt0 + tid] * (1.f - d) * (1.f - expf(beta * log1pf(-d)));
        }
        s.du[tid] = du;
      }
      if (tid < 3 * TP) {
        const int t = tid / 3;
        float d = 0.f;
        if (t < tn) {
          const float rg = a.rgb[pt0 * 3 + tid];
          d = a.grgb[pt0 * 3 + tid] * rg * (1.f - rg);
        }
        s.dc2p[tid] = d;
        s.dc2pb[tid] = bf16_round(d);
      }
      __syncthreads();
      const TileGrad tg{s.es, s.ec, s.h1, s.h2, s.c1, s.dc2p, s.dc2pb, s.du, s.red, s.wtile, s.ddpart};
      tile_backward(tg, wc2, wd, wc1ht, w2t, E, nh, beta, o, ws, tn, acc);
    }
    // direction-part grads: the ray's summed dc1p, rounded once, against its embedding
    dir_grads(s.dsr, s.dcr, s.ddpart, E, nh, o, ws);
    __syncthreads();
  }
}

}  // namespace

void launch_field_color_fwd(const float* pts, const float* dirs, int n_halves, int n_rays, int n_pts,
                            const float* fmat, int n_base, int ladder, const float* const* weights, int n_hidden,
                            float beta, float* dens, float* rgb, void* h1, void* h2, void* c1, void* es, void* ec,
                            void* stream) {
  if (n_halves <= 0 || n_rays <= 0 || n_pts <= 0) return;
  TORCH_CHECK(n_hidden > 0 && n_hidden <= HMAX, "field-colour forward kernel: n_hidden must be in [1, 256]");
  const int E = n_base * (ladder > 1 ? ladder : 1);
  const size_t smem = fwd_smem_bytes(E);
  TORCH_CHECK(smem <= 232448, "field-colour forward kernel: ", smem, " bytes of shared memory exceed 227 KB");
  const int64_t n_tiles = (n_pts + TP - 1) / TP;
  TORCH_CHECK(n_rays * n_tiles < (int64_t)1 << 31, "field-colour forward kernel: too many tiles per half");
  C10_CUDA_CHECK(cudaFuncSetAttribute(field_color_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem));
  FwdArgs a;
  a.pts = pts;
  a.dirs = dirs;
  a.R = n_rays;
  a.P = n_pts;
  a.n_tiles = (int)n_tiles;
  a.fmat = fmat;
  a.n_base = n_base;
  a.ladder = ladder;
  a.E = E;
  a.nh = n_hidden;
  const float** dst[13] = {&a.w1s, &a.w1c, &a.b1, &a.w2, &a.b2, &a.wd, &a.bd,
                           &a.wc1h, &a.wc1ds, &a.wc1dc, &a.bc1, &a.wc2, &a.bc2};
  for (int i = 0; i < 13; ++i) *dst[i] = weights[i];
  a.beta = beta;
  a.dens = dens;
  a.rgb = rgb;
  a.h1 = static_cast<bf16*>(h1);
  a.h2 = static_cast<bf16*>(h2);
  a.c1 = static_cast<bf16*>(c1);
  a.es = static_cast<bf16*>(es);
  a.ec = static_cast<bf16*>(ec);
  field_color_fwd_kernel<<<dim3((unsigned)(n_rays * n_tiles), n_halves), NT, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void launch_field_color_bwd(const float* dirs, int n_halves, int n_rays, int n_pts, const float* fmat, int n_base,
                            int ladder, const float* wd, const float* wc2, const float* w2t, const float* wc1ht,
                            int n_hidden, float beta, const void* h1, const void* h2, const void* c1, const void* es,
                            const void* ec, const float* dens, const float* rgb, const float* gdens,
                            const float* grgb, float* work, int n_blocks, float* out, void* stream) {
  if (n_halves <= 0 || n_rays <= 0 || n_pts <= 0) return;
  TORCH_CHECK(n_hidden > 0 && n_hidden <= HMAX, "field-colour backward kernel: n_hidden must be in [1, 256]");
  TORCH_CHECK(n_blocks > 0, "field-colour backward kernel: n_blocks must be positive");
  const int E = n_base * (ladder > 1 ? ladder : 1);
  const size_t smem = bwd_smem_bytes(E);
  TORCH_CHECK(smem <= 232448, "field-colour backward kernel: ", smem, " bytes of shared memory exceed 227 KB");
  C10_CUDA_CHECK(cudaFuncSetAttribute(field_color_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem));
  BwdArgs a;
  a.dirs = dirs;
  a.R = n_rays;
  a.P = n_pts;
  a.fmat = fmat;
  a.n_base = n_base;
  a.ladder = ladder;
  a.E = E;
  a.nh = n_hidden;
  a.wd = wd;
  a.wc2 = wc2;
  a.w2t = w2t;
  a.wc1ht = wc1ht;
  a.h1 = static_cast<const bf16*>(h1);
  a.h2 = static_cast<const bf16*>(h2);
  a.c1 = static_cast<const bf16*>(c1);
  a.es = static_cast<const bf16*>(es);
  a.ec = static_cast<const bf16*>(ec);
  a.dens = dens;
  a.rgb = rgb;
  a.gdens = gdens;
  a.grgb = grgb;
  a.beta = beta;
  a.work = work;
  a.n_blocks = n_blocks;
  a.G = GradOffsets(E, n_hidden).total;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  field_color_bwd_kernel<<<dim3(n_blocks, n_halves), NT, smem, st>>>(a);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  sum_slices<<<dim3((unsigned)((a.G + 255) / 256), n_halves), 256, 0, st>>>(work, n_blocks, a.G, out);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}
