// K1: the NeRF density field, forward only.
//
// Replaces the Pallas TPU kernel _dens_kernel (imagesequenceregistration-
// for6dposeestimationlabeling_tpu/ops/field_kernel.py:304, pallas_call at
// :346, via _make_dens_op / field_density).  Per point:
//   angles = x0*F[0,:] + x1*F[1,:] + x2*F[2,:]      exact f32 products
//   (s, c) = sincos(angles), then ladder-1 double-angle rungs (grouped)
//   h1 = softplus_b(bf16(s) W1s + bf16(c) W1c + b1)  f32 accumulation
//   h2 = softplus_b(bf16(h1) W2 + b2)                f32 accumulation
//   out = 1 - exp(-softplus_b(h2 . wd + bd))         h2 not rounded, f32
// The wrapper hands the product weights over as bf16 (the values the TPU
// kernel rounds them to), zero-padded: W1 = [W1s; W1c] with each half's
// E rows padded to Ep (a multiple of 16), 256 columns; W2 256 x 256.
//
// What bounds it on the card: ~315 kFLOP of bf16 products a point at the
// reference width (H = 60 harmonics, 256 hidden), 0.66 TFLOP for a 128^3
// grid, 0.67 ms at the 989 TFLOP/s of the tensor cores; its bytes (16 a
// point in and out, the weights from L2) are far below that.  Beside the
// products: 360 full-range sincosf a point (frequencies up to omega0 2^59,
// so most take the slow range reduction) and 512 softplus.  Design: a
// block owns 64 points, the M of its tile; the two products run on the
// tensor cores (mma.sync m16n8k16, bf16 -> f32, field_mma.cuh), the
// embedding's K = 2 x 180 zero-padded to 2 x 192.  The bf16 weights (W1
// 184 KB + W2 128 KB) do not fit a block's 227 KB beside the tile, so they
// stream from L2 in 32-row slabs through a double-buffered cp.async ring
// that runs on across both products; at ~85 KB a block two blocks share
// an SM, so one block's sin/cos overlaps the other's products.  Build
// without --use_fast_math: sincosf keeps its full range reduction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include <algorithm>

#include "field_common.cuh"
#include "field_mma.cuh"
#include "kernels.h"

namespace {

using mma::bf16;
using mma::LDW;
using mma::MT;
using T = mma::Tile<256>;  // two blocks of 8 warps an SM

__global__ void __launch_bounds__(256, 2)
density_kernel(const float* __restrict__ pts, int64_t n, const float* __restrict__ fmat, int n_base, int ladder,
               int Ep, const bf16* __restrict__ w1, const bf16* __restrict__ w2, const float* __restrict__ b1,
               const float* __restrict__ b2, const float* __restrict__ wd, const float* __restrict__ bd, int nh,
               float beta, int embed_only, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int E = n_base * max(ladder, 1);  // width of each of the sin / cos blocks
  const int lda = 2 * Ep + 8;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* A = ring + 2 * mma::SLAB;  // (MT, 2 Ep): es | ec
  bf16* H = A;                     // (MT, 256) h1, over the embedding once the first product is done
  float* red = reinterpret_cast<float*>(A + MT * max(lda, LDW));
  const int tid = threadIdx.x;
  const int64_t p0 = (int64_t)blockIdx.x * MT;
  const int tn = n - p0 < MT ? (int)(n - p0) : MT;

  int slot = 0;
  if (!embed_only) T::issue_slab(w1, ring);
  field::embed(pts + p0 * 3, tn, MT, fmat, n_base, ladder, lda, A, A + Ep);
  for (int i = tid; i < MT * (Ep - E); i += 256) {  // the K padding reads as zeros
    const int p = i / (Ep - E), c = E + i % (Ep - E);
    A[p * lda + c] = __float2bfloat16_rn(0.f);
    A[p * lda + Ep + c] = __float2bfloat16_rn(0.f);
  }
  if (embed_only) {  // the embedding alone, for timing it: keep one value a point
    __syncthreads();
    if (tid < tn) out[p0 + tid] = __bfloat162float(A[tid * lda]) + __bfloat162float(A[tid * lda + Ep + E - 1]);
    return;
  }

  T::Acc acc;
  T::zero(acc);
  T::stream_mma(A, lda, w1, 2 * Ep, w2, ring, slot, acc);
  // h1 = bf16(softplus(. + b1)), units past nh exactly 0
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::JN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = T::col(j, e);
        acc[i][j][e] = c < nh ? field::softplus_b(acc[i][j][e] + b1[c], beta) : 0.f;
      }
  T::store_tile(acc, H);
  T::zero(acc);
  T::stream_mma(H, LDW, w2, mma::WN, nullptr, ring, slot, acc);
  // density head in f32 on the unrounded h2: per point, sum over units
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::JN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = T::col(j, e);
        acc[i][j][e] = c < nh ? field::softplus_b(acc[i][j][e] + b2[c], beta) * wd[c] : 0.f;
      }
  const float part = T::row_sum(acc, red);
  if (tid < tn) out[p0 + tid] = 1.f - expf(-field::softplus_b(part + bd[0], beta));
}

}  // namespace

void launch_density(const float* pts, int64_t n, const float* fmat, int n_base, int ladder, int ep, const void* w1,
                    const void* w2, const float* b1, const float* b2, const float* wd, const float* bd, int n_hidden,
                    float beta, int embed_only, float* out, void* stream) {
  if (n <= 0) return;
  TORCH_CHECK(n_hidden > 0 && n_hidden <= mma::WN, "density kernel: n_hidden must be in [1, 256]");
  const int E = n_base * (ladder > 1 ? ladder : 1);
  TORCH_CHECK(ep >= E && ep % 16 == 0, "density kernel: the padded embedding width must be a multiple of 16 >= ", E);
  const size_t smem =
      sizeof(bf16) * (2 * (size_t)mma::SLAB + (size_t)MT * std::max(2 * ep + 8, LDW)) + sizeof(float) * 4 * MT;
  TORCH_CHECK(smem <= 232448, "density kernel: ", smem, " bytes of shared memory exceed 227 KB");
  C10_CUDA_CHECK(cudaFuncSetAttribute(density_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  const int64_t blocks = (n + MT - 1) / MT;
  density_kernel<<<(unsigned)blocks, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      pts, n, fmat, n_base, ladder, ep, static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), b1, b2, wd, bd,
      n_hidden, beta, embed_only, out);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}
