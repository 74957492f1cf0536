// The weight-grad contractions of K4 (bundle_loss.cu) and K6
// (field_color.cu): dw_kernel, one kernel for both, built once here.
//
// Six products per half, out = A^T B summed over the records' rows: A's
// columns [a_col, a_col + M) are the grad's rows, B's 256 columns its
// columns (units past nh dropped).  Over the points: dW1s = es^T dh1, dW1c =
// ec^T dh1, dW2 = h1^T dh2, dWc1h = h2^T dc1; over the rays: dWc1ds = ds^T
// ddp, dWc1dc = dc^T ddp.  Their flat order in a slice: w1s w1c w2 wc1h
// wc1ds wc1dc (4 E nh + 2 nh^2 floats).
//
// What bounds it: the products, 4 E nh + 4 nh^2 bf16 FLOP a point (0.45
// MFLOP at the reference width) on mma.sync, against the 3.8 KB record of
// a point, of which each grad tile reads its 64 + 256 columns.  Output-stationary:
// a block owns a 64 x 256 tile of one grad and one of S fixed, contiguous
// slices of the rows, streams both operands through a double-buffered
// cp.async ring and writes its partial sums to its own slice; sum_slices
// adds the slices in a fixed order (no float atomics: bit-identical
// relaunches).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include "field_common.cuh"
#include "field_mma.cuh"
#include "field_tc.cuh"

namespace field_tc {
namespace {

using TD = mma::Tile<256>;       // two blocks of 8 warps an SM
constexpr int KD = 64;           // record rows a slab
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

void launch_weight_grads(const bf16* rec, const bf16* rrec, int n_halves, int R, int P, int E, int Ep, int nh,
                         float* part, int n_splits, float* mat_out, cudaStream_t stream) {
  DwArgs d;
  d.rec = rec;
  d.rrec = rrec;
  d.R = R;
  d.P = P;
  d.E = E;
  d.Ep = Ep;
  d.nh = nh;
  d.n_splits = n_splits;
  d.part = part;
  d.G = 4 * (int64_t)E * nh + 2 * (int64_t)nh * nh;
  const size_t dsmem = sizeof(bf16) * 2 * KD * (LDA_T + LDW);
  C10_CUDA_CHECK(cudaFuncSetAttribute(dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dsmem));
  dw_kernel<<<dim3((unsigned)(dw_tiles(E, nh) * n_splits), n_halves), 256, dsmem, stream>>>(d);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  field::sum_slices<<<dim3((unsigned)((d.G + 255) / 256), n_halves), 256, 0, stream>>>(part, n_splits, d.G, mat_out);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace field_tc
