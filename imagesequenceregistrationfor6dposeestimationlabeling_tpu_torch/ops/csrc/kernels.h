// Host launchers of the package's CUDA kernels, shared by the .cu files
// and the binding.  Plain C++ types only: pointers to device memory, sizes,
// and the CUDA stream as an opaque pointer, so the binding compiles without
// CUDA's or PyTorch's headers.  Every launcher checks the launch and throws
// (c10::Error) on failure.
#pragma once

#include <cstdint>

// K1: density field (density.cu).  out[n] = 1 - exp(-softplus(h2 . wd + bd))
// for points pts[n] (N, 3).  w1 (2 ep, 256) = [W1s; W1c] and w2 (256, 256)
// are bf16, zero-padded (each embedding half to ep rows, a multiple of 16);
// b1, b2, wd (n_hidden,), bd (1,) f32.  embed_only: the embedding alone,
// for timing it (out then holds one embedding value a point).
void launch_density(const float* pts, int64_t n, const float* fmat, int n_base, int ladder, int ep, const void* w1,
                    const void* w2, const float* b1, const float* b2, const float* wd, const float* bd, int n_hidden,
                    float beta, int embed_only, float* out, void* stream);

// K2: nearest neighbour (nn_min.cu).  For query (N, 3): dist (N,) and the
// lowest index (N,) of the closest ref (M, 3) point with mask > 0.
void launch_nn_min(const float* query, int64_t n, const float* ref, const float* mask, int64_t m,
                   float* dist, int32_t* idx, void* stream);

// K3: dense correspondence (corr_argmax.cu).  For queries (N, E): argmax
// over keys (M, E) of q . k and max_logit - logsumexp.
void launch_corr_argmax(const float* queries, int64_t n, const float* keys, int64_t m, int e,
                        int32_t* idx, float* conf, void* stream);

// K4: NeRF bundle loss and backward for n_halves fields (bundle_loss.cu).
// pts (H, R, P, 3), unit dirs (H, R, 3), tgt (H, R, 8).  mats[5] are bf16,
// zero-padded to 256 columns, with a leading half axis: w1 = [W1s; W1c]
// (2 ep rows), w2, wc1h, wc1h^T, w2^T (256 rows).  vecs[9] are f32 with a
// leading half axis: b1, b2, wd, bd, wc1ds, wc1dc, bc1, wc2, bc2.  Scratch:
// vwork (H, n_blocks, vec width), rec (H, R, P, rec width) and rrec (H, R,
// ray rec width) bf16, part (H, n_splits, G), G = 4 E nh + 2 nh^2.  Out:
// vec_out (H, vec width) = b1 b2 wd bd bc1 wc2 bc2 ce_sum se_sum, mat_out
// (H, G) = w1s w1c w2 wc1h wc1ds wc1dc, flat; w_out (H, R, P) may be null.
int64_t bundle_loss_rec_width(int ep);
int64_t bundle_loss_ray_rec_width(int ep);
int64_t bundle_loss_vec_width(int n_hidden);
int bundle_loss_dw_tiles(int e, int n_hidden);
void launch_bundle_loss(const float* pts, const float* dirs, const float* tgt, int n_halves, int n_rays, int n_pts,
                        const float* fmat, int n_base, int ladder, int ep, const void* const* mats,
                        const float* const* vecs, int n_hidden, float beta, float hs, float hs2, float scale,
                        float scale3, float* vwork, int n_blocks, void* rec, void* rrec, float* part, int n_splits,
                        float* vec_out, float* mat_out, float* w_out, void* stream);

// K5: NeRF field colour forward for n_halves fields, residuals stored
// (field_color.cu).  pts (H, R, P, 3), unit dirs (H, R, 3); weights[13] as
// for K4.  Writes dens (H, R, P, 1) and rgb (H, R, P, 3) in f32, and the
// bf16 residuals h1, h2, c1 (H, R, P, n_hidden) and es, ec (H, R, P, E).
void launch_field_color_fwd(const float* pts, const float* dirs, int n_halves, int n_rays, int n_pts,
                            const float* fmat, int n_base, int ladder, const float* const* weights, int n_hidden,
                            float beta, float* dens, float* rgb, void* h1, void* h2, void* c1, void* es, void* ec,
                            void* stream);

// K6: its backward (field_color.cu).  From K5's residuals and outputs and
// the cotangents gdens (H, R, P, 1), grgb (H, R, P, 3): the 13 grads, flat
// per half in K4's order, into out (H, G).  wd, wc2, w2t (W2^T) and wc1ht
// (Wc1h^T) carry the leading half axis; work is (H, n_blocks, G) scratch.
void launch_field_color_bwd(const float* dirs, int n_halves, int n_rays, int n_pts, const float* fmat, int n_base,
                            int ladder, const float* wd, const float* wc2, const float* w2t, const float* wc1ht,
                            int n_hidden, float beta, const void* h1, const void* h2, const void* c1, const void* es,
                            const void* ec, const float* dens, const float* rgb, const float* gdens,
                            const float* grgb, float* work, int n_blocks, float* out, void* stream);
