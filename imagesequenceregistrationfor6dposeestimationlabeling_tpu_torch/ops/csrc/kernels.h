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
// b1, b2, wd (n_hidden,), bd (1,) f32.
void launch_density(const float* pts, int64_t n, const float* fmat, int n_base, int ladder, int ep, const void* w1,
                    const void* w2, const float* b1, const float* b2, const float* wd, const float* bd, int n_hidden,
                    float beta, float* out, void* stream);

// K2: nearest neighbour (nn_min.cu).  For query (N, 3): dist (N,) and the
// lowest index (N,) of the closest ref (M, 3) point with mask > 0 (mask
// may be null: every point counts).  The references go in n_splits
// consecutive splits of split_len points, one block row each; with more
// than one, work holds the partials (n_splits * N * 8 bytes) and a merge
// pass combines them.
void launch_nn_min(const float* query, int64_t n, const float* ref, const float* mask, int64_t m, int n_splits,
                   int64_t split_len, void* work, float* dist, int32_t* idx, void* stream);
// blocks of the K2 kernel one SM of the current device holds at once
int nn_min_blocks_per_sm();

// K3: dense correspondence (corr_argmax.cu).  For queries (N, E): argmax
// over keys (M, E) of q . k and max_logit - logsumexp.  Keys split as K2's
// references (work: n_splits * N * 16 bytes).
void launch_corr_argmax(const float* queries, int64_t n, const float* keys, int64_t m, int e, int n_splits,
                        int64_t split_len, void* work, int32_t* idx, float* conf, void* stream);
int corr_argmax_blocks_per_sm();
// queries one block of K2 or K3 covers (the split planner's query tile)
int point_queries_per_block();

// The NeRF field kernels' workspace (field_tc.cuh): the bf16 record widths
// a point and a ray for an embedding padded to ep, the f32 vector-grad
// slice width, and the weight-grad contraction's tiles.
int64_t field_rec_width(int ep);
int64_t field_ray_rec_width(int ep);
int64_t field_vec_width(int n_hidden);
int field_dw_tiles(int e, int n_hidden);

// K4: NeRF bundle loss and backward for n_halves fields (bundle_loss.cu).
// pts (H, R, P, 3), unit dirs (H, R, 3), tgt (H, R, 8).  mats[5] are bf16,
// zero-padded to 256 columns, with a leading half axis: w1 = [W1s; W1c]
// (2 ep rows), w2, wc1h, wc1h^T, w2^T (256 rows).  vecs[9] are f32 with a
// leading half axis: b1, b2, wd, bd, wc1ds, wc1dc, bc1, wc2, bc2.  Scratch:
// vwork (H, n_blocks, vec width), rec (H, R, P, rec width) and rrec (H, R,
// ray rec width) bf16, part (H, n_splits, G), G = 4 E nh + 2 nh^2; act
// (H, R, P, 3 x 256) f32: null for bf16 activations, else the act32
// variant's (bundle_loss_act32_kernel) record of the f32 activations.  Out:
// vec_out (H, vec width) = b1 b2 wd bd bc1 wc2 bc2 ce_sum se_sum, mat_out
// (H, G) = w1s w1c w2 wc1h wc1ds wc1dc, flat; w_out (H, R, P) may be null.
void launch_bundle_loss(const float* pts, const float* dirs, const float* tgt, int n_halves, int n_rays, int n_pts,
                        const float* fmat, int n_base, int ladder, int ep, const void* const* mats,
                        const float* const* vecs, int n_hidden, float beta, float hs, float hs2, float scale,
                        float scale3, float* vwork, int n_blocks, void* rec, void* rrec, float* act, float* part,
                        int n_splits, float* vec_out, float* mat_out, float* w_out, void* stream);

// K5: NeRF field colour forward for n_halves fields, residuals stored
// (field_color.cu).  pts (H, R, P, 3), unit dirs (H, R, 3); mats and vecs
// as for K4 (K5 reads w1, w2, wc1h and every vec).  Writes dens (H, R, P,
// 1) and rgb (H, R, P, 3) in f32, and each point's es | ec | h1 | h2 | c1
// into rec (H, R, P, rec width); act as K4's (non-null: the act32 variant,
// which also writes each point's f32 h1 | h2 | c1 there).  n_blocks blocks
// per half walk the rays.
void launch_field_color_fwd(const float* pts, const float* dirs, int n_halves, int n_rays, int n_pts,
                            const float* fmat, int n_base, int ladder, int ep, const void* const* mats,
                            const float* const* vecs, int n_hidden, float beta, void* rec, float* act, float* dens,
                            float* rgb, int n_blocks, void* stream);

// K6: its backward (field_color.cu).  From K5's records (act: null, or
// the act32 variant's f32 record) and outputs and the cotangents gdens (H,
// R, P, 1), grgb (H, R, P, 3): K6 reads mats wc1ht, w2t and vecs wd, wc2;
// fills the record's cotangent slots and rrec; out vec_out and mat_out as
// K4's (ce_sum, se_sum zero).  Scratch as K4's.
void launch_field_color_bwd(const float* dirs, int n_halves, int n_rays, int n_pts, const float* fmat, int n_base,
                            int ladder, int ep, const void* const* mats, const float* const* vecs, int n_hidden,
                            float beta, void* rec, const float* act, const float* dens, const float* rgb,
                            const float* gdens, const float* grgb, float* vwork, int n_blocks, void* rrec, float* part,
                            int n_splits, float* vec_out, float* mat_out, void* stream);
