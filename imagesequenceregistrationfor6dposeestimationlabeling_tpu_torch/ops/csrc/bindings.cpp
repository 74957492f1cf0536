// Python binding of the kernel launchers: device pointers and the stream
// arrive as integers (tensor.data_ptr(), stream.cuda_stream); the Python
// wrappers own validation and allocation.
#include <pybind11/pybind11.h>

#include <initializer_list>

#include "kernels.h"

namespace {

template <typename T>
T* ptr(uintptr_t p) {
  return reinterpret_cast<T*>(p);
}

void density(uintptr_t pts, int64_t n, uintptr_t fmat, int n_base, int ladder, int ep, uintptr_t w1, uintptr_t w2,
             uintptr_t b1, uintptr_t b2, uintptr_t wd, uintptr_t bd, int n_hidden, float beta, uintptr_t out,
             uintptr_t stream) {
  launch_density(ptr<const float>(pts), n, ptr<const float>(fmat), n_base, ladder, ep, ptr<const void>(w1),
                 ptr<const void>(w2), ptr<const float>(b1), ptr<const float>(b2), ptr<const float>(wd),
                 ptr<const float>(bd), n_hidden, beta, ptr<float>(out), ptr<void>(stream));
}

void nn_min(uintptr_t query, int64_t n, uintptr_t ref, uintptr_t mask, int64_t m, int n_splits, int64_t split_len,
            uintptr_t work, uintptr_t dist, uintptr_t idx, uintptr_t stream) {
  launch_nn_min(ptr<const float>(query), n, ptr<const float>(ref), ptr<const float>(mask), m, n_splits, split_len,
                ptr<void>(work), ptr<float>(dist), ptr<int32_t>(idx), ptr<void>(stream));
}

void corr_argmax(uintptr_t queries, int64_t n, uintptr_t keys, int64_t m, int e, int n_splits, int64_t split_len,
                 uintptr_t work, uintptr_t idx, uintptr_t conf, uintptr_t stream) {
  launch_corr_argmax(ptr<const float>(queries), n, ptr<const float>(keys), m, e, n_splits, split_len, ptr<void>(work),
                     ptr<int32_t>(idx), ptr<float>(conf), ptr<void>(stream));
}

// the field kernels' weights: mats[5] = w1 w2 wc1h wc1ht w2t (bf16), vecs[9]
// = b1 b2 wd bd wc1ds wc1dc bc1 wc2 bc2 (f32); 0 where a kernel reads none
struct FieldWeights {
  const void* mats[5];
  const float* vecs[9];
  FieldWeights(std::initializer_list<uintptr_t> m, std::initializer_list<uintptr_t> v) {
    int i = 0;
    for (uintptr_t p : m) mats[i++] = ptr<const void>(p);
    i = 0;
    for (uintptr_t p : v) vecs[i++] = ptr<const float>(p);
  }
};

void bundle_loss(uintptr_t pts, uintptr_t dirs, uintptr_t tgt, int n_halves, int n_rays, int n_pts,
                 uintptr_t fmat, int n_base, int ladder, int ep, uintptr_t w1, uintptr_t w2, uintptr_t wc1h,
                 uintptr_t wc1ht, uintptr_t w2t, uintptr_t b1, uintptr_t b2, uintptr_t wd, uintptr_t bd,
                 uintptr_t wc1ds, uintptr_t wc1dc, uintptr_t bc1, uintptr_t wc2, uintptr_t bc2, int n_hidden,
                 float beta, float hs, float hs2, float scale, float scale3, uintptr_t vwork, int n_blocks,
                 uintptr_t rec, uintptr_t rrec, uintptr_t act, uintptr_t part, int n_splits, uintptr_t vec_out,
                 uintptr_t mat_out, uintptr_t w_out, uintptr_t stream) {
  const FieldWeights w({w1, w2, wc1h, wc1ht, w2t}, {b1, b2, wd, bd, wc1ds, wc1dc, bc1, wc2, bc2});
  launch_bundle_loss(ptr<const float>(pts), ptr<const float>(dirs), ptr<const float>(tgt), n_halves, n_rays, n_pts,
                     ptr<const float>(fmat), n_base, ladder, ep, w.mats, w.vecs, n_hidden, beta, hs, hs2, scale,
                     scale3, ptr<float>(vwork), n_blocks, ptr<void>(rec), ptr<void>(rrec), ptr<float>(act),
                     ptr<float>(part), n_splits, ptr<float>(vec_out), ptr<float>(mat_out), ptr<float>(w_out),
                     ptr<void>(stream));
}

void field_color_fwd(uintptr_t pts, uintptr_t dirs, int n_halves, int n_rays, int n_pts, uintptr_t fmat, int n_base,
                     int ladder, int ep, uintptr_t w1, uintptr_t w2, uintptr_t wc1h, uintptr_t b1, uintptr_t b2,
                     uintptr_t wd, uintptr_t bd, uintptr_t wc1ds, uintptr_t wc1dc, uintptr_t bc1, uintptr_t wc2,
                     uintptr_t bc2, int n_hidden, float beta, uintptr_t rec, uintptr_t act, uintptr_t dens,
                     uintptr_t rgb, int n_blocks, uintptr_t stream) {
  const FieldWeights w({w1, w2, wc1h, 0, 0}, {b1, b2, wd, bd, wc1ds, wc1dc, bc1, wc2, bc2});
  launch_field_color_fwd(ptr<const float>(pts), ptr<const float>(dirs), n_halves, n_rays, n_pts,
                         ptr<const float>(fmat), n_base, ladder, ep, w.mats, w.vecs, n_hidden, beta, ptr<void>(rec),
                         ptr<float>(act), ptr<float>(dens), ptr<float>(rgb), n_blocks, ptr<void>(stream));
}

void field_color_bwd(uintptr_t dirs, int n_halves, int n_rays, int n_pts, uintptr_t fmat, int n_base, int ladder,
                     int ep, uintptr_t wc1ht, uintptr_t w2t, uintptr_t wd, uintptr_t wc2, int n_hidden, float beta,
                     uintptr_t rec, uintptr_t act, uintptr_t dens, uintptr_t rgb, uintptr_t gdens, uintptr_t grgb,
                     uintptr_t vwork, int n_blocks, uintptr_t rrec, uintptr_t part, int n_splits, uintptr_t vec_out,
                     uintptr_t mat_out, uintptr_t stream) {
  const FieldWeights w({0, 0, 0, wc1ht, w2t}, {0, 0, wd, 0, 0, 0, 0, wc2, 0});
  launch_field_color_bwd(ptr<const float>(dirs), n_halves, n_rays, n_pts, ptr<const float>(fmat), n_base, ladder, ep,
                         w.mats, w.vecs, n_hidden, beta, ptr<void>(rec), ptr<const float>(act), ptr<const float>(dens),
                         ptr<const float>(rgb), ptr<const float>(gdens), ptr<const float>(grgb), ptr<float>(vwork),
                         n_blocks, ptr<void>(rrec), ptr<float>(part), n_splits, ptr<float>(vec_out),
                         ptr<float>(mat_out), ptr<void>(stream));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  mod.def("density", &density);
  mod.def("nn_min", &nn_min);
  mod.def("nn_min_blocks_per_sm", &nn_min_blocks_per_sm);
  mod.def("corr_argmax", &corr_argmax);
  mod.def("corr_argmax_blocks_per_sm", &corr_argmax_blocks_per_sm);
  mod.def("point_queries_per_block", &point_queries_per_block);
  mod.def("bundle_loss", &bundle_loss);
  mod.def("field_rec_width", &field_rec_width);
  mod.def("field_ray_rec_width", &field_ray_rec_width);
  mod.def("field_vec_width", &field_vec_width);
  mod.def("field_dw_tiles", &field_dw_tiles);
  mod.def("field_color_fwd", &field_color_fwd);
  mod.def("field_color_bwd", &field_color_bwd);
}
