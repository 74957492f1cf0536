// Python binding of the kernel launchers: device pointers and the stream
// arrive as integers (tensor.data_ptr(), stream.cuda_stream); the Python
// wrappers own validation and allocation.
#include <pybind11/pybind11.h>

#include "kernels.h"

namespace {

template <typename T>
T* ptr(uintptr_t p) {
  return reinterpret_cast<T*>(p);
}

void density(uintptr_t pts, int64_t n, uintptr_t fmat, int n_base, int ladder, int ep, uintptr_t w1, uintptr_t w2,
             uintptr_t b1, uintptr_t b2, uintptr_t wd, uintptr_t bd, int n_hidden, float beta, int embed_only,
             uintptr_t out, uintptr_t stream) {
  launch_density(ptr<const float>(pts), n, ptr<const float>(fmat), n_base, ladder, ep, ptr<const void>(w1),
                 ptr<const void>(w2), ptr<const float>(b1), ptr<const float>(b2), ptr<const float>(wd),
                 ptr<const float>(bd), n_hidden, beta, embed_only, ptr<float>(out), ptr<void>(stream));
}

void nn_min(uintptr_t query, int64_t n, uintptr_t ref, uintptr_t mask, int64_t m, uintptr_t dist,
            uintptr_t idx, uintptr_t stream) {
  launch_nn_min(ptr<const float>(query), n, ptr<const float>(ref), ptr<const float>(mask), m,
                ptr<float>(dist), ptr<int32_t>(idx), ptr<void>(stream));
}

void corr_argmax(uintptr_t queries, int64_t n, uintptr_t keys, int64_t m, int e, uintptr_t idx,
                 uintptr_t conf, uintptr_t stream) {
  launch_corr_argmax(ptr<const float>(queries), n, ptr<const float>(keys), m, e,
                     ptr<int32_t>(idx), ptr<float>(conf), ptr<void>(stream));
}

void bundle_loss(uintptr_t pts, uintptr_t dirs, uintptr_t tgt, int n_halves, int n_rays, int n_pts,
                 uintptr_t fmat, int n_base, int ladder, int ep, uintptr_t w1, uintptr_t w2, uintptr_t wc1h,
                 uintptr_t wc1ht, uintptr_t w2t, uintptr_t b1, uintptr_t b2, uintptr_t wd, uintptr_t bd,
                 uintptr_t wc1ds, uintptr_t wc1dc, uintptr_t bc1, uintptr_t wc2, uintptr_t bc2, int n_hidden,
                 float beta, float hs, float hs2, float scale, float scale3, uintptr_t vwork, int n_blocks,
                 uintptr_t rec, uintptr_t rrec, uintptr_t part, int n_splits, uintptr_t vec_out, uintptr_t mat_out,
                 uintptr_t w_out, uintptr_t stream) {
  const void* mats[5] = {ptr<const void>(w1), ptr<const void>(w2), ptr<const void>(wc1h), ptr<const void>(wc1ht),
                         ptr<const void>(w2t)};
  const float* vecs[9] = {ptr<const float>(b1),    ptr<const float>(b2),    ptr<const float>(wd),
                          ptr<const float>(bd),    ptr<const float>(wc1ds), ptr<const float>(wc1dc),
                          ptr<const float>(bc1),   ptr<const float>(wc2),   ptr<const float>(bc2)};
  launch_bundle_loss(ptr<const float>(pts), ptr<const float>(dirs), ptr<const float>(tgt), n_halves, n_rays, n_pts,
                     ptr<const float>(fmat), n_base, ladder, ep, mats, vecs, n_hidden, beta, hs, hs2, scale, scale3,
                     ptr<float>(vwork), n_blocks, ptr<void>(rec), ptr<void>(rrec), ptr<float>(part), n_splits,
                     ptr<float>(vec_out), ptr<float>(mat_out), ptr<float>(w_out), ptr<void>(stream));
}

void field_color_fwd(uintptr_t pts, uintptr_t dirs, int n_halves, int n_rays, int n_pts, uintptr_t fmat, int n_base,
                     int ladder, uintptr_t w1s, uintptr_t w1c, uintptr_t b1, uintptr_t w2, uintptr_t b2, uintptr_t wd,
                     uintptr_t bd, uintptr_t wc1h, uintptr_t wc1ds, uintptr_t wc1dc, uintptr_t bc1, uintptr_t wc2,
                     uintptr_t bc2, int n_hidden, float beta, uintptr_t dens, uintptr_t rgb, uintptr_t h1, uintptr_t h2,
                     uintptr_t c1, uintptr_t es, uintptr_t ec, uintptr_t stream) {
  const float* weights[13] = {ptr<const float>(w1s),  ptr<const float>(w1c),   ptr<const float>(b1),
                              ptr<const float>(w2),   ptr<const float>(b2),    ptr<const float>(wd),
                              ptr<const float>(bd),   ptr<const float>(wc1h),  ptr<const float>(wc1ds),
                              ptr<const float>(wc1dc), ptr<const float>(bc1),  ptr<const float>(wc2),
                              ptr<const float>(bc2)};
  launch_field_color_fwd(ptr<const float>(pts), ptr<const float>(dirs), n_halves, n_rays, n_pts,
                         ptr<const float>(fmat), n_base, ladder, weights, n_hidden, beta, ptr<float>(dens),
                         ptr<float>(rgb), ptr<void>(h1), ptr<void>(h2), ptr<void>(c1), ptr<void>(es), ptr<void>(ec),
                         ptr<void>(stream));
}

void field_color_bwd(uintptr_t dirs, int n_halves, int n_rays, int n_pts, uintptr_t fmat, int n_base, int ladder,
                     uintptr_t wd, uintptr_t wc2, uintptr_t w2t, uintptr_t wc1ht, int n_hidden, float beta,
                     uintptr_t h1, uintptr_t h2, uintptr_t c1, uintptr_t es, uintptr_t ec, uintptr_t dens,
                     uintptr_t rgb, uintptr_t gdens, uintptr_t grgb, uintptr_t work, int n_blocks, uintptr_t out,
                     uintptr_t stream) {
  launch_field_color_bwd(ptr<const float>(dirs), n_halves, n_rays, n_pts, ptr<const float>(fmat), n_base, ladder,
                         ptr<const float>(wd), ptr<const float>(wc2), ptr<const float>(w2t), ptr<const float>(wc1ht),
                         n_hidden, beta, ptr<const void>(h1), ptr<const void>(h2), ptr<const void>(c1),
                         ptr<const void>(es), ptr<const void>(ec), ptr<const float>(dens), ptr<const float>(rgb),
                         ptr<const float>(gdens), ptr<const float>(grgb), ptr<float>(work), n_blocks, ptr<float>(out),
                         ptr<void>(stream));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  mod.def("density", &density);
  mod.def("nn_min", &nn_min);
  mod.def("corr_argmax", &corr_argmax);
  mod.def("bundle_loss", &bundle_loss);
  mod.def("bundle_loss_rec_width", &bundle_loss_rec_width);
  mod.def("bundle_loss_ray_rec_width", &bundle_loss_ray_rec_width);
  mod.def("bundle_loss_vec_width", &bundle_loss_vec_width);
  mod.def("bundle_loss_dw_tiles", &bundle_loss_dw_tiles);
  mod.def("field_color_fwd", &field_color_fwd);
  mod.def("field_color_bwd", &field_color_bwd);
}
