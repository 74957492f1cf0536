"""The operation / byte counts and peaks against hand-worked values at small
shapes, and the benchmark's weights against the program's modules."""

import pytest
import torch

from portbench.harness import counts, weights


def test_k4_counts():
    assert counts.k4_flops(6, 4) == {"fwd": 160, "bwd": 224, "ray": 96}
    assert counts.k4_weight_bytes(6, 4) == 640
    # 2 halves x 3 rays x 5 points: 30 points at 16 bytes (with weights),
    # 6 rays at 44, weights read and grads written 2 x 2 x 640
    assert counts.k4_pass(2, 3, 5, 6, 4, True) == (3304, 12672)
    assert counts.k4_pass(2, 3, 5, 6, 4, False) == (3304 - 120, 12672)


def test_nerf_step_flops():
    fc = {"n_harmonic_functions": 1, "n_hidden": 2}
    tr = {"halves": 1, "cams_per_step": 1, "rays_per_image": 2, "n_pts_coarse": 2, "n_pts_fine": 3,
          "add_input_samples": True}
    # per point forward 56, input grads 32; per ray 24; 14 points, 4 ray passes
    assert counts.field_step_flops(fc, tr) == 14 * (2 * 56 + 32) + 4 * 2 * 24


def test_k3_bound():
    # 10 queries x 20 keys x 2: 320 bytes, 800 FLOPs, 200 exponentials
    assert counts.k3_least_s(10, 20, 2) == pytest.approx(320 / 3.35e12)
    # 10^9 pairs: e = 2 is bound by the exponentials, e = 12 by the FFMAs
    assert counts.k3_least_s(1000, 10**6, 2) == pytest.approx(1e9 / (132 * 16 * 1.98e9))
    assert counts.k3_least_s(1000, 10**6, 12) == pytest.approx(2.4e10 / 67e12)


def test_unet_flops():
    uc = {"stage_sizes": [1, 1], "widths": [4, 8], "decoder_width": 2, "n_class": 3}
    fwd = counts.unet_conv_flops(uc, 1, 8)
    assert fwd == [301056, 18432, 1152, 2048, 576, 1152, 64, 3456, 78336, 9216, 768]
    assert counts.unet_flops(uc, 1, 8) == 3 * 416256 - 301056


def test_pose_and_serve_flops():
    cfg = {"unet": {"stage_sizes": [1, 1], "widths": [4, 8], "decoder_width": 2, "n_class": 3},
           "field": {"n_hidden": 2, "feature_dim": 3, "n_harmonic_functions": 1, "siren": True}}
    tr = {"batch_size": 1, "sample_size": 2, "image_size": 8}
    head = 4 * (2 * 2 * (3 * 2 + 2 * 4 + 2 * 3) + 2 * (2 * 4 + 2 * 3))
    assert counts.pose_step_flops(cfg, tr) == 947712 + head + 3 * 2 * 1 * 2 * 2 * 3
    st = {"batch": 1, "image_size": 8, "down_sample": 3, "n_keys": 5}
    assert counts.serve_queries(st) == 9
    assert counts.serve_request_flops(cfg, st) == 416256 + 2 * 9 * 5 * 3


@pytest.mark.parametrize("siren", [True, False])
def test_field_weights_load_into_the_program(siren):
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.config import FieldConfig
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.fields import NerfField

    fc = {"n_harmonic_functions": 4, "n_hidden": 8, "feature_dim": 3, "siren": siren, "density_bias": -1.5}
    p = weights.field_params(torch.Generator().manual_seed(0), fc)
    f = NerfField(FieldConfig(n_harmonic_functions=4, n_hidden=8, feature_dim=3, siren=siren))
    assert {k: tuple(v.shape) for k, v in f.state_dict().items()} == {k: tuple(v.shape) for k, v in p.items()}
    f.load_state_dict(p)


def test_unet_weights_load_into_the_program():
    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.models.unet import ResNetUNet

    uc = {"stage_sizes": [1, 2], "widths": [8, 16], "decoder_width": 8, "n_class": 5}
    net = ResNetUNet(5, (1, 2), (8, 16), 8)
    p = weights.unet_params(torch.Generator().manual_seed(0), uc)
    assert list(net.state_dict()) == list(p)
    net.load_state_dict(p)
