"""The yardstick's frozen copies and arithmetic: the scene generator against the port's, the model
FLOP functions against a count of the reference's modules at a tiny width, K1's and K2's bytes and
operations by hand, and the trace arithmetic."""

import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import roofline, traceio
from harness.scene import make_scene
from reference.nrref.field_components.mlp import MLP
from reference.nrref.model_components.cnns import RGBDecoder
from reference.nrref.model_components.radar_decoder import RadarDecoder
from reference.nrref.model_components.vgg import Vgg19Features
from reference.nrref.models.neuradar import NeuRadarModelConfig
from tiny import tiny_config


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _tiny_model_config():
    cfg = NeuRadarModelConfig()
    cfg.field.geo_hidden_dim, cfg.field.nff_hidden_dim, cfg.field.nff_out_dim = 8, 8, 8
    cfg.appearance_dim, cfg.rgb_hidden_dim = 4, 8
    cfg.sampling.proposal_field_1.hidden_dim = cfg.sampling.proposal_field_2.hidden_dim = 4
    return cfg


def test_field_flops_match_a_count_of_the_mlps():
    cfg = _tiny_model_config()
    f, s = cfg.field, cfg.sampling
    grid = f.grid.static.num_levels * f.grid.static.hashgrid_dim
    geo = MLP(grid, f.nff_out_dim + 1, f.geo_num_layers, f.geo_hidden_dim)
    feat = MLP(f.nff_out_dim + 16, f.nff_out_dim, f.nff_num_layers, f.nff_hidden_dim)
    props = [MLP(p.grid.static.num_levels * p.grid.static.hashgrid_dim, 1, 2, p.hidden_dim)
             for p in (s.proposal_field_1, s.proposal_field_2)]
    n_main = s.num_nerf_samples + 1
    counted = _count(lambda: geo(torch.zeros(n_main, grid))) + _count(lambda: feat(torch.zeros(n_main, f.nff_out_dim + 16)))
    for mlp, n in zip(props, s.num_proposal_samples):
        counted += _count(lambda: mlp(torch.zeros(n, mlp.hidden_0.in_features)))
    assert roofline.field_flops_per_ray(cfg) == counted


def test_radar_and_lidar_flops_match_a_count():
    cfg = _tiny_model_config()
    d = cfg.field.nff_out_dim + cfg.appearance_dim
    dec = RadarDecoder(d_model=d, dropout=0.0)
    S = 24
    counted = _count(lambda: dec(torch.randn(1, S, d), torch.randn(1, S, 3)))
    assert roofline.radar_flops_per_scan(cfg, S) == counted
    lidar = MLP(d, 2, num_layers=3, layer_width=32)
    assert roofline.lidar_flops_per_ray(cfg) == _count(lambda: lidar(torch.zeros(1, d)))


def test_cnn_and_vgg_flops_match_a_count():
    cfg = _tiny_model_config()
    d = cfg.field.nff_out_dim + cfg.appearance_dim
    cnn = RGBDecoder(d, cfg.rgb_hidden_dim, cfg.rgb_upsample_factor).eval()
    assert roofline.cnn_flops(cfg, 5, 7, 2) == _count(lambda: cnn(torch.zeros(2, 5, 7, d)))
    vgg = Vgg19Features()
    assert roofline.vgg_flops(32, 48, 2) == _count(lambda: vgg(torch.zeros(2, 32, 48, 3)))


def test_kernel_bytes_and_ops_by_hand():
    R, S, C = 10, 3, 4
    assert roofline.k1_fwd(R, S, C)[0] == 4 * (30 + 120 + 30 + 40 + 10)
    assert roofline.k1_bwd(R, S, C)[0] == 4 * (30 + 120 + 30 + 40 + 10 + 30 + 120)
    nbytes, ops = roofline.k2_fwd(1, 4400, 48)
    assert nbytes == 2 * 4 * 4400 * 48 and ops == 4 * 4400**2 * 48
    # the kernel table's bound of a VoD scan's K2 forward: 0.0038 ms by its bf16 operations
    assert roofline.bound_s(nbytes, ops, roofline.BF16_FLOPS) * 1e3 == pytest.approx(0.00376, abs=1e-5)


def test_train_step_flops_add_up():
    from reference.nrref.models.neuradar import SegmentLayout

    cfg = _tiny_model_config()
    layout = SegmentLayout(num_cam=2 * 16, num_lidar=8, num_radar_scans=2, rays_per_scan=6, patch_size=(4, 4))
    fwd = (layout.total * roofline.field_flops_per_ray(cfg) + 8 * roofline.lidar_flops_per_ray(cfg)
           + 2 * roofline.radar_flops_per_scan(cfg, 6) + roofline.cnn_flops(cfg, 4, 4, 2))
    vgg = roofline.vgg_flops(12, 12, 2)
    assert roofline.train_step_flops(cfg, layout, 3) == 3 * fwd + 3 * vgg


def test_the_scene_copy_matches_the_port():
    from neuradar_tpu_torch.configs import bench_program

    spec = dict(tiny_config()["scene"])
    f = 1924 / (math.pi / 3)
    spec.update(num_frames=24, coarse_image=[96, 156], lidar_points_per_scan=8192, image=[1418, 3848],
                intrinsics=[f, f, 1924.0, 1084.0], camera_type="FISHEYE", distortion=[-0.2, 0.05, 0.001, 0.0, 0.01, -0.01],
                radar_fov={"min_azimuth": -0.80, "max_azimuth": 0.80, "min_elevation": -0.08, "max_elevation": 0.40,
                           "azimuth_step": 0.015, "elevation_step": 0.015})
    ours, theirs = make_scene(dict(spec, seed=0)), bench_program.zod_camera_scene_outputs()
    for name in ("camera_to_worlds", "intrinsics", "camera_type", "distortion_params", "camera_times", "images",
                 "lidar_to_worlds", "radar_to_worlds", "radar_times"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name), err_msg=name)
    for a, b in zip(ours.lidar_points + ours.radar_points, theirs.lidar_points + theirs.radar_points):
        np.testing.assert_array_equal(a, b)
    assert ours.radar_fov == theirs.radar_fov and ours.image_size == theirs.image_size


def test_union_and_labels():
    assert traceio.union_intervals([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
