"""The port's render path (neuradar_tpu_torch) against the JAX package, end to end.

One tiny synthetic scene is built on each side from the same dataparser seed.
The JAX pipeline initializes its variables; the hash tables, biases, norm
scales and batch-norm statistics are then perturbed with numpy (at init the
tables are U(-1e-3, 1e-3) and the biases zero, where a wrong hash index or a
misplaced bias would hardly show), and the same trees are loaded into the port.
render_camera, render_lidar and render_radar must then agree.

Tolerance: float32 on both sides, rtol 1e-4 / atol 1e-4. The two frameworks
differ only in summation order and in the last ulp of exp/log/pow.
"""

import jax
import numpy as np
import pytest
import torch

from neuradar_tpu.data.datamanager import ADDataManagerConfig
from neuradar_tpu.data.dataparsers.synthetic import SyntheticDataParser, SyntheticDataParserConfig
from neuradar_tpu.pipelines.ad_neuradar_pipeline import ADNeuRadarPipeline, ADNeuRadarPipelineConfig
from neuradar_tpu_torch.data.dataparsers import synthetic as t_synthetic
from neuradar_tpu_torch.pipelines import ad_neuradar_pipeline as t_pipeline
from neuradar_tpu_torch.utils.params import load_jax_params

# One torch thread a process. A parallel run (pytest-xdist) puts several workers on the same cores, and
# each collects every test file, so this holds for all the port's tests there: torch's OpenMP threads
# spin while they wait, and several workers' full thread pools on the same cores slow a test down
# some twentyfold (a ten-step train test: 5 s alone, 75 s beside five busy processes).
torch.set_num_threads(1)

RTOL = ATOL = 1e-4
RADAR_FOV = dict(min_azimuth=-0.8, max_azimuth=0.8, min_elevation=-0.08, max_elevation=0.32,
                 azimuth_step=0.1, elevation_step=0.1)
SCENE = dict(num_frames=8, image_height=24, image_width=36, lidar_points_per_scan=256)


def shrink(m):
    """The tiny sizes of the verify recipe; the same on both sides."""
    m.field.grid.static.log2_hashmap_size = 12
    m.field.grid.actor.log2_hashmap_size = 10
    for pf in (m.sampling.proposal_field_1, m.sampling.proposal_field_2):
        pf.grid.static.log2_hashmap_size = 11
        pf.grid.actor.log2_hashmap_size = 9
    m.sampling.num_proposal_samples = (16, 8)
    m.sampling.num_nerf_samples = 6


def perturb(params, batch_stats, seed=0):
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x)
        name = path[-1].key
        if name == "hash_table":
            return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        if name == "bias":
            return (x + rng.normal(0.0, 0.05, x.shape)).astype(np.float32)
        if name == "scale":
            return (x + rng.normal(0.0, 0.05, x.shape)).astype(np.float32)
        if name == "mean":
            return rng.normal(0.0, 0.05, x.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        return x

    return (jax.tree_util.tree_map_with_path(leaf, params), jax.tree_util.tree_map_with_path(leaf, batch_stats))


@pytest.fixture(scope="module")
def pipelines():
    out = SyntheticDataParser(SyntheticDataParserConfig(**SCENE)).get_dataparser_outputs()
    out.radar_fov = dict(RADAR_FOV)
    cfg = ADNeuRadarPipelineConfig(datamanager=ADDataManagerConfig(
        num_rgb_patches=2, patch_size=4, num_lidar_rays=32, num_radar_scans=2, max_radar_gt=16))
    shrink(cfg.model)
    cfg.model.loss.vgg_mult = 0.0
    jpipe = ADNeuRadarPipeline(cfg, out)
    variables = jpipe.init_variables(0)
    params, batch_stats = perturb(variables["params"], variables["batch_stats"])

    t_out = t_synthetic.SyntheticDataParser(t_synthetic.SyntheticDataParserConfig(**SCENE)).get_dataparser_outputs()
    t_out.radar_fov = dict(RADAR_FOV)
    t_cfg = t_pipeline.ADNeuRadarPipelineConfig()
    shrink(t_cfg.model)
    t_cfg.model.loss.vgg_mult = 0.0
    tpipe = t_pipeline.ADNeuRadarPipeline(t_cfg, t_out, "cpu")
    load_jax_params(tpipe.model, params, batch_stats)
    return jpipe, {"params": params, "batch_stats": batch_stats}, tpipe


def _close(got, want, name):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want), name
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("cam_idx", [0, 5])
def test_render_camera(pipelines, cam_idx):
    jpipe, variables, tpipe = pipelines
    want = jpipe.render_camera(variables, cam_idx)
    got = tpipe.render_camera(cam_idx)
    for key in ("rgb", "depth", "accumulation"):
        _close(got[key], want[key], key)


def test_render_lidar(pipelines):
    jpipe, variables, tpipe = pipelines
    want = jpipe.render_lidar(variables, 3, max_points=300)  # 256 points, padded to 300
    got = tpipe.render_lidar(3, max_points=300)
    assert got["num_valid"] == want["num_valid"] == 256
    np.testing.assert_array_equal(got["points"], want["points"])
    for key in ("depth", "intensity", "ray_drop_prob"):
        _close(got[key], want[key], key)


def test_render_radar(pipelines):
    jpipe, variables, tpipe = pipelines
    for scan_idx in (0, 6):
        _close(tpipe.render_radar(scan_idx)["radar_output"], jpipe.render_radar(variables, scan_idx)["radar_output"],
               f"radar_output[{scan_idx}]")


def test_render_radar_batched_scans(pipelines):
    """Scans rendered as one batch give each scan's own render."""
    _, _, tpipe = pipelines
    batched = tpipe.render_radar([0, 6])["radar_output"]
    for i, scan_idx in enumerate((0, 6)):
        _close(batched[i], tpipe.render_radar(scan_idx)["radar_output"], f"scan {scan_idx}")
