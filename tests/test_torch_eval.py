"""The port's evaluation and training entry point (neuradar_tpu_torch) against the JAX package.

Host metrics (GOSPA, chamfer, EMD, SSIM) on numpy inputs; the radar point sampler (deterministic,
and 'nll' with the JAX package's uniform draws fed in); the LPIPS surrogate with the JAX package's
VGG filters loaded; the three eval-metric families of the pipeline on a tiny scene with the same
perturbed weights on both sides (tests/test_torch_slice.py) and, for radar, the same draws; the
command-line overrides. Then the port alone: the cadences of a tiny run of the train command, the
eval command on its run directory, a checkpoint round trip and a resume, and that every module of
the port imports with JAX blocked. Each test states its tolerance.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuradar_tpu.configs import cli as j_cli
from neuradar_tpu.configs.method_configs import get_method as j_get_method
from neuradar_tpu.model_components import gospa as j_gospa
from neuradar_tpu.model_components import radar_utils as j_radar
from neuradar_tpu.pipelines import ad_neuradar_pipeline as j_pipeline
from neuradar_tpu_torch.configs import cli as t_cli
from neuradar_tpu_torch.configs.method_configs import get_method as t_get_method
from neuradar_tpu_torch.data import datamanager as t_dm
from neuradar_tpu_torch.data.dataparsers import synthetic as t_synthetic
from neuradar_tpu_torch.engine import optimizers as t_opt
from neuradar_tpu_torch.engine.trainer import Trainer, TrainerConfig
from neuradar_tpu_torch.model_components import fid as t_fid
from neuradar_tpu_torch.model_components import gospa as t_gospa
from neuradar_tpu_torch.model_components import radar_utils as t_radar
from neuradar_tpu_torch.model_components import vgg as t_vgg
from neuradar_tpu_torch.pipelines import ad_neuradar_pipeline as t_pipeline
from neuradar_tpu_torch.scripts import eval as t_eval_script
from neuradar_tpu_torch.scripts import train as t_train_script
from neuradar_tpu_torch.utils.params import load_jax_params
from tests.test_torch_slice import pipelines, shrink  # noqa: F401 - the module-scoped fixture

REPO = Path(__file__).resolve().parents[1]
# the tiny overrides of the README's train command, cadences set apart
TINY_ARGV = [
    "--dataparser.num_frames", "8", "--dataparser.image_height", "24", "--dataparser.image_width", "36",
    "--dataparser.lidar_points_per_scan", "256",
    "--pipeline.datamanager.num_rgb_patches", "2", "--pipeline.datamanager.patch_size", "4",
    "--pipeline.datamanager.num_lidar_rays", "32", "--pipeline.datamanager.num_radar_scans", "2",
    "--pipeline.datamanager.max_radar_gt", "16",
    "--pipeline.model.field.grid.static.log2_hashmap_size", "12",
    "--pipeline.model.field.grid.actor.log2_hashmap_size", "10",
    "--pipeline.model.sampling.proposal_field_1.grid.static.log2_hashmap_size", "11",
    "--pipeline.model.sampling.proposal_field_1.grid.actor.log2_hashmap_size", "9",
    "--pipeline.model.sampling.proposal_field_2.grid.static.log2_hashmap_size", "11",
    "--pipeline.model.sampling.proposal_field_2.grid.actor.log2_hashmap_size", "9",
    "--pipeline.model.sampling.num_proposal_samples", "16,8", "--pipeline.model.sampling.num_nerf_samples", "6",
]
TINY_RADAR_FOV = dict(min_azimuth=-0.8, max_azimuth=0.8, min_elevation=-0.08, max_elevation=0.32,
                      azimuth_step=0.1, elevation_step=0.1)  # 16 x 4 rays a scan
CADENCE_ARGV = ["--steps_per_eval_batch", "2", "--steps_per_eval_image", "3", "--steps_per_eval_all_images", "4",
                "--steps_per_eval_all_radars", "4", "--steps_per_save", "3", "--steps_per_log", "1"]


def _clouds(seed, n, m):
    rng = np.random.RandomState(seed)
    return rng.normal(0, 5, (n, 3)).astype(np.float32), rng.normal(0, 5, (m, 3)).astype(np.float32)


# ---------------------------------------------------------------------------- host metrics


@pytest.mark.parametrize("n,m", [(12, 40), (30, 7), (0, 5), (5, 0), (25, 25)])
def test_gospa_chamfer_emd_match_jax(n, m):
    """GOSPA with its decomposition and assignment, chamfer and EMD: the same numpy and scipy code on
    both sides, to 1e-10."""
    x, y = _clouds(n * 100 + m, n, m)
    got, want = t_gospa.calculate_gospa(x, y), j_gospa.calculate_gospa(x, y)
    assert got[1] == want[1]
    np.testing.assert_allclose([got[0], *got[2:]], [want[0], *want[2:]], rtol=0, atol=1e-10)
    if n and m:
        np.testing.assert_allclose(t_radar.chamfer_distance_np(x, y), j_radar.chamfer_distance_np(x, y), atol=1e-10)
        np.testing.assert_allclose(t_radar.emd_distance_np(x, y), j_radar.emd_distance_np(x, y), atol=1e-10)


def test_ssim_matches_jax():
    """_ssim_np on two images and on an image smaller than the 11 x 11 window, to 1e-10."""
    rng = np.random.RandomState(3)
    for h, w in ((24, 36), (7, 9)):
        a, b = rng.uniform(size=(h, w, 3)).astype(np.float32), rng.uniform(size=(h, w, 3)).astype(np.float32)
        np.testing.assert_allclose(t_pipeline._ssim_np(a, b), j_pipeline._ssim_np(a, b), rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------- radar sampling


def _radar_output(n_mb=300, seed=4):
    rng = np.random.RandomState(seed)
    out = rng.normal(size=(n_mb, 7)).astype(np.float32)
    out[:, 0] = rng.uniform(0, 1, n_mb)
    out[:7, 0] = 1.0  # saturated existence: ties that the stable sort must order like jnp.argsort
    out[:, 4:7] = np.abs(out[:, 4:7])
    return out


def _jax_uniforms(key, n_mb):
    """The two draws of JAX's nll sampler for one key (radar_utils.py:343-347)."""
    k1, k2 = jax.random.split(key)
    u_exist = jax.random.uniform(k1, (n_mb,), jnp.float32)  # bernoulli(k1, r) is uniform(k1) < r
    u_loc = jax.random.uniform(k2, (n_mb, 3), minval=-0.5 + 1e-6, maxval=0.5 - 1e-6)
    return np.array(u_exist), np.array(u_loc)


@pytest.mark.parametrize("max_detections", [1000, 100])
def test_sample_radar_points_euclidean_exact(max_detections):
    ro = _radar_output()
    want = j_radar.sample_radar_points(jnp.asarray(ro), "euclidean", threshold=0.5, max_detections=max_detections)
    got = t_radar.sample_radar_points(torch.from_numpy(ro), "euclidean", threshold=0.5, max_detections=max_detections)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("max_detections", [1000, 100])
def test_sample_radar_points_nll_with_jax_draws(max_detections):
    """The keep mask exactly; the Laplace points to rtol 1e-6, atol 1e-6 (log1p's last ulp)."""
    ro = _radar_output()
    key = jax.random.PRNGKey(11)
    want = j_radar.sample_radar_points(jnp.asarray(ro), "nll", rng=key, max_detections=max_detections)
    uniforms = tuple(torch.from_numpy(u) for u in _jax_uniforms(key, ro.shape[0]))
    got = t_radar.sample_radar_points(torch.from_numpy(ro), "nll", uniforms, max_detections=max_detections)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)


def test_nll_uniforms_ranges():
    u_exist, u_loc = t_radar.nll_uniforms(5000, torch.Generator().manual_seed(0))
    assert u_exist.shape == (5000,) and u_loc.shape == (5000, 3)
    assert 0 <= float(u_exist.min()) and float(u_exist.max()) < 1
    assert t_radar.LAPLACE_U_LOW <= float(u_loc.min()) and float(u_loc.max()) < t_radar.LAPLACE_U_HIGH


# ---------------------------------------------------------------------------- VGG and LPIPS


@pytest.fixture(scope="module")
def jax_lpips():
    from neuradar_tpu.model_components.fid import PerceptualDistance

    return PerceptualDistance(image_hw=(24, 36))


def _port_lpips(jax_params):
    pd = t_fid.PerceptualDistance("cpu")
    load_jax_params(pd.module, jax_params["params"])
    return pd


def test_perceptual_distance_with_jax_filters(jax_lpips):
    """The LPIPS surrogate on two images and on an image with itself, with JAX's random filters in
    the port's trunk: rtol 1e-5, atol 1e-6 (float32 convolutions sum in other orders)."""
    rng = np.random.RandomState(5)
    a, b = rng.uniform(size=(24, 36, 3)).astype(np.float32), rng.uniform(size=(24, 36, 3)).astype(np.float32)
    pd = _port_lpips(jax_lpips.params)
    np.testing.assert_allclose(pd(a, b), jax_lpips(a, b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pd(torch.from_numpy(a), a), 0.0, atol=1e-6)


def test_vgg_weights_from_npz(jax_lpips, monkeypatch, tmp_path):
    """$NEURADAR_VGG19_WEIGHTS (HWIO kernels, as the JAX package reads them) lands in the port's
    trunk exactly, and the weights count as pretrained."""
    params = jax_lpips.params["params"]
    path = tmp_path / "vgg19.npz"
    np.savez(path, **{f"{k}_{leaf}": np.asarray(v[leaf]) for k, v in params.items() for leaf in ("kernel", "bias")})
    monkeypatch.setenv("NEURADAR_VGG19_WEIGHTS", str(path))
    assert t_vgg.has_pretrained_weights()
    got = t_vgg.Vgg19Features()
    want = t_vgg.Vgg19Features()
    load_jax_params(want, params)
    for (name, g), w in zip(got.state_dict().items(), want.state_dict().values()):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


def test_vgg_random_filters_are_seeded():
    a, b, c = t_vgg.Vgg19Features(0), t_vgg.Vgg19Features(0), t_vgg.Vgg19Features(1)
    assert torch.equal(a.conv4.weight, b.conv4.weight) and not torch.equal(a.conv4.weight, c.conv4.weight)
    std = float(a.conv12.weight.detach().std())
    assert abs(std - (2.0 / (9 * 512)) ** 0.5) < 0.05 * std  # He normal


# ---------------------------------------------------------------------------- eval-metric families


def test_eval_image_metrics_match_jax(pipelines, jax_lpips, monkeypatch):  # noqa: F811
    """PSNR, SSIM and the LPIPS surrogate (JAX's filters loaded) over the eval images: rtol 1e-4,
    atol 1e-5, as the renders (tests/test_torch_slice.py). The rates are timings and only checked
    to be positive."""
    jpipe, variables, tpipe = pipelines
    monkeypatch.setattr(t_pipeline, "PerceptualDistance", lambda device: _port_lpips(jax_lpips.params))
    want = jpipe.get_average_eval_image_metrics(variables)
    got = tpipe.get_average_eval_image_metrics()
    assert sorted(got) == sorted(want)
    for key in ("psnr", "ssim", "lpips_vggsurrogate"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5, err_msg=key)
    assert got["eval_rays_per_sec"] > 0 and got["fps"] > 0


def test_eval_lidar_metrics_match_jax(pipelines):  # noqa: F811
    """The five lidar metrics over the eval scans: rtol 1e-3 (squared depth errors of renders that
    agree to 1e-4), and the ray-drop accuracy exactly."""
    jpipe, variables, tpipe = pipelines
    want = jpipe.get_average_eval_lidar_metrics(variables, max_points=300)
    got = tpipe.get_average_eval_lidar_metrics(max_points=300)
    assert sorted(got) == sorted(want)
    assert got["ray_drop_accuracy"] == want["ray_drop_accuracy"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-6, err_msg=key)


def test_eval_radar_metrics_match_jax(pipelines):  # noqa: F811
    """The ten radar metrics over 3 eval scans x 10 rounds, the port fed the uniforms that JAX's
    loop draws (one key split per round, pipeline:466-479): the empty-prediction count exactly, the
    distances to rtol 1e-4 (renders agree to 1e-4 and the sampled points move with them)."""
    jpipe, variables, tpipe = pipelines
    want = jpipe.get_average_eval_radar_metrics(variables)
    rng, queue = jax.random.PRNGKey(0), []
    for _ in tpipe.datamanager.eval_radar_indices():
        for _ in range(tpipe.config.radar_sampling_rounds):
            rng, sub = jax.random.split(rng)
            queue.append(sub)

    def draw(n_mb):
        return tuple(torch.from_numpy(u) for u in _jax_uniforms(queue.pop(0), n_mb))

    got = tpipe.get_average_eval_radar_metrics(draw=draw)
    assert not queue, "every round drew"
    assert sorted(got) == sorted(want)
    assert got["n_empty_pred_radar"] == want["n_empty_pred_radar"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
    assert want["gospa_mean"] > 0


# ---------------------------------------------------------------------------- command line


def test_parse_overrides_matches_jax():
    """The verify recipe's tiny argv, plus a cadence, a bool and an Optional set to none: every
    overridden field gets the same value and type on both sides."""
    extra = ["--steps_per_save", "3", "--save_only_latest_checkpoint", "false", "--load_dir", "none",
             "--pipeline.radar_sampling_rounds=4"]
    argv = TINY_ARGV + extra
    got = t_cli.parse_overrides(t_get_method("neuradar-synthetic"), argv)
    want = j_cli.parse_overrides(j_get_method("neuradar-synthetic"), argv)
    paths = [a[2:].split("=")[0] for a in argv if a.startswith("--")]
    for path in paths:
        g, w = got, want
        for part in path.split("."):
            g, w = getattr(g, part), getattr(w, part)
        assert g == w and type(g) is type(w), path
    assert got.pipeline.model.sampling.num_proposal_samples == (16, 8)
    assert got.load_dir is None and got.save_only_latest_checkpoint is False


def test_train_command_help(capsys):
    """--help lists the methods; <method> --help lists the fields with their defaults."""
    assert t_train_script.main(["--help"]) == 0
    assert "neuradar-synthetic" in capsys.readouterr().out
    assert t_train_script.main(["neuradar-synthetic", "--help"]) == 0
    out = capsys.readouterr().out
    assert "--steps_per_eval_all_radars (default: 2000)" in out and "--pipeline.radar_sampling_rounds (default: 10)" in out


def test_metric_tracker_matches_jax():
    """Best tracking and early stopping on a negated PSNR series (margin 0.05, patience 3)."""
    from neuradar_tpu.engine.trainer import MetricTracker as JTracker, MetricTrackerConfig as JConfig
    from neuradar_tpu_torch.engine.trainer import MetricTracker, MetricTrackerConfig

    got, want = MetricTracker(MetricTrackerConfig()), JTracker(JConfig())
    for psnr in (10.0, 12.0, 11.9, 11.0, 12.5, 11.0, 10.0, 9.0, 13.0):
        assert got.update(-psnr) == want.update(-psnr)
        assert (got.best, got.num_degradations, got.should_stop) == (want.best, want.num_degradations,
                                                                     want.should_stop)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A 7-step tiny run of the train command on the CPU with every cadence, all checkpoints kept.
    The synthetic scene's radar FoV is cut from the ZOD grid (107 x 33 rays a scan) to the tiny
    learning check's 16 x 4 (scripts/validate_learning.py) while the tests of this run go, since the
    command line cannot shrink it; the all-radars eval samples 2 rounds."""
    out = tmp_path_factory.mktemp("runs")
    argv = ["neuradar-synthetic", "--device", "cpu", "--max_num_iterations", "7", "--output_dir", str(out),
            "--experiment_name", "tiny", "--save_only_latest_checkpoint", "false", *CADENCE_ARGV, *TINY_ARGV,
            "--pipeline.radar_sampling_rounds", "2"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_synthetic, "ZOD_RADAR_FOV", TINY_RADAR_FOV)
        assert t_train_script.main(argv) == 0
        yield out / "tiny" / "neuradar-synthetic"


def test_train_command_cadences(cli_run):
    """After the step of 0-based index i, cadence c fires when i >= c and i % c == 0 (the JAX
    trainer's rule with one step per dispatch): eval batch (2) after 2, 4, 6; single image (3) after
    3, 6; all images and all radars (4) after 4; checkpoints (3) carry the step counts 4 and 7, the
    last written again as the final one."""
    assert (cli_run / "config.json").exists() and (cli_run / "final_metrics.json").exists()
    events = [json.loads(line) for line in (cli_run / "logs" / "events.jsonl").read_text().splitlines()]

    def steps(key):
        return sorted(e["step"] for e in events if key in e)

    assert steps("train_rays_per_sec") == list(range(7))
    assert steps("eval_psnr") == [2, 4, 6]
    assert steps("eval_image_psnr") == [3, 6]
    assert steps("ssim") == steps("lidar_chamfer_distance") == [4]  # images and lidar in one event
    assert steps("gospa_mean") == [4]
    assert sorted(p.name for p in (cli_run / "logs" / "images").iterdir()) == ["eval_rgb_000003.png",
                                                                               "eval_rgb_000006.png"]
    assert sorted(p.name for p in (cli_run / "checkpoints").iterdir()) == ["step-000000004.pt", "step-000000007.pt"]
    config = json.loads((cli_run / "config.json").read_text())
    assert config["method_name"] == "neuradar-synthetic" and config["max_num_iterations"] == 7
    final = json.loads((cli_run / "final_metrics.json").read_text())
    assert np.isfinite(final["loss"]) and final["total_train_time"] > 0


def test_png_events_decode(cli_run):
    """The PNG the writer made with zlib and struct decodes to the rendered image's size."""
    import zlib

    data = (cli_run / "logs" / "images" / "eval_rgb_000003.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    assert (h, w) == (24, 36)
    idat = data[data.index(b"IDAT") + 4 : data.index(b"IEND") - 8]
    raw = zlib.decompress(idat)
    assert len(raw) == h * (1 + 3 * w)


def test_eval_command_on_the_run(cli_run, tmp_path):
    """The eval command reloads config.json and the latest checkpoint (step 7) and writes every
    metric of the three families, finite."""
    out = tmp_path / "eval.json"
    assert t_eval_script.main(["--load-config", str(cli_run), "--output-path", str(out), "--device", "cpu",
                               "--radar-sampling-rounds", "2"]) == 0
    doc = json.loads(out.read_text())
    assert doc["checkpoint_step"] == 7 and doc["method"] == "neuradar-synthetic"
    assert len(doc["results"]) == 20 and all(np.isfinite(v) for v in doc["results"].values())
    assert sorted(doc["seconds"]) == ["image", "lidar", "radar"]


def _tiny_trainer(scene, out, **kw):
    cfg = TrainerConfig(pipeline=t_pipeline.ADNeuRadarPipelineConfig(datamanager=t_dm.ADDataManagerConfig(
        num_rgb_patches=2, patch_size=4, num_lidar_rays=32, num_radar_scans=2, max_radar_gt=16)),
        optimizers=t_opt.default_optimizer_groups(2001), output_dir=str(out), steps_per_eval_batch=0,
        steps_per_eval_image=0, steps_per_eval_all_images=0, steps_per_eval_all_radars=0, steps_per_save=0,
        steps_per_log=1, seed=7, **kw)
    shrink(cfg.pipeline.model)
    trainer = Trainer(cfg, scene, "cpu")
    trainer.setup(prefetch=False)
    return trainer


def test_checkpoint_round_trip_and_resume(pipelines, tmp_path):  # noqa: F811
    """A 3-step run's checkpoint restores every parameter and buffer, every optimizer moment and
    step count and the generator state exactly; training then resumes to max_num_iterations, and
    only the latest checkpoint is left."""
    scene = pipelines[2].outputs
    first = _tiny_trainer(scene, tmp_path, max_num_iterations=3)
    first.train()
    assert first.step == 3
    ckpt_dir = first.run_dir / "checkpoints"
    second = _tiny_trainer(scene, tmp_path, max_num_iterations=5, load_dir=str(ckpt_dir))
    assert second.step == 3
    for (name, a), b in zip(first.model.state_dict().items(), second.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)
    for g, opt in first.optimizer.optimizers.items():
        want, got = opt.state_dict(), second.optimizer.optimizers[g].state_dict()
        assert sorted(got["state"]) == sorted(want["state"])
        for i, st in want["state"].items():
            for k, v in st.items():
                torch.testing.assert_close(got["state"][i][k], v, rtol=0, atol=0, msg=f"{g} {i} {k}")
    assert torch.equal(second.generator.get_state(), first.generator.get_state())
    second.train()
    assert second.step == 5
    assert [p.name for p in ckpt_dir.iterdir()] == ["step-000000005.pt"]
    events = [json.loads(line) for line in (second.run_dir / "logs" / "events.jsonl").read_text().splitlines()]
    assert [e["step"] for e in events] == [0, 1, 2, 3, 4]


def test_port_imports_without_jax():
    """Every module of the port, its scripts and chip_smoke.py import with jax, flax, neuradar_tpu,
    PIL and matplotlib blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'neuradar_tpu', 'PIL', 'matplotlib'):\n"
        "    sys.modules[name] = None\n"
        "import neuradar_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(neuradar_tpu_torch.__path__, 'neuradar_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 40
