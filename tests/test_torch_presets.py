"""The port's presets and the paper's model settings against the JAX package.

Every ported preset's config, field by field, against the JAX preset of the same name (the JAX
package's options the port does not carry are listed, and nothing else may differ); the registry
and the train command's listing; then the neurad-paper model (the SO3xR3 camera optimizer on, no
radar, one appearance embedding a sensor, no actor flips) on a tiny scene dressed in ZOD's camera
model (an equidistant fisheye with 6 distortion coefficients) with rolling shutter: one train step
(every loss term, camera_opt_regularizer among them, and every gradient, pose_adjustment's among
them) against ``jax.value_and_grad`` of the JAX pipeline's train loss, and an eval render against
the JAX pipeline's render_camera. Both sides get the same perturbed weights and the same sampling
jitter, as in tests/test_torch_train.py. Each test states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuradar_tpu.configs.method_configs import get_method as j_get_method
from neuradar_tpu.data import datamanager as j_dm
from neuradar_tpu.data.dataparsers.synthetic import SyntheticDataParser, SyntheticDataParserConfig
from neuradar_tpu.pipelines.ad_neuradar_pipeline import ADNeuRadarPipeline
from neuradar_tpu_torch.cameras.cameras import CameraType
from neuradar_tpu_torch.configs.method_configs import get_method, method_configs, method_descriptions
from neuradar_tpu_torch.data.dataparsers import synthetic as t_synthetic
from neuradar_tpu_torch.engine.trainer import Trainer
from neuradar_tpu_torch.models import neuradar as t_model
from neuradar_tpu_torch.model_components.dynamic_actors import trajectories_from_dicts
from neuradar_tpu_torch.pipelines import ad_neuradar_pipeline as t_pipeline
from neuradar_tpu_torch.scripts import train as t_train_script
from neuradar_tpu_torch.utils import rng as t_rng
from neuradar_tpu_torch.utils.params import load_jax_params
from tests.test_torch_slice import RADAR_FOV, SCENE, perturb, shrink

PORTED = ("neuradar", "neuradar-set", "neuradar-synthetic", "neurad", "neurad-scaleopt", "neurader", "neuradest",
          "neurader-scaleopt", "neuradest-scaleopt", "neurad-paper", "neurad-2x-paper", "neuradar-vod",
          "neurad-nuscenes", "neurad-pandaset", "neurad-kittimot", "neurad-argoverse2", "neurad-wod", "splatfacto",
          "splatfacto-big")
# the JAX package's options the port does not carry: its TPU and multi-device machinery (Pallas
# switches, remat policies, the packed/dense hash-grid layouts, sharding, several steps a dispatch,
# the profiler, the viewer), optax's optimizer state dtypes and clipping, and the field variants no
# preset turns on
NOT_PORTED = {
    "data_parallel", "tensor_parallel", "gradient_accumulation_steps", "mixed_precision", "steps_per_dispatch",
    "profiler", "viewer_port", "vis", "pipeline.model.compensate_upsampling_when_rendering",
    "pipeline.model.dynamic_actors.optimize_trajectories", "pipeline.model.field.learnable_beta",
    "pipeline.model.field.multisample_mode", "pipeline.model.field.num_multisamples", "pipeline.model.field.use_sdf",
    "pipeline.model.nff_remat", "pipeline.model.nff_remat_policy", "pipeline.model.normalize_depth",
    "pipeline.model.use_pallas_attention", "pipeline.model.use_pallas_composite",
}
NOT_PORTED_LEAVES = {"max_norm", "moments_dtype", "mu_dtype", "dense_low_levels", "packed_dense_cells",
                     "packed_max_cells", "disable_actors", "decoder"}
# ZOD's camera model on the tiny scene: the 6 OpenCV coefficients of tests/test_sensors.py's Newton
# test, and a rolling shutter of 40 ms across the rows
ZOD_DIST = np.array([-0.2, 0.05, 0.001, 0.0, 0.01, -0.01], np.float32)
DM = dict(num_rgb_patches=2, patch_size=4, num_lidar_rays=32, num_radar_scans=0, max_radar_gt=16)


def _leaves(obj, prefix=""):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {prefix + "__class__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out.update(_leaves(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    if isinstance(obj, dict):
        out = {prefix + "__keys__": sorted(obj)}
        for k, v in obj.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: obj}


def _not_ported(path: str) -> bool:
    return path in NOT_PORTED or path.rsplit(".", 1)[-1] in NOT_PORTED_LEAVES or path.endswith(".decoder.__class__")


@pytest.mark.parametrize("name", PORTED)
def test_preset_matches_jax(name):
    """Every field of the preset, the class of every config and the keys of every dict (the
    optimizer groups) equal the JAX preset's; the JAX package's fields the port lacks are exactly
    the options listed in NOT_PORTED."""
    got, want = _leaves(get_method(name)), _leaves(j_get_method(name))
    assert not set(got) - set(want), sorted(set(got) - set(want))
    missing = sorted(p for p in set(want) - set(got) if not _not_ported(p))
    assert not missing, missing
    for path in sorted(set(got)):
        assert got[path] == want[path] and type(got[path]) is type(want[path]), (path, got[path], want[path])


def test_registry_and_train_listing(capsys):
    """The registry holds the ported presets, each described; the train command lists them."""
    assert sorted(method_configs) == sorted(PORTED) and sorted(method_descriptions) == sorted(PORTED)
    assert t_train_script.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert all(f"  {name}:" in out for name in PORTED)
    with pytest.raises(KeyError, match="nerfacto"):
        get_method("nerfacto")


def _dress(out):
    """The scene in ZOD's camera model, with a rolling shutter on top."""
    n = len(out.camera_to_worlds)
    out.camera_type = np.full(n, int(CameraType.FISHEYE))
    out.distortion_params = np.tile(ZOD_DIST[None], (n, 1))
    out.camera_velocities = np.tile(np.array([[5.0, 0.0, 0.0]], np.float32), (n, 1))
    out.rolling_shutter_offsets = np.tile(np.array([[-0.02, 0.02]], np.float32), (n, 1))
    out.radar_fov = dict(RADAR_FOV)
    return out


def _model_config(model, nff_chunks=1):
    """The preset's model at the tiny sizes, float32, without the VGG loss (4-ray patches are too
    small for VGG-19). The JAX package draws the sampling jitter inside its scan over chunks, so a
    comparison with it runs one chunk; the port's chunks are held to one chunk in
    tests/test_torch_train.py."""
    shrink(model)
    model.loss.vgg_mult = 0.0
    model.compute_dtype = "float32"
    model.nff_chunks = nff_chunks
    return model


@pytest.fixture(scope="module")
def paper_pipelines():
    jcfg = j_get_method("neurad-paper").pipeline
    jcfg.datamanager = j_dm.ADDataManagerConfig(**DM)
    _model_config(jcfg.model)
    jpipe = ADNeuRadarPipeline(jcfg, _dress(SyntheticDataParser(SyntheticDataParserConfig(**SCENE))
                                            .get_dataparser_outputs()))
    variables = jax.device_get(jpipe.init_variables(0))
    params, batch_stats = perturb(variables["params"], variables["batch_stats"])
    adj = np.random.RandomState(3).normal(0.0, 0.02, np.shape(params["camera_optimizer"]["pose_adjustment"]))
    adj[::4] = 0.0  # frames at the zero start: the exponential map's Taylor branch
    params["camera_optimizer"]["pose_adjustment"] = adj.astype(np.float32)

    tcfg = get_method("neurad-paper").pipeline
    tcfg.datamanager = dataclasses.replace(tcfg.datamanager, **DM)
    _model_config(tcfg.model)
    t_out = _dress(t_synthetic.SyntheticDataParser(t_synthetic.SyntheticDataParserConfig(**SCENE))
                   .get_dataparser_outputs())
    tpipe = t_pipeline.ADNeuRadarPipeline(tcfg, t_out, "cpu")
    load_jax_params(tpipe.model, params, batch_stats)
    return jpipe, params, batch_stats, tpipe


def test_paper_model_layout(paper_pipelines):
    """No radar scans; one appearance embedding a sensor; a pose adjustment for every camera, lidar
    and radar frame; the camera table holds the fisheye with its distortion and rolling shutter."""
    jpipe, params, _, tpipe = paper_pipelines
    assert tpipe.layout.num_radar_scans == 0 and tpipe.layout.total == 64
    m = tpipe.model
    assert m.appearance_embedding.weight.shape == (3, 16) and m.embeds_per_sensor == 1
    # no radar scans in a batch: no radar decoder (as the flax tree has none) and no radar evals
    assert m.radar_decoder is None and "radar_decoder" not in params
    assert len(tpipe.datamanager.eval_radar_indices()) == 0
    with pytest.raises(ValueError, match="decodes no radar"):
        tpipe.render_radar(0)
    assert m.camera_optimizer.pose_adjustment.shape == (24, 6) == params["camera_optimizer"]["pose_adjustment"].shape
    cams = tpipe.tables.cameras
    assert torch.unique(cams.camera_type).tolist() == [int(CameraType.FISHEYE)] and cams.distortion_params.shape == (8, 6)
    assert {"velocities", "rolling_shutter_offsets"} <= set(cams.metadata)


@pytest.fixture(scope="module")
def paper_train_step(paper_pipelines):
    """value_and_grad of both sides on one batch with the same jitter."""
    jpipe, params, batch_stats, tpipe = paper_pipelines
    batch = j_dm.ADDataManager(jpipe.outputs, j_dm.ADDataManagerConfig(**DM)).sample_train_batch()
    layout = jpipe.layout
    s = jpipe.config.model.sampling
    rng = np.random.RandomState(21)
    jitter = [rng.uniform(size=(layout.total, 1)).astype(np.float32)
              for _ in (*s.num_proposal_samples, s.num_nerf_samples)]
    j_queue, t_queue = list(jitter), list(jitter)
    uniform = jax.random.uniform

    def j_uniform(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        if tuple(shape) == (layout.total, 1):
            return jnp.asarray(j_queue.pop(0))
        return uniform(key, shape, dtype, *args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", j_uniform)
    try:
        (j_total, (j_losses, j_metrics, j_stats)), j_grads = jax.jit(
            jax.value_and_grad(jpipe.make_train_loss_fn(), has_aux=True))(
            params, batch_stats, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    finally:
        mp.undo()
    mp = pytest.MonkeyPatch()
    mp.setattr(t_rng, "uniform", lambda generator, shape, device: torch.from_numpy(t_queue.pop(0)).to(device))
    try:
        model = tpipe.model
        model.train()
        model.zero_grad()
        t_total, t_losses, t_metrics = tpipe.make_train_loss_fn()(batch, torch.Generator().manual_seed(0))
        t_total.backward()
    finally:
        mp.undo()
    assert not j_queue and not t_queue, "every jitter array was drawn on both sides"
    return (j_total, j_losses, j_stats, jax.device_get(j_grads)), (t_total, t_losses, t_metrics, tpipe)


def test_paper_train_step_losses(paper_train_step):
    """The total and every loss term, camera_opt_regularizer among them; rtol 1e-4 / atol 1e-6
    (float32, summation order). The camera optimizer's metrics are logged with the step."""
    (j_total, j_losses, _, _), (t_total, t_losses, t_metrics, _) = paper_train_step
    assert sorted(t_losses) == sorted(j_losses) and "camera_opt_regularizer" in t_losses
    assert "radar_loss" not in t_losses
    for key in j_losses:
        np.testing.assert_allclose(float(t_losses[key].detach()), float(j_losses[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(float(t_total.detach()), float(j_total), rtol=1e-4, atol=1e-6)
    assert float(t_metrics["camera_opt_translation"]) > 0 and float(t_metrics["camera_opt_rotation"]) > 0


def test_paper_train_step_gradients(paper_train_step):
    """The gradient of every parameter, pose_adjustment's among them (its rows at zero included), by
    tests/test_torch_train.py's rule: rtol 1e-3, atol 1e-4 of the parameter's largest gradient, at
    least 1e-7; a parameter whose JAX gradient stays under 1e-6 is held to atol 1e-6."""
    (_, _, j_stats, j_grads), (_, _, _, tpipe) = paper_train_step
    model = tpipe.model
    want_model = t_model.NeuRadarModel(model.config, model.scene, trajectories_from_dicts(tpipe.outputs.trajectories),
                                       decode_radar=False)
    load_jax_params(want_model, j_grads, j_stats)
    names = []
    for (name, p), w in zip(model.named_parameters(), want_model.parameters()):
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = float(w.abs().max())
        np.testing.assert_allclose(got.numpy(), w.detach().numpy(), rtol=1e-3,
                                   atol=1e-6 if scale < 1e-6 else max(1e-4 * scale, 1e-7), err_msg=name)
        names.append(name)
    assert "camera_optimizer.pose_adjustment" in names and len(names) == len(list(model.parameters()))
    pose_grad = model.camera_optimizer.pose_adjustment.grad
    assert bool(torch.isfinite(pose_grad).all()) and float(pose_grad[::4].abs().max()) > 0


def test_paper_eval_render(paper_pipelines):
    """render_camera of an eval frame through the fisheye with distortion and rolling shutter, one
    appearance embedding a sensor (use_temporal_appearance off), the camera optimizer not applied
    (eval); rtol 1e-4 / atol 1e-4 as tests/test_torch_slice.py."""
    jpipe, params, batch_stats, tpipe = paper_pipelines
    want = jpipe.render_camera({"params": params, "batch_stats": batch_stats}, 5)
    load_jax_params(tpipe.model, params, batch_stats)  # a train step before moved the batch-norm statistics
    tpipe.model.eval()
    got = tpipe.render_camera(5)
    for key in ("rgb", "depth", "accumulation"):
        assert tuple(got[key].shape) == np.shape(want[key]), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4, atol=1e-4, err_msg=key)


def test_load_jax_params_checks_the_appearance_embedding(paper_pipelines):
    """A flax tree with temporal appearance (sensors x time bins) does not load into a model without
    it (one embedding a sensor), and the other way round."""
    _, params, batch_stats, tpipe = paper_pipelines
    temporal = {**params, "appearance_embedding": {"embedding": np.zeros((3 * 4, 16), np.float32)}}
    with pytest.raises(ValueError, match="appearance_embedding"):
        load_jax_params(tpipe.model, temporal, batch_stats)
    cfg = dataclasses.replace(tpipe.model.config, use_temporal_appearance=True)
    model = t_model.NeuRadarModel(cfg, tpipe.model.scene, trajectories_from_dicts(tpipe.outputs.trajectories),
                                  decode_radar=False)
    assert model.appearance_embedding.weight.shape[0] == 3 * model.embeds_per_sensor > 3
    with pytest.raises(ValueError, match="appearance_embedding"):
        load_jax_params(model, params, batch_stats)


def test_pose_adjustment_trains_and_resumes(tmp_path):
    """Two port steps of neurad on the dressed tiny scene move pose_adjustment (the camera_opt
    group); the checkpoint holds it and its Adam state, and a resumed trainer continues from both
    to the same third step as an uninterrupted one."""
    out = _dress(t_synthetic.SyntheticDataParser(t_synthetic.SyntheticDataParserConfig(**SCENE))
                 .get_dataparser_outputs())

    def trainer(load_dir=None):
        cfg = get_method("neurad")
        cfg.pipeline.datamanager = dataclasses.replace(cfg.pipeline.datamanager, **DM)
        _model_config(cfg.pipeline.model, nff_chunks=2)
        cfg.output_dir, cfg.experiment_name, cfg.load_dir = str(tmp_path), "t", load_dir
        tr = Trainer(cfg, out, "cpu")
        tr.setup(prefetch=False)
        return tr

    a = trainer()
    assert "camera_opt" in a.optimizer.optimizers
    for _ in range(2):
        a.train_step()
    pose = a.model.camera_optimizer.pose_adjustment.detach().clone()
    assert pose.abs().max() > 0
    path = a.save_checkpoint()
    assert "camera_optimizer.pose_adjustment" in torch.load(path, weights_only=True)["model"]
    b = trainer(str(path.parent))
    assert b.step == 2 and torch.equal(b.model.camera_optimizer.pose_adjustment.detach(), pose)
    b.pipeline.datamanager.sample_train_batch()  # the sampler restarts from its seed on resume; skip to batch 3
    b.pipeline.datamanager.sample_train_batch()
    a.train_step()
    b.train_step()
    torch.testing.assert_close(b.model.camera_optimizer.pose_adjustment, a.model.camera_optimizer.pose_adjustment,
                               rtol=0, atol=0)
