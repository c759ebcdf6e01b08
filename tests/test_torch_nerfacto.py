"""The port's nerfacto (``models/nerfacto.py``, ``fields/nerfacto_field.py``, ``engine/nerfacto_trainer.py``)
against the JAX package and against the benchmark's plain reference (``benchmark/reference/nrref/nerfacto.py``).

A tiny nerfacto (small grids, a few samples a round, 32 rays) on a tiny synthetic scene, with seeded
random weights (the hash tables N(0, 0.1), the biases moved off zero, a small pose adjustment for every
frame so the camera optimizer's rotation and translation both act), one host batch of the JAX
datamanager (the port's draws the same), the anneal midway (step 300 of 1,000): the outputs (rgb,
accumulation, depth), every loss term and every parameter's gradient of one train forward. The JAX side
takes the port's jitter, handed to ``jax.random.uniform`` in the order the samplers draw it; the
reference draws it from the same generator as the port. Tolerances are tests/test_torch_presets.py's:
the outputs and loss terms rtol 1e-4 / atol 1e-6 (float32, summation order: XLA and torch reduce in
other orders, and the reference sums its loss terms block by block), the gradients rtol 1e-3 with atol
1e-4 of the parameter's largest gradient, at least 1e-7 (the hash tables receive scatter-added sums in
another order, and the gradient passes through exp, pow and divisions whose last ulp differs). The
trainer: its steps, the anneal and the schedule, its checkpoint round trip and the train command.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuradar_tpu.data import datamanager as j_dm
from neuradar_tpu.data.dataparsers.synthetic import SyntheticDataParser as JParser
from neuradar_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JParserConfig
from neuradar_tpu.models import nerfacto as j_nerfacto
from neuradar_tpu_torch.configs import method_configs
from neuradar_tpu_torch.data import datamanager as t_dm
from neuradar_tpu_torch.data.dataparsers.synthetic import SyntheticDataParser, SyntheticDataParserConfig
from neuradar_tpu_torch.model_components.ray_samplers import draw_jitter
from neuradar_tpu_torch.models import nerfacto as t_nerfacto
from neuradar_tpu_torch.scripts import train as train_script
from neuradar_tpu_torch.utils.params import load_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark"))
from reference.nrref.nerfacto import NerfactoRun, settings_of  # noqa: E402

SCENE = dict(num_frames=8, image_height=24, image_width=36, lidar_points_per_scan=256)
MODEL = dict(num_levels=4, log2_hashmap_size=10, max_res=256, num_proposal_samples_per_ray=(16, 8),
             num_nerf_samples_per_ray=8, hidden_dim=16, hidden_dim_color=16, appearance_embedding_dim=8,
             proposal_net_args_list=(
                 {"hidden_dim": 8, "log2_hashmap_size": 8, "num_levels": 3, "max_res": 64, "use_linear": False},
                 {"hidden_dim": 8, "log2_hashmap_size": 8, "num_levels": 4, "max_res": 128, "use_linear": False}))
PATCHES, PATCH = 2, 4
STEP = 300
OUT_TOL = dict(rtol=1e-4, atol=1e-6)


def _grad_tol(want: np.ndarray) -> dict:
    scale = float(np.abs(want).max())
    return dict(rtol=1e-3, atol=1e-6 if scale < 1e-6 else max(1e-4 * scale, 1e-7))


def _perturb(params, seed=0):
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x)
        name = path[-1].key
        if name == "hash_table":
            return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        if name == "bias":
            return (x + rng.normal(0.0, 0.05, x.shape)).astype(np.float32)
        if name == "pose_adjustment":
            return rng.normal(0.0, 0.01, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def step():
    """One train forward and backward on the three sides from the same weights, batch and jitter."""
    jout = JParser(JParserConfig(**SCENE)).get_dataparser_outputs()
    tout = SyntheticDataParser(SyntheticDataParserConfig(**SCENE)).get_dataparser_outputs()
    dm_cfg = dict(num_rgb_patches=PATCHES, patch_size=PATCH, num_lidar_rays=0, num_radar_scans=0)
    jdm = j_dm.ADDataManager(jout, j_dm.ADDataManagerConfig(**dm_cfg), rgb_upsample_factor=1)
    tdm = t_dm.ADDataManager(tout, t_dm.ADDataManagerConfig(**dm_cfg), "cpu", rgb_upsample_factor=1)
    batch = jdm.sample_train_batch()
    assert all(np.array_equal(batch[k], v) for k, v in tdm.sample_train_batch().items())
    scale = float(np.abs(jout.scene_box.aabb).max())
    R = PATCHES * PATCH**2

    jmodel = j_nerfacto.NerfactoModel(config=j_nerfacto.NerfactoModelConfig(**MODEL), static_scale=scale,
                                      num_embeds=len(jout.camera_to_worlds))
    jbundle = j_dm.build_train_bundle(jdm.tables, jax.tree.map(jnp.asarray, batch), jdm.layout, 1)
    gt = {"rgb": jnp.asarray(batch["image"], jnp.float32).reshape(-1, 3) / 255.0}
    variables = jax.jit(lambda k: jmodel.init({"params": k, "sampling": k}, jbundle, train=True))(
        jax.random.PRNGKey(3))
    params = jax.device_get(_perturb(variables["params"]))

    tcfg = t_nerfacto.NerfactoModelConfig(**MODEL)
    tmodel = t_nerfacto.NerfactoModel(tcfg, scale, num_embeds=len(tout.camera_to_worlds))
    load_jax_params(tmodel, params)
    anneal = tmodel.anneal_for_step(STEP)
    jitter = draw_jitter(torch.Generator().manual_seed(5), R, (*MODEL["num_proposal_samples_per_ray"],
                                                                MODEL["num_nerf_samples_per_ray"]), True, "cpu")
    queue = [j.numpy() for j in jitter]
    uniform = jax.random.uniform

    def j_uniform(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        if tuple(shape) == (R, 1):
            return jnp.asarray(queue.pop(0))
        return uniform(key, shape, dtype, *args, **kwargs)

    def j_loss(p):
        total, (losses, _, outputs) = jmodel.apply(
            {"params": p}, jbundle, gt, train=True, method=jmodel.loss_and_metrics,
            anneal=jmodel.anneal_for_step(STEP), rngs={"sampling": jax.random.PRNGKey(0)})
        return total, (losses, {k: outputs[k] for k in ("rgb", "accumulation", "depth")})

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", j_uniform)
    try:
        (j_total, (j_losses, j_outputs)), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    finally:
        mp.undo()
    assert not queue, "every jitter array was drawn"

    tbatch = t_dm.batch_to_device(batch, "cpu")
    tbundle = t_dm.build_train_bundle(tdm.tables, tbatch, tdm.layout, 1)
    tmodel.train()
    t_total, t_losses, _, t_outputs = tmodel.loss_and_metrics(
        tbundle, {"rgb": tbatch["image"].float().reshape(-1, 3) / 255.0}, train=True,
        generator=torch.Generator().manual_seed(5), anneal=anneal)
    t_total.backward()

    spec = {**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}, "camera_optimizer": "SO3xR3",
            "lr_init": 1e-2, "lr_final": 1e-4, "warmup_steps": 512, "max_num_iterations": 30000,
            "num_rgb_patches": PATCHES, "patch_size": PATCH}
    ref = NerfactoRun(settings_of(spec), tout, "cpu", block_rays=R // 2)
    ref.model.load_state_dict(tmodel.state_dict())
    r_total, r_losses, r_outputs = ref.loss_and_grads(batch, torch.Generator().manual_seed(5), STEP)
    return {
        "jax": (float(j_total), {k: float(v) for k, v in j_losses.items()}, jax.device_get(j_outputs), j_grads),
        "port": (float(t_total.detach()), {k: float(v.detach()) for k, v in t_losses.items()}, t_outputs, tmodel),
        "ref": (r_total, r_losses, r_outputs, ref.model),
    }


@pytest.mark.parametrize("side", ["jax", "ref"])
def test_outputs(step, side):
    """rgb, accumulation and depth of the train forward, OUT_TOL."""
    want = step[side][2]
    got = step["port"][2]
    for key in ("rgb", "accumulation", "depth"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), err_msg=key, **OUT_TOL)
    assert float(np.asarray(want["accumulation"]).max()) > 0.1  # the tables' weights make a scene to render


@pytest.mark.parametrize("side", ["jax", "ref"])
def test_loss_terms(step, side):
    """The total and every loss term, camera_opt_regularizer among them, OUT_TOL."""
    total, losses = step[side][:2]
    t_total, t_losses = step["port"][:2]
    assert sorted(t_losses) == sorted(losses) == ["camera_opt_regularizer", "distortion_loss", "interlevel_loss",
                                                  "rgb_loss"]
    for key in losses:
        np.testing.assert_allclose(t_losses[key], losses[key], err_msg=key, **OUT_TOL)
        assert losses[key] > 0, key
    np.testing.assert_allclose(t_total, total, **OUT_TOL)


@pytest.mark.parametrize("side", ["jax", "ref"])
def test_gradients(step, side):
    """Every parameter's gradient: the field's grid and MLPs, the appearance embedding, both proposal
    networks and the pose adjustment; each nonzero."""
    tmodel = step["port"][3]
    if side == "jax":
        want_model = t_nerfacto.NerfactoModel(tmodel.config, 1.0, num_embeds=tmodel.field.appearance.num_embeddings)
        load_jax_params(want_model, step["jax"][3])
        want = {n: p.detach().numpy() for n, p in want_model.named_parameters()}
    else:
        want = {n: p.grad.numpy() for n, p in step["ref"][3].named_parameters()}
    names = [n for n, _ in tmodel.named_parameters()]
    assert sorted(names) == sorted(want) and "camera_optimizer.pose_adjustment" in names
    assert {"proposal_0.grid.hash_table", "proposal_1.decoder.output.weight", "field.appearance.weight"} <= set(names)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], err_msg=name, **_grad_tol(want[name]))
        assert float(np.abs(want[name]).max()) > 0, name


def test_samplers_and_losses_match_jax():
    """The lin-disp sampler at jittered and plain bins, the anneal exponent, and the interlevel and
    distortion losses on random histograms, against the JAX package's (rtol 1e-6 / atol 1e-6)."""
    from neuradar_tpu.cameras.rays import RayBundle as JBundle
    from neuradar_tpu.model_components import losses as j_losses
    from neuradar_tpu.model_components import ray_samplers as j_samplers
    from neuradar_tpu_torch.cameras.rays import RayBundle
    from neuradar_tpu_torch.model_components import losses as t_losses
    from neuradar_tpu_torch.model_components import ray_samplers as t_samplers

    rng = np.random.RandomState(0)
    R = 6
    arrays = dict(origins=rng.randn(R, 3), directions=rng.randn(R, 3), pixel_area=np.full((R, 1), 1e-4),
                  nears=np.full((R, 1), 0.05), fars=np.full((R, 1), 1000.0))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    jb = JBundle(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tb = RayBundle(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    u = rng.uniform(size=(R, 1)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32: jnp.asarray(u))
    try:
        js = [j_samplers.lin_disp_piecewise_sampler(jb, 12, rng=k) for k in (None, jax.random.PRNGKey(0))]
    finally:
        mp.undo()
    ts = [t_samplers.lin_disp_piecewise_sampler(tb, 12, jitter=j) for j in (None, torch.from_numpy(u))]
    for j, t in zip(js, ts):
        for attr in ("starts", "ends"):
            np.testing.assert_allclose(getattr(t.frustums, attr).numpy(), np.asarray(getattr(j.frustums, attr)),
                                       rtol=1e-6, atol=1e-6)
    jcfg = j_nerfacto.NerfactoModelConfig(proposal_weights_anneal_max_num_iters=5000)
    tmodel = t_nerfacto.NerfactoModel(t_nerfacto.NerfactoModelConfig(**MODEL, proposal_weights_anneal_max_num_iters=5000),
                                      1.0)
    jm = j_nerfacto.NerfactoModel(config=jcfg, static_scale=1.0)
    for s in (0, 1, 700, 4999, 5000, 9000):
        np.testing.assert_allclose(tmodel.anneal_for_step(s), float(jm.anneal_for_step(s)), rtol=1e-6)
    assert tmodel.anneal_for_step(5000) == 1.0
    weights = [rng.dirichlet(np.ones(12), size=R)[..., None].astype(np.float32) * 0.9 for _ in range(3)]
    jl = [j_losses.interlevel_loss([jnp.asarray(w) for w in weights], [js[1], js[0], js[1]]),
          j_losses.distortion_loss([jnp.asarray(w) for w in weights], [js[1], js[0], js[1]])]
    tl = [t_losses.interlevel_loss([torch.from_numpy(w) for w in weights], [ts[1], ts[0], ts[1]]),
          t_losses.distortion_loss([torch.from_numpy(w) for w in weights], [ts[1], ts[0], ts[1]])]
    for t, j in zip(tl, jl):
        assert float(j) > 0
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6, atol=1e-6)


def _tiny_trainer(tmp_path):
    cfg = method_configs.NerfactoTrainerConfig(dataparser=SyntheticDataParserConfig())
    cfg.dataparser = SyntheticDataParserConfig(**SCENE)
    cfg.model = t_nerfacto.NerfactoModelConfig(**MODEL)
    cfg.num_rgb_patches, cfg.patch_size = PATCHES, PATCH
    cfg.output_dir = str(tmp_path)
    return cfg


def test_trainer_steps_and_checkpoint(tmp_path):
    """Three steps of the trainer: every loss term finite, every parameter moved, the rate the schedule's
    (linear warm-up from 1e-8); a checkpoint restores the parameters, Adam's state, the step and the
    generator, so that the next step is the same on both."""
    cfg = _tiny_trainer(tmp_path)
    trainer = cfg.setup(device="cpu", prefetch=False)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    for _ in range(3):
        losses, metrics = trainer.train_step()
        assert all(bool(torch.isfinite(v)) for v in losses.values()) and float(metrics["psnr"]) > 0
    assert trainer.step == 3
    for n, p in trainer.model.named_parameters():
        assert not torch.equal(p, before[n]), n
    (opt,) = trainer.optimizer.optimizers.values()
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-8 + (1e-2 - 1e-8) * 2 / 512)
    trainer.save_checkpoint()
    other = cfg.setup(device="cpu", prefetch=False)
    other.load_checkpoint(trainer.run_dir / "checkpoints")
    other.dm.rng.set_state(trainer.dm.rng.get_state())
    assert other.step == 3
    a, b = trainer.train_step()[0]["total"], other.train_step()[0]["total"]
    assert float(a) == float(b)


def test_train_command(tmp_path, monkeypatch):
    """``scripts/train.py nerfacto`` trains through NerfactoTrainer: the config, final metrics (the
    eval PSNR) and the checkpoint in the run directory."""
    monkeypatch.setitem(method_configs.method_configs, "nerfacto", lambda: _tiny_trainer(tmp_path))
    assert train_script.main(["nerfacto", "--device", "cpu", "--max_num_iterations", "2", "--steps_per_log", "1",
                              "--steps_per_eval_batch", "1", "--experiment_name", "t"]) == 0
    run = tmp_path / "t" / "nerfacto"
    metrics = json.loads((run / "final_metrics.json").read_text())
    assert np.isfinite(metrics["eval_psnr"]) and metrics["eval_num_images"] > 0
    assert json.loads((run / "config.json").read_text())["model"]["num_levels"] == MODEL["num_levels"]
    assert (run / "checkpoints" / "nerfacto.pt").is_file()
