"""The port's train step (neuradar_tpu_torch) against the JAX package.

Module by module (the batch sampler, the train bundle, the losses and the
auction, train-mode batch norm, the optimizer groups and schedules) and then
the whole step: ``loss_and_metrics(train=True)`` on a tiny scene, its total,
every loss term and the gradient of every parameter, against
``jax.value_and_grad`` of the JAX pipeline's ``make_train_loss_fn``. Both
sides get the same perturbed weights (as in tests/test_torch_slice.py) and
the same random draws: actor flips and dropout are off, and the sampling
jitter is one list of numpy arrays handed out in call order to the JAX
samplers' ``jax.random.uniform`` and to the port's ``utils.rng.uniform``.
Each test states its tolerance. The JAX side is built once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuradar_tpu.data import datamanager as j_dm
from neuradar_tpu.data.dataparsers.synthetic import SyntheticDataParser, SyntheticDataParserConfig
from neuradar_tpu.engine import optimizers as j_opt
from neuradar_tpu.model_components import cnns as j_cnns
from neuradar_tpu.model_components import losses as j_losses
from neuradar_tpu.model_components import radar_utils as j_radar
from neuradar_tpu.models import neuradar as j_model
from neuradar_tpu.pipelines.ad_neuradar_pipeline import ADNeuRadarPipeline, ADNeuRadarPipelineConfig
from neuradar_tpu_torch.data import datamanager as t_dm
from neuradar_tpu_torch.data.dataparsers import synthetic as t_synthetic
from neuradar_tpu_torch.engine import optimizers as t_opt
from neuradar_tpu_torch.engine.trainer import Trainer, TrainerConfig
from neuradar_tpu_torch.model_components import cnns as t_cnns
from neuradar_tpu_torch.model_components import losses as t_losses
from neuradar_tpu_torch.model_components import radar_utils as t_radar
from neuradar_tpu_torch.models import neuradar as t_model
from neuradar_tpu_torch.pipelines import ad_neuradar_pipeline as t_pipeline
from neuradar_tpu_torch.utils import rng as t_rng
from neuradar_tpu_torch.utils.params import load_jax_params
from tests.test_torch_slice import RADAR_FOV, SCENE, perturb, shrink

DM = dict(num_rgb_patches=2, patch_size=4, num_lidar_rays=32, num_radar_scans=2, max_radar_gt=16)
TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=name, **tol)


def _outputs(side):
    parser = SyntheticDataParser if side == "jax" else t_synthetic.SyntheticDataParser
    config = SyntheticDataParserConfig if side == "jax" else t_synthetic.SyntheticDataParserConfig
    out = parser(config(**SCENE)).get_dataparser_outputs()
    out.radar_fov = dict(RADAR_FOV)
    return out


def _train_config(model_cfg):
    """The tiny model with its randomness pinned: no actor flips, no dropout."""
    shrink(model_cfg)
    model_cfg.field.grid.actor.flip_prob = 0.0
    model_cfg.radar_transformer_dropout = 0.0
    return model_cfg


@pytest.fixture(scope="module")
def scenes():
    return _outputs("jax"), _outputs("torch")


# ---------------------------------------------------------------------------- datamanager


@pytest.mark.parametrize("masked", [False, True])
def test_sample_train_batch_bit_equal(scenes, masked):
    """Three consecutive train batches and one eval batch from the same seed: equal bytes and
    dtypes; with pixel masks, patch corners are redrawn by rejection sampling on both sides."""
    outs = list(scenes)
    if masked:
        keep = np.random.RandomState(12).uniform(size=scenes[0].images.shape[:3]) > 0.02
        outs = [dataclasses.replace(o, masks=keep) for o in scenes]
    jm = j_dm.ADDataManager(outs[0], j_dm.ADDataManagerConfig(**DM))
    tm = t_dm.ADDataManager(outs[1], t_dm.ADDataManagerConfig(**DM), "cpu")
    for i in range(3):
        want, got = jm.sample_train_batch(), tm.sample_train_batch()
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"batch {i} {key}")
    want, got = jm.sample_eval_batch(), tm.sample_eval_batch()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"eval {key}")


def test_build_train_bundle(scenes):
    """Rays and metadata of the merged [camera | lidar | radar] train bundle; float32 on both sides."""
    jm = j_dm.ADDataManager(scenes[0], j_dm.ADDataManagerConfig(**DM))
    tm = t_dm.ADDataManager(scenes[1], t_dm.ADDataManagerConfig(**DM), "cpu")
    batch = jm.sample_train_batch()
    assert tm.layout == t_model.SegmentLayout(**jm.layout.__dict__)
    jb = j_dm.build_train_bundle(jm.tables, jax.tree.map(jnp.asarray, batch), jm.layout)
    tb = t_dm.build_train_bundle(tm.tables, t_dm.batch_to_device(batch, "cpu"), tm.layout)
    for name in ("origins", "directions", "pixel_area", "times", "fars", "camera_indices"):
        _close(getattr(tb, name), getattr(jb, name), dict(rtol=1e-6, atol=1e-6), name)
    assert sorted(tb.metadata) == sorted(jb.metadata)
    for key in jb.metadata:
        _close(tb.metadata[key], jb.metadata[key], dict(rtol=1e-6, atol=1e-6), key)


# ---------------------------------------------------------------------------- losses


def _histograms(seed, R=40, S=12):
    rng = np.random.RandomState(seed)
    sdist = np.sort(rng.uniform(0, 1, (R, S + 1)), axis=-1).astype(np.float32)
    sdist[:, 0], sdist[:, -1] = 0.0, 1.0
    w = rng.dirichlet(np.ones(S + 1), R)[:, :S].astype(np.float32)
    return sdist, w


def test_interlevel_and_distortion_losses():
    """zipnerf_interlevel_loss_sdist (value and gradients in the proposal weights) and the
    distortion loss (value and gradient). Tolerance rtol 1e-5 / atol 1e-6 on values (float32,
    sorts and cumulative sums in the same order); rtol 1e-3 on the interlevel gradient, which
    divides by (w + 1e-5)^2 and so magnifies the last-ulp differences of the blurred CDF."""
    levels = [_histograms(s, S=n) for s, n in ((0, 16), (1, 8), (2, 6))]
    sd = [s for s, _ in levels]
    ws = [w for _, w in levels]

    def j_loss(w0, w1):
        return j_losses.zipnerf_interlevel_loss_sdist(sd, [w0, w1, ws[2]])

    want, want_g = jax.value_and_grad(j_loss, argnums=(0, 1))(ws[0], ws[1])
    tw = [torch.from_numpy(w).requires_grad_(True) for w in ws[:2]]
    got = t_losses.zipnerf_interlevel_loss_sdist([torch.from_numpy(s) for s in sd], [*tw, torch.from_numpy(ws[2])])
    got.backward()
    _close(got, want, name="interlevel")
    for g, w, i in zip(tw, want_g, range(2)):
        _close(g.grad, w, dict(rtol=1e-3, atol=1e-6), name=f"interlevel grad {i}")

    want, want_g = jax.value_and_grad(j_losses.distortion_loss_sdist, argnums=1)(sd[2], ws[2])
    w2 = torch.from_numpy(ws[2]).requires_grad_(True)
    got = t_losses.distortion_loss_sdist(torch.from_numpy(sd[2]), w2)
    got.backward()
    _close(got, want, name="distortion")
    _close(w2.grad, want_g, name="distortion grad")


def test_loss_helpers():
    """_blur_stepfun, _sorted_interp_quad, _pulse_width, masked_mean, BCE with logits, and the
    model's _depth_l1_with_nonreturns and _masked_median. Tolerance rtol 1e-5 / atol 1e-6, except
    the blurred density: it is a difference of running sums of y / 2r (tens here), which XLA
    and torch accumulate in different orders, so its absolute error is a few ulp of those sums
    (atol 1e-3)."""
    sdist, w = _histograms(3)
    w_norm = w / np.diff(sdist, axis=-1)
    for i in range(3):
        assert t_losses._pulse_width(i) == j_losses._pulse_width(i)
        got = t_losses._blur_stepfun(torch.from_numpy(sdist), torch.from_numpy(w_norm), t_losses._pulse_width(i))
        want = j_losses._blur_stepfun(sdist, w_norm, j_losses._pulse_width(i))
        _close(got[0], want[0], name=f"blur edges {i}")
        _close(got[1], want[1], dict(rtol=1e-5, atol=1e-3), name=f"blur density {i}")
    x = np.sort(np.random.RandomState(4).uniform(-0.1, 1.1, (40, 9)), axis=-1).astype(np.float32)
    xp, fcdf = sdist, np.cumsum(np.concatenate([np.zeros((40, 1)), w], -1), -1).astype(np.float32)
    fpdf = np.abs(np.random.RandomState(5).normal(size=xp.shape)).astype(np.float32)
    _close(t_losses._sorted_interp_quad(*(torch.from_numpy(a) for a in (x, xp, fpdf, fcdf))),
           j_losses._sorted_interp_quad(x, xp, fpdf, fcdf), name="interp")

    rng = np.random.RandomState(6)
    v = rng.normal(size=50).astype(np.float32) * 5
    mask = rng.uniform(size=50) < 0.6
    _close(t_losses.masked_mean(torch.from_numpy(v), torch.from_numpy(mask)), j_losses.masked_mean(v, mask))
    target = (rng.uniform(size=50) < 0.5).astype(np.float32)
    _close(t_losses.binary_cross_entropy_with_logits(torch.from_numpy(v), torch.from_numpy(target)),
           j_losses.binary_cross_entropy_with_logits(v, target))
    pred, tgt = (rng.uniform(1, 200, (50, 1)).astype(np.float32) for _ in range(2))
    _close(t_model._depth_l1_with_nonreturns(torch.from_numpy(pred), torch.from_numpy(tgt), torch.from_numpy(mask),
                                             150.0, 0.1),
           j_model._depth_l1_with_nonreturns(pred, tgt, mask, 150.0, 0.1))
    for m in (mask, mask[:-1], np.zeros(50, bool)):
        n = len(m)
        _close(t_model._masked_median(torch.from_numpy(v[:n]), torch.from_numpy(m)),
               j_model._masked_median(v[:n], m), name=f"median n={m.sum()}")


def _radar_inputs(seed=7, N=3, G=12, M=40):
    rng = np.random.RandomState(seed)
    gt = rng.normal(0, 5, (N, G, 3)).astype(np.float32)
    mask = rng.uniform(size=(N, G)) < 0.7
    pred = np.concatenate([rng.uniform(0.01, 0.99, (N, M, 1)), rng.normal(0, 5, (N, M, 3)),
                           rng.uniform(0.0005, 2, (N, M, 3))], -1).astype(np.float32)
    return gt, mask, pred


def test_auction_assignment_index_equal():
    """The same cost matrices to both auctions give the same assignment, index for index (the
    port runs 64 rounds batched over scans; the JAX package stops when all rows are assigned)."""
    gt, mask, pred = _radar_inputs()
    for method in ("euclidean", "nll"):
        want_cost = jax.vmap(lambda g, m, p: j_radar.radar_cost_matrix(g, m, p, method))(gt, mask, pred)
        got_cost = t_radar.radar_cost_matrix(*(torch.from_numpy(a) for a in (gt, mask, pred)), method)
        _close(got_cost, want_cost, dict(rtol=1e-5, atol=1e-4), name=f"{method} cost")
        cost = np.asarray(want_cost)
        want = j_radar.solve_assignment(cost, mask, "auction")
        got = t_radar.auction_assignment(torch.from_numpy(cost), torch.from_numpy(mask))
        np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=method)
        assert (_np(got)[mask] >= 0).all()


@pytest.mark.parametrize("training,seed", [(True, 8), (False, 8), (True, 9)])
def test_radar_loss(training, seed):
    """calculate_radar_loss (cost, auction, NLL loss): value and gradient; rtol 1e-5 / atol 1e-6."""
    gt, mask, pred = _radar_inputs(seed=seed)

    def j_loss(p):
        return j_radar.calculate_radar_loss(gt, mask, p, "nll", training, "auction")

    (want, want_assign), want_g = jax.value_and_grad(j_loss, has_aux=True)(pred)
    tp = torch.from_numpy(pred).requires_grad_(True)
    got, got_assign = t_radar.calculate_radar_loss(torch.from_numpy(gt), torch.from_numpy(mask), tp, "nll", training)
    got.backward()
    np.testing.assert_array_equal(_np(got_assign), np.asarray(want_assign))
    _close(got, want, name="radar loss")
    _close(tp.grad, want_g, name="radar grad")
    r, mean, scale = t_radar.mb_split(torch.from_numpy(pred))
    for g, w in zip((r, mean, scale), j_radar.mb_split(pred)):
        _close(g, w)


# ---------------------------------------------------------------------------- batch norm, optimizer


def test_batch_norm_training():
    """Train-mode BasicBlock: output and the updated batch_stats against flax (momentum 0.99,
    biased fast variance). At 2 patches of 4 x 4 (32 pixels) the unbiased variance would be 3 %
    off. Tolerance rtol 1e-5 / atol 1e-5."""
    x = np.random.RandomState(0).normal(1.0, 2.0, size=(2, 4, 4, 8)).astype(np.float32)
    jmod = j_cnns.BasicBlock(dim=8)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params, stats = perturb(variables["params"], variables["batch_stats"])
    want, mutated = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    tmod = t_cnns.BasicBlock(8, 8).train()
    load_jax_params(tmod, params, stats)
    got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(got, want, tol, "output")
    for bn in ("bn1", "bn2"):
        _close(getattr(tmod, bn).running_mean, mutated["batch_stats"][bn]["mean"], tol, f"{bn} mean")
        _close(getattr(tmod, bn).running_var, mutated["batch_stats"][bn]["var"], tol, f"{bn} var")


@pytest.fixture(scope="module")
def pipelines(scenes):
    """The tiny JAX pipeline with perturbed variables, and the port's pipeline holding the same weights."""
    cfg = ADNeuRadarPipelineConfig(datamanager=j_dm.ADDataManagerConfig(**DM))
    _train_config(cfg.model)
    cfg.model.loss.vgg_mult = 0.0
    jpipe = ADNeuRadarPipeline(cfg, scenes[0])
    variables = jpipe.init_variables(0)
    params, batch_stats = perturb(variables["params"], variables["batch_stats"])
    tcfg = t_pipeline.ADNeuRadarPipelineConfig(datamanager=t_dm.ADDataManagerConfig(**DM))
    _train_config(tcfg.model)
    tcfg.model.loss.vgg_mult = 0.0
    tpipe = t_pipeline.ADNeuRadarPipeline(tcfg, scenes[1], "cpu")
    load_jax_params(tpipe.model, params, batch_stats)
    return jpipe, params, batch_stats, tpipe


def _torch_name(path):
    return ".".join(str(p.key) for p in path)


def test_optimizer_groups_and_schedules(pipelines):
    """Every parameter's group label, and each group's learning rate at steps 0, 1, 500, 2500
    and the last (2000), against the JAX package's labels and optax schedules (rtol 1e-6)."""
    jpipe, params, _, tpipe = pipelines
    j_labels = {}
    jax.tree_util.tree_map_with_path(lambda p, _: j_labels.setdefault(tuple(k.key for k in p), None), params)
    want = {k: j_opt.param_group_label(k) for k in j_labels}
    groups_t, groups_j = t_opt.default_optimizer_groups(2001), j_opt.default_optimizer_groups(2001)
    opt = t_opt.GroupedOptimizer(tpipe.model, groups_t)
    for path, label in want.items():
        # flax keeps a Dense's kernel and bias under one module; the port's loader maps both
        prefix = ".".join(path[:-1])
        got = {lab for name, lab in opt.labels.items() if name.startswith(prefix + ".") or name == prefix}
        assert got == {label}, (path, got, label)
    assert set(opt.optimizers) == {"trajectory_opt", "cnn", "fields", "hashgrids", "transformer"}
    for g in groups_t:
        j_sched = groups_j[g].scheduler.build(groups_j[g].optimizer.lr)
        t_sched = groups_t[g].schedule()
        for step in (0, 1, 500, 2500, 2000):
            np.testing.assert_allclose(t_sched(step), float(j_sched(step)), rtol=1e-6, err_msg=f"{g} step {step}")


def test_optimizer_update_on_fixed_gradients(pipelines):
    """One update of every parameter from fixed numpy gradients against the optax transform of
    build_optimizer. Constant rates (no schedules) keep the update well above float32 rounding,
    weight decay is raised to 0.5 / 0.1 so the decoupled AdamW term shows, and the transformer
    group is left out so its parameters must stay frozen. Tolerance rtol 1e-5 / atol 1e-7."""
    _, params, batch_stats, tpipe = pipelines

    def groups(module):
        g = module.default_optimizer_groups(2001)
        for cfg in g.values():
            cfg.scheduler = None
        g["cnn"].optimizer.weight_decay = 0.5
        g["fields"].optimizer.weight_decay = 0.1
        del g["transformer"]
        return g

    rng = np.random.RandomState(11)
    grads = jax.tree.map(lambda x: rng.normal(size=np.shape(x)).astype(np.float32)
                         * (rng.uniform(size=np.shape(x)) < 0.9), params)
    tx = j_opt.build_optimizer(params, groups(j_opt))
    updates, _ = tx.update(grads, tx.init(params), params)
    want = jax.tree.map(lambda p, u: np.asarray(p) + np.asarray(u), params, updates)

    t_model_ = t_model.NeuRadarModel(tpipe.model.config, tpipe.model.scene, _trajectories(tpipe))
    load_jax_params(t_model_, params, batch_stats)
    g_model = t_model.NeuRadarModel(tpipe.model.config, tpipe.model.scene, _trajectories(tpipe))
    load_jax_params(g_model, grads, batch_stats)
    for p, g in zip(t_model_.parameters(), g_model.parameters()):
        p.grad = g.detach().clone()
    opt = t_opt.GroupedOptimizer(t_model_, groups(t_opt))
    opt.step(0)
    w_model = t_model.NeuRadarModel(tpipe.model.config, tpipe.model.scene, _trajectories(tpipe))
    load_jax_params(w_model, want, batch_stats)
    for (name, p), w in zip(t_model_.named_parameters(), w_model.parameters()):
        _close(p, w, dict(rtol=1e-5, atol=1e-7), name)
    frozen = [n for n, lab in opt.labels.items() if lab == "frozen"]
    assert frozen and all(n.startswith("radar_decoder") for n in frozen)


def _trajectories(tpipe):
    from neuradar_tpu_torch.model_components.dynamic_actors import trajectories_from_dicts

    return trajectories_from_dicts(tpipe.outputs.trajectories)


# ---------------------------------------------------------------------------- the whole step


@pytest.fixture(scope="module")
def train_step_results(pipelines):
    """value_and_grad of both sides on one batch with the same jitter."""
    jpipe, params, batch_stats, tpipe = pipelines
    batch = j_dm.ADDataManager(jpipe.outputs, j_dm.ADDataManagerConfig(**DM)).sample_train_batch()
    layout = jpipe.layout
    m = jpipe.config.model
    rng = np.random.RandomState(21)
    jitter = [rng.uniform(size=(layout.total, 1)).astype(np.float32)
              for _ in (*m.sampling.num_proposal_samples, m.sampling.num_nerf_samples)]

    def handout(tag):
        queue = list(jitter)

        def draw(shape):
            arr = queue.pop(0)
            assert tuple(shape) == arr.shape, (tag, shape, arr.shape)
            return arr

        draw.queue = queue
        return draw

    mp = pytest.MonkeyPatch()
    j_draw = handout("jax")
    uniform = jax.random.uniform

    def j_uniform(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        # only the samplers' [R, 1] jitter; any other draw (a flax initializer) passes through
        if tuple(shape) == (layout.total, 1):
            return jnp.asarray(j_draw(shape))
        return uniform(key, shape, dtype, *args, **kwargs)

    mp.setattr(jax.random, "uniform", j_uniform)
    try:
        # jitted: the jitter arrays enter as constants when the step is traced
        loss_fn = jpipe.make_train_loss_fn()
        (j_total, (j_losses_, _, j_stats)), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, batch_stats, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    finally:
        mp.undo()
    mp = pytest.MonkeyPatch()
    t_draw = handout("torch")
    mp.setattr(t_rng, "uniform", lambda generator, shape, device: torch.from_numpy(t_draw(shape)).to(device))
    try:
        model = tpipe.model
        model.train()
        model.zero_grad()
        t_total, t_losses_, _ = tpipe.make_train_loss_fn()(batch, torch.Generator().manual_seed(0))
        t_total.backward()
    finally:
        mp.undo()
    assert not j_draw.queue and not t_draw.queue, "every jitter array was drawn on both sides"
    return (j_total, j_losses_, j_stats, j_grads), (t_total, t_losses_, tpipe)


def test_train_step_losses(train_step_results):
    """The total and every loss term; rtol 1e-4 / atol 1e-6 (float32, summation order)."""
    (j_total, j_losses_, _, _), (t_total, t_losses_, _) = train_step_results
    assert sorted(t_losses_) == sorted(j_losses_)  # JAX returns its aux dict with sorted keys
    for key in j_losses_:
        _close(t_losses_[key], j_losses_[key], dict(rtol=1e-4, atol=1e-6), key)
    _close(t_total, j_total, dict(rtol=1e-4, atol=1e-6), "total")


def test_train_step_gradients(train_step_results):
    """The gradient of every parameter. Tolerance rtol 1e-3, atol 1e-4 of the parameter's largest
    gradient, at least 1e-7: the hash tables receive scatter-added sums in another order, and the
    gradient passes through exp, pow and divisions whose last ulp differs between the frameworks.
    A parameter whose JAX gradient stays under 1e-6 everywhere is taken as nought to rounding (a
    convolution's bias before batch norm has an exact gradient of zero, so both sides hold noise
    alone) and is held to atol 1e-6."""
    (_, _, j_stats, j_grads), (_, _, tpipe) = train_step_results
    model = tpipe.model
    want_model = t_model.NeuRadarModel(model.config, model.scene, _trajectories(tpipe))
    load_jax_params(want_model, j_grads, j_stats)
    n = 0
    for (name, p), w in zip(model.named_parameters(), want_model.parameters()):
        # a parameter the loss never reaches (the radar angle head) has no gradient; JAX's is 0
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = float(w.abs().max())
        _close(got, w, dict(rtol=1e-3, atol=1e-6 if scale < 1e-6 else max(1e-4 * scale, 1e-7)), name)
        n += 1
    assert n == len(list(model.parameters()))
    # the batch-norm statistics were updated the flax way
    for name, buf in model.named_buffers():
        if name.endswith("running_mean") or name.endswith("running_var"):
            _close(buf, dict(want_model.named_buffers())[name], dict(rtol=1e-5, atol=1e-6), name)


def test_ten_port_steps_lower_the_loss(scenes):
    """Ten seeded port steps on the tiny scene (flips and dropout on) lower the eval-mode loss of
    a fixed batch."""
    cfg = TrainerConfig(max_num_iterations=2001, seed=3,
                        pipeline=t_pipeline.ADNeuRadarPipelineConfig(datamanager=t_dm.ADDataManagerConfig(**DM)),
                        optimizers=t_opt.default_optimizer_groups(2001))
    shrink(cfg.pipeline.model)
    cfg.pipeline.model.loss.vgg_mult = 0.0  # 12-pixel patches are too small for VGG-19's four pools
    trainer = Trainer(cfg, scenes[1], "cpu")
    trainer.setup(prefetch=False)
    eval_loss = trainer.pipeline.make_eval_loss_fn()
    batch = trainer.pipeline.datamanager.sample_eval_batch()
    trainer.model.eval()
    before = float(eval_loss(batch)[0])
    for _ in range(10):
        losses, _ = trainer.train_step()
        assert all(np.isfinite(float(v)) for v in losses.values())
    trainer.model.eval()
    assert float(eval_loss(batch)[0]) < before


def test_field_backward_through_actors(scenes):
    """Backward of the main field for rays through the actor boxes: the gradients of the hash
    tables, the MLPs and the actor trajectories (through the sampled box poses), against
    jax.grad. (On the tiny train step above few main-field samples land in an actor box.)
    Tolerance rtol 1e-3, atol 1e-4 of each parameter's largest gradient (scatter order)."""
    from neuradar_tpu.fields import neurad_field as j_field
    from neuradar_tpu.field_components import neurad_encoding as j_ne
    from neuradar_tpu.model_components import dynamic_actors as j_da
    from neuradar_tpu_torch.fields import neurad_field as t_field
    from neuradar_tpu_torch.field_components import neurad_encoding as t_ne
    from neuradar_tpu_torch.model_components import dynamic_actors as t_da
    from tests.test_torch_modules import ACTOR_TIME, _actor_rays, _grid_config, _perturbed, _samples

    scene = scenes[0]
    origins, dirs, times = _actor_rays(scene)
    assert np.all(times == ACTOR_TIME)
    js, ts = _samples(len(origins), 10, origins, dirs)
    j_actors = j_da.DynamicActors(trajectories=j_da.trajectories_from_dicts(scene.trajectories))
    args = (jnp.asarray(times), jnp.asarray(origins), jnp.asarray(dirs))
    a_vars = j_actors.init(jax.random.PRNGKey(0), *args, method=j_da.DynamicActors.get_ray_candidates)
    jc = j_actors.apply(a_vars, *args, method=j_da.DynamicActors.get_ray_candidates)
    jfield = j_field.NeuRADField(config=j_field.NeuRADFieldConfig(grid=_grid_config(j_ne, 12, 10)),
                                 static_scale=100.0, n_actors=2)
    f_vars = _perturbed(jax.jit(jfield.init)(jax.random.PRNGKey(0), js, jc))
    cot = np.random.RandomState(9).normal(size=(len(origins), 10, 32)).astype(np.float32)

    def j_loss(a_params, f_params):
        cands = j_actors.apply({"params": a_params}, *args, method=j_da.DynamicActors.get_ray_candidates)
        return jnp.sum(jfield.apply({"params": f_params}, js, cands)["feature"] * cot)

    want_a, want_f = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(a_vars["params"], f_vars["params"])

    t_actors = t_da.DynamicActors(t_da.trajectories_from_dicts(scenes[1].trajectories))
    tfield = t_field.NeuRADField(t_field.NeuRADFieldConfig(grid=_grid_config(t_ne, 12, 10)), 100.0, 2)
    load_jax_params(tfield, f_vars["params"])
    tc = t_actors.get_ray_candidates(*(torch.from_numpy(a) for a in (times, origins, dirs)))
    (tfield(ts, tc)["feature"] * torch.from_numpy(cot)).sum().backward()
    want_field = t_field.NeuRADField(t_field.NeuRADFieldConfig(grid=_grid_config(t_ne, 12, 10)), 100.0, 2)
    load_jax_params(want_field, want_f)
    pairs = [(f"actors.{k}", getattr(t_actors, k).grad, want_a[k]) for k in ("actor_positions", "actor_rotations_6d")]
    pairs += [(n, p.grad, w) for (n, p), w in zip(tfield.named_parameters(), want_field.parameters())]
    for name, got, want in pairs:
        scale = float(np.abs(_np(want)).max())
        got = np.zeros(np.shape(want), np.float32) if got is None else got  # sdf's beta: no path to "feature"
        _close(got, want, dict(rtol=1e-3, atol=1e-4 * max(scale, 1e-3)), name)
    assert float(np.abs(_np(want_a["actor_positions"])).max()) > 0, "the rays must reach the trajectories"


def test_chunked_recompute_matches_one_chunk(scenes):
    """nff_chunks = 2 with the backward recompute (torch.utils.checkpoint) gives the loss terms
    and gradients of the unchunked step, flips and dropout on: the draws are made before the
    chunks are cut. Tolerance rtol 1e-5, atol 1e-5 of each parameter's largest gradient (the
    chunks add their table gradients in another order)."""
    steps = []
    for chunks in (1, 2):
        cfg = t_pipeline.ADNeuRadarPipelineConfig(datamanager=t_dm.ADDataManagerConfig(**DM))
        shrink(cfg.model)
        cfg.model.loss.vgg_mult = 0.0  # 12-pixel patches are too small for VGG-19's four pools
        cfg.model.nff_chunks = chunks
        pipe = t_pipeline.ADNeuRadarPipeline(cfg, scenes[1], "cpu", seed=5)
        assert pipe.layout.total % 2 == 0
        batch = pipe.datamanager.sample_train_batch()
        total, losses, _ = pipe.make_train_loss_fn()(batch, torch.Generator().manual_seed(9))
        total.backward()
        steps.append((losses, pipe.model))
    (l1, m1), (l2, m2) = steps
    for key in l1:
        _close(l2[key], l1[key], dict(rtol=1e-5, atol=1e-7), key)
    for (name, p1), p2 in zip(m1.named_parameters(), m2.parameters()):
        g1 = p1.grad if p1.grad is not None else torch.zeros_like(p1)
        g2 = p2.grad if p2.grad is not None else torch.zeros_like(p2)
        _close(g2, g1, dict(rtol=1e-5, atol=1e-5 * max(float(g1.abs().max()), 1e-3)), name)
