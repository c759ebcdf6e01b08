"""Splatfacto (3D Gaussian splatting) of the port against the JAX package and against the
benchmark's plain reference, at a tiny size on the CPU, where the port runs K5's plain version
(``ops/splat.render_plain``).

Against the JAX package (``neuradar_tpu/models/splatfacto.py`` and its trainer): the projection,
the colours at SH degree 0-3, the render on tiles with fewer gaussians than K, on tiles that overflow
K, on depth ties at the cut and against the JAX package's chunked scoring, the loss and every
gradient with the screen-space mean gradient, refine and the opacity reset, and three train steps
with a refine after each and an opacity reset (parameters, alive mask, statistics and Adam's moments,
reset for the refreshed slots only). Against ``benchmark/reference/nrref/splatfacto.py``: the render,
loss and gradients, and three steps past ``stop_split_at``. Then the train command on splatfacto
through ``SplatfactoTrainer.train_step`` and ``exporter.py gaussian-ply`` on its run. Each test states
its tolerance.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuradar_tpu.data.dataparsers.synthetic import SyntheticDataParser as JParser
from neuradar_tpu.data.dataparsers.synthetic import SyntheticDataParserConfig as JParserConfig
from neuradar_tpu.engine.splatfacto_trainer import SplatfactoTrainer as JTrainer
from neuradar_tpu.engine.splatfacto_trainer import SplatfactoTrainerConfig as JTrainerConfig
from neuradar_tpu.models import splatfacto as jsf
from neuradar_tpu_torch.data.dataparsers.synthetic import SyntheticDataParser, SyntheticDataParserConfig
from neuradar_tpu_torch.engine import splatfacto_trainer as st
from neuradar_tpu_torch.models import splatfacto as sf
from neuradar_tpu_torch.scripts import exporter as exporter_script
from neuradar_tpu_torch.scripts import train as train_script

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark"))
from reference.nrref.splatfacto import SplatReference, SplatSettings  # noqa: E402

H, W = 40, 56  # 3 x 4 tiles, the canvas cropped
G = 256
SCENE = dict(num_frames=4, image_height=32, image_width=48, lidar_points_per_scan=64)
# float32 sums in another order: the image and loss to 1e-5; a gradient leaf by its relative L2 gap,
# 1e-4 (the means' and scales' gradients cancel across a gaussian's pixels, which amplifies rounding)
IMAGE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_GAP = 1e-4


def _rotation(rv) -> np.ndarray:
    """Rodrigues' rotation of the rotation vector ``rv``."""
    th = np.linalg.norm(rv)
    k = np.asarray(rv) / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _gaussians(n=G, seed=0, degree=3):
    """Random gaussians mostly in front of the camera, a few behind it and a tenth dead."""
    rng = np.random.RandomState(seed)
    means = rng.randn(n, 3) * [2.5, 2.0, 1.5] + [0.0, 0.0, -8.0]
    means[:6, 2] = rng.uniform(-1.0, 3.0, 6)  # at, near and behind the camera's plane
    p = {"means": means, "log_scales": np.log(rng.uniform(0.15, 0.6, (n, 3))), "quats": rng.randn(n, 4),
         "opacity_logits": rng.randn(n, 1), "rgb_logits": rng.randn(n, 3)}
    if degree > 0:
        p["sh_rest"] = rng.randn(n, 3 * sf.sh_num_rest(degree)) * 0.2
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, np.arange(n) < int(0.9 * n)


def _camera():
    w2c = np.concatenate([_rotation([0.05, -0.1, 0.03]), [[0.2], [-0.1], [0.3]]], 1).astype(np.float32)
    return {"fx": 45.0, "fy": 45.0, "cx": W / 2, "cy": H / 2, "height": H, "width": W}, w2c


def _both(p, alive):
    return ({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(alive),
            {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}, torch.as_tensor(alive))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gap(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_projection_matches_jax():
    """Every gaussian's in-view test exactly; the 2D mean, covariance, depth and radius of those in
    view to 1e-5 (float32, products in another order). Those at depth 0.1 or less are never in view
    and the port projects them at depth 1 (their values are not compared; they are finite)."""
    p, alive = _gaussians()
    cam, w2c = _camera()
    jp, ja, tp, ta = _both(p, alive)
    args = (cam["fx"], cam["fy"], cam["cx"], cam["cy"], W, H)
    want = jsf.project_gaussians(jp, ja, jnp.asarray(w2c), *args)
    got = sf.project_gaussians(tp, ta, torch.as_tensor(w2c), *args)
    iv = np.asarray(want[4])
    np.testing.assert_array_equal(_np(got[4]), iv)
    assert 100 < iv.sum() < G and np.isfinite(_np(got[1])).all()
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(_np(g)[iv], np.asarray(w)[iv], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_colors_match_jax(degree):
    """The DC colour plus the SH bands at the centre-to-camera direction, clamped below at 0, to
    1e-6."""
    p, alive = _gaussians(degree=degree)
    jp, _, tp, _ = _both(p, alive)
    origin = np.array([0.3, -0.2, 0.5], np.float32)
    want = jsf.gaussian_colors(jp, jnp.asarray(origin), degree)
    got = sf.gaussian_colors(tp, torch.as_tensor(origin), degree)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def _render_case(case):
    """(params, alive, top_k, the JAX package's score chunk) of a render case."""
    p, alive = _gaussians()
    if case == "depth_ties":  # 32 pairs of gaussians at one mean: equal depths, other colours
        p["means"][40:72] = p["means"][8:40]
    top_k = {"fewer_than_k": 256, "overflow": 8, "depth_ties": 12, "chunked": 16}[case]
    return p, alive, top_k, 96 if case == "chunked" else 0


@pytest.mark.parametrize("case", ["fewer_than_k", "overflow", "depth_ties", "chunked"])
def test_rasterize_matches_jax(case):
    """The image, alpha and depth to IMAGE_TOL and the share of overflowing tiles exactly; the JAX
    package's chunked scoring (3 chunks of 96, the last clamped) lists the same gaussians."""
    p, alive, top_k, chunk = _render_case(case)
    cam, w2c = _camera()
    jp, ja, tp, ta = _both(p, alive)
    args = (cam["fx"], cam["fy"], cam["cx"], cam["cy"], H, W, top_k)
    want = jsf.rasterize(jp, ja, jnp.asarray(w2c), *args, sh_degree=3, score_chunk=chunk)
    got = sf.rasterize(tp, ta, torch.as_tensor(w2c), *args, sh_degree=3)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(_np(g), np.asarray(w), **IMAGE_TOL)
    assert got[3][3] == pytest.approx(float(want[3][3]))
    assert (got[3][3] > 0) == (case in ("overflow", "depth_ties", "chunked"))


def test_loss_and_gradients_match_jax():
    """0.8 L1 + 0.2 (1 - SSIM) to 1e-6 relative; every parameter's gradient and the screen-space
    mean gradient (the zero offset's) to GRAD_GAP."""
    p, alive = _gaussians()
    cam, w2c = _camera()
    config = sf.SplatfactoConfig(max_gaussians=G, tile_top_k=24)
    jconfig = jsf.SplatfactoConfig(max_gaussians=G, tile_top_k=24)
    gt = np.random.RandomState(5).rand(H, W, 3).astype(np.float32)
    jp, ja, tp, ta = _both(p, alive)

    def loss_fn(params, off):
        return jsf.splat_loss(jconfig, params, {"alive": ja}, {**cam, "w2c": jnp.asarray(w2c)}, jnp.asarray(gt),
                              mean2d_offset=off)[0]

    want, (gp, goff) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(jp, jnp.zeros((G, 2), jnp.float32))
    off = torch.zeros(G, 2, requires_grad=True)
    got, _ = sf.splat_loss(config, tp, ta, {**cam, "w2c": torch.as_tensor(w2c)}, torch.as_tensor(gt),
                           mean2d_offset=off)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    for k in p:
        assert _gap(tp[k].grad, gp[k]) < GRAD_GAP, k
    assert _gap(off.grad, goff) < GRAD_GAP and np.abs(np.asarray(goff)).max() > 0


def _refine_state(seed=1):
    """Gaussians with densification statistics: some to split (larger than 2), some to clone, some
    to cull (transparent or larger than 10) and free slots."""
    p, alive = _gaussians(seed=seed)
    rng = np.random.RandomState(seed)
    p["log_scales"][:20] = np.log(3.0)  # split if wanted
    p["log_scales"][20:24] = np.log(12.0)  # culled once the scale cull is on
    p["opacity_logits"][24:40] = -8.0  # culled
    accum = rng.uniform(0.0, 2e-3, G).astype(np.float32)
    count = rng.randint(0, 4, G).astype(np.float32)
    return p, alive, accum, count


@pytest.mark.parametrize("step", [None, 3500, 15000])
def test_refine_and_opacity_reset_match_jax(step):
    """Cull, clone and split into free slots (the split noise the JAX package draws, handed to the
    port), and the opacity reset: parameters to 1e-6, the alive mask and the refreshed slots exactly,
    the statistics zeroed."""
    p, alive, accum, count = _refine_state()
    config = sf.SplatfactoConfig(max_gaussians=G)
    jconfig = jsf.SplatfactoConfig(max_gaussians=G)
    key = jax.random.PRNGKey(3)
    jstate = {"alive": jnp.asarray(alive), "grad_accum": jnp.asarray(accum), "grad_count": jnp.asarray(count)}
    jparams, jstate_after, jrefreshed = jsf.refine_gaussians(jconfig, {k: jnp.asarray(v) for k, v in p.items()}, jstate,
                                                             key, None if step is None else jnp.int32(step))
    noise = torch.as_tensor(np.array(jax.random.normal(key, (G, 3))))
    tp = {k: torch.as_tensor(v.copy()) for k, v in p.items()}
    tstate = {"alive": torch.as_tensor(alive.copy()), "grad_accum": torch.as_tensor(accum.copy()),
              "grad_count": torch.as_tensor(count.copy())}
    refreshed = sf.refine_gaussians(config, tp, tstate, noise, step)
    np.testing.assert_array_equal(_np(refreshed), np.asarray(jrefreshed))
    np.testing.assert_array_equal(_np(tstate["alive"]), np.asarray(jstate_after["alive"]))
    assert (step == 15000) == (not _np(refreshed).any())
    for k in p:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jparams[k]), rtol=1e-6, atol=1e-6, err_msg=k)
    assert not _np(tstate["grad_accum"]).any() and not _np(tstate["grad_count"]).any()
    sf.reset_opacities(config, tp)
    np.testing.assert_allclose(_np(tp["opacity_logits"]),
                               np.asarray(jsf.reset_opacities(jconfig, jparams)["opacity_logits"]), rtol=1e-7)


def _tiny_trainers(tmp_path, model_kw, seed=7):
    """The JAX trainer and the port's on the same tiny synthetic scene and config."""
    jcfg = JTrainerConfig(model=jsf.SplatfactoConfig(**model_kw), seed=seed, output_dir=str(tmp_path / "jax"),
                          steps_per_eval_all_images=0)
    jt = JTrainer(jcfg, dataparser_outputs=JParser(JParserConfig(**SCENE)).get_dataparser_outputs())
    jt.setup()
    tcfg = st.SplatfactoTrainerConfig(model=sf.SplatfactoConfig(**model_kw), seed=seed,
                                      output_dir=str(tmp_path / "port"), steps_per_eval_all_images=0)
    tt = tcfg.setup(SyntheticDataParser(SyntheticDataParserConfig(**SCENE)).get_dataparser_outputs(), "cpu")
    return jt, tt


def test_three_train_steps_match_jax(tmp_path):
    """Three steps, then a refine (densification on, free slots) and an opacity reset after the
    third, the split noise the JAX trainer draws handed to the port: the alive mask exactly,
    parameters and Adam's moments by their relative L2 gap (1e-4 for the parameters; 1e-3 for the
    moments, whose squares double a gradient's gap and whose refreshed slots restart from zero on
    both sides). One refine: a second would rank the first one's copies, whose statistics tie but
    for rounding, and copy other sources on either side."""
    model_kw = dict(max_gaussians=512, tile_top_k=32, warmup_steps=0, refine_every=2, reset_alpha_every=1,
                    densify_grad_thresh=1e-6)
    jt, tt = _tiny_trainers(tmp_path, model_kw)
    np.testing.assert_array_equal(_np(tt.model.alive), np.asarray(jt.state["alive"]))
    seeded = int(tt.model.alive.sum())
    assert 0 < seeded < 512
    key = [jax.random.PRNGKey(jt.config.seed)]

    def jax_noise():  # the JAX trainer's draw: key, sub = split(key), normal(sub, (G, 3))
        key[0], sub = jax.random.split(key[0])
        return torch.as_tensor(np.array(jax.random.normal(sub, (512, 3))))

    tt.refine_noise = jax_noise
    jt.train(3)
    for _ in range(3):
        tt.train_step()
    np.testing.assert_array_equal(_np(tt.model.alive), np.asarray(jt.state["alive"]))
    assert int(tt.model.alive.sum()) > seeded  # densified into free slots
    for k, v in tt.model.params.items():
        assert _gap(v, jt.params[k]) < 1e-4, k
    inner = jt.opt_state.inner_states
    for k, opt in tt.optimizer.optimizers.items():
        state = opt.state[opt.param_groups[0]["params"][0]]
        adam = inner[k].inner_state[0]
        assert _gap(state["exp_avg"], adam.mu[k]) < 1e-3, k
        assert _gap(state["exp_avg_sq"], adam.nu[k]) < 1e-3, k
        assert int(state["step"]) == int(adam.count), k


def _reference(trainer, lowered=False):
    mc, cfg = trainer.config.model, trainer.config
    lrs = cfg.learning_rates()
    settings = SplatSettings(top_k=mc.tile_top_k, sh_degree=mc.sh_degree, ssim_lambda=mc.ssim_lambda,
                             learning_rates=lrs, cull_alpha_thresh=mc.cull_alpha_thresh,
                             cull_scale_thresh=mc.cull_scale_thresh, refine_every=mc.refine_every,
                             warmup_steps=mc.warmup_steps, reset_alpha_every=mc.reset_alpha_every,
                             stop_split_at=mc.stop_split_at)
    return SplatReference(settings, trainer.images.numpy(), trainer.w2cs.numpy(), trainer.outputs.intrinsics, "cpu",
                          tiles_per_block=4, lowered=lowered)


def test_port_matches_the_benchmark_reference(tmp_path):
    """The port's plain path against ``nrref/splatfacto.py`` from the same gaussians: the loss to
    1e-6, the image to IMAGE_TOL and every gradient to GRAD_GAP; then three steps from step 15,000
    (a refine after the first that only culls): losses to 1e-5 and parameters to 1e-4 by their
    relative L2 gap. The reference in bf16 is further than 1e-2 on every gradient."""
    model_kw = dict(max_gaussians=1024, tile_top_k=32)
    _, tt = _tiny_trainers(tmp_path, model_kw)
    p, _ = _gaussians(n=1024, seed=2)
    p["means"] = p["means"] * [2.0, 0.5, 3.0] + [20.0, 0.0, 0.0]  # ahead of the cameras, which look down +x
    with torch.no_grad():
        for k, v in tt.model.params.items():
            v.copy_(torch.as_tensor(p[k]))
        tt.model.alive.fill_(True)
    start = {k: v.detach().clone() for k, v in tt.model.params.items()}
    alive = torch.ones(1024, dtype=torch.bool)
    ref = _reference(tt)
    loss_r, grads_r, image_r = ref.loss_and_grads(start, alive, 0)
    loss_p, out = sf.splat_loss(tt.config.model, tt.model.params, tt.model.alive, tt.camera(0), tt.ground_truth(0))
    loss_p.backward()
    assert float(loss_p.detach()) == pytest.approx(loss_r, rel=1e-6)
    np.testing.assert_allclose(_np(out["rgb"]), _np(image_r), **IMAGE_TOL)
    for k, v in tt.model.params.items():
        assert _gap(v.grad, grads_r[k]) < GRAD_GAP, k
    low = _reference(tt, lowered=True).loss_and_grads(start, alive, 0)[1]
    assert all(_gap(low[k], grads_r[k]) > 1e-2 for k in grads_r), {k: _gap(low[k], grads_r[k]) for k in low}

    tt.step = 15000
    images, draw = [], tt.next_image
    tt.next_image = lambda: images.append(draw()) or images[-1]
    losses = [float(tt.train_step()[0]["total"]) for _ in range(3)]
    follow = ref.follow(start, alive, images, 15000)
    np.testing.assert_allclose(losses, follow["losses"], rtol=1e-5)
    for k, v in tt.model.params.items():
        assert _gap(v - start[k], follow["after"][k] - start[k]) < 1e-4, k


def test_train_command_and_gaussian_ply(tmp_path, monkeypatch):
    """``train.py splatfacto`` trains through SplatfactoTrainer.train_step (once a step) and writes
    gaussians.npz; ``exporter.py gaussian-ply`` writes the standard 3DGS PLY of it: its header names
    62 float properties (position, normal, 3 DC, 45 SH rest, opacity, 3 scales, 4 rotations) and its
    vertex count is the run's alive gaussians."""
    calls = []
    real = st.SplatfactoTrainer.train_step
    monkeypatch.setattr(st.SplatfactoTrainer, "train_step", lambda self: calls.append(self.step) or real(self))
    argv = ["splatfacto", "--device", "cpu", "--max_num_iterations", "3", "--output_dir", str(tmp_path),
            "--experiment_name", "t", "--model.max_gaussians", "1024", "--model.tile_top_k", "16",
            "--steps_per_eval_all_images", "0"] + sum(([f"--dataparser.{k}", str(v)] for k, v in SCENE.items()), [])
    assert train_script.main(argv) == 0
    assert calls == [0, 1, 2]
    run_dir = tmp_path / "t" / "splatfacto"
    with np.load(run_dir / "gaussians.npz") as z:
        alive = int(z["state_alive"].sum())
        assert int(z["step"]) == 3 and z["param_sh_rest"].shape == (1024, 45)
    ply = tmp_path / "splat.ply"
    assert exporter_script.main(["gaussian-ply", "--load-config", str(run_dir), "--output-path", str(ply)]) == 0
    data = ply.read_bytes()
    head, body = data.split(b"end_header\n", 1)
    lines = head.decode().splitlines()
    assert lines[:3] == ["ply", "format binary_little_endian 1.0", f"element vertex {alive}"]
    props = [line.split()[-1] for line in lines[3:]]
    assert props[:9] == ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"] and len(props) == 62
    assert props[-8:] == ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"]
    assert len(body) == alive * 62 * 4 and np.isfinite(np.frombuffer(body, "<f4")).all()
