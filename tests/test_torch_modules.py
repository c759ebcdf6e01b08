"""Module-by-module parity of the port (neuradar_tpu_torch) with the JAX package.

Small widths; inputs are made with numpy from a seed and fed to both sides;
flax parameters go into the port through utils/params.load_jax_params, with
hash tables, biases and batch-norm statistics perturbed first so that a
wrong index or a dropped term shows. Tolerance: float32 on both sides,
rtol 1e-5 / atol 1e-5 unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuradar_tpu.cameras import rays as j_rays
from neuradar_tpu.cameras.cameras import generate_camera_rays as j_generate_camera_rays
from neuradar_tpu.data.datamanager import build_sensor_tables as j_build_sensor_tables
from neuradar_tpu.data.dataparsers.synthetic import SyntheticDataParser, SyntheticDataParserConfig
from neuradar_tpu.field_components import encodings as j_enc
from neuradar_tpu.field_components import neurad_encoding as j_ne
from neuradar_tpu.fields import neurad_field as j_field
from neuradar_tpu.model_components import cnns as j_cnns
from neuradar_tpu.model_components import dynamic_actors as j_da
from neuradar_tpu.model_components import radar_decoder as j_radar
from neuradar_tpu.model_components import ray_samplers as j_samplers
from neuradar_tpu.utils.math import GaussiansStd as JGaussians
from neuradar_tpu_torch.cameras import rays as t_rays
from neuradar_tpu_torch.cameras.cameras import generate_camera_rays as t_generate_camera_rays
from neuradar_tpu_torch.data.datamanager import build_sensor_tables as t_build_sensor_tables
from neuradar_tpu_torch.data.dataparsers import synthetic as t_synthetic
from neuradar_tpu_torch.field_components import encodings as t_enc
from neuradar_tpu_torch.field_components import neurad_encoding as t_ne
from neuradar_tpu_torch.fields import neurad_field as t_field
from neuradar_tpu_torch.model_components import cnns as t_cnns
from neuradar_tpu_torch.model_components import dynamic_actors as t_da
from neuradar_tpu_torch.model_components import radar_decoder as t_radar
from neuradar_tpu_torch.model_components import ray_samplers as t_samplers
from neuradar_tpu_torch.utils.math import GaussiansStd as TGaussians
from neuradar_tpu_torch.utils.params import load_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)
# Under jit, XLA fuses the position arithmetic and rounds it differently. At the
# finest grid level (resolution 8192, table entries ~0.1) a one-ulp position
# difference moves a feature by ~1e-5, so grid features get 1e-4.
GRID_TOL = dict(rtol=1e-4, atol=1e-4)
SCENE = dict(num_frames=8, image_height=24, image_width=36, lidar_points_per_scan=64)
ACTOR_TIME = 1.0


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=name, **tol)


def _perturbed(tree, seed=0):
    """Hash tables N(0, 0.1); biases, norm scales and running stats moved off their init values."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x)
        name = path[-1].key
        if name == "hash_table":
            return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        if name in ("bias", "scale", "mean"):
            return (x + rng.normal(0.0, 0.1, x.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def scene():
    return SyntheticDataParser(SyntheticDataParserConfig(**SCENE)).get_dataparser_outputs()


def _actor_rays(scene, n=24, seed=0):
    """Rays that start 10 m behind an actor box and run through it at ACTOR_TIME."""
    rng = np.random.RandomState(seed)
    traj = scene.trajectories
    centers = []
    for t in traj:
        i = int(np.argmin(np.abs(np.asarray(t["timestamps"]) - ACTOR_TIME)))
        centers.append(np.asarray(t["poses"])[i, :3, 3])
    which = np.arange(n) % len(centers)
    origins = np.stack([centers[a] for a in which]) + np.array([-10.0, 0.0, 0.0]) + rng.normal(0, 0.3, (n, 3))
    dirs = np.array([1.0, 0.0, 0.0]) + rng.normal(0, 0.03, (n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    times = np.full((n,), ACTOR_TIME, np.float32)
    return origins.astype(np.float32), dirs.astype(np.float32), times


@pytest.fixture(scope="module")
def actor_rays(scene):
    """Rays through the actor boxes with both sides' actor candidates: (origins, dirs, jax, torch)."""
    origins, dirs, times = _actor_rays(scene)
    return (origins, dirs, *_candidates(scene, origins, dirs, times))


def _candidates(scene, origins, dirs, times):
    traj = j_da.trajectories_from_dicts(scene.trajectories)
    jmod = j_da.DynamicActors(trajectories=traj)
    jvars = jmod.init(jax.random.PRNGKey(0), jnp.asarray(times), jnp.asarray(origins), jnp.asarray(dirs),
                      method=j_da.DynamicActors.get_ray_candidates)
    jc = jmod.apply(jvars, jnp.asarray(times), jnp.asarray(origins), jnp.asarray(dirs),
                    method=j_da.DynamicActors.get_ray_candidates)
    tmod = t_da.DynamicActors(t_da.trajectories_from_dicts(scene.trajectories))
    tc = tmod.get_ray_candidates(torch.from_numpy(times), torch.from_numpy(origins), torch.from_numpy(dirs))
    return jc, tc


def _samples(n_rays, n_samples, origins, dirs, seed=1, t0=5.0, t1=15.0):
    """Sorted sample bins along each ray, as both frameworks' RaySamples."""
    rng = np.random.RandomState(seed)
    edges = np.sort(rng.uniform(t0, t1, (n_rays, n_samples + 1)), axis=1).astype(np.float32)
    area = rng.uniform(1e-6, 1e-4, (n_rays, 1)).astype(np.float32)
    starts, ends = edges[:, :-1, None], edges[:, 1:, None]
    jb = j_rays.RayBundle(origins=jnp.asarray(origins), directions=jnp.asarray(dirs), pixel_area=jnp.asarray(area))
    tb = t_rays.RayBundle(origins=torch.from_numpy(origins), directions=torch.from_numpy(dirs),
                          pixel_area=torch.from_numpy(area))
    return (jb.get_ray_samples(jnp.asarray(starts), jnp.asarray(ends)),
            tb.get_ray_samples(torch.from_numpy(starts), torch.from_numpy(ends)))


@pytest.mark.parametrize("d", [3, 4])
def test_hash_encoding(d):
    """3-D static grid and 4-D actor grid (the fourth hash prime); float32-floored scalings."""
    kw = dict(num_levels=5, min_res=16, max_res=512, log2_hashmap_size=10, features_per_level=2, n_input_dims=d)
    pos = np.random.RandomState(d).uniform(0.0, 1.0, (500, d)).astype(np.float32)
    jmod = j_enc.HashEncoding(**kw)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(pos)))
    want = jmod.apply(params, jnp.asarray(pos))
    tmod = t_enc.HashEncoding(**kw)
    load_jax_params(tmod, params["params"])
    assert tmod.scalings == tuple(float(s) for s in jmod.bind(params).scalings)
    _close(tmod(torch.from_numpy(pos)), want)


def test_sh_encoding():
    dirs = np.random.RandomState(0).normal(size=(100, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    want = j_enc.SHEncoding(levels=4).apply({}, jnp.asarray(dirs))
    _close(t_enc.SHEncoding(levels=4)(torch.from_numpy(dirs)), want, dict(rtol=1e-6, atol=1e-6))


def test_actor_candidates(actor_rays):
    _, _, jc, tc = actor_rays
    assert bool(tc.valid.any()), "the rays must pass actors for this test to mean anything"
    np.testing.assert_array_equal(_np(tc.valid), _np(jc.valid))
    np.testing.assert_array_equal(_np(tc.actor_id), _np(jc.actor_id))
    for name in ("w2b", "center", "bounds", "radius"):
        _close(getattr(tc, name), getattr(jc, name), name=name)


def _grid_config(module, static_log2, actor_log2, **static):
    s = module.StaticSettings(log2_hashmap_size=static_log2, **static)
    a = module.ActorSettings(log2_hashmap_size=actor_log2, hashgrid_dim=static.get("hashgrid_dim", 4))
    return module.NeuRADHashEncodingConfig(static=s, actor=a)


def test_neurad_encoding_with_actors(actor_rays):
    origins, dirs, jc, tc = actor_rays
    js, ts = _samples(len(origins), 12, origins, dirs)
    jg = js.frustums.get_fast_isotropic_gaussian(1)
    jg = JGaussians(mean=jg.mean[..., 0, :], std=jg.std[..., 0, :])
    tg = ts.frustums.get_fast_isotropic_gaussian(1)
    tg = TGaussians(mean=tg.mean[..., 0, :], std=tg.std[..., 0, :])
    jdirs = jnp.broadcast_to(jnp.asarray(dirs)[:, None], jg.mean.shape)

    jmod = j_ne.NeuRADHashEncoding(config=_grid_config(j_ne, 12, 10), static_scale=100.0, n_actors=2)
    params = _perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(0), jg, jc, jdirs))
    jf, jd = jax.jit(jmod.apply)(params, jg, jc, jdirs)
    tmod = t_ne.NeuRADHashEncoding(_grid_config(t_ne, 12, 10), static_scale=100.0, n_actors=2)
    load_jax_params(tmod, params["params"])
    tf, td = tmod(tg, tc, torch.from_numpy(np.array(jdirs)))
    has_actor = _np(t_da.assign_samples_to_actors(tc, tg.mean)[1])
    assert 0 < has_actor.mean() < 1, "samples both inside and outside the actor boxes"
    _close(tf, jf, GRID_TOL, name="features")
    _close(td, jd, name="directions")


def test_neurad_field(actor_rays):
    origins, dirs, jc, tc = actor_rays
    js, ts = _samples(len(origins), 10, origins, dirs)
    jcfg = j_field.NeuRADFieldConfig(grid=_grid_config(j_ne, 12, 10))
    jmod = j_field.NeuRADField(config=jcfg, static_scale=100.0, n_actors=2)
    params = _perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(0), js, jc))
    want = jax.jit(jmod.apply)(params, js, jc)
    tmod = t_field.NeuRADField(t_field.NeuRADFieldConfig(grid=_grid_config(t_ne, 12, 10)), 100.0, 2)
    load_jax_params(tmod, params["params"])
    got = tmod(ts, tc)
    for key in ("feature", "sdf", "alpha"):
        _close(got[key], want[key], GRID_TOL, name=key)


def test_proposal_field(actor_rays):
    origins, dirs, jc, tc = actor_rays
    js, ts = _samples(len(origins), 10, origins, dirs)
    jcfg = j_field.NeuRADProposalFieldConfig(grid=_grid_config(j_ne, 11, 9, num_levels=6, base_res=128,
                                                                 max_res=4096, hashgrid_dim=1))
    jmod = j_field.NeuRADProposalField(config=jcfg, static_scale=100.0, n_actors=2)
    params = _perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(0), js, jc))
    tcfg = t_field.NeuRADProposalFieldConfig(grid=_grid_config(t_ne, 11, 9, num_levels=6, base_res=128,
                                                                 max_res=4096, hashgrid_dim=1))
    tmod = t_field.NeuRADProposalField(tcfg, 100.0, 2)
    load_jax_params(tmod, params["params"])
    _close(tmod(ts, tc), jax.jit(jmod.apply)(params, js, jc), GRID_TOL)


def _density(t_mid):
    """A smooth stand-in for a proposal field: a surface near 30 m plus haze."""
    return 0.05 + 4.0 * np.exp(-((t_mid - 30.0) ** 2) / 8.0)


def test_proposal_sampler_chain():
    """power sampler -> two PDF rounds (16, 8) -> 6 NeRF samples, deterministic (eval)."""
    rng = np.random.RandomState(3)
    n = 40
    origins = rng.normal(size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    area = np.full((n, 1), 1e-5, np.float32)
    nears, fars = np.zeros((n, 1), np.float32), np.full((n, 1), 2000.0, np.float32)
    jb = j_rays.RayBundle(*(jnp.asarray(x) for x in (origins, dirs, area, nears, fars)))
    tb = t_rays.RayBundle(*(torch.from_numpy(x) for x in (origins, dirs, area, nears, fars)))

    def j_density(rs):
        t = (rs.frustums.starts + rs.frustums.ends) / 2
        return 0.05 + 4.0 * jnp.exp(-((t - 30.0) ** 2) / 8.0)

    def t_density(rs):
        t = (rs.frustums.starts + rs.frustums.ends) / 2
        return 0.05 + 4.0 * torch.exp(-((t - 30.0) ** 2) / 8.0)

    jr, jw = jax.jit(lambda b: j_samplers.proposal_network_sampler(
        b, [j_density, j_density], (16, 8), 6, rng=None,
        initial_sampler=lambda rb, k, rng=None, single_jitter=True: j_samplers.power_sampler(rb, k, rng, single_jitter),
    )[:2])(jb)
    tr, tw, _ = t_samplers.proposal_network_sampler(tb, [t_density, t_density], (16, 8), 6)
    for name in ("starts", "ends"):
        _close(getattr(tr.frustums, name), getattr(jr.frustums, name), dict(rtol=1e-4, atol=1e-4), name=name)
    for i, (g, w) in enumerate(zip(tw, jw)):
        _close(g, w, dict(rtol=1e-4, atol=1e-6), name=f"weights round {i}")
    # the PDF rounds pulled every sample from the 2,000 m far plane towards the surface
    assert _np(tr.frustums.ends).max() < 100.0


def test_rgb_decoder():
    """NHWC in and out; covers conv HWIO -> OIHW, the unflipped flax ConvTranspose and BatchNorm statistics."""
    x = np.random.RandomState(0).normal(size=(2, 5, 6, 12)).astype(np.float32)
    jmod = j_cnns.RGBDecoder(hidden_dim=8, upsample_factor=3)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params, stats = _perturbed(variables["params"]), _perturbed(variables["batch_stats"], seed=1)
    want = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    tmod = t_cnns.RGBDecoder(12, hidden_dim=8, upsample_factor=3).eval()
    load_jax_params(tmod, params, stats)
    got = tmod(torch.from_numpy(x))
    assert got.shape == (2, 15, 18, 3)
    _close(got, want, name="rgb")


@pytest.mark.parametrize("feature_scale", [1.0, 0.003])
def test_radar_decoder(feature_scale):
    """At feature scale 0.003 the variance (~1e-5) is near the LayerNorm epsilon: flax's 1e-6, not torch's 1e-5."""
    rng = np.random.RandomState(0)
    feats = (feature_scale * rng.normal(size=(2, 70, 48))).astype(np.float32)
    geometry = rng.normal(0, 10, size=(2, 70, 3)).astype(np.float32)
    jmod = j_radar.RadarDecoder(d_model=48, dropout=0.0, attn_impl="flax")
    params = _perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(geometry)))
    want_out, want_ang = jax.jit(jmod.apply)(params, jnp.asarray(feats), jnp.asarray(geometry))
    tmod = t_radar.RadarDecoder(d_model=48)
    load_jax_params(tmod, params["params"])
    got_out, got_ang = tmod(torch.from_numpy(feats), torch.from_numpy(geometry))
    _close(got_out, want_out, dict(rtol=1e-4, atol=1e-5), name="radar_output")
    _close(got_ang, want_ang, dict(rtol=1e-4, atol=1e-5), name="angles")


@pytest.fixture(scope="module")
def tables(scene):
    t_out = t_synthetic.SyntheticDataParser(t_synthetic.SyntheticDataParserConfig(**SCENE)).get_dataparser_outputs()
    return j_build_sensor_tables(scene), t_build_sensor_tables(t_out, torch.device("cpu"))


def _bundles_close(tb, jb, keys):
    for name in ("origins", "directions", "pixel_area", "times", "fars"):
        _close(getattr(tb, name), getattr(jb, name), dict(rtol=1e-6, atol=1e-6), name=name)
    for key in keys:
        _close(tb.metadata[key], jb.metadata[key], dict(rtol=1e-6, atol=1e-6), name=key)


def test_camera_rays(tables):
    jt, tt = tables
    rng = np.random.RandomState(0)
    cam = rng.randint(0, SCENE["num_frames"], 50)
    coords = np.stack([rng.randint(0, 24, 50), rng.randint(0, 36, 50)], axis=1)
    jb = j_generate_camera_rays(jt.cameras, jnp.asarray(cam), jnp.asarray(coords))
    tb = t_generate_camera_rays(tt.cameras, torch.from_numpy(cam), torch.from_numpy(coords))
    _bundles_close(tb, jb, ("sensor_idxs", "directions_norm"))


def test_lidar_rays(tables, scene):
    jt, tt = tables
    pts = scene.lidar_points[2][:40]
    idx = np.full(40, 2)
    jb = jt.lidars.generate_rays(jnp.asarray(idx), jnp.asarray(pts))
    tb = tt.lidars.generate_rays(torch.from_numpy(idx), torch.from_numpy(pts))
    _bundles_close(tb, jb, ("sensor_idxs", "directions_norm", "did_return"))


def test_radar_rays(tables):
    jt, tt = tables
    assert tt.radars.rays_per_scan == jt.radars.rays_per_scan == 3531  # ZOD FoV, 107 x 33
    jb = jt.radars.generate_rays(jnp.asarray([1, 4]))
    tb = tt.radars.generate_rays(torch.tensor([1, 4]))
    _bundles_close(tb, jb, ("sensor_idxs", "directions_spher", "did_return"))
