"""The port's shifted-view FID evals against the JAX package's.

``frechet_distance`` (numpy and scipy on both sides) on seeded features; ``FeatureExtractor`` with the
JAX package's VGG-19 filters loaded (its seeded random ones: the two packages draw their random
filters from other generators); the actor edits (``ActorEdits``, ``_apply_edits``,
``get_boxes2world(edits)``) against the JAX module's; ``render_camera`` with an origin shift and with
actor edits against the JAX pipeline's on the tiny scene of tests/test_torch_slice.py;
``compute_fid_metrics(max_frames=2)`` against the JAX pipeline's with the JAX filters on both sides;
and a tiny train command whose ``calc_fid_steps`` falls inside the run. Each test states its
tolerance.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuradar_tpu.data.dataparsers.base import linspaced_split
from neuradar_tpu.model_components import dynamic_actors as j_da
from neuradar_tpu.model_components import fid as j_fid
from neuradar_tpu_torch.data.dataparsers import synthetic as t_synthetic
from neuradar_tpu_torch.model_components import dynamic_actors as t_da
from neuradar_tpu_torch.model_components import fid as t_fid
from neuradar_tpu_torch.pipelines import ad_neuradar_pipeline as t_pipeline
from neuradar_tpu_torch.scripts import train as t_train_script
from neuradar_tpu_torch.utils.params import load_jax_params
from tests.test_torch_eval import TINY_ARGV, TINY_RADAR_FOV
from tests.test_torch_slice import ATOL, RTOL, pipelines  # noqa: F401 (fixture)

FID_KEYS = ("lane_shift_0", "lane_shift_2", "lane_shift_3", "vertical_shift_1", "actor_shift_rot", "actor_shift_trans")
# features: float32 convolution sums in other orders than XLA's
FEATURE_TOL = dict(rtol=1e-4, atol=1e-5)


def test_frechet_distance_matches_jax():
    """The same numpy and scipy on both sides: equal to the last bit, on well- and ill-conditioned
    covariances (more samples than features, and fewer)."""
    rng = np.random.RandomState(0)
    for n, d in ((40, 8), (3, 16)):
        a, b = rng.normal(0, 1, (n, d)), rng.normal(0.3, 1.2, (n + 1, d))
        assert t_fid.frechet_distance(a, b) == j_fid.frechet_distance(a, b)
        assert t_fid.frechet_distance(a, a) == j_fid.frechet_distance(a, a)


@pytest.fixture(scope="module")
def j_ext():
    """The JAX package's extractor at the tiny scene's size; one compile of its 8-image batch serves
    every test here."""
    return j_fid.FeatureExtractor(image_hw=(24, 36))


def _port_extractor_with_jax_filters(j_extractor) -> t_fid.FeatureExtractor:
    ext = t_fid.FeatureExtractor("cpu")
    load_jax_params(ext.module, j_extractor.params["params"])
    return ext


def test_feature_extractor_matches_jax(j_ext):
    """Pooled relu5_1 features of 11 seeded images (8 a batch, so the last batch is short) with the
    JAX filters, within FEATURE_TOL."""
    images = np.random.RandomState(1).uniform(size=(11, 24, 36, 3)).astype(np.float32)
    want = j_ext(images)
    got = _port_extractor_with_jax_filters(j_ext)(images)
    assert got.shape == want.shape == (11, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **FEATURE_TOL)
    with pytest.raises(ValueError, match="at least one image"):
        t_fid.FeatureExtractor("cpu")(images[:0])


def _boxes(seed=2, q=3, a=4):
    """Seeded boxes-to-world [Q, A, 3, 4]: yawed, pitched a little, anywhere."""
    rng = np.random.RandomState(seed)
    yaw, pitch = rng.uniform(-np.pi, np.pi, (q, a)), rng.uniform(-0.1, 0.1, (q, a))
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    rz = np.stack([np.stack([cy, -sy, 0 * cy], -1), np.stack([sy, cy, 0 * cy], -1),
                   np.stack([0 * cy, 0 * cy, 1 + 0 * cy], -1)], -2)
    rx = np.stack([np.stack([1 + 0 * cp, 0 * cp, 0 * cp], -1), np.stack([0 * cp, cp, -sp], -1),
                   np.stack([0 * cp, sp, cp], -1)], -2)
    t = rng.normal(0, 20, (q, a, 3, 1))
    return np.concatenate([rz @ rx, t], -1).astype(np.float32)


EDITS = [dict(), dict(lateral=2.0), dict(longitudinal=-1.5, index=2), dict(rotation=0.5),
         dict(rotation=-0.5, lateral=1.0, index=1), dict(remove=True), dict(remove=True, index=3)]


@pytest.mark.parametrize("edit", EDITS, ids=lambda e: "-".join(f"{k}={v}" for k, v in e.items()) or "none")
def test_apply_edits_matches_jax(edit):
    """The box-frame shift, the yaw about the world's z, the selection by index and the removal by
    the 1e6 lift, on seeded boxes: rtol 1e-6, atol 1e-5 (float32 products in other orders; the lifted
    z carries 1e6's ulp); an empty edit returns the boxes as they are."""
    b2w = _boxes()
    j_mod = j_da.DynamicActors(trajectories=j_da.trajectories_from_dicts([]))
    want = np.asarray(j_mod._apply_edits(jnp.asarray(b2w), j_da.ActorEdits(**edit)))
    got_t = t_da._apply_edits(torch.from_numpy(b2w), t_da.ActorEdits(**edit))
    np.testing.assert_allclose(got_t.numpy(), want, rtol=1e-6, atol=1e-5)
    if not edit:
        assert torch.equal(got_t, torch.from_numpy(b2w))
    index = edit.get("index", -1)
    if index >= 0:  # the other actors are untouched
        others = [a for a in range(b2w.shape[1]) if a != index]
        np.testing.assert_array_equal(got_t.numpy()[:, others], b2w[:, others])


def _trajectories():
    """Two actors over three times, moving and turning."""
    out = []
    for a in range(2):
        poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
        for i in range(3):
            c, s = np.cos(0.2 * i + a), np.sin(0.2 * i + a)
            poses[i, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
            poses[i, :3, 3] = [5.0 * a + i, 2.0 - a, 0.5]
        out.append(dict(timestamps=np.array([0.0, 0.5, 1.0]), poses=poses, dims=np.array([2.0, 4.5, 1.6], np.float32)))
    return out


@pytest.mark.parametrize("edit", [dict(lateral=-2.0), dict(rotation=0.5, index=1), dict(remove=True, index=0)])
def test_boxes2world_with_edits_matches_jax(edit):
    """get_boxes2world(query_times, edits) of the JAX module and the port's, the same trajectories,
    at times between the keyframes: rtol 1e-5, atol 1e-4 (the 6d interpolation's float32 rounding;
    the lifted z at 1e6)."""
    trajs = _trajectories()
    times = np.array([0.1, 0.5, 0.77], np.float32)
    j_mod = j_da.DynamicActors(trajectories=j_da.trajectories_from_dicts(trajs))
    j_vars = j_mod.init(jax.random.PRNGKey(0), jnp.asarray(times), method=j_da.DynamicActors.get_boxes2world)
    want, want_valid = j_mod.apply(j_vars, jnp.asarray(times), j_da.ActorEdits(**edit),
                                   method=j_da.DynamicActors.get_boxes2world)
    t_mod = t_da.DynamicActors(t_da.trajectories_from_dicts(trajs))
    got, got_valid = t_mod.get_boxes2world(torch.from_numpy(times), t_da.ActorEdits(**edit))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    plain, _ = t_mod.get_boxes2world(torch.from_numpy(times))
    assert not torch.allclose(got, plain)


def test_ray_candidates_with_edits_match_jax():
    """get_ray_candidates(..., edits) of the JAX module and the port's: 64 seeded rays from near the
    actors, the actors moved 2 m sideways and turned, or the second one removed: the same candidates
    (valid, actor ids) and, where valid, their centres and world-to-box transforms (rtol 1e-5, atol
    1e-4); the edit changes the candidates."""
    trajs = _trajectories()
    rng = np.random.RandomState(5)
    times = rng.uniform(0, 1, 64).astype(np.float32)
    origins = np.stack([rng.uniform(-5, 0, 64), rng.uniform(-3, 3, 64), np.full(64, 1.5)], 1).astype(np.float32)
    target = np.stack([rng.uniform(0, 8, 64), rng.uniform(-1, 3, 64), np.full(64, 0.5)], 1)
    dirs = (target - origins) / np.linalg.norm(target - origins, axis=1, keepdims=True)
    args = tuple(a.astype(np.float32) for a in (times, origins, dirs))
    j_mod = j_da.DynamicActors(trajectories=j_da.trajectories_from_dicts(trajs))
    j_vars = j_mod.init(jax.random.PRNGKey(0), *map(jnp.asarray, args), method=j_da.DynamicActors.get_ray_candidates)
    t_mod = t_da.DynamicActors(t_da.trajectories_from_dicts(trajs))
    plain = t_mod.get_ray_candidates(*map(torch.from_numpy, args))
    for edit in (dict(lateral=2.0, rotation=0.5), dict(remove=True, index=1)):
        want = j_mod.apply(j_vars, *map(jnp.asarray, args), edits=j_da.ActorEdits(**edit),
                           method=j_da.DynamicActors.get_ray_candidates)
        got = t_mod.get_ray_candidates(*map(torch.from_numpy, args), edits=t_da.ActorEdits(**edit))
        valid = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid.numpy(), valid)
        assert valid.any() and not (torch.equal(got.valid, plain.valid) and torch.allclose(got.center, plain.center))
        np.testing.assert_array_equal(got.actor_id.numpy()[valid], np.asarray(want.actor_id)[valid])
        for name in ("center", "w2b"):
            np.testing.assert_allclose(getattr(got, name).detach().numpy()[valid],
                                       np.asarray(getattr(want, name))[valid], rtol=1e-5, atol=1e-4,
                                       err_msg=f"{edit} {name}")


def _close(got, want, name):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want), name
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("case", ["origin_shift", "actor_edits"])
def test_render_camera_shifted_matches_jax(pipelines, case):  # noqa: F811
    """render_camera of the tiny scene with the ray origins moved (2 m sideways and 1 m up), or with
    the actors moved 2 m sideways and turned, against the JAX pipeline's: tests/test_torch_slice.py's
    tolerance (rtol 1e-4, atol 1e-4); the shifted render differs from the plain one. (In frame 4 a few
    samples of the tiny model land in the turned boxes and move the depth by ~1e-7; the candidates
    themselves are held in test_ray_candidates_with_edits_match_jax.)"""
    jpipe, variables, tpipe = pipelines
    if case == "origin_shift":
        cam_idx, kw = 2, dict(origin_shift=np.array([0.0, 2.0, 1.0], np.float32))
        jkw = kw
    else:
        cam_idx = 4
        kw = dict(actor_edits=t_da.ActorEdits(lateral=-2.0, rotation=0.5))
        jkw = dict(actor_edits=j_da.ActorEdits(lateral=-2.0, rotation=0.5))
    want = jpipe.render_camera(variables, cam_idx, **jkw)
    got = tpipe.render_camera(cam_idx, **kw)
    for key in ("rgb", "depth", "accumulation"):
        _close(got[key], want[key], key)
    plain = tpipe.render_camera(cam_idx)
    assert not torch.equal(got["depth"], plain["depth"])


def test_compute_fid_metrics_matches_jax(pipelines, j_ext, monkeypatch):  # noqa: F811
    """compute_fid_metrics(max_frames=2) of the tiny scene (3 eval frames, the first 2 taken) with the
    JAX filters on both sides: the six surrogate keys; the features each family's distance is taken
    on within FEATURE_TOL; and the distances themselves within rtol 1e-5 of JAX's (measured: 1.9e-7
    at most; a Frechet distance of 2 samples in 512 dimensions square-roots a rank-1 covariance, which
    can magnify the features' float32 differences). A shift must move some family."""
    jpipe, variables, tpipe = pipelines
    for pipe in (jpipe, tpipe):
        monkeypatch.setattr(pipe.outputs, "camera_split", linspaced_split(8, 0.375))
    assert list(tpipe.datamanager.eval_camera_indices()) == [0, 4, 7]
    monkeypatch.setattr(t_pipeline, "FeatureExtractor", lambda device: _port_extractor_with_jax_filters(j_ext))
    monkeypatch.setattr(j_fid, "FeatureExtractor", lambda image_hw: j_ext)
    seen = {"jax": [], "port": []}
    for side, mod in (("jax", j_fid), ("port", t_pipeline)):
        def record(a, b, side=side, real=mod.frechet_distance):
            seen[side].append((np.asarray(a), np.asarray(b)))
            return real(a, b)

        monkeypatch.setattr(mod, "frechet_distance", record)
    want = jpipe.compute_fid_metrics(variables, max_frames=2)
    got = tpipe.compute_fid_metrics(max_frames=2)
    assert list(got) == list(want) == [f"{k}_fid_vggsurrogate" for k in FID_KEYS]
    assert len(seen["port"]) == len(seen["jax"]) == 6
    for (ga, gb), (wa, wb) in zip(seen["port"], seen["jax"]):
        assert ga.shape == wa.shape == (2, 512) and gb.shape == wb.shape and len(gb) in (2, 4)
        np.testing.assert_allclose(ga, wa, **FEATURE_TOL)
        np.testing.assert_allclose(gb, wb, **FEATURE_TOL)
    for key in got:
        assert np.isfinite(got[key]) and got[key] >= 0.0, key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    assert len({round(v, 6) for v in got.values()}) > 1


def test_driving_direction_matches_jax(pipelines, monkeypatch):  # noqa: F811
    """The ego's driving direction from the camera velocities where the parser gives them (a near-0
    one falls back), else from the neighbouring camera positions (last frame: backwards)."""
    jpipe, _, tpipe = pipelines
    n = len(tpipe.outputs.camera_to_worlds)
    for cam_idx in (0, 3, n - 1):
        np.testing.assert_allclose(tpipe._driving_direction(cam_idx), jpipe._driving_direction(cam_idx), atol=1e-12)
    vel = np.tile(np.array([[3.0, -4.0, 0.0]], np.float32), (n, 1))
    vel[1] = 1e-4
    for pipe in (jpipe, tpipe):
        monkeypatch.setattr(pipe.outputs, "camera_velocities", vel)
    for cam_idx in (0, 1):
        np.testing.assert_allclose(tpipe._driving_direction(cam_idx), jpipe._driving_direction(cam_idx), atol=1e-12)
    np.testing.assert_allclose(tpipe._driving_direction(0), [0.6, -0.8, 0.0], atol=1e-7)


def test_train_command_runs_the_fid_evals(tmp_path, monkeypatch):
    """A tiny 2-step run of the train command with calc_fid_steps (1,): after the step of index 1
    the six FID keys are logged, finite, and the run's final metrics carry them."""
    monkeypatch.setattr(t_synthetic, "ZOD_RADAR_FOV", TINY_RADAR_FOV)
    argv = ["neuradar-synthetic", "--device", "cpu", "--max_num_iterations", "2", "--output_dir", str(tmp_path),
            "--experiment_name", "fid", "--steps_per_eval_batch", "0", "--steps_per_eval_all_images", "0",
            "--steps_per_eval_all_radars", "0", "--steps_per_save", "0", "--steps_per_log", "1",
            "--pipeline.calc_fid_steps", "1", *TINY_ARGV]
    assert t_train_script.main(argv) == 0
    run = tmp_path / "fid" / "neuradar-synthetic"
    events = [json.loads(line) for line in (run / "logs" / "events.jsonl").read_text().splitlines()]
    keys = [f"{k}_fid_vggsurrogate" for k in FID_KEYS]
    fid_events = [e for e in events if keys[0] in e]
    assert [e["step"] for e in fid_events] == [1]
    assert all(np.isfinite(fid_events[0][k]) for k in keys)
    final = json.loads((run / "final_metrics.json").read_text())
    assert all(k in final for k in keys)
