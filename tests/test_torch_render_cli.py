"""The port's render, export, texture and closed-loop commands against the JAX package's, on a run
directory.

One run directory is built without training: the perturbed parameters of the JAX package's tiny
pipeline (the scene and model of tests/test_torch_slice.py, 3 of its 8 frames for eval) are
loaded into the port's Trainer and saved as the port's checkpoint beside ``config.json``; a second directory holds the same checkpoint with the
euclidean radar loss. Each port command then runs on the CPU through its ``main(argv)``, and the
JAX command through its own ``main(argv)`` with its run loader replaced by that pipeline and
parameters (the JAX package has no reader of the port's checkpoints). The written files, their
counts and their JSON keys must be the JAX command's; the frames, radar points, PLY points and
meshes are held to the JAX outputs within the tolerances stated. Radar points drawn by 'nll' come
from other generators on the two sides, so there the multi-Bernoulli outputs are held instead.
"""

import dataclasses
import http.client
import io
import json
import shutil
import threading
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from neuradar_tpu.data.dataparsers import base as j_base
from neuradar_tpu.model_components import dynamic_actors as j_da
from neuradar_tpu.scripts import exporter as j_exporter
from neuradar_tpu.scripts import render as j_render
from neuradar_tpu.scripts import render_radar as j_render_radar
from neuradar_tpu.scripts import texture as j_texture
from neuradar_tpu.utils import meshing as j_mesh
from neuradar_tpu_torch.configs.cli import parse_overrides
from neuradar_tpu_torch.configs.method_configs import get_method
from neuradar_tpu_torch.data.dataparsers import base as t_base
from neuradar_tpu_torch.data.dataparsers import synthetic as t_synthetic
from neuradar_tpu_torch.engine.trainer import Trainer
from neuradar_tpu_torch.model_components import dynamic_actors as t_da
from neuradar_tpu_torch.scripts import closed_loop as t_closed_loop
from neuradar_tpu_torch.scripts import exporter as t_exporter
from neuradar_tpu_torch.scripts import render as t_render
from neuradar_tpu_torch.scripts import render_radar as t_render_radar
from neuradar_tpu_torch.scripts import texture as t_texture
from neuradar_tpu_torch.scripts.train import config_to_jsonable
from neuradar_tpu_torch.utils import colormaps as t_cm
from neuradar_tpu_torch.utils import meshing as t_mesh
from neuradar_tpu_torch.utils.params import load_jax_params
from tests.test_torch_eval import TINY_ARGV, TINY_RADAR_FOV
from tests.test_torch_slice import ATOL, RTOL, pipelines  # noqa: F401 (fixture)

EVAL_FRACTION = 0.375  # 3 eval frames of 8
RADAR_EXISTENCE_BIAS = 1.0
UINT8_TOL = 1  # a uint8 image of float32 renders that agree to RTOL / ATOL
# a colormapped depth: a float32 difference can move a pixel to the next of turbo's 256 entries
DEPTH_PNG_TOL = int(np.ceil(np.abs(np.diff(t_cm.colormap_table("turbo"), axis=0)).max() * 255)) + UINT8_TOL
# world points from depths within RTOL / ATOL: the depth error grows with the distance
POINT_TOL = dict(rtol=1e-4, atol=1e-3)
# a screened-Poisson mesh: the solve spreads each point's difference over the whole grid, and a vertex
# placed between two grid values va, vb moves by their difference over |va - vb|; within this share of
# a voxel (measured: 1.1e-3 on a grid of 16 over 40 m)
POISSON_VOXEL_TOL = 2e-3


@pytest.fixture(scope="module")
def run(pipelines, tmp_path_factory):  # noqa: F811
    """The JAX pipeline of tests/test_torch_slice.py with its perturbed parameters (a ray-drop logit
    of -3 on every lidar ray and an existence logit raised by RADAR_EXISTENCE_BIAS, so that the
    exports keep lidar returns and radar points), and the port's run directories
    (nll and euclidean radar losses) holding the same parameters. While the module's tests run, both
    sides take every third frame of each sensor for eval (frames 0, 4 and 7, so that the interpolated
    commands have pairs) and the port's synthetic scene the tiny 16 x 4 radar grid of the JAX
    pipeline's (the port's parser reads both when a command loads the run)."""
    jpipe, variables, _ = pipelines
    params = jax.tree.map(np.array, variables["params"])
    params["lidar_decoder"]["output"]["bias"][1] = -3.0
    params["radar_decoder"]["existence_probability_head"]["output"]["bias"][0] = RADAR_EXISTENCE_BIAS
    batch_stats = variables["batch_stats"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_synthetic, "ZOD_RADAR_FOV", TINY_RADAR_FOV)
        mp.setattr(t_synthetic, "linspaced_split", lambda n: t_base.linspaced_split(n, EVAL_FRACTION))
        for sensor in ("camera", "lidar", "radar"):
            mp.setattr(jpipe.outputs, f"{sensor}_split", j_base.linspaced_split(8, EVAL_FRACTION))
        root = tmp_path_factory.mktemp("cli")
        config = parse_overrides(get_method("neuradar-synthetic"),
                                 [*TINY_ARGV, "--output_dir", str(root), "--experiment_name", "nll"])
        trainer = Trainer(config, device="cpu")
        trainer.setup(prefetch=False)
        assert list(trainer.pipeline.datamanager.eval_radar_indices()) == [0, 4, 7]
        load_jax_params(trainer.model, params, batch_stats)
        nll = trainer.run_dir
        nll.mkdir(parents=True)
        (nll / "config.json").write_text(json.dumps(config_to_jsonable(config), indent=2))
        trainer.save_checkpoint()
        trainer.shutdown()
        euclidean = root / "euclidean" / "neuradar-synthetic"
        shutil.copytree(nll, euclidean)
        cfg_json = json.loads((euclidean / "config.json").read_text())
        cfg_json["pipeline"]["model"]["loss"]["radar_loss_type"] = "euclidean"
        (euclidean / "config.json").write_text(json.dumps(cfg_json))

        c2w = np.asarray(jpipe.outputs.camera_to_worlds)
        path = {"camera_path": [{"camera_to_world": np.concatenate([c2w[i], [[0, 0, 0, 1]]]).reshape(-1).tolist()}
                                for i in (1, 6)], "render_height": 24, "render_width": 36}
        yield SimpleNamespace(jpipe=jpipe, variables={"params": params, "batch_stats": batch_stats}, root=root,
                              dirs={"nll": nll, "euclidean": euclidean}, camera_path=path)


def _camera_path_file(run, tmp_path, camera_type=None) -> Path:
    spec = dict(run.camera_path, **({"camera_type": camera_type} if camera_type else {}))
    p = tmp_path / "camera_path.json"
    p.write_text(json.dumps(spec))
    return p


def _run_both(run, j_main, t_main, argv, tmp_path, loss="nll"):
    """The JAX command (its run loader replaced, its pipeline's tables put back afterwards, its radar
    loss set to ``loss``) and the port's on the ``loss`` run directory, each writing under its own
    root: "{out}" and "{run}" in argv stand for the side's output root and the run directory.
    Returns the two output roots and the two return codes."""
    stub = SimpleNamespace(pipeline=run.jpipe, eval_variables=lambda: run.variables)
    tables = run.jpipe.datamanager.tables
    rcs = {}
    for side in ("jax", "port"):
        out = tmp_path / side
        args = [a.format(out=out, run=run.dirs[loss]) for a in argv]
        if side == "jax":
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(j_render, "_load_trainer", lambda run_dir: stub)
                mp.setattr(run.jpipe.config.model.loss, "radar_loss_type", loss)
                try:
                    rcs[side] = j_main(args)
                finally:
                    run.jpipe.datamanager.tables = tables
        else:
            rcs[side] = t_main([*args, "--device", "cpu"])
    return tmp_path / "jax", tmp_path / "port", rcs


def _files(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _png(path: Path) -> np.ndarray:
    return np.asarray(Image.open(path))


def _points_ply(path: Path) -> np.ndarray:
    data = path.read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    assert b"property uchar" not in data[:end]
    return np.frombuffer(data[end:], np.float32).reshape(-1, 3)


def _close_png(got: Path, want: Path, tol: int):
    g, w = _png(got).astype(np.int64), _png(want).astype(np.int64)
    assert g.shape == w.shape, (got.name, g.shape, w.shape)
    diff = np.abs(g - w)
    assert diff.max() <= tol, (got.name, diff.max())
    if tol > UINT8_TOL:
        assert (diff > UINT8_TOL).mean() < 0.05, got.name


RENDER_CASES = {
    "dataset": ["dataset", "--max-frames", "2"],
    "lane-shift": ["lane-shift", "--max-frames", "2", "--shift", "1.5"],
    "actor-shift": ["actor-shift", "--max-frames", "1", "--actor-lateral", "2.0", "--actor-rotation", "0.5"],
    "actor-remove": ["actor-shift", "--max-frames", "1", "--actor-remove", "--actor-index", "0"],
    "interpolated": ["interpolated", "--max-frames", "2", "--steps-per-transition", "2", "--split", "train"],
    "spiral": ["spiral", "--max-frames", "2", "--radius", "1.0"],
    **{f"camera-path-{ct}": ["camera-path", ct]
       for ct in ("perspective", "fisheye", "equirectangular", "omnidirectional", "vr180")},
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_render_commands_match_jax(run, case, tmp_path):
    """Each render.py command: the same files and render_info.json; frames within UINT8_TOL, the
    colormapped depth PNGs within DEPTH_PNG_TOL (most pixels within UINT8_TOL)."""
    argv = list(RENDER_CASES[case])
    if argv[0] == "camera-path":
        argv = ["camera-path", "--camera-path-filename", str(_camera_path_file(run, tmp_path, argv[1]))]
    jax_out, port_out, rcs = _run_both(run, j_render.main, t_render.main,
                                       [*argv, "--load-config", "{run}", "--output-dir", "{out}"], tmp_path)
    assert rcs == {"jax": 0, "port": 0}
    files = _files(jax_out)
    assert _files(port_out) == files and sum(f.endswith(".png") for f in files) >= 2, files
    for f in files:
        if f.endswith(".json"):
            assert json.loads((port_out / f).read_text()) == json.loads((jax_out / f).read_text()), f
        else:
            _close_png(port_out / f, jax_out / f, DEPTH_PNG_TOL if "depth_" in f else UINT8_TOL)


def test_lane_shift_restores_the_tables(run, tmp_path):
    """The port's lane-shift renders moved cameras and puts the pipeline's sensor tables back."""
    pipeline = t_render.load_pipeline(run.dirs["nll"], "cpu")
    tables = pipeline.tables
    moved = dataclasses.replace(tables, cameras=dataclasses.replace(
        tables.cameras, camera_to_worlds=tables.cameras.camera_to_worlds + 1.0))
    plain = pipeline.render_camera(0)["depth"]
    with t_render.swapped_tables(pipeline, moved):
        assert pipeline.tables is moved and pipeline.datamanager.tables is moved
        assert not torch.equal(pipeline.render_camera(0)["depth"], plain)
    assert pipeline.tables is tables and pipeline.datamanager.tables is tables
    assert torch.equal(pipeline.render_camera(0)["depth"], plain)


RADAR_CASES = {
    "dataset": ["dataset"],
    "pose-shift": ["pose-shift", "--lateral-shift", "1.5"],
    "actor-shift": ["actor-shift", "--actor-lateral", "2.0"],
    "interpolated": ["interpolated", "--steps-per-transition", "2"],
    "full-sensor-set": ["full-sensor-set", "--frame", "1"],
    "camera-path": ["camera-path"],
}


@pytest.mark.parametrize("loss", ["euclidean", "nll"])
@pytest.mark.parametrize("case", list(RADAR_CASES))
def test_render_radar_commands_match_jax(run, case, loss, tmp_path):
    """Each render_radar.py command, at 2 scans: the same files and the same JSON keys; ground truth
    equal. Euclidean: the kept points the JAX command's, within the render's RTOL / ATOL. nll: the
    draws differ, so the multi-Bernoulli outputs of the eval scans are held to the JAX pipeline's
    (RTOL / ATOL). full-sensor-set: info.json equal, rgb.png and depth.png within UINT8_TOL, the lidar
    PLY's points within POINT_TOL, the radar PLY as the points above."""
    argv = list(RADAR_CASES[case])
    if case == "camera-path":
        path = dict(run.camera_path, camera_path=[
            {"camera_to_world": np.concatenate([np.asarray(run.jpipe.outputs.radar_to_worlds[i]), [[0, 0, 0, 1]]])
             .reshape(-1).tolist()} for i in (1, 6)])
        (tmp_path / "radar_path.json").write_text(json.dumps(path))
        argv += ["--camera-path-filename", str(tmp_path / "radar_path.json")]
    jax_out, port_out, rcs = _run_both(run, j_render_radar.main, t_render_radar.main,
                                       [*argv, "--load-config", "{run}", "--output-dir", "{out}", "--max-scans", "2"],
                                       tmp_path, loss)
    assert rcs == {"jax": 0, "port": 0}
    files = _files(jax_out)
    assert _files(port_out) == files and len(files) >= 2, files
    for f in files:
        got, want = port_out / f, jax_out / f
        if f.endswith("info.json"):
            assert json.loads(got.read_text()) == json.loads(want.read_text())
        elif f.endswith(".json"):
            g, w = json.loads(got.read_text()), json.loads(want.read_text())
            assert sorted(g) == sorted(w), f
            if "gt_points" in w:
                np.testing.assert_array_equal(np.asarray(g["gt_points"]), np.asarray(w["gt_points"]))
            if loss == "euclidean":
                assert len(g["points"]) == len(w["points"]), f
                np.testing.assert_allclose(np.asarray(g["points"]).reshape(-1, 3),
                                           np.asarray(w["points"]).reshape(-1, 3), rtol=RTOL, atol=ATOL)
        elif f.endswith(".ply"):
            g, w = _points_ply(got), _points_ply(want)
            if f.endswith("lidar.ply") or loss == "euclidean":
                assert g.shape == w.shape, f
                np.testing.assert_allclose(g, w, **(POINT_TOL if f.endswith("lidar.ply") else dict(rtol=RTOL, atol=ATOL)))
        elif f.endswith(("rgb.png", "depth.png")):
            _close_png(got, want, UINT8_TOL)
        else:  # the scan figures: the port's bird's-eye raster, the JAX package's matplotlib plot
            assert _png(got).shape == (t_render_radar.BEV_PIXELS, t_render_radar.BEV_PIXELS, 3)
    if loss == "nll" and case == "dataset":
        pipeline = t_render.load_pipeline(run.dirs["nll"], "cpu")
        for scan in pipeline.datamanager.eval_radar_indices():
            np.testing.assert_allclose(pipeline.render_radar(int(scan))["radar_output"].numpy(),
                                       run.jpipe.render_radar(run.variables, int(scan))["radar_output"],
                                       rtol=RTOL, atol=ATOL)


EXPORT_CASES = ("pointcloud", "radar-pointcloud", "sdf-surface", "sdf-mesh", "tsdf-mesh", "poisson-mesh", "cameras")


@pytest.mark.parametrize("case", EXPORT_CASES)
def test_exporter_commands_match_jax(run, case, tmp_path):
    """Each exporter.py command (2 scans, 300 lidar points a scan, grids of 16 on a 20 m cube, the
    euclidean run for radar-pointcloud): the same files; camera poses equal; PLY points within
    POINT_TOL; a mesh's faces the same in number and order, each face's corners within POINT_TOL
    (a Poisson mesh's within POISSON_VOXEL_TOL of a voxel). The
    vertex lists may differ by a few entries: vertices closer than 1e-5 of a voxel are merged, and
    a difference within the tolerance can move a pair across that line (4 of 11,461 in sdf-mesh)."""
    loss = "euclidean" if case == "radar-pointcloud" else "nll"
    jax_out, port_out, rcs = _run_both(run, j_exporter.main, t_exporter.main, [
        case, "--load-config", "{run}", "--output-path", "{out}/" + case + ".ply", "--max-scans", "2",
        "--points-per-scan", "300", "--grid-resolution", "16", "--bounds", "20"], tmp_path, loss)
    assert rcs == {"jax": 0, "port": 0}
    files = _files(jax_out)
    assert _files(port_out) == files, files
    for f in files:
        got, want = port_out / f, jax_out / f
        if f.endswith(".json"):
            assert json.loads(got.read_text()) == json.loads(want.read_text())
        elif case.endswith("mesh"):
            gv, gf, _ = t_mesh.read_ply_mesh(got)
            wv, wf, _ = j_mesh.read_ply_mesh(want)
            assert len(wf) > 0 and gf.shape == wf.shape, (case, gf.shape, wf.shape)
            assert abs(len(gv) - len(wv)) <= max(2, 1e-3 * len(wv)), (case, len(gv), len(wv))
            tol = dict(rtol=0.0, atol=POISSON_VOXEL_TOL * 40.0 / 15) if case == "poisson-mesh" else POINT_TOL
            np.testing.assert_allclose(gv[gf], wv[wf], **tol)
        else:
            g, w = _points_ply(got), _points_ply(want)
            assert len(w) > 0 and g.shape == w.shape, (case, g.shape, w.shape)
            np.testing.assert_allclose(g, w, **POINT_TOL)


def test_gaussian_ply_is_refused(run, tmp_path, capsys):
    """gaussian-ply exports a splatfacto run's gaussians.npz; on a neuradar run, which has none, it
    exits non-zero with a message naming splatfacto, and writes nothing."""
    assert t_exporter.main(["gaussian-ply", "--load-config", str(run.dirs["nll"]),
                            "--output-path", str(tmp_path / "g.ply"), "--device", "cpu"]) != 0
    assert "splatfacto" in capsys.readouterr().err
    assert not (tmp_path / "g.ply").exists()


def test_texture_command_matches_jax(run, tmp_path):
    """texture.py on a mesh in front of the first eval camera, 2 cameras: the same vertices and
    faces, the vertex colors (uint8) within UINT8_TOL."""
    c2w = np.asarray(run.jpipe.outputs.camera_to_worlds[0], np.float64)
    s = np.linspace(-3, 3, 8)
    gu, gv = np.meshgrid(s, s, indexing="ij")
    verts = (np.stack([gu.reshape(-1), gv.reshape(-1), np.full(gu.size, -8.0)], 1) @ c2w[:3, :3].T
             + c2w[:3, 3]).astype(np.float32)
    idx = np.arange(64).reshape(8, 8)
    faces = np.stack([idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:]], -1).reshape(-1, 3).astype(np.int32)
    t_mesh.write_ply_mesh(tmp_path / "mesh.ply", verts, faces)
    jax_out, port_out, rcs = _run_both(run, j_texture.main, t_texture.main, [
        "--load-config", "{run}", "--input-mesh", str(tmp_path / "mesh.ply"), "--output-path", "{out}/textured.ply",
        "--max-cameras", "2", "--depth-tol", "10"], tmp_path)
    assert rcs == {"jax": 0, "port": 0}
    gv, gf, gc = t_mesh.read_ply_mesh(port_out / "textured.ply")
    wv, wf, wc = j_mesh.read_ply_mesh(jax_out / "textured.ply")
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gf, wf)
    assert np.abs(gc * 255 - wc * 255).max() <= UINT8_TOL + 1e-3
    assert (np.abs(gc - 0.5) > 0.01).any()  # some vertex was seen


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=None if body is None else json.dumps(body))
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def test_closed_loop_server_matches_jax(run):
    """The port's server on a free port of localhost: /info and GET /actors equal to the JAX
    package's state; POST /actors sets the edit of later renders; POST /render returns a PNG of the
    request's size equal to the JAX pipeline's render_pose at that pose, time and edit within
    UINT8_TOL; an unknown path is 404, a bad pose 500."""
    from neuradar_tpu.scripts import closed_loop as j_closed_loop

    state = t_closed_loop.ClosedLoopState(t_render.load_pipeline(run.dirs["nll"], "cpu"))
    j_state = j_closed_loop.ClosedLoopState(SimpleNamespace(pipeline=run.jpipe, eval_variables=lambda: run.variables))
    server = t_closed_loop.serve(state, 0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        status, ctype, body = _request(port, "GET", "/info")
        assert status == 200 and ctype == "application/json"
        assert json.loads(body) == json.loads(json.dumps(j_state.info()))
        status, _, body = _request(port, "GET", "/actors")
        want = [{"timestamps": t["timestamps"].tolist(), "dims": np.asarray(t["dims"]).tolist()}
                for t in run.jpipe.outputs.trajectories]
        assert status == 200 and json.loads(body) == {"trajectories": want} and len(want) > 0
        edit = {"index": 1, "lateral": 1.5, "rotation": 0.3}
        assert _request(port, "POST", "/actors", edit)[:2] == (200, "application/json")
        assert state.edits == t_da.ActorEdits(lateral=1.5, rotation=0.3, index=1)
        pose = np.asarray(run.jpipe.outputs.camera_to_worlds[3], np.float32)
        status, ctype, body = _request(port, "POST", "/render", {"pose": pose.tolist(), "time": 1.5, "hw": [24, 36]})
        assert status == 200 and ctype == "image/png"
        got = np.asarray(Image.open(io.BytesIO(body)))
        want = run.jpipe.render_pose(run.variables, pose, hw=(24, 36), time_s=1.5,
                                     actor_edits=j_da.ActorEdits(lateral=1.5, rotation=0.3, index=1))
        assert got.shape == want.shape == (24, 36, 3)
        assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= UINT8_TOL
        assert _request(port, "GET", "/nowhere")[0] == 404
        assert _request(port, "POST", "/render", {"pose": [1.0, 2.0]})[0] == 500
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_closed_loop_server_concurrent_requests(run):
    """16 clients at once on the threaded server, a switch interval of 1 us: each /render of one of
    two poses returns that pose's serial render bit for bit while zero actor edits are posted
    between them (the lock serializes the renders and the edits; a render that saw another's state
    half-way would differ)."""
    import sys

    state = t_closed_loop.ClosedLoopState(t_render.load_pipeline(run.dirs["nll"], "cpu"))
    poses = [np.asarray(run.jpipe.outputs.camera_to_worlds[i], np.float32) for i in (2, 5)]
    want = [state.render(p, 0.0, (24, 36)) for p in poses]
    server = t_closed_loop.serve(state, 0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    results, edits = {}, [{"index": -1, "lateral": 0.0}, {"index": -1, "longitudinal": 0.0}]

    def client(i):
        if i % 4 == 3:
            results[i] = _request(port, "POST", "/actors", edits[i % 2])[0]
        else:
            status, _, body = _request(port, "POST", "/render", {"pose": poses[i % 2].tolist(), "hw": [24, 36]})
            results[i] = (status, np.asarray(Image.open(io.BytesIO(body))) if status == 200 else body)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        clients = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        assert not any(c.is_alive() for c in clients)
    finally:
        sys.setswitchinterval(interval)
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert len(results) == 16
    for i, r in results.items():
        if i % 4 == 3:
            assert r == 200
        else:
            assert r[0] == 200 and np.array_equal(r[1], want[i % 2]), i
    assert state.edits == t_da.ActorEdits()
