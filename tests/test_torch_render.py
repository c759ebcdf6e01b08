"""The port's render and export layer against the JAX package's, module by module.

The quaternion functions and ``get_spiral_path`` (utils/poses.py) on tests/test_math_poses.py's
inputs; every colormap (utils/colormaps.py, matplotlib's tables kept in the port) and
``project_points`` (viewer/overlays.py); each function of utils/meshing.py; and, on the tiny scene of
tests/test_torch_slice.py with its perturbed JAX parameters loaded into the port, the model's
``query_geometry``, the pipeline's ``viewer_intrinsics``, ``render_pose`` and ``radar_points_world``,
and texture.py's ``bake_vertex_colors``. Each test states its tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuradar_tpu.model_components import dynamic_actors as j_da
from neuradar_tpu.scripts import texture as j_texture
from neuradar_tpu.utils import colormaps as j_cm
from neuradar_tpu.utils import meshing as j_mesh
from neuradar_tpu.utils import poses as j_poses
from neuradar_tpu.viewer import overlays as j_overlays
from neuradar_tpu.models.neuradar import NeuRadarModel
from neuradar_tpu_torch.cameras.cameras import CameraType
from neuradar_tpu_torch.model_components import dynamic_actors as t_da
from neuradar_tpu_torch.scripts import texture as t_texture
from neuradar_tpu_torch.utils import colormaps as t_cm
from neuradar_tpu_torch.utils import meshing as t_mesh
from neuradar_tpu_torch.utils import poses as t_poses
from neuradar_tpu_torch.viewer import overlays as t_overlays
from tests.test_torch_slice import ATOL, RTOL, pipelines  # noqa: F401 (fixture)

# host float32 pose algebra in torch against jnp: the same formulas, last-ulp differences of
# sqrt/arccos/sin
POSE_TOL = dict(rtol=1e-6, atol=1e-6)
# a camera's uint8 image: the render's float32 differences (RTOL/ATOL) can move a pixel across one
# rounding boundary
UINT8_TOL = 1


def _quaternions():
    rng = np.random.RandomState(3)  # tests/test_math_poses.py's
    q = rng.randn(32, 4)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def test_quaternion_functions_match_jax():
    """quaternion_to_matrix, matrix_to_quaternion (the round trip, and each of Shepperd's four
    branches on rotations by pi about x, y, z and the identity) and quaternion_slerp at scalar and
    per-row t, on the short arc and on nearly parallel quaternions: POSE_TOL."""
    q = _quaternions()
    mats = t_poses.quaternion_to_matrix(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(mats, np.asarray(j_poses.quaternion_to_matrix(jnp.asarray(q))), **POSE_TOL)
    branches = np.stack([np.eye(3), np.diag([1, -1, -1]), np.diag([-1, 1, -1]), np.diag([-1, -1, 1])]).astype(np.float32)
    for m in (mats, branches):
        got = t_poses.matrix_to_quaternion(torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(got, np.asarray(j_poses.matrix_to_quaternion(jnp.asarray(m))), **POSE_TOL)
    q0, q1 = q[:16], q[16:]
    near = (q0 + 1e-7).astype(np.float32)
    t_rows = np.linspace(0, 1, 16, dtype=np.float32)
    for a, b, t in ((q0, q1, 0.3), (q0, -q1, 0.7), (q0, q1, t_rows), (q0, near, 0.5)):
        got = t_poses.quaternion_slerp(torch.from_numpy(a), torch.from_numpy(b), t).numpy()
        want = np.asarray(j_poses.quaternion_slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)))
        np.testing.assert_allclose(got, want, **POSE_TOL)


@pytest.mark.parametrize("seed_pose", ["translated", "rotated"])
def test_spiral_path_matches_jax(seed_pose):
    """get_spiral_path of tests/test_math_poses.py's seed (and of a rotated one): 8 steps, radius 0.5,
    one turn; float32 on both sides, rtol 1e-5 / atol 1e-5."""
    seed = np.eye(3, 4, dtype=np.float32)
    seed[:3, 3] = [1.0, 2.0, 3.0]
    if seed_pose == "rotated":
        seed[:3, :3] = t_poses.quaternion_to_matrix(torch.from_numpy(_quaternions()[0])).numpy()
    for kw in (dict(steps=8, radius=0.5, rots=1, zrate=0.5), dict(steps=5, radius=2.0, rots=2, zrate=1.5, focal=30.0)):
        got = t_poses.get_spiral_path(seed, **kw).numpy()
        want = np.asarray(j_poses.get_spiral_path(seed, **kw))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_colormaps_match_jax():
    """Every route of apply_colormap and every named table, apply_depth_colormap with and without
    accumulation and planes, the boolean and PCA maps: the same numpy on both sides and the same
    256-entry tables, so equal to the last bit."""
    rng = np.random.RandomState(0)
    img = rng.uniform(-0.2, 1.3, (6, 7, 1))
    img[0, 0, 0] = np.nan
    for name in t_cm.Colormaps:
        np.testing.assert_array_equal(t_cm.apply_float_colormap(img, name), j_cm.apply_float_colormap(img, name))
    opts = [t_cm.ColormapOptions(), t_cm.ColormapOptions(colormap="magma", normalize=True, invert=True),
            t_cm.ColormapOptions(colormap="cividis", colormap_min=0.2, colormap_max=0.7, range_min=0.1, range_max=0.9)]
    feats = rng.normal(0, 1, (5, 6, 8))
    for o in opts:
        jo = j_cm.ColormapOptions(**vars(o))
        for x in (img[1:], rng.uniform(0, 1, (4, 4, 3)), rng.uniform(0, 1, (4, 4, 1)) > 0.5, feats):
            np.testing.assert_array_equal(t_cm.apply_colormap(x, o), j_cm.apply_colormap(x, jo))
    depth = rng.uniform(1, 50, (6, 7, 1))
    acc = rng.uniform(0, 1, (6, 7, 1))
    for kw in (dict(), dict(accumulation=acc), dict(accumulation=acc, near_plane=5.0, far_plane=30.0)):
        np.testing.assert_array_equal(t_cm.apply_depth_colormap(depth, **kw), j_cm.apply_depth_colormap(depth, **kw))
    np.testing.assert_array_equal(t_cm.apply_pca_colormap(feats), j_cm.apply_pca_colormap(feats))
    np.testing.assert_array_equal(t_cm.apply_boolean_colormap(img[..., 0] > 0.5),
                                  j_cm.apply_boolean_colormap(img[..., 0] > 0.5))


def test_project_points_matches_jax():
    """project_points of random points seen from a rotated camera, some behind it: the same numpy
    float64 on both sides, equal."""
    rng = np.random.RandomState(1)
    c2w = np.concatenate([t_poses.quaternion_to_matrix(torch.from_numpy(_quaternions()[2])).numpy(),
                          [[1.0], [-2.0], [0.5]]], axis=1)
    pts = rng.normal(0, 10, (200, 3))
    pts[0] = c2w[:3, 3]  # at the camera: z = 0
    got, want = t_overlays.project_points(c2w, 300.0, 310.0, 64.0, 48.0, pts), \
        j_overlays.project_points(c2w, 300.0, 310.0, 64.0, 48.0, pts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _sphere_grid(res=20, bounds=2.0, radius=1.3):
    xs = np.linspace(-bounds, bounds, res)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    sdf = np.sqrt(gx**2 + gy**2 + (gz * 1.3) ** 2) - radius
    return sdf.astype(np.float32), np.array([-bounds] * 3), 2 * bounds / (res - 1)


def _sphere_points(n=600, seed=2):
    rng = np.random.RandomState(seed)
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = 8.0 * d + rng.normal(0, 0.01, (n, 3))
    return pts, np.zeros_like(pts)  # seen from the centre


@pytest.mark.parametrize("fn", ["marching_tetrahedra", "tsdf_fuse", "ply_mesh_io", "vertex_normals",
                                "estimate_normals", "screened_poisson_mesh"])
def test_meshing_matches_jax(fn, tmp_path):
    """Each function of utils/meshing.py on a seeded input: the same numpy and scipy on both sides,
    so equal to the last bit (the PLY files byte for byte)."""
    sdf, origin, spacing = _sphere_grid()
    if fn == "marching_tetrahedra":
        for level in (0.0, 0.3):
            for g, w in zip(t_mesh.marching_tetrahedra(sdf, origin, spacing, level),
                            j_mesh.marching_tetrahedra(sdf, origin, spacing, level)):
                np.testing.assert_array_equal(g, w)
        assert len(t_mesh.marching_tetrahedra(sdf, origin, spacing)[1]) > 100
    elif fn == "tsdf_fuse":
        rng = np.random.RandomState(4)
        depths = rng.uniform(2, 20, (2, 6, 9)).astype(np.float32)
        depths[0, 0, 0] = np.inf
        intr = np.array([[10.0, 10.0, 13.5, 9.0], [12.0, 11.0, 13.0, 8.5]])
        c2ws = np.stack([np.eye(3, 4), np.concatenate([t_poses.quaternion_to_matrix(
            torch.from_numpy(_quaternions()[5])).numpy(), [[0.5], [0.0], [1.0]]], axis=1)])
        for kw in (dict(), dict(trunc=1.0)):
            for g, w in zip(t_mesh.tsdf_fuse(depths, intr, c2ws, 12.0, 24, depth_stride=3, **kw),
                            j_mesh.tsdf_fuse(depths, intr, c2ws, 12.0, 24, depth_stride=3, **kw)):
                np.testing.assert_array_equal(g, w)
    elif fn == "ply_mesh_io":
        verts, faces = t_mesh.marching_tetrahedra(sdf, origin, spacing)
        colors = np.random.RandomState(0).uniform(0, 1, verts.shape)
        for c in (None, colors):
            t_mesh.write_ply_mesh(tmp_path / "t.ply", verts, faces, colors=c)
            j_mesh.write_ply_mesh(tmp_path / "j.ply", verts, faces, colors=c)
            assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
            got, want = t_mesh.read_ply_mesh(tmp_path / "t.ply"), j_mesh.read_ply_mesh(tmp_path / "j.ply")
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    elif fn == "vertex_normals":
        verts, faces = t_mesh.marching_tetrahedra(sdf, origin, spacing)
        np.testing.assert_array_equal(t_mesh.vertex_normals(verts, faces), j_mesh.vertex_normals(verts, faces))
    elif fn == "estimate_normals":
        pts, origins = _sphere_points()
        for k in (16, 5):
            np.testing.assert_array_equal(t_mesh.estimate_normals(pts, origins, k), j_mesh.estimate_normals(pts, origins, k))
    else:
        pts, origins = _sphere_points()
        normals = t_mesh.estimate_normals(pts, origins)
        for kw in (dict(), dict(screen=0.1, smooth_sigma_vox=0.0)):
            got = t_mesh.screened_poisson_mesh(pts, normals, bounds=12.0, resolution=24, **kw)
            want = j_mesh.screened_poisson_mesh(pts, normals, bounds=12.0, resolution=24, **kw)
            assert len(want[1]) > 100
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_query_geometry_matches_jax(pipelines):
    """The model's raw SDF at world positions [R, S, 3] (the static grid, std 0.05) with the perturbed
    tables: tests/test_torch_slice.py's rtol / atol 1e-4."""
    jpipe, variables, tpipe = pipelines
    pts = np.random.RandomState(5).uniform(-30, 30, (16, 24, 3)).astype(np.float32)
    want = np.asarray(jpipe.model.apply(variables, jnp.asarray(pts), method=NeuRadarModel.query_geometry))
    with torch.no_grad():
        got = tpipe.model.query_geometry(torch.from_numpy(pts)).numpy()
    assert got.shape == want.shape == (16, 24, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_viewer_intrinsics_match_jax(pipelines):
    jpipe, _, tpipe = pipelines
    for hw in ((24, 36), (96, 156), (720, 1296)):
        assert tpipe.viewer_intrinsics(hw) == jpipe.viewer_intrinsics(hw)


POSE = np.array([[0.0, 0.0, -1.0, 1.0], [-1.0, 0.0, 0.0, 0.5], [0.0, 1.0, 0.0, 0.2]], np.float32)  # looks down +x


@pytest.mark.parametrize("camera_type", [CameraType.PERSPECTIVE, CameraType.FISHEYE, CameraType.EQUIRECTANGULAR,
                                         CameraType.OMNIDIRECTIONALSTEREO_L, CameraType.OMNIDIRECTIONALSTEREO_R,
                                         CameraType.VR180_L, CameraType.VR180_R])
def test_render_pose_matches_jax(pipelines, camera_type):
    """render_pose at 24 x 36 (every camera type; fx = W/2 for all but the perspective, the JAX
    package's rule) with each output: rgb within UINT8_TOL; depth and accumulation colormapped, where a
    float32 difference can move a pixel to the next of the colormap's 256 entries, so within the
    largest step between neighbouring entries of turbo (its table) plus UINT8_TOL, and most pixels
    within UINT8_TOL. A scene time and an actor edit go with the perspective camera."""
    jpipe, variables, tpipe = pipelines
    step = int(np.ceil(np.abs(np.diff(t_cm.colormap_table("turbo"), axis=0)).max() * 255)) + UINT8_TOL
    cases = [dict()]
    if camera_type == CameraType.PERSPECTIVE:
        cases += [dict(time_s=2.5), dict(time_s=1.0, edits=dict(lateral=2.0, rotation=0.5))]
    for case in cases:
        kw = dict(hw=(24, 36), camera_type=int(camera_type), time_s=case.get("time_s", 0.0))
        edits = case.get("edits")
        for output in ("rgb", "depth", "accumulation"):
            want = jpipe.render_pose(variables, POSE, output=output, actor_edits=edits and j_da.ActorEdits(**edits), **kw)
            got = tpipe.render_pose(POSE, output=output, actor_edits=edits and t_da.ActorEdits(**edits), **kw)
            assert got.dtype == np.uint8 and got.shape == want.shape == ((24, 36, 3) if output == "rgb" else (8, 12, 3))
            diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
            if output == "rgb":
                assert diff.max() <= UINT8_TOL, (case, output, diff.max())
            else:
                assert diff.max() <= step and (diff > UINT8_TOL).mean() < 0.05, (case, output, diff.max())
    assert tpipe.render_pose(POSE, hw=(20, 40)).shape == (18, 39, 3)  # cut to multiples of the upsample factor


def test_radar_points_world_matches_jax(pipelines):
    """radar_points_world at three times (the nearest scan each), threshold 0.5 and a lower one:
    the kept set equal, the world points within the render's rtol / atol 1e-4."""
    jpipe, variables, tpipe = pipelines
    for time_s, thr in ((0.0, 0.5), (1.7, 0.5), (3.2, 0.05)):
        want = jpipe.radar_points_world(variables, time_s=time_s, threshold=thr)
        got = tpipe.radar_points_world(time_s=time_s, threshold=thr)
        assert got.dtype == np.float32 and got.shape == want.shape, (time_s, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert len(tpipe.radar_points_world(time_s=3.2, threshold=0.05)) > 0


def test_bake_vertex_colors_matches_jax(pipelines):
    """bake_vertex_colors of a plane of vertices in front of the first cameras, 2 and 3 views: the
    colors within the render's rtol / atol 1e-4 (the same numpy on the rendered rgb and depth)."""
    jpipe, variables, tpipe = pipelines
    c2w = np.asarray(tpipe.outputs.camera_to_worlds[0], np.float64)
    # a 10 x 10 grid of vertices on a plane 6 m in front of camera 0, facing it
    s = np.linspace(-2, 2, 10)
    gu, gv = np.meshgrid(s, s, indexing="ij")
    local = np.stack([gu.reshape(-1), gv.reshape(-1), np.full(gu.size, -6.0)], 1)
    verts = (local @ c2w[:3, :3].T + c2w[:3, 3]).astype(np.float32)
    idx = np.arange(100).reshape(10, 10)
    faces = np.concatenate([np.stack([idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:]], -1).reshape(-1, 3),
                            np.stack([idx[1:, :-1], idx[1:, 1:], idx[:-1, 1:]], -1).reshape(-1, 3)]).astype(np.int32)
    for max_cameras, tol in ((2, 0.08), (3, 10.0)):
        want = j_texture.bake_vertex_colors(jpipe, variables, verts, faces, max_cameras=max_cameras, depth_tol=tol)
        got = t_texture.bake_vertex_colors(tpipe, verts, faces, max_cameras=max_cameras, depth_tol=tol)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (np.abs(got - 0.5) > 1e-6).any()  # some vertex was seen
