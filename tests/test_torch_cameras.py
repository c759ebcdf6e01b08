"""The port's camera model (neuradar_tpu_torch/cameras/cameras.py) against the JAX package's.

Every camera type, without distortion, with the 6-coefficient OpenCV model and with the
12-coefficient layout; rolling shutter row-wise and column-wise; a table that mixes every type;
ZOD's front camera (an equidistant fisheye with distortion of fisheye strength) over its whole
image; and the Newton solves on their own. The cameras, poses and pixels are made with numpy from
a seed and fed to both sides in float32. Each test states its tolerance.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuradar_tpu.cameras import cameras as jc
from neuradar_tpu.data.datamanager import build_sensor_tables as j_build_sensor_tables
from neuradar_tpu.data.dataparsers.synthetic import SyntheticDataParser, SyntheticDataParserConfig
from neuradar_tpu_torch.cameras import cameras as tc
from neuradar_tpu_torch.data.datamanager import build_sensor_tables as t_build_sensor_tables
from neuradar_tpu_torch.data.dataparsers import synthetic as t_synthetic

# the distortion of tests/test_sensors.py's Newton test (fisheye strength) and, for the 12-slot
# layout, FISHEYE624's of tests/test_fisheye624.py
DIST6 = np.array([-0.2, 0.05, 0.001, 0.0, 0.01, -0.01], np.float32)
DIST12 = np.array([0.35, -0.12, 0.03, -0.004, 0.0005, -0.00002,
                   1e-3, -8e-4, 5e-4, -2e-4, 3e-4, -1e-4], np.float32)
# float32 on both sides; the Newton solves build their Jacobians analytically here and by jvp in the
# JAX package, and every trigonometric function rounds its last ulp on its own
TOL = dict(rtol=1e-5, atol=1e-5)
# the pixel footprint is a product of two differences of neighbouring unit vectors (~1e-3 each),
# so the directions' float32 rounding (6e-8) enters it relatively at ~1e-4
AREA_TOL = dict(rtol=2e-4, atol=1e-9)
# ZOD's front camera after the hood crop, an equidistant fisheye whose 3848 columns span 120 degrees
ZOD_H, ZOD_W = 1418, 3848
ZOD_F = (ZOD_W / 2) / (math.pi / 3)


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)], -2)


def _camera_arrays(seed, types, dist=None, rs=None, H=48, W=64, f=None):
    """numpy fields of a camera table: one camera per entry of ``types``; ``rs`` None, "vertical" or
    "horizontal" (half of the cameras read out column-wise)."""
    rng = np.random.RandomState(seed)
    n = len(types)
    c2w = np.concatenate([_rotations(rng, n), rng.normal(size=(n, 3, 1)) * 5], -1).astype(np.float32)
    f = f if f is not None else rng.uniform(0.6, 1.2, (n, 1)) * W
    fields = dict(
        camera_to_worlds=c2w,
        fx=np.broadcast_to(f, (n, 1)).astype(np.float32),
        fy=(np.broadcast_to(f, (n, 1)) * rng.uniform(0.95, 1.05, (n, 1))).astype(np.float32),
        cx=(W / 2 + rng.uniform(-3, 3, (n, 1))).astype(np.float32),
        cy=(H / 2 + rng.uniform(-3, 3, (n, 1))).astype(np.float32),
        width=np.full((n, 1), W, np.int32), height=np.full((n, 1), H, np.int32),
        camera_type=np.asarray(types, np.int32)[:, None],
        times=rng.uniform(0, 5, (n, 1)).astype(np.float32),
    )
    if dist is not None:
        fields["distortion_params"] = np.tile(dist[None], (n, 1)).astype(np.float32)
    meta = {"sensor_idxs": np.arange(n, dtype=np.int32)[:, None] % 2}
    if rs is not None:
        meta["velocities"] = rng.normal(size=(n, 3)).astype(np.float32) * 5
        start = rng.uniform(-0.03, 0.0, (n, 1))
        meta["rolling_shutter_offsets"] = np.concatenate([start, start + 0.05], 1).astype(np.float32)
        if rs == "horizontal":
            meta["rs_horizontal"] = (np.arange(n) % 2 == 0)[:, None]
    fields["metadata"] = meta
    return fields


def _coords(seed, n_rays, n_cams, H=48, W=64):
    rng = np.random.RandomState(seed + 100)
    idx = rng.randint(0, n_cams, n_rays).astype(np.int32)
    coords = np.stack([rng.randint(0, H, n_rays), rng.randint(0, W, n_rays)], 1).astype(np.float32)
    return idx, coords


def _both(fields, idx, coords):
    jcams = jc.Cameras(**{k: ({m: jnp.asarray(a) for m, a in v.items()} if k == "metadata" else jnp.asarray(v))
                          for k, v in fields.items()})
    tcams = tc.Cameras(**{k: ({m: torch.from_numpy(np.asarray(a)) for m, a in v.items()} if k == "metadata"
                              else torch.from_numpy(np.asarray(v))) for k, v in fields.items()})
    want = jax.jit(jc.generate_camera_rays)(jcams, jnp.asarray(idx), jnp.asarray(coords))
    got = tc.generate_camera_rays(tcams, torch.from_numpy(idx), torch.from_numpy(coords))
    return got, want


def _check(got, want, tol=TOL, area_tol=AREA_TOL):
    for name in ("origins", "directions", "times", "camera_indices", "fars"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert tuple(g.shape) == tuple(w.shape), name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **tol)
    np.testing.assert_allclose(got.pixel_area.numpy(), np.asarray(want.pixel_area), err_msg="pixel_area", **area_tol)
    assert sorted(got.metadata) == sorted(want.metadata)
    for key in want.metadata:
        np.testing.assert_allclose(got.metadata[key].numpy(), np.asarray(want.metadata[key]), err_msg=key, **tol)


@pytest.mark.parametrize("dist", [None, "6", "12"])
@pytest.mark.parametrize("cam_type", list(tc.CameraType), ids=lambda t: t.name)
def test_generate_camera_rays_every_type(cam_type, dist):
    """One camera type a table of 3 cameras, 256 random pixels: origins, directions, times, camera
    indices, pixel_area and the metadata, without distortion and with 6 or 12 coefficients."""
    d = {None: None, "6": DIST6 * 0.5, "12": DIST12}[dist]
    fields = _camera_arrays(int(cam_type) * 10 + (dist is not None) + (dist == "12"), [int(cam_type)] * 3, d)
    if cam_type in (tc.CameraType.EQUIRECTANGULAR, *tc._ODS, *tc._VR180):
        # the unit x of the equirectangular types spans [-1, 1] at fx = W / 2
        fields["fx"] = np.full((3, 1), 32.0, np.float32)
        fields["fy"] = np.full((3, 1), 32.0, np.float32)
    got, want = _both(fields, *_coords(int(cam_type), 256, 3))
    _check(got, want)


@pytest.mark.parametrize("rs", ["vertical", "horizontal"])
@pytest.mark.parametrize("cam_type", [tc.CameraType.PERSPECTIVE, tc.CameraType.FISHEYE], ids=lambda t: t.name)
def test_rolling_shutter(cam_type, rs):
    """Rolling shutter from pixel centres: row-wise, and column-wise on the cameras flagged
    rs_horizontal; the velocities and offsets stay out of the rays' metadata."""
    fields = _camera_arrays(7, [int(cam_type)] * 4, DIST6, rs=rs)
    got, want = _both(fields, *_coords(7, 256, 4))
    _check(got, want)
    assert "velocities" not in got.metadata and "rolling_shutter_offsets" not in got.metadata
    still = _both(_camera_arrays(7, [int(cam_type)] * 4, DIST6), *_coords(7, 256, 4))[0]
    assert not np.allclose(got.origins.numpy(), still.origins.numpy())


def test_mixed_camera_types():
    """A table that holds every type, with 12 coefficients and rolling shutter: each ray takes its
    own camera's branch."""
    types = [int(t) for t in tc.CameraType] * 2
    fields = _camera_arrays(3, types, DIST12, rs="horizontal")
    cams = tc.Cameras(**{k: ({m: torch.from_numpy(np.asarray(a)) for m, a in v.items()} if k == "metadata"
                             else torch.from_numpy(np.asarray(v))) for k, v in fields.items()})
    assert set(torch.unique(cams.camera_type).tolist()) == set(types)
    got, want = _both(fields, *_coords(3, 512, len(types)))
    _check(got, want)


@pytest.mark.parametrize("corner", ["grid", "edges"])
def test_zod_fisheye_whole_image(corner):
    """ZOD's front camera: FISHEYE with the 6 coefficients at full strength, 3848 x 1418, over a grid
    of the whole image and along its four edges (where the Newton solve works hardest). Directions
    within 1e-5 of the JAX package's (the largest difference found: 3.3e-7); the pixel footprint,
    differences of neighbouring directions 5e-4 apart, within rtol 1e-3 (found: 7.9e-4)."""
    H, W = ZOD_H, ZOD_W
    fields = _camera_arrays(11, [int(tc.CameraType.FISHEYE)], DIST6, H=H, W=W, f=ZOD_F)
    fields["cx"] = np.full((1, 1), W / 2, np.float32)
    fields["cy"] = np.full((1, 1), 2168 / 2, np.float32)  # the crop removes rows below the centre only
    if corner == "grid":
        rr, cc = np.meshgrid(np.linspace(0, H - 1, 61), np.linspace(0, W - 1, 97), indexing="ij")
    else:
        edge_r, edge_c = np.arange(0, H, 7), np.arange(0, W, 7)
        rr = np.concatenate([edge_r, edge_r, np.zeros_like(edge_c), np.full_like(edge_c, H - 1)])
        cc = np.concatenate([np.zeros_like(edge_r), np.full_like(edge_r, W - 1), edge_c, edge_c])
    coords = np.stack([rr.reshape(-1), cc.reshape(-1)], 1).astype(np.float32)
    got, want = _both(fields, np.zeros(len(coords), np.int32), coords)
    _check(got, want, dict(rtol=0, atol=1e-5), dict(rtol=1e-3, atol=1e-10))
    assert float(np.abs(got.directions.numpy() - np.asarray(want.directions)).max()) < 1e-5


def test_undistort_solves():
    """The Newton solves alone against the JAX package's, and each against its forward model:
    OpenCV's at fisheye strength out to |uv| = 1.5, FISHEYE624's out to theta = 1.4."""
    rng = np.random.RandomState(0)
    uv = rng.uniform(-1.05, 1.05, (512, 2)).astype(np.float32)
    dist = np.tile(DIST6[None], (512, 1))
    got = tc._undistort(torch.from_numpy(uv), torch.from_numpy(dist)).numpy()
    want = np.asarray(jc._undistort(jnp.asarray(uv), jnp.asarray(dist)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    w = rng.uniform(-1.0, 1.0, (512, 2)).astype(np.float32)
    d12 = np.tile(DIST12[None], (512, 1))
    m = tc.fisheye624_distort(torch.from_numpy(w), torch.from_numpy(d12))
    np.testing.assert_allclose(m.numpy(), np.asarray(jc.fisheye624_distort(jnp.asarray(w), jnp.asarray(d12))),
                               rtol=1e-6, atol=1e-6)
    back = tc._undistort_fisheye624(m, torch.from_numpy(d12)).numpy()
    np.testing.assert_allclose(back, np.asarray(jc._undistort_fisheye624(jnp.asarray(m.numpy()), jnp.asarray(d12))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(back, w, atol=1e-5)


def test_analytic_jacobians_match_autograd():
    """The Newton solves' analytic 2x2 Jacobians against torch's autograd of the forward models."""
    rng = np.random.RandomState(1)
    x, y = (torch.from_numpy(rng.uniform(-1, 1, 64)).double() for _ in range(2))
    for fn, dist in ((tc._opencv, DIST6), (tc._fisheye624, DIST12)):
        d = torch.from_numpy(np.tile(dist[None], (64, 1))).double()
        fn_d = (lambda a, b, fn=fn, d=d: fn(a, b, d))
        (_, _), jac = fn_d(x, y)
        xr, yr = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        (fu, fv), _ = fn_d(xr, yr)
        gu = torch.autograd.grad(fu.sum(), (xr, yr), retain_graph=True)
        gv = torch.autograd.grad(fv.sum(), (xr, yr))
        for got, want in zip(jac, (gu[0], gu[1], gv[0], gv[1])):
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_sensor_tables_carry_distortion_and_rolling_shutter():
    """build_sensor_tables' camera table against the JAX package's on a scene with distortion,
    velocities, readout offsets and column-wise readout on half the frames; the train rays of both
    tables agree."""
    scene = dict(num_frames=6, image_height=24, image_width=36, lidar_points_per_scan=64)
    j_out = SyntheticDataParser(SyntheticDataParserConfig(**scene)).get_dataparser_outputs()
    t_out = t_synthetic.SyntheticDataParser(t_synthetic.SyntheticDataParserConfig(**scene)).get_dataparser_outputs()
    n = len(j_out.camera_to_worlds)
    rng = np.random.RandomState(4)
    extra = dict(camera_type=np.full(n, int(tc.CameraType.FISHEYE)),
                 distortion_params=np.tile(DIST6[None], (n, 1)),
                 camera_velocities=rng.normal(size=(n, 3)).astype(np.float32),
                 rolling_shutter_offsets=np.tile(np.array([[-0.01, 0.02]], np.float32), (n, 1)),
                 rolling_shutter_horizontal=np.arange(n) % 2 == 0)
    for out in (j_out, t_out):
        for k, v in extra.items():
            setattr(out, k, v)
    jt, tt = j_build_sensor_tables(j_out), t_build_sensor_tables(t_out, torch.device("cpu"))
    assert torch.unique(tt.cameras.camera_type).tolist() == [int(tc.CameraType.FISHEYE)]
    np.testing.assert_array_equal(tt.cameras.distortion_params.numpy(), np.asarray(jt.cameras.distortion_params))
    assert sorted(tt.cameras.metadata) == sorted(jt.cameras.metadata)
    for key, want in jt.cameras.metadata.items():
        np.testing.assert_array_equal(tt.cameras.metadata[key].numpy(), np.asarray(want), err_msg=key)
    idx, coords = _coords(5, 200, n, 24, 36)
    want = jc.generate_camera_rays(jt.cameras, jnp.asarray(idx), jnp.asarray(coords))
    got = tc.generate_camera_rays(tt.cameras, torch.from_numpy(idx), torch.from_numpy(coords))
    _check(got, want)


def test_camera_table_checks():
    """An unknown type or a distortion layout other than 6 or 12 coefficients is refused."""
    fields = _camera_arrays(0, [1, 2])
    base = {k: torch.from_numpy(np.asarray(v)) for k, v in fields.items() if k != "metadata"}
    with pytest.raises(ValueError, match="unknown camera types"):
        tc.Cameras(**{**base, "camera_type": torch.tensor([[1], [12]], dtype=torch.int32)})
    with pytest.raises(ValueError, match="6 or 12"):
        tc.Cameras(**base, distortion_params=torch.zeros(2, 4))
