"""Cameras and batched ray generation (port of the JAX package's cameras/cameras.py).

Every camera type of the JAX package: PERSPECTIVE, equidistant FISHEYE,
EQUIRECTANGULAR, the stereo render types (ODS and VR180, left and right),
ORTHOPHOTO and FISHEYE624; OpenCV radial and tangential distortion (6
coefficients, k1 k2 k3 k4 p1 p2) inverted by a 2x2 Newton solve, and the
12-coefficient FISHEYE624 model; rolling-shutter compensation, row-wise or
(``rs_horizontal``) column-wise, from pixel centres.

Convention: the camera looks down -z, x right, y up; unit-plane coords are
((col + 0.5 - cx) / fx, -(row + 0.5 - cy) / fy).

The Newton solves use the analytic 2x2 Jacobian of the distortion (the JAX
package builds its columns with ``jax.jvp``), so ray generation builds no
autograd graph: no gradient flows into it, the camera optimizer acts on the
generated rays. As in the JAX package, every type's directions are computed
and each ray selects its camera's.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from neuradar_tpu_torch.cameras.rays import RayBundle
from neuradar_tpu_torch.utils import trace
from neuradar_tpu_torch.utils.math import normalize_with_norm


class CameraType(enum.IntEnum):
    PERSPECTIVE = 1
    FISHEYE = 2
    EQUIRECTANGULAR = 3
    # render-only stereo types: equirectangular directions with per-eye origins on the
    # interocular circle (ODS) or axis (VR180)
    OMNIDIRECTIONALSTEREO_L = 4
    OMNIDIRECTIONALSTEREO_R = 5
    ORTHOPHOTO = 6
    FISHEYE624 = 7
    VR180_L = 8
    VR180_R = 9


VR_IPD = 0.064  # interpupillary distance in meters
_ODS = (CameraType.OMNIDIRECTIONALSTEREO_L, CameraType.OMNIDIRECTIONALSTEREO_R)
_VR180 = (CameraType.VR180_L, CameraType.VR180_R)
# the metadata keys rolling-shutter compensation consumes; they do not travel with the rays
_RS_KEYS = ("rolling_shutter_offsets", "velocities", "rs_horizontal")


@dataclass
class Cameras:
    """Batched intrinsics/extrinsics ([N, ...] tensors). ``distortion_params`` is [N, 6] (k1 k2 k3
    k4 p1 p2) or [N, 12] (FISHEYE624's k1..k6 p1 p2 s1..s4). metadata may carry 'sensor_idxs'
    [N, 1] and, for rolling shutter, 'velocities' [N, 3], 'rolling_shutter_offsets' [N, 2] (the
    first and last row's time offsets) and 'rs_horizontal' [N, 1] bool (column-wise readout)."""

    camera_to_worlds: torch.Tensor  # [N, 3, 4]
    fx: torch.Tensor  # [N, 1]
    fy: torch.Tensor  # [N, 1]
    cx: torch.Tensor  # [N, 1]
    cy: torch.Tensor  # [N, 1]
    width: torch.Tensor  # [N, 1] int
    height: torch.Tensor  # [N, 1] int
    camera_type: torch.Tensor  # [N, 1] int
    distortion_params: Optional[torch.Tensor] = None
    times: Optional[torch.Tensor] = None  # [N, 1]
    metadata: Dict[str, torch.Tensor] = field(default_factory=dict)

    def __post_init__(self):
        with trace.host_sync("camera_types"):
            types = torch.unique(self.camera_type)
        with trace.host_sync("camera_types"):
            unknown = {int(t) for t in types.tolist()} - {int(t) for t in CameraType}
        if unknown:
            raise ValueError(f"unknown camera types {sorted(unknown)}")
        if self.distortion_params is not None and self.distortion_params.shape[-1] not in (6, 12):
            raise ValueError(f"distortion_params [N, {self.distortion_params.shape[-1]}]: 6 or 12 per camera")

    @property
    def num_cameras(self) -> int:
        return self.camera_to_worlds.shape[0]


def _newton_2x2(target: torch.Tensor, fn_and_jacobian, num_iters: int) -> torch.Tensor:
    """w with fn(w) = target for [..., 2] coords, from w = target: ``num_iters`` Newton steps on the
    2x2 system, the determinant clamped to 1e-12 where its magnitude falls below."""
    w = target
    for _ in range(num_iters):
        (fx, fy), (a, b, c, d) = fn_and_jacobian(w[..., 0], w[..., 1])  # [[a, b], [c, d]] = d f / d w
        rx, ry = fx - target[..., 0], fy - target[..., 1]
        det = a * d - b * c
        det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
        w = w - torch.stack([(rx * d - ry * b) / det, (a * ry - c * rx) / det], dim=-1)
    return w


def _opencv(x, y, dist):
    """OpenCV's radial (k1..k4) and tangential (p1, p2) distortion of unit-plane coords (x, y),
    dist [..., 6], and its 2x2 Jacobian."""
    k1, k2, k3, k4, p1, p2 = dist.unbind(-1)
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    dradial = k1 + r2 * (2.0 * k2 + r2 * (3.0 * k3 + r2 * 4.0 * k4))  # d radial / d r2
    fx = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    fy = y * radial + 2 * p2 * x * y + p1 * (r2 + 2 * y * y)
    xy = 2.0 * x * y * dradial
    jac = (radial + 2.0 * x * x * dradial + 2 * p1 * y + 6 * p2 * x,
           xy + 2 * p1 * x + 2 * p2 * y,
           xy + 2 * p2 * y + 2 * p1 * x,
           radial + 2.0 * y * y * dradial + 2 * p2 * x + 6 * p1 * y)
    return (fx, fy), jac


def _undistort(coords: torch.Tensor, dist: torch.Tensor, num_iters: int = 5) -> torch.Tensor:
    """Newton inverse of OpenCV's distortion (``_opencv``), dist [..., 6]."""
    return _newton_2x2(coords, lambda x, y: _opencv(x, y, dist), num_iters)


def fisheye624_distort(w: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Forward FISHEYE624 distortion of equidistant-projected coords w [..., 2] (OpenCV frame, y
    down); dist [..., 12] packs k1..k6, p1, p2, s1..s4. The radial polynomial acts on theta, the
    tangential and thin-prism terms on the radially distorted coords."""
    (u, v), _ = _fisheye624(w[..., 0], w[..., 1], dist)
    return torch.stack([u, v], dim=-1)


def _fisheye624(wx, wy, dist):
    """FISHEYE624's forward map and its 2x2 Jacobian at (wx, wy)."""
    k = [dist[..., i] for i in range(6)]
    p1, p2 = dist[..., 6], dist[..., 7]
    s1, s2, s3, s4 = dist[..., 8], dist[..., 9], dist[..., 10], dist[..., 11]
    th2 = wx * wx + wy * wy
    poly = 1.0 + th2 * (k[0] + th2 * (k[1] + th2 * (k[2] + th2 * (k[3] + th2 * (k[4] + th2 * k[5])))))
    dpoly = k[0] + th2 * (2 * k[1] + th2 * (3 * k[2] + th2 * (4 * k[3] + th2 * (5 * k[4] + th2 * 6 * k[5]))))
    ur, vr = wx * poly, wy * poly
    r2 = ur * ur + vr * vr
    u = ur + 2.0 * p1 * ur * vr + p2 * (r2 + 2.0 * ur * ur) + s1 * r2 + s2 * r2 * r2
    v = vr + p1 * (r2 + 2.0 * vr * vr) + 2.0 * p2 * ur * vr + s3 * r2 + s4 * r2 * r2
    # d (ur, vr) / d (wx, wy)
    cross = 2.0 * wx * wy * dpoly
    a0, b0 = poly + 2.0 * wx * wx * dpoly, cross
    c0, d0 = cross, poly + 2.0 * wy * wy * dpoly
    # d (u, v) / d (ur, vr)
    a1 = 1.0 + 2.0 * p1 * vr + 6.0 * p2 * ur + 2.0 * s1 * ur + 4.0 * s2 * r2 * ur
    b1 = 2.0 * p1 * ur + 2.0 * p2 * vr + 2.0 * s1 * vr + 4.0 * s2 * r2 * vr
    c1 = 2.0 * p1 * ur + 2.0 * p2 * vr + 2.0 * s3 * ur + 4.0 * s4 * r2 * ur
    d1 = 1.0 + 6.0 * p1 * vr + 2.0 * p2 * ur + 2.0 * s3 * vr + 4.0 * s4 * r2 * vr
    jac = (a1 * a0 + b1 * c0, a1 * b0 + b1 * d0, c1 * a0 + d1 * c0, c1 * b0 + d1 * d0)
    return (u, v), jac


def _undistort_fisheye624(m: torch.Tensor, dist: torch.Tensor, num_iters: int = 8) -> torch.Tensor:
    """Inverse of fisheye624_distort by a fixed-iteration 2x2 Newton solve."""
    return _newton_2x2(m, lambda wx, wy: _fisheye624(wx, wy, dist), num_iters)


def _fisheye_directions(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Equidistant fisheye: theta = |(x, y)|, clipped to [1e-9, pi]."""
    theta = torch.clamp(torch.sqrt(x * x + y * y), 1e-9, math.pi)
    sot = torch.sin(theta) / theta
    return torch.stack([x * sot, y * sot, -torch.cos(theta)], dim=-1)


def _equirect_directions(theta: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Azimuth ``theta`` and y in [-1/2, 1/2] (the polar angle pi * (1/2 - y)) -> directions."""
    phi = math.pi * (0.5 - y)
    return torch.stack([-torch.sin(theta) * torch.sin(phi), torch.cos(phi), -torch.cos(theta) * torch.sin(phi)], dim=-1)


def _directions_from_coords(unit_coords: torch.Tensor, cam_type: torch.Tensor) -> torch.Tensor:
    """Camera-frame direction (z = -1 forward) per camera type: PERSPECTIVE (x, y, -1); FISHEYE
    equidistant; EQUIRECTANGULAR and ODS map x in [-1, 1] to the azimuth; VR180 halves its range;
    ORTHOPHOTO points straight down -z. Every branch is computed and each ray selects its own."""
    x, y = unit_coords[..., 0], unit_coords[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    ods = (cam_type == CameraType.EQUIRECTANGULAR) | (cam_type == _ODS[0]) | (cam_type == _ODS[1])
    vr180 = (cam_type == _VR180[0]) | (cam_type == _VR180[1])
    out = torch.stack([x, y, -one], dim=-1)
    out = torch.where((cam_type == CameraType.FISHEYE)[..., None], _fisheye_directions(x, y), out)
    out = torch.where(ods[..., None], _equirect_directions(-math.pi * x, y), out)
    out = torch.where(vr180[..., None], _equirect_directions(-math.pi * x / 2, y), out)
    return torch.where((cam_type == CameraType.ORTHOPHOTO)[..., None], torch.stack([zero, zero, -one], dim=-1), out)


def _stereo_origin_offsets(unit_x: torch.Tensor, cam_type: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """World-frame origin offsets [R, 3] of the stereo types: the eye sits VR_IPD/2 from the mount,
    for ODS on the interocular circle turning with the azimuth (camera frame [cos t, 0, -sin t]),
    for VR180 on the fixed x axis; zero for the other types."""
    def side(left, right):
        return (cam_type == right).to(unit_x.dtype) - (cam_type == left).to(unit_x.dtype)

    eye, eye_vr = side(*_ODS), side(*_VR180)
    theta = -math.pi * unit_x
    half = VR_IPD / 2.0
    off_cam = torch.stack([eye * half * torch.cos(theta) + eye_vr * half, torch.zeros_like(unit_x),
                           -eye * half * torch.sin(theta)], dim=-1)
    return torch.einsum("rij,rj->ri", rot, off_cam)


def generate_camera_rays(cameras: Cameras, camera_indices: torch.Tensor, coords: torch.Tensor) -> RayBundle:
    """Rays for (camera, pixel) pairs: camera_indices [R], coords [R, 2] (row, col).

    pixel_area comes from the direction deltas to the +1-pixel neighbours in x and y, as in the
    JAX package; the neighbours are undistorted like the pixel itself."""
    idx = camera_indices.long()
    fx, fy = cameras.fx[idx], cameras.fy[idx]
    cx, cy = cameras.cx[idx], cameras.cy[idx]
    c2w = cameras.camera_to_worlds[idx]
    cam_type = cameras.camera_type[idx][..., 0]

    rows = coords[..., 0].to(fx.dtype)[..., None]
    cols = coords[..., 1].to(fx.dtype)[..., None]

    dist = cameras.distortion_params[idx] if cameras.distortion_params is not None else None
    has_624 = dist is not None and dist.shape[-1] == 12
    # FISHEYE624 reads its own 12 coefficients; the other types of a 12-coefficient table read its
    # k1..k4, p1, p2 slots
    std_dist = torch.cat([dist[..., 0:4], dist[..., 6:8]], -1) if has_624 else dist

    def dirs_for(r, c):
        u = (c + 0.5 - cx) / fx
        v_cv = (r + 0.5 - cy) / fy  # OpenCV frame (y down)
        uv = torch.cat([u, -v_cv], dim=-1)  # undistorted with y flipped, as the JAX package does
        if std_dist is not None:
            uv = _undistort(uv, std_dist)
        d = _directions_from_coords(uv, cam_type)
        if has_624:
            w = _undistort_fisheye624(torch.cat([u, v_cv], dim=-1), dist)
            th = torch.clamp(torch.linalg.vector_norm(w, dim=-1), 1e-9, math.pi)
            sot = torch.sin(th) / th
            d624 = torch.stack([w[..., 0] * sot, -w[..., 1] * sot, -torch.cos(th)], dim=-1)
            d = torch.where((cam_type == CameraType.FISHEYE624)[..., None], d624, d)
        return d

    rot = c2w[..., :3, :3]

    def to_world(d):
        return torch.einsum("rij,rj->ri", rot, d)

    d0, n0 = normalize_with_norm(to_world(dirs_for(rows, cols)))
    d1, _ = normalize_with_norm(to_world(dirs_for(rows, cols + 1)))
    d2, _ = normalize_with_norm(to_world(dirs_for(rows + 1, cols)))
    dx = torch.linalg.vector_norm(d0 - d1, dim=-1)
    dy = torch.linalg.vector_norm(d0 - d2, dim=-1)
    pixel_area = (dx * dy)[..., None]

    origins = c2w[..., :3, 3] + _stereo_origin_offsets(((cols + 0.5 - cx) / fx)[..., 0], cam_type, rot)
    times = cameras.times[idx] if cameras.times is not None else None

    metadata = {k: v[idx] for k, v in cameras.metadata.items() if k not in _RS_KEYS}
    metadata["directions_norm"] = n0

    # rolling shutter: row-wise by default, column-wise where rs_horizontal; the readout fraction
    # is taken at the pixel centre
    meta = cameras.metadata
    if "rolling_shutter_offsets" in meta and "velocities" in meta:
        offsets = meta["rolling_shutter_offsets"][idx]  # [R, 2]
        duration = offsets[..., 1:2] - offsets[..., 0:1]
        frac = (rows + 0.5) / cameras.height[idx].to(rows.dtype)
        if "rs_horizontal" in meta:
            frac = torch.where(meta["rs_horizontal"][idx], (cols + 0.5) / cameras.width[idx].to(cols.dtype), frac)
        time_offsets = frac * duration + offsets[..., 0:1]
        origins = origins + meta["velocities"][idx] * time_offsets
        if times is not None:
            times = times + time_offsets

    return RayBundle(
        origins=origins,
        directions=d0,
        pixel_area=pixel_area,
        camera_indices=idx[..., None].int(),
        times=times,
        metadata=metadata,
        fars=torch.full_like(pixel_area, 1e6),
    )
