"""Mesh extraction (port of the JAX package's utils/meshing.py, the same arithmetic): marching
tetrahedra (6 tetrahedra a cube, a 16-case table) for an isosurface of a grid, in torch on a given
device with the numpy version's operations one for one; and in numpy on the host, TSDF fusion of
rendered depth maps, screened-Poisson reconstruction of an oriented point cloud by a DCT solve, PLY
mesh I/O, vertex normals and k-NN normal estimation.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

# tet decomposition of a cube: corners indexed by bits (x, y, z) -> 0..7 with
# vertex v = (i + dx, j + dy, k + dz), index = dx*4 + dy*2 + dz. All six tets
# share the main diagonal 0-7.
_CUBE_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    np.int64,
)

# tet edges as (vertex a, vertex b) pairs
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)

# case -> up to 2 triangles of edge ids (-1 = unused); bit i set = vertex i
# is inside (value < level)
_TET_TRIS = -np.ones((16, 2, 3), np.int64)
_TET_TRIS[0x1, 0] = (0, 1, 2)
_TET_TRIS[0x2, 0] = (0, 4, 3)
_TET_TRIS[0x4, 0] = (1, 3, 5)
_TET_TRIS[0x8, 0] = (2, 5, 4)
_TET_TRIS[0x3] = ((1, 2, 4), (1, 4, 3))
_TET_TRIS[0x5] = ((0, 3, 5), (0, 5, 2))
_TET_TRIS[0x9] = ((0, 4, 5), (0, 5, 1))
_TET_TRIS[0x6] = ((0, 5, 4), (0, 1, 5))
_TET_TRIS[0xA] = ((0, 5, 3), (0, 2, 5))
_TET_TRIS[0xC] = ((1, 4, 2), (1, 3, 4))
_TET_TRIS[0x7] = ((2, 4, 5), (-1, -1, -1))
_TET_TRIS[0xB] = ((1, 5, 3), (-1, -1, -1))
_TET_TRIS[0xD] = ((0, 3, 4), (-1, -1, -1))
_TET_TRIS[0xE] = ((0, 2, 1), (-1, -1, -1))
# marching_tetrahedra takes the cubes of this many at a time (whole x slabs)
MARCHING_BATCH_CUBES = 1 << 21


def marching_tetrahedra(
    grid: np.ndarray,
    origin: np.ndarray,
    spacing: float,
    level: float = 0.0,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the `level` isosurface of a scalar grid as a triangle mesh, computed in torch on
    ``device`` (the grid's cubes a batch of x slabs at a time) with the JAX package's numpy
    arithmetic op for op, so the result is its result to the bit.

    Args:
        grid: [Nx, Ny, Nz] scalar field (e.g. signed distance).
        origin: world position of voxel (0, 0, 0).
        spacing: voxel edge length.
    Returns:
        (verts [V, 3] float32 world coords, faces [F, 3] int32). Vertices are
        deduplicated on edge identity so faces share vertices.
    """
    dev = torch.device(device)
    g = torch.as_tensor(np.asarray(grid), device=dev)
    nx, ny, nz = g.shape
    cube_tets = torch.as_tensor(_CUBE_TETS, device=dev)
    tet_edges = torch.as_tensor(_TET_EDGES, device=dev)
    tet_tris = torch.as_tensor(_TET_TRIS, device=dev)
    bits = torch.tensor([1, 2, 4, 8], device=dev)
    corner_off = torch.tensor([(d >> 2 & 1, d >> 1 & 1, d & 1) for d in range(8)], dtype=torch.long, device=dev)
    jj, kk = torch.meshgrid(torch.arange(ny - 1, device=dev), torch.arange(nz - 1, device=dev), indexing="ij")
    jj, kk = jj.reshape(-1), kk.reshape(-1)
    slabs = max(1, MARCHING_BATCH_CUBES // max(len(jj), 1))
    verts_all = []
    # the cubes in the order of the numpy slab loop: x slab, then (y, z); 6 tetrahedra a cube
    for i0 in range(0, nx - 1, slabs):
        ii = torch.arange(i0, min(i0 + slabs, nx - 1), device=dev)
        ci = torch.stack([ii[:, None].expand(-1, len(jj)), jj.expand(len(ii), -1), kk.expand(len(ii), -1)], -1)
        corners = ci.reshape(-1, 1, 3) + corner_off[None]  # [M, 8, 3]
        vals = g[corners[..., 0], corners[..., 1], corners[..., 2]] - level  # [M, 8]
        tv = vals[:, cube_tets].reshape(-1, 4)
        tc = corners[:, cube_tets].reshape(-1, 4, 3)
        case = ((tv < 0) * bits).sum(-1)
        tris = tet_tris[case]  # [T, 2, 3]
        t_idx, tri_idx = torch.nonzero(tris[..., 0] >= 0, as_tuple=True)
        if len(t_idx) == 0:
            continue
        edges = tris[t_idx, tri_idx]  # [K, 3] edge ids
        ea, eb = tet_edges[edges][..., 0], tet_edges[edges][..., 1]
        va, vb = tv[t_idx[:, None], ea], tv[t_idx[:, None], eb]  # [K, 3]
        pa, pb = tc[t_idx[:, None], ea].double(), tc[t_idx[:, None], eb].double()  # [K, 3, 3]
        t = (va / (va - vb + 1e-30))[..., None]
        verts_all.append((pa + t * (pb - pa)).reshape(-1, 3))

    if not verts_all:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    v = torch.cat(verts_all)  # [3F, 3] grid coords, 3 per face in order
    # dedupe vertices (quantized to 1e-5 voxel, rows in lexicographic order as np.unique) so faces
    # share them; each unique vertex represented by its last occurrence
    key = torch.round(v * 1e5).to(torch.long)
    uniq, inv = torch.unique(key, dim=0, return_inverse=True)
    order = torch.zeros(len(uniq), dtype=torch.long, device=dev).scatter_reduce_(
        0, inv, torch.arange(len(v), device=dev), reduce="amax", include_self=False)
    verts = v[order] * spacing + torch.as_tensor(np.asarray(origin, np.float64), device=dev)
    faces = inv.reshape(-1, 3).to(torch.int32)
    # drop degenerate faces (two corners snapped together)
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return verts.float().cpu().numpy(), faces[ok].cpu().numpy()


def tsdf_fuse(
    depths: np.ndarray,
    intrinsics: np.ndarray,
    c2ws: np.ndarray,
    bounds: float,
    resolution: int,
    trunc: Optional[float] = None,
    depth_stride: int = 1,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Fuse per-view euclidean depth maps into a TSDF volume.

    cf. nerfstudio/exporter/tsdf_utils.py:TSDF.integrate_tsdf. Depth maps are
    along-ray euclidean distances (the renderer's expected-depth output) at
    `depth_stride` subsampling of the full-res intrinsics (the NeuRadar CNN
    renders 1 ray per u x u pixel block).

    Returns (tsdf [R, R, R], weights [R, R, R], spacing); surface at tsdf=0.
    """
    R = resolution
    spacing = 2 * bounds / (R - 1)
    xs = np.linspace(-bounds, bounds, R, dtype=np.float64)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)  # [N, 3]
    if trunc is None:
        trunc = 4.0 * spacing

    tsdf = np.zeros(len(pts), np.float64)
    weight = np.zeros(len(pts), np.float64)
    for v in range(len(depths)):
        fx, fy, cx, cy = intrinsics[v][:4]
        c2w = np.vstack([c2ws[v][:3], [0, 0, 0, 1]])
        w2c = np.linalg.inv(c2w)
        p_cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        z = -p_cam[:, 2]  # camera looks down -z
        with np.errstate(divide="ignore", invalid="ignore"):
            px = fx * (p_cam[:, 0] / z) + cx
            py = fy * (-p_cam[:, 1] / z) + cy
        h, w = depths[v].shape
        col = np.clip((px / depth_stride).astype(np.int64), 0, w - 1)
        row = np.clip((py / depth_stride).astype(np.int64), 0, h - 1)
        valid = (z > 0.05) & (px >= 0) & (px < w * depth_stride) & (py >= 0) & (py < h * depth_stride)
        d_obs = depths[v][row, col]
        dist = np.linalg.norm(pts - c2w[:3, 3], axis=-1)
        sdf = d_obs - dist
        upd = valid & (sdf > -trunc) & np.isfinite(d_obs)
        val = np.clip(sdf / trunc, -1.0, 1.0)
        tsdf[upd] = (tsdf[upd] * weight[upd] + val[upd]) / (weight[upd] + 1.0)
        weight[upd] += 1.0

    # unobserved voxels stay far outside so no phantom surface appears
    tsdf[weight == 0] = 1.0
    return tsdf.reshape(R, R, R), weight.reshape(R, R, R), spacing


def write_ply_mesh(path: Path, verts: np.ndarray, faces: np.ndarray,
                   colors: np.ndarray = None) -> None:
    """Binary little-endian PLY with vertex + face elements; optional
    per-vertex colors in [0, 1] stored as uchar rgb."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        vprops = ["property float x", "property float y", "property float z"]
        if colors is not None:
            vprops += ["property uchar red", "property uchar green", "property uchar blue"]
        header = [
            "ply", "format binary_little_endian 1.0",
            f"element vertex {len(verts)}", *vprops,
            f"element face {len(faces)}",
            "property list uchar int vertex_indices",
            "end_header",
        ]
        f.write(("\n".join(header) + "\n").encode())
        if colors is None:
            verts.astype("<f4").tofile(f)
        else:
            rec = np.zeros(len(verts), dtype=[("xyz", "<f4", 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = verts
            rec["rgb"] = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
            rec.tofile(f)
        rec = np.zeros(len(faces), dtype=[("n", np.uint8), ("idx", "<i4", 3)])
        rec["n"] = 3
        rec["idx"] = faces
        rec.tofile(f)


def read_ply_mesh(path: Path):
    """Read a binary little-endian PLY written by write_ply_mesh (plain or
    vertex-colored): returns (verts [N, 3] f32, faces [F, 3] i32,
    colors [N, 3] float in [0,1] or None)."""
    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode().splitlines()
    n_vert = n_face = 0
    vert_props = []
    element = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "element":
            element = parts[1]
            if element == "vertex":
                n_vert = int(parts[2])
            elif element == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and element == "vertex" and parts[1] != "list":
            vert_props.append((parts[2], parts[1]))
    type_map = {"float": "<f4", "uchar": "u1", "double": "<f8", "int": "<i4"}
    vdtype = np.dtype([(name, type_map[t]) for name, t in vert_props])
    body = data[end:]
    vrec = np.frombuffer(body, dtype=vdtype, count=n_vert)
    verts = np.stack([vrec["x"], vrec["y"], vrec["z"]], axis=1).astype(np.float32)
    colors = None
    names = {n for n, _ in vert_props}
    if {"red", "green", "blue"} <= names:
        colors = np.stack([vrec["red"], vrec["green"], vrec["blue"]], axis=1).astype(np.float32) / 255.0
    fdtype = np.dtype([("n", np.uint8), ("idx", "<i4", 3)])
    frec = np.frombuffer(body, dtype=fdtype, count=n_face, offset=n_vert * vdtype.itemsize)
    return verts, frec["idx"].astype(np.int32), colors


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals from a triangle mesh."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted face normals
    normals = np.zeros_like(verts)
    for k in range(3):
        np.add.at(normals, faces[:, k], fn)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.clip(norm, 1e-12, None)


def estimate_normals(points: np.ndarray, view_origins: np.ndarray, k: int = 16) -> np.ndarray:
    """Per-point normals via k-NN PCA, oriented to face the sensor.

    view_origins: [N, 3] the sensor position each point was observed from
    (a lidar scan knows it exactly, so no orientation heuristic is needed).
    """
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    _, nbr = tree.query(points, k=min(k, len(points)))
    nbrs = points[nbr]  # [N, k, 3]
    centered = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered)
    # smallest-eigenvalue eigenvector of each 3x3 covariance
    _, vecs = np.linalg.eigh(cov)  # ascending eigenvalues
    normals = vecs[:, :, 0]
    to_sensor = view_origins - points
    flip = np.sign(np.einsum("ni,ni->n", normals, to_sensor))
    flip[flip == 0] = 1.0
    return normals * flip[:, None]


def screened_poisson_mesh(
    points: np.ndarray,
    normals: np.ndarray,
    bounds: float,
    resolution: int = 128,
    screen: float = 1e-2,
    smooth_sigma_vox: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Screened-Poisson reconstruction: solve (lap - screen) chi = div V for
    the indicator chi, where V is the splatted oriented-normal field, then
    extract the isosurface at the mean chi over the input samples.

    Regular-grid formulation of Kazhdan et al.: normals are trilinearly
    splatted (+ gaussian smoothing in the spectral domain), the Poisson
    solve is exact in DCT-II space (Neumann boundaries — the right BC for an
    open scene crop), and the mesh comes from the same marching-tetrahedra
    used everywhere else in this module.

    Returns (verts [V, 3], faces [F, 3]) in world coordinates.
    """
    from scipy import fft as sfft

    res, b = resolution, bounds
    h = 2 * b / (res - 1)
    # --- trilinear normal splat into V [3, res, res, res]
    gp = (points + b) / h
    i0 = np.clip(np.floor(gp).astype(np.int64), 0, res - 2)
    frac = np.clip(gp - i0, 0.0, 1.0)
    V = np.zeros((3, res, res, res), np.float64)
    for corner in range(8):
        bits = np.array([(corner >> 2) & 1, (corner >> 1) & 1, corner & 1])
        w = np.prod(np.where(bits[None, :], frac, 1 - frac), axis=1)  # [N]
        idx = i0 + bits[None, :]
        flat = (idx[:, 0] * res + idx[:, 1]) * res + idx[:, 2]
        for axis in range(3):
            np.add.at(V[axis].reshape(-1), flat, w * normals[:, axis])

    # --- divergence (central differences, Neumann edges)
    div = np.zeros((res, res, res), np.float64)
    for axis in range(3):
        div += np.gradient(V[axis], h, axis=axis)

    # --- spectral solve in DCT-II space: eigenvalues of the 1-D Neumann
    # Laplacian are (2 cos(pi k / res) - 2) / h^2
    lam1 = (2.0 * np.cos(np.pi * np.arange(res) / res) - 2.0) / (h * h)
    lam = lam1[:, None, None] + lam1[None, :, None] + lam1[None, None, :]
    rhs = sfft.dctn(div, type=2, norm="ortho")
    if smooth_sigma_vox > 0:
        # gaussian low-pass (applied spectrally — smooths the splat noise)
        sig = smooth_sigma_vox * np.pi / res
        g1 = np.exp(-0.5 * (sig * np.arange(res)) ** 2)
        rhs = rhs * g1[:, None, None] * g1[None, :, None] * g1[None, None, :]
    chi_hat = rhs / (lam - screen)  # lam <= 0 so the denominator never hits 0
    chi = sfft.idctn(chi_hat, type=2, norm="ortho")

    # --- iso level: mean chi at the input samples (Kazhdan's choice)
    samp = chi[
        np.clip(np.round(gp[:, 0]).astype(int), 0, res - 1),
        np.clip(np.round(gp[:, 1]).astype(int), 0, res - 1),
        np.clip(np.round(gp[:, 2]).astype(int), 0, res - 1),
    ]
    level = float(samp.mean())
    return marching_tetrahedra(
        (chi - level).astype(np.float32), np.array([-b] * 3, np.float32), h
    )
