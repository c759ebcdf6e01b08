"""Export command of the port: point clouds, meshes and camera poses of a trained run (port of the
JAX package's scripts/exporter.py).

    python -m neuradar_tpu_torch.scripts.exporter <command> --load-config <run dir> [--device cpu] ...

Commands: ``pointcloud`` (the eval lidar scans' predicted returns, world frame), ``radar-pointcloud``
(the eval radar scans' points, world frame), ``sdf-surface`` (the SDF's zero crossings on a grid
as points), ``sdf-mesh`` (its marching-tetrahedra mesh), ``tsdf-mesh`` (eval depth maps fused into
a TSDF and meshed), ``poisson-mesh`` (screened Poisson of the lidar point cloud with its normals)
and ``cameras`` (the train and eval camera poses as JSON). ``gaussian-ply`` exports a splatfacto
run, and splatfacto is still to port: the command refuses. The renders and the SDF queries run on
the card unless ``--device cpu`` is given, the marching tetrahedra of the SDF and TSDF meshes on
the same device; the TSDF fusion and the Poisson solve run in numpy on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

# the SDF grid is queried in batches of x slabs of about this many points
SDF_QUERY_POINTS = 2**20


def write_ply(path: Path, points: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """A binary little-endian PLY of float32 points [N, 3], with uchar colors from [0, 1] where given."""
    path.parent.mkdir(parents=True, exist_ok=True)
    n = len(points)
    has_color = colors is not None
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if has_color:
            header += ["property uchar red", "property uchar green", "property uchar blue"]
        header += ["end_header"]
        f.write(("\n".join(header) + "\n").encode())
        if has_color:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = points.astype(np.float32)
            rec["rgb"] = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
            rec.tofile(f)
        else:
            points.astype(np.float32).tofile(f)


def export_camera_poses(pipeline, out_dir: Path) -> None:
    """transforms_train.json and transforms_eval.json: each camera's index and 4 x 4 camera_to_world."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    eval_idx = set(int(i) for i in pipeline.datamanager.eval_camera_indices())
    c2ws = np.asarray(pipeline.outputs.camera_to_worlds)
    splits = {"transforms_train.json": [i for i in range(len(c2ws)) if i not in eval_idx],
              "transforms_eval.json": sorted(eval_idx)}
    for name, idxs in splits.items():
        frames = [{"camera_index": int(i), "transform": np.concatenate([c2ws[i], [[0, 0, 0, 1]]], axis=0).tolist()}
                  for i in idxs]
        (out_dir / name).write_text(json.dumps(frames, indent=4))
        print(f"wrote {len(frames)} poses to {out_dir / name}")


@torch.inference_mode()
def query_sdf_grid(pipeline, res: int, bounds: float) -> np.ndarray:
    """The model's SDF [res, res, res] on the cube [-bounds, bounds]^3 (float32 axes from
    np.linspace), queried on the pipeline's device a batch of x slabs at a time."""
    xs = np.linspace(-bounds, bounds, res, dtype=np.float32)
    axis = torch.as_tensor(xs, device=pipeline.device)
    yy, zz = torch.meshgrid(axis, axis, indexing="ij")
    sdf = np.zeros((res, res, res), np.float32)
    slabs = max(1, SDF_QUERY_POINTS // (res * res))
    for i in range(0, res, slabs):
        x = axis[i : i + slabs]
        pts = torch.stack([x[:, None, None].expand(-1, res, res), yy.expand(len(x), -1, -1),
                           zz.expand(len(x), -1, -1)], dim=-1)
        sdf[i : i + len(x)] = pipeline.model.query_geometry(pts.reshape(len(x) * res, res, 3))[..., 0].reshape(
            len(x), res, res).cpu().numpy()
    return sdf


def sdf_crossings(sdf: np.ndarray, bounds: float) -> np.ndarray:
    """World points where the SDF grid changes sign between neighbours along each axis, placed by
    linear interpolation."""
    res, b = sdf.shape[0], bounds
    surf = []
    for axis in range(3):
        a = np.moveaxis(sdf, axis, 0)
        idx = np.argwhere((a[:-1] * a[1:]) < 0)
        if len(idx) == 0:
            continue
        v0 = a[idx[:, 0], idx[:, 1], idx[:, 2]]
        v1 = a[idx[:, 0] + 1, idx[:, 1], idx[:, 2]]
        coords = idx.astype(np.float32)
        coords[:, 0] += v0 / (v0 - v1 + 1e-9)
        order = [axis, *(i for i in range(3) if i != axis)]
        world = np.empty_like(coords)
        for src, dst in enumerate(order):
            world[:, dst] = coords[:, src]
        surf.append(-b + world * (2 * b / (res - 1)))
    return np.concatenate(surf) if surf else np.zeros((0, 3))


def lidar_points_world(pipeline, max_scans: int, points_per_scan: int):
    """The predicted returns (ray-drop probability under 0.5, padding rows left out) of the first
    ``max_scans`` eval lidar scans in the world frame, and each point's sensor position."""
    pts, origins = [], []
    for scan_idx in list(pipeline.datamanager.eval_lidar_indices())[:max_scans]:
        rend = pipeline.render_lidar(int(scan_idx), max_points=points_per_scan)
        keep = rend["ray_drop_prob"][:, 0].cpu().numpy() < 0.5
        keep[int(rend["num_valid"]):] = False
        sensor = rend["points"][:, :3] / np.linalg.norm(rend["points"][:, :3], axis=-1, keepdims=True).clip(1e-6) \
            * rend["depth"].cpu().numpy()
        l2w = pipeline.tables.lidars.lidar_to_worlds[int(scan_idx)].cpu().numpy()
        pts.append((sensor @ l2w[:3, :3].T + l2w[:3, 3])[keep])
        origins.append(np.broadcast_to(l2w[:3, 3], pts[-1].shape).copy())
    return pts, origins


def main(argv=None) -> int:
    from neuradar_tpu_torch.utils import meshing

    parser = argparse.ArgumentParser()
    parser.add_argument("command", choices=("pointcloud", "radar-pointcloud", "sdf-surface", "sdf-mesh", "tsdf-mesh",
                                            "poisson-mesh", "gaussian-ply", "cameras"))
    parser.add_argument("--load-config", type=Path, required=True)
    parser.add_argument("--output-path", type=Path, default=Path("exports/points.ply"))
    parser.add_argument("--max-scans", type=int, default=8)
    parser.add_argument("--points-per-scan", type=int, default=8192)
    parser.add_argument("--grid-resolution", type=int, default=128)
    parser.add_argument("--bounds", type=float, default=60.0, help="half-extent of the export cube (m)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.command == "gaussian-ply":
        print("exporter gaussian-ply: it exports a splatfacto run, and splatfacto is still to port to "
              "neuradar_tpu_torch", file=sys.stderr)
        return 2

    from neuradar_tpu_torch.scripts.render import load_pipeline
    from neuradar_tpu_torch.scripts.render_radar import ScanSampler

    pipeline = load_pipeline(args.load_config, args.device)
    res, b = args.grid_resolution, args.bounds

    if args.command == "cameras":
        export_camera_poses(pipeline, args.output_path if args.output_path.suffix == "" else args.output_path.parent)
        return 0

    if args.command == "tsdf-mesh":
        u = pipeline.config.model.rgb_upsample_factor
        cam_idxs = [int(c) for c in pipeline.datamanager.eval_camera_indices()][: args.max_scans]
        depths = [pipeline.render_camera(ci)["depth"].cpu().numpy() for ci in cam_idxs]
        tsdf, _, spacing = meshing.tsdf_fuse(
            np.stack(depths), np.stack([np.asarray(pipeline.outputs.intrinsics[ci, :4]) for ci in cam_idxs]),
            np.stack([np.asarray(pipeline.outputs.camera_to_worlds[ci]) for ci in cam_idxs]),
            bounds=b, resolution=res, depth_stride=u)
        verts, faces = meshing.marching_tetrahedra(tsdf, np.array([-b] * 3), spacing, device=pipeline.device)
        meshing.write_ply_mesh(args.output_path, verts, faces)
        print(f"wrote mesh ({len(verts)} verts, {len(faces)} faces) to {args.output_path}")
        return 0

    if args.command in ("sdf-surface", "sdf-mesh"):
        sdf = query_sdf_grid(pipeline, res, b)
        if args.command == "sdf-mesh":
            verts, faces = meshing.marching_tetrahedra(sdf, np.array([-b] * 3), 2 * b / (res - 1),
                                                       device=pipeline.device)
            meshing.write_ply_mesh(args.output_path, verts, faces)
            print(f"wrote mesh ({len(verts)} verts, {len(faces)} faces) to {args.output_path}")
            return 0
        points = sdf_crossings(sdf, b)
        write_ply(args.output_path, points)
        print(f"wrote {len(points)} surface points to {args.output_path}")
        return 0

    if args.command in ("pointcloud", "poisson-mesh"):
        all_pts, all_origins = lidar_points_world(pipeline, args.max_scans, args.points_per_scan)
        if args.command == "poisson-mesh":
            points, origins = np.concatenate(all_pts, axis=0), np.concatenate(all_origins, axis=0)
            inb = np.abs(points).max(axis=1) < b
            points, origins = points[inb], origins[inb]
            if len(points) < 16:
                raise SystemExit("poisson-mesh: too few in-bounds points")
            normals = meshing.estimate_normals(points, origins)
            verts, faces = meshing.screened_poisson_mesh(points, normals, bounds=b, resolution=res)
            meshing.write_ply_mesh(args.output_path, verts, faces)
            print(f"wrote mesh ({len(verts)} verts, {len(faces)} faces) to {args.output_path}")
            return 0
    else:  # radar-pointcloud
        sample = ScanSampler(pipeline.config.model)
        all_pts = []
        for scan_idx in list(pipeline.datamanager.eval_radar_indices())[: args.max_scans]:
            local = sample(pipeline.render_radar(int(scan_idx))["radar_output"])
            r2w = pipeline.tables.radars.radar_to_worlds[int(scan_idx)].cpu().numpy()
            all_pts.append(local @ r2w[:3, :3].T + r2w[:3, 3])

    points = np.concatenate(all_pts, axis=0) if all_pts else np.zeros((0, 3))
    write_ply(args.output_path, points)
    print(f"wrote {len(points)} points to {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
