"""Texture command of the port: colours the vertices of a mesh from a trained run's renders and
writes a vertex-coloured PLY (port of the JAX package's scripts/texture.py).

Each vertex is projected into up to ``--max-cameras`` rendered views (the eval cameras first, then
the train cameras); a view counts where its rendered depth agrees with the vertex's
(``--depth-tol``, relative), weighted by the cosine between the vertex normal and the direction
to the camera. Vertices that no view sees are grey.

    python -m neuradar_tpu_torch.scripts.texture --load-config <run dir> --input-mesh mesh.ply \
        [--output-path exports/textured.ply] [--device cpu]

It renders on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def bake_vertex_colors(pipeline, verts: np.ndarray, faces: np.ndarray, max_cameras: int = 8,
                       depth_tol: float = 0.08) -> np.ndarray:
    """[N, 3] vertex colors in [0, 1] from up to ``max_cameras`` rendered views (float64 on the host)."""
    from neuradar_tpu_torch.utils.meshing import vertex_normals
    from neuradar_tpu_torch.viewer.overlays import project_points

    normals = vertex_normals(verts, faces)
    acc = np.zeros((len(verts), 3), np.float64)
    wsum = np.zeros(len(verts), np.float64)
    cam_idxs = [int(i) for i in pipeline.datamanager.eval_camera_indices()]
    seen = set(cam_idxs)
    cam_idxs = (cam_idxs + [i for i in range(len(pipeline.outputs.camera_to_worlds)) if i not in seen])[:max_cameras]
    for ci in cam_idxs:
        rend = pipeline.render_camera(ci)
        rgb = rend["rgb"].double().cpu().numpy()
        depth = rend["depth"].double().cpu().numpy()
        H, W = rgb.shape[:2]
        if depth.shape != (H, W):  # one depth a u x u block: repeated to the rgb's grid
            ry, rx = H // depth.shape[0], W // depth.shape[1]
            depth = np.repeat(np.repeat(depth, ry, axis=0), rx, axis=1)[:H, :W]
        c2w = np.asarray(pipeline.outputs.camera_to_worlds[ci])
        fx, fy, cx, cy = np.asarray(pipeline.outputs.intrinsics[ci, :4])
        uv, z = project_points(c2w, fx, fy, cx, cy, verts)
        u = np.round(uv[:, 0]).astype(np.int64)
        v = np.round(uv[:, 1]).astype(np.int64)
        inside = (z > 0.1) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        ui, vi = np.clip(u, 0, W - 1), np.clip(v, 0, H - 1)
        visible = inside & (np.abs(depth[vi, ui] - z) < depth_tol * np.maximum(z, 1.0))
        view_dir = c2w[:3, 3][None] - verts  # vertex -> camera
        view_dir = view_dir / np.clip(np.linalg.norm(view_dir, axis=1, keepdims=True), 1e-9, None)
        w = np.clip(np.sum(normals * view_dir, axis=1), 0.0, None)  # front-facing weight
        w = np.where(visible, w, 0.0)
        acc += rgb[vi, ui] * w[:, None]
        wsum += w
    colors = np.where(wsum[:, None] > 1e-9, acc / np.clip(wsum[:, None], 1e-9, None), 0.5)
    return np.clip(colors, 0.0, 1.0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--load-config", type=Path, required=True)
    parser.add_argument("--input-mesh", type=Path, required=True, help="PLY mesh (e.g. exporter sdf-mesh output)")
    parser.add_argument("--output-path", type=Path, default=Path("exports/textured.ply"))
    parser.add_argument("--max-cameras", type=int, default=8)
    parser.add_argument("--depth-tol", type=float, default=0.08, help="relative rendered-depth agreement for visibility")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from neuradar_tpu_torch.scripts.render import load_pipeline
    from neuradar_tpu_torch.utils.meshing import read_ply_mesh, write_ply_mesh

    pipeline = load_pipeline(args.load_config, args.device)
    verts, faces, _ = read_ply_mesh(args.input_mesh)
    colors = bake_vertex_colors(pipeline, verts, faces, max_cameras=args.max_cameras, depth_tol=args.depth_tol)
    write_ply_mesh(args.output_path, verts, faces, colors=colors)
    print(f"wrote textured mesh ({len(verts)} verts) to {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
