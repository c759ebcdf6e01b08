"""Radar render command of the port: simulates radar scans of a trained run's scene and writes each
scan's points as JSON with a bird's-eye PNG (port of the JAX package's scripts/render_radar.py).

    python -m neuradar_tpu_torch.scripts.render_radar <command> --load-config <run dir> [--device cpu] ...

Commands: ``dataset`` (the eval scans, beside their ground truth), ``pose-shift`` (every radar
moved sideways by ``--lateral-shift`` m), ``actor-shift`` (the actors moved, turned or removed),
``interpolated`` (poses slerped between eval scans), ``camera-path`` (each keyframe of a
camera_path.json as the radar's pose) and ``full-sensor-set`` (one eval frame of every sensor: rgb
and depth PNGs, lidar and radar PLYs). A scan's points are drawn from the model's multi-Bernoulli
output as ``loss.radar_loss_type`` says: 'euclidean' keeps the means above the existence
threshold, 'nll' draws, from one CPU generator seeded 0 a command, so the card and the CPU draw
alike. It renders on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from neuradar_tpu_torch.model_components import radar_utils
from neuradar_tpu_torch.model_components.dynamic_actors import ActorEdits
from neuradar_tpu_torch.scripts.render import load_pipeline, parse_camera_path, save_png, slerp_pose, swapped_tables

BEV_PIXELS = 400  # the bird's-eye figure's side
PRED_COLOR = (40, 90, 255)  # blue
GT_COLOR = (30, 170, 60)  # green


def bev_image(pred: np.ndarray, gt: Optional[np.ndarray], size: int = BEV_PIXELS) -> np.ndarray:
    """A uint8 [size, size, 3] bird's-eye view of points in the sensor frame: x up the image, y to
    the left, the square fitted around every point and the sensor, 3 x 3 dots, ground truth in
    green under the prediction in blue, the sensor as a grey cross."""
    img = np.full((size, size, 3), 255, np.uint8)
    sets = [(gt, GT_COLOR), (pred, PRED_COLOR)]
    xy = np.concatenate([np.zeros((1, 2))] + [p[:, :2] for p, _ in sets if p is not None and len(p)])
    lo, hi = xy.min(axis=0), xy.max(axis=0)
    half = max(float((hi - lo).max()) / 2, 1.0) * 1.05
    centre = (lo + hi) / 2

    def pixels(p):
        row = np.round((centre[0] + half - p[:, 0]) / (2 * half) * (size - 1)).astype(np.int64)
        col = np.round((centre[1] + half - p[:, 1]) / (2 * half) * (size - 1)).astype(np.int64)
        return row, col

    r0, c0 = pixels(np.zeros((1, 2)))
    img[np.clip(r0[0] - 4, 0, size - 1):r0[0] + 5, c0[0]] = 128
    img[r0[0], np.clip(c0[0] - 4, 0, size - 1):c0[0] + 5] = 128
    for pts, color in sets:
        if pts is None or not len(pts):
            continue
        row, col = pixels(pts)
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                img[np.clip(row + dr, 0, size - 1), np.clip(col + dc, 0, size - 1)] = color
    return img


def save_scan(out_dir: Path, name: str, pred: np.ndarray, gt: Optional[np.ndarray]) -> None:
    """``<name>.json`` with ``points`` (and ``gt_points`` where given) and its bird's-eye ``<name>.png``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    payload = {"points": pred.tolist()}
    if gt is not None:
        payload["gt_points"] = gt.tolist()
    (out_dir / f"{name}.json").write_text(json.dumps(payload))
    save_png(out_dir / f"{name}.png", bev_image(pred, gt))


class ScanSampler:
    """Points of one scan's multi-Bernoulli output [n_mb, 7] as the model's config says, the 'nll'
    draws from one CPU generator seeded ``seed``."""

    def __init__(self, model_config, seed: int = 0):
        self.loss_type = model_config.loss.radar_loss_type
        self.threshold = model_config.existence_probability_threshold
        self.generator = torch.Generator().manual_seed(seed)

    def __call__(self, radar_output: torch.Tensor) -> np.ndarray:
        uniforms = (radar_utils.nll_uniforms(radar_output.shape[0], self.generator)
                    if self.loss_type == "nll" else None)
        pts, keep = radar_utils.sample_radar_points(radar_output, self.loss_type, uniforms, threshold=self.threshold)
        return pts[keep].cpu().numpy()


def _with_radar_pose(tables, scan_idx: int, pose: np.ndarray):
    """The sensor tables with radar scan ``scan_idx`` at ``pose`` [3, 4]."""
    r2w = tables.radars.radar_to_worlds.clone()
    r2w[scan_idx] = torch.as_tensor(np.asarray(pose[:3, :4], np.float32), device=r2w.device)
    return dataclasses.replace(tables, radars=dataclasses.replace(tables.radars, radar_to_worlds=r2w))


def full_sensor_set(pipeline, sample: ScanSampler, frame: int, out_dir: Path) -> dict:
    """One eval frame of every sensor: rgb.png and depth.png (depth over its maximum, grey), the
    kept lidar returns (sensor frame) as lidar.ply and the radar points as radar.ply."""
    from neuradar_tpu_torch.scripts.exporter import write_ply

    out_dir.mkdir(parents=True, exist_ok=True)
    dm = pipeline.datamanager
    cams, lids, rads = dm.eval_camera_indices(), dm.eval_lidar_indices(), dm.eval_radar_indices()
    written = {}
    if len(cams):
        ci = int(cams[min(frame, len(cams) - 1)])
        rend = pipeline.render_camera(ci)
        save_png(out_dir / "rgb.png", rend["rgb"])
        d = rend["depth"].cpu().numpy()
        save_png(out_dir / "depth.png", d / max(d.max(), 1e-6))
        written["camera_frame"] = ci
    if len(lids):
        li = int(lids[min(frame, len(lids) - 1)])
        lr = pipeline.render_lidar(li)
        keep = lr["ray_drop_prob"][:, 0].cpu().numpy() < 0.5
        keep[int(lr["num_valid"]):] = False  # the padding rows
        dirs = lr["points"][:, :3] / np.linalg.norm(lr["points"][:, :3], axis=-1, keepdims=True).clip(1e-6)
        write_ply(out_dir / "lidar.ply", (dirs * lr["depth"].cpu().numpy())[keep])
        written["lidar_scan"] = li
    if len(rads):
        ri = int(rads[min(frame, len(rads) - 1)])
        write_ply(out_dir / "radar.ply", sample(pipeline.render_radar(ri)["radar_output"])[:, :3])
        written["radar_scan"] = ri
    (out_dir / "info.json").write_text(json.dumps(written))
    return written


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command", required=True)
    for cmd in ("dataset", "pose-shift", "actor-shift", "interpolated", "full-sensor-set", "camera-path"):
        p = sub.add_parser(cmd)
        p.add_argument("--load-config", type=Path, required=True)
        p.add_argument("--output-dir", type=Path, default=Path("renders/radar"))
        p.add_argument("--max-scans", type=int, default=16)
        p.add_argument("--device", default="cuda")
        if cmd == "camera-path":
            p.add_argument("--camera-path-filename", type=Path, required=True,
                           help="nerfstudio camera_path.json; each keyframe pose is the radar-to-world pose")
        if cmd == "pose-shift":
            p.add_argument("--lateral-shift", type=float, default=2.0)
        if cmd == "actor-shift":
            p.add_argument("--actor-lateral", type=float, default=0.0)
            p.add_argument("--actor-longitudinal", type=float, default=0.0)
            p.add_argument("--actor-rotation", type=float, default=0.0)
            p.add_argument("--actor-index", type=int, default=-1)
            p.add_argument("--actor-remove", action="store_true",
                           help="remove the selected actor(s) instead of shifting")
        if cmd == "interpolated":
            p.add_argument("--steps-per-transition", type=int, default=2)
        if cmd == "full-sensor-set":
            p.add_argument("--frame", type=int, default=0, help="index into the eval split")
    args = parser.parse_args(argv)

    pipeline = load_pipeline(args.load_config, args.device)
    sample = ScanSampler(pipeline.config.model)
    out_dir = args.output_dir / args.command
    tables = pipeline.tables
    scans = [int(s) for s in pipeline.datamanager.eval_radar_indices()]

    if args.command == "full-sensor-set":
        written = full_sensor_set(pipeline, sample, args.frame, out_dir)
        print(f"wrote full sensor set to {out_dir}: {written}")
        return 0

    if args.command == "camera-path":
        frames = parse_camera_path(json.loads(args.camera_path_filename.read_text()))[: args.max_scans or None]
        if not scans:
            print("no eval radar scans available")
            return 1
        for i, pose in enumerate(frames):
            with swapped_tables(pipeline, _with_radar_pose(tables, scans[0], pose)):
                save_scan(out_dir, f"path_{i:04d}", sample(pipeline.render_radar(scans[0])["radar_output"]), None)
        print(f"wrote {len(frames)} camera-path radar scans to {out_dir}")
        return 0

    if args.command == "interpolated":
        # the source scan's timestamp is kept, so the actors stay where they were at that scan
        scans = scans[: args.max_scans]
        r2w = tables.radars.radar_to_worlds.cpu().numpy()
        n_out = 0
        for a, b in zip(scans[:-1], scans[1:]):
            for s in range(args.steps_per_transition):
                pose = slerp_pose(r2w[a], r2w[b], s / args.steps_per_transition)
                with swapped_tables(pipeline, _with_radar_pose(tables, a, pose)):
                    pred = sample(pipeline.render_radar(a)["radar_output"])
                save_scan(out_dir, f"interp_{n_out:04d}", pred, np.zeros((0, 3)))
                n_out += 1
        print(f"wrote {n_out} interpolated scans to {out_dir}")
        return 0

    edits = None
    if args.command == "actor-shift":
        edits = ActorEdits(lateral=args.actor_lateral, longitudinal=args.actor_longitudinal,
                           rotation=args.actor_rotation, index=args.actor_index, remove=args.actor_remove)
    if args.command == "pose-shift":
        # every radar moved along its own y axis
        r2w = tables.radars.radar_to_worlds
        moved = r2w.clone()
        moved[..., :3, 3] += args.lateral_shift * r2w[..., :3, 1]
        tables = dataclasses.replace(tables, radars=dataclasses.replace(tables.radars, radar_to_worlds=moved))
    scans = scans[: args.max_scans]
    with swapped_tables(pipeline, tables):
        for scan_idx in scans:
            pred = sample(pipeline.render_radar(scan_idx, actor_edits=edits)["radar_output"])
            save_scan(out_dir, f"scan_{scan_idx:04d}", pred, pipeline.outputs.radar_points[scan_idx][:, :3])
    print(f"wrote {len(scans)} scans to {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
