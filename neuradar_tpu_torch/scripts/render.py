"""Camera render command of the port: renders a trained run's scene from the dataset's poses, from
shifted or interpolated poses, along a spiral or a viewer's camera path, and writes PNGs and a
``render_info.json`` (port of the JAX package's scripts/render.py).

    python -m neuradar_tpu_torch.scripts.render <command> --load-config <run dir> [--device cpu] ...

Commands: ``dataset``, ``lane-shift`` (every camera moved sideways by ``--shift`` m),
``actor-shift`` (the actors moved, turned or removed), ``interpolated`` (slerp between the split's
poses), ``spiral`` (around the split's first camera) and ``camera-path`` (a nerfstudio
camera_path.json: perspective, fisheye, equirectangular, omnidirectional stereo left over right,
VR180 left beside right). The run directory is the train command's (``config.json`` and
``checkpoints/``); it renders on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from pathlib import Path
from typing import Iterator, List, Union

import numpy as np
import torch

from neuradar_tpu_torch.cameras.cameras import CameraType
from neuradar_tpu_torch.model_components.dynamic_actors import ActorEdits
from neuradar_tpu_torch.utils.colormaps import apply_depth_colormap
from neuradar_tpu_torch.utils.poses import get_spiral_path, matrix_to_quaternion, quaternion_slerp, quaternion_to_matrix
from neuradar_tpu_torch.utils.tb_writer import encode_png

# a camera_path.json's camera_type -> the eyes rendered for one frame
CAMERA_PATH_TYPES = {
    "perspective": [CameraType.PERSPECTIVE],
    "fisheye": [CameraType.FISHEYE],
    "equirectangular": [CameraType.EQUIRECTANGULAR],
    "omnidirectional": [CameraType.OMNIDIRECTIONALSTEREO_L, CameraType.OMNIDIRECTIONALSTEREO_R],
    "vr180": [CameraType.VR180_L, CameraType.VR180_R],
}


def load_pipeline(load_config: Path, device: Union[str, torch.device] = "cuda"):
    """The pipeline of a train command's run directory (or a file in it), its latest checkpoint
    loaded (scripts/eval.py ``load_trainer``) and the model in eval mode."""
    from neuradar_tpu_torch.scripts.eval import load_trainer

    run_dir = load_config if load_config.is_dir() else load_config.parent
    trainer = load_trainer(run_dir, device)
    trainer.model.eval()
    return trainer.pipeline


def save_png(path: Path, image) -> None:
    """An RGB or grey PNG of a uint8 or [0, 1] float image."""
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(image.cpu().numpy() if isinstance(image, torch.Tensor) else image))


@contextlib.contextmanager
def swapped_tables(pipeline, tables) -> Iterator[None]:
    """Render with other sensor tables (moved poses) and put the pipeline's back afterwards."""
    old = pipeline.tables
    pipeline.tables = pipeline.datamanager.tables = tables
    try:
        yield
    finally:
        pipeline.tables = pipeline.datamanager.tables = old


def slerp_pose(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """The [3, 4] pose a fraction ``t`` of the way from ``a`` to ``b``: rotations by slerp,
    translations linearly."""
    qa, qb = (matrix_to_quaternion(torch.as_tensor(p[:3, :3])) for p in (a, b))
    rot = quaternion_to_matrix(quaternion_slerp(qa, qb, t)).numpy()
    trans = (1 - t) * a[:3, 3] + t * b[:3, 3]
    return np.concatenate([rot, trans[:, None]], axis=1)


def parse_camera_path(spec: dict) -> List[np.ndarray]:
    """The [3, 4] float32 camera-to-world poses of a nerfstudio camera_path.json: a flat 16-float
    row-major ``camera_to_world`` (the viewer's export) or a nested 4 x 4 / 3 x 4 list."""
    frames = []
    for f in spec.get("camera_path", spec.get("keyframes", [])):
        m = np.asarray(f["camera_to_world"], np.float32)
        if m.ndim == 1:
            m = m.reshape(4, 4) if m.size == 16 else m.reshape(3, 4)
        frames.append(m[:3, :4])
    return frames


def _split(pipeline, split: str) -> list:
    idx = pipeline.datamanager.eval_camera_indices() if split == "eval" else pipeline.outputs.camera_split.train
    return [int(i) for i in idx]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command", required=True)
    cp = sub.add_parser("camera-path")
    cp.add_argument("--camera-path-filename", type=Path, required=True,
                    help="nerfstudio camera_path.json (viewer-exported)")
    cmds = {"camera-path": cp}
    for cmd in ("dataset", "lane-shift", "interpolated", "actor-shift", "spiral"):
        p = cmds[cmd] = sub.add_parser(cmd)
        p.add_argument("--split", choices=("eval", "train"), default="eval")
        p.add_argument("--max-frames", type=int, default=16)
        if cmd == "lane-shift":
            p.add_argument("--shift", type=float, default=2.0, help="lateral shift in meters")
        if cmd == "interpolated":
            p.add_argument("--steps-per-transition", type=int, default=4, help="in-between frames per keyframe pair")
        if cmd == "spiral":
            p.add_argument("--radius", type=float, default=0.5, help="spiral radius in meters")
            p.add_argument("--rots", type=int, default=2)
            p.add_argument("--zrate", type=float, default=0.5)
        if cmd == "actor-shift":
            p.add_argument("--actor-lateral", type=float, default=0.0)
            p.add_argument("--actor-longitudinal", type=float, default=0.0)
            p.add_argument("--actor-rotation", type=float, default=0.0)
            p.add_argument("--actor-index", type=int, default=-1)
            p.add_argument("--actor-remove", action="store_true", help="remove instead of shifting")
    for p in cmds.values():
        p.add_argument("--load-config", type=Path, required=True)
        p.add_argument("--output-dir", type=Path, default=Path("renders/camera"))
        p.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    pipeline = load_pipeline(args.load_config, args.device)

    if args.command == "camera-path":
        spec = json.loads(args.camera_path_filename.read_text())
        frames = parse_camera_path(spec)
        hw = (int(spec.get("render_height", 96)), int(spec.get("render_width", 156)))
        ct_name = str(spec.get("camera_type", "perspective")).lower()
        eyes = CAMERA_PATH_TYPES.get(ct_name, [CameraType.PERSPECTIVE])
        out_dir = args.output_dir / "camera_path"
        out_dir.mkdir(parents=True, exist_ok=True)
        for i, c2w in enumerate(frames):
            imgs = [pipeline.render_pose(c2w, hw=hw, camera_type=int(ct)) for ct in eyes]
            # stereo: ODS left over right, VR180 left beside right
            img = np.concatenate(imgs, axis=0 if eyes[0] == CameraType.OMNIDIRECTIONALSTEREO_L else 1)
            save_png(out_dir / f"frame_{i:05d}.png", img)
        (out_dir / "render_info.json").write_text(json.dumps(
            {"command": "camera-path", "frames": len(frames), "camera_type": ct_name}))
        print(f"wrote {len(frames)} camera-path frames to {out_dir}")
        return 0

    out_dir = args.output_dir / args.command
    out_dir.mkdir(parents=True, exist_ok=True)
    split_idx = _split(pipeline, args.split)
    if args.command == "spiral":
        seed_c2w = np.asarray(pipeline.outputs.camera_to_worlds[split_idx[0]], np.float32)
        poses = get_spiral_path(seed_c2w, steps=args.max_frames, radius=args.radius, rots=args.rots,
                                zrate=args.zrate).numpy()
        for i, c2w in enumerate(poses):
            save_png(out_dir / f"frame_{i:05d}.png", pipeline.render_pose(c2w))
        (out_dir / "render_info.json").write_text(
            json.dumps({"command": "spiral", "seed_camera": split_idx[0], "frames": len(poses)}))
        print(f"wrote {len(poses)} spiral frames to {out_dir}")
        return 0

    if args.command == "interpolated":
        keyframes = split_idx[: args.max_frames]
        keys = np.asarray(pipeline.outputs.camera_to_worlds[np.asarray(keyframes, np.int64)])
        n_out = 0
        for a, b in zip(keys[:-1], keys[1:]):
            for s in range(args.steps_per_transition):
                c2w = slerp_pose(a, b, s / args.steps_per_transition).astype(np.float32)
                save_png(out_dir / f"frame_{n_out:05d}.png", pipeline.render_pose(c2w))
                n_out += 1
        (out_dir / "render_info.json").write_text(
            json.dumps({"command": "interpolated", "keyframes": keyframes, "frames": n_out}))
        print(f"wrote {n_out} interpolated frames to {out_dir}")
        return 0

    edits = None
    tables = pipeline.tables
    if args.command == "actor-shift":
        edits = ActorEdits(lateral=args.actor_lateral, longitudinal=args.actor_longitudinal,
                           rotation=args.actor_rotation, index=args.actor_index, remove=args.actor_remove)
    if args.command == "lane-shift":
        # every camera moved along its own x axis
        c2w = tables.cameras.camera_to_worlds
        moved = c2w.clone()
        moved[..., :3, 3] += args.shift * c2w[..., :3, 0]
        tables = dataclasses.replace(tables, cameras=dataclasses.replace(tables.cameras, camera_to_worlds=moved))
    frames = split_idx[: args.max_frames]
    with swapped_tables(pipeline, tables):
        for cam_idx in frames:
            rend = pipeline.render_camera(cam_idx, actor_edits=edits)
            save_png(out_dir / f"frame_{cam_idx:05d}.png", rend["rgb"])
            save_png(out_dir / f"depth_{cam_idx:05d}.png", apply_depth_colormap(rend["depth"].cpu().numpy()[..., None]))
    (out_dir / "render_info.json").write_text(json.dumps({"command": args.command, "frames": frames}))
    print(f"wrote {len(frames)} frames to {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
