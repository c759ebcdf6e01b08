"""Data manager: host-side batch sampling and device-side ray generation (port
of the JAX package's data/datamanager.py).

The host draws only indices (camera frames and patch corners, lidar point
subsets, radar scan ids) with one ``np.random.RandomState(seed)``, in the
JAX package's draw order, so one seed gives bit-equal batches on both sides;
the ground truth is gathered with numpy fancy indexing (the same bytes as the
JAX package's C++ gathers). ``build_train_bundle`` then generates the rays on
the device from the sensor tables. A background thread can prefetch host
batches.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from neuradar_tpu_torch.cameras.cameras import Cameras, generate_camera_rays
from neuradar_tpu_torch.cameras.lidars import Lidars
from neuradar_tpu_torch.cameras.radars import Radars, fov_grid
from neuradar_tpu_torch.cameras.rays import RayBundle
from neuradar_tpu_torch.data.dataparsers.base import DataparserOutputs
from neuradar_tpu_torch.models.neuradar import SegmentLayout


@dataclass
class ADDataManagerConfig:
    """Batch composition: 40 patches of 32 x 32 camera rays + 16,384 lidar rays + 16 radar scans."""

    num_rgb_patches: int = 40
    patch_size: int = 32  # rendered rays per patch side
    num_lidar_rays: int = 16384
    num_radar_scans: int = 16
    max_radar_gt: int = 256
    prefetch_depth: int = 4
    seed: int = 42


@dataclass
class SensorTables:
    """Device-resident sensor tables."""

    cameras: Cameras
    lidars: Lidars
    radars: Radars
    num_cam_frames: int = 0
    num_lidar_frames: int = 0
    num_radar_frames: int = 0


def build_sensor_tables(out: DataparserOutputs, device: torch.device) -> SensorTables:
    if out.distortion_params is not None:
        raise NotImplementedError("the port renders undistorted cameras only")
    if out.camera_velocities is not None and out.rolling_shutter_offsets is not None:
        raise NotImplementedError("the port does not compensate rolling shutter yet")

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    nc = len(out.camera_to_worlds)
    cameras = Cameras(
        camera_to_worlds=t(out.camera_to_worlds),
        fx=t(out.intrinsics[:, 0:1]),
        fy=t(out.intrinsics[:, 1:2]),
        cx=t(out.intrinsics[:, 2:3]),
        cy=t(out.intrinsics[:, 3:4]),
        width=torch.full((nc, 1), out.image_size[1], dtype=torch.int32, device=device),
        height=torch.full((nc, 1), out.image_size[0], dtype=torch.int32, device=device),
        camera_type=t(out.camera_type[:, None], torch.int32),
        times=t(out.camera_times[:, None]),
        metadata={"sensor_idxs": t(out.camera_sensor_idxs[:, None], torch.int32)},
    )
    lidar_meta = {"sensor_idxs": t(out.lidar_sensor_idxs[:, None], torch.int32)}
    if out.lidar_velocities is not None:
        lidar_meta["velocities"] = t(out.lidar_velocities)
    lidars = Lidars(
        lidar_to_worlds=t(out.lidar_to_worlds),
        lidar_type=torch.zeros((len(out.lidar_to_worlds), 1), dtype=torch.int32, device=device),
        times=t(out.lidar_times[:, None]),
        metadata=lidar_meta,
    )
    # camera-only datasets carry no radar FoV; any placeholder works since
    # num_radar_frames == 0 gates all use
    fov = out.radar_fov or {
        "min_azimuth": -0.5, "max_azimuth": 0.5, "min_elevation": -0.1,
        "max_elevation": 0.1, "azimuth_step": 0.1, "elevation_step": 0.1,
    }
    radars = Radars(
        radar_to_worlds=t(out.radar_to_worlds),
        radar_type=torch.zeros((len(out.radar_to_worlds), 1), dtype=torch.int32, device=device),
        fov_directions=t(fov_grid(fov["min_azimuth"], fov["max_azimuth"], fov["min_elevation"],
                                  fov["max_elevation"], fov["azimuth_step"], fov["elevation_step"])),
        times=t(out.radar_times[:, None]),
        metadata={"sensor_idxs": t(out.radar_sensor_idxs[:, None], torch.int32)},
        azimuth_ray_divergence=fov["azimuth_step"],
        elevation_ray_divergence=fov["elevation_step"],
    )
    return SensorTables(
        cameras=cameras,
        lidars=lidars,
        radars=radars,
        num_cam_frames=nc,
        num_lidar_frames=len(out.lidar_to_worlds),
        num_radar_frames=len(out.radar_to_worlds),
    )


def merge_modality_bundles(cam: Optional[RayBundle], lidar: Optional[RayBundle],
                           radar: Optional[RayBundle]) -> RayBundle:
    """Concatenate [cam | lidar | radar] bundles; metadata keys are the union,
    zero-filled where a modality lacks them (did_return defaults to True and
    directions_norm to 1)."""
    bundles = [b for b in (cam, lidar, radar) if b is not None]
    keys = set()
    donors = {}
    for b in bundles:
        keys |= set(b.metadata.keys())
        for k, v in b.metadata.items():
            donors.setdefault(k, v)
    for b in bundles:
        n = b.origins.shape[0]
        md = dict(b.metadata)
        if "did_return" not in md and "did_return" in keys:
            md["did_return"] = torch.ones((n, 1), dtype=torch.bool, device=b.origins.device)
        if "directions_norm" not in md:
            md["directions_norm"] = torch.ones((n, 1), dtype=b.origins.dtype, device=b.origins.device)
        for k in keys:
            if k not in md:
                donor = donors[k]
                md[k] = torch.zeros((n, *donor.shape[1:]), dtype=donor.dtype, device=donor.device)
        b.metadata = md

    def cat(name):
        vals = [getattr(b, name) for b in bundles]
        if all(v is None for v in vals):
            return None
        if name == "times":
            # zero-fill bundles without timestamps instead of dropping the
            # real per-point times other modalities carry
            vals = [v if v is not None else torch.zeros_like(b.origins[:, :1]) for v, b in zip(vals, bundles)]
        elif any(v is None for v in vals):
            return None
        return torch.cat(vals, dim=0)

    return RayBundle(
        origins=cat("origins"),
        directions=cat("directions"),
        pixel_area=cat("pixel_area"),
        nears=cat("nears"),
        fars=cat("fars"),
        times=cat("times"),
        camera_indices=cat("camera_indices"),
        metadata={k: torch.cat([b.metadata[k] for b in bundles], dim=0) for k in sorted(keys)},
    )


def build_train_bundle(tables: SensorTables, batch: Dict[str, torch.Tensor], layout: SegmentLayout,
                       rgb_upsample_factor: int = 3) -> RayBundle:
    """The merged [cam | lidar | radar] bundle of a batch already on the device. Camera
    patches shoot one ray at the centre of every u x u block of ground-truth pixels."""
    ps = layout.patch_size[0]
    u = rgb_upsample_factor
    cam_bundle = lidar_bundle = radar_bundle = None
    if layout.num_cam > 0:
        grid = torch.arange(ps, device=batch["patch_tl"].device) * u + u // 2
        rr, cc = torch.meshgrid(grid, grid, indexing="ij")
        offsets = torch.stack([rr.reshape(-1), cc.reshape(-1)], dim=-1)  # [ps*ps, 2]
        coords = batch["patch_tl"][:, None, :].long() + offsets[None]
        cam_idx = torch.repeat_interleave(batch["cam_frame_idx"].long(), ps * ps)
        cam_bundle = generate_camera_rays(tables.cameras, cam_idx, coords.reshape(-1, 2))
    if layout.num_lidar > 0:
        lidar_bundle = tables.lidars.generate_rays(batch["lidar_scan_idx"], batch["lidar_points"])
        # frame-index offsets so a camera optimizer would see unique frame ids
        lidar_bundle.camera_indices = lidar_bundle.camera_indices + tables.num_cam_frames
    if layout.num_radar_scans > 0:
        radar_bundle = tables.radars.generate_rays(batch["radar_scan_idx"])
        radar_bundle.camera_indices = radar_bundle.camera_indices + tables.num_cam_frames + tables.num_lidar_frames
    return merge_modality_bundles(cam_bundle, lidar_bundle, radar_bundle)


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host batch -> device tensors (the image stays uint8 and is normalized in the loss)."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


class ADDataManager:
    """Host-side sampler with an optional prefetch thread, and the device sensor tables."""

    def __init__(self, outputs: DataparserOutputs, config: ADDataManagerConfig, device,
                 rgb_upsample_factor: int = 3):
        self.outputs = outputs
        self.config = config
        self.u = rgb_upsample_factor
        self.rng = np.random.RandomState(config.seed)
        # eval batches are drawn on the main thread while the prefetch thread consumes
        # self.rng (RandomState is not thread-safe), so the eval split has its own generator
        self.eval_rng = np.random.RandomState(config.seed + 9999)
        self.tables = build_sensor_tables(outputs, torch.device(device))
        self.images_u8 = np.ascontiguousarray(outputs.images)  # [Nc, H, W, 3]
        masks = getattr(outputs, "masks", None)
        if masks is not None:
            inv = (~np.asarray(masks, bool)).astype(np.int64)  # 1 = masked
            self._mask_integral = np.zeros((inv.shape[0], inv.shape[1] + 1, inv.shape[2] + 1), np.int64)
            self._mask_integral[:, 1:, 1:] = inv.cumsum(axis=1).cumsum(axis=2)
        else:
            self._mask_integral = None
        self._pack_lidar(outputs)
        self._pad_radar(outputs)
        self._queue: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._worker_error: Optional[BaseException] = None

    def _pack_lidar(self, out: DataparserOutputs) -> None:
        def pack(scans):
            pts = [out.lidar_points[si] for si in scans]
            ids = [np.full(len(p), si, np.int64) for p, si in zip(pts, scans)]
            if not pts:
                return np.zeros((0, 6), np.float32), np.zeros((0,), np.int64)
            return np.concatenate(pts, axis=0), np.concatenate(ids, axis=0)

        self.lidar_points_packed, self.lidar_scan_ids_packed = pack(out.lidar_split.train)
        self.eval_lidar_points_packed, self.eval_lidar_scan_ids_packed = pack(out.lidar_split.eval)

    def _pad_radar(self, out: DataparserOutputs) -> None:
        g = self.config.max_radar_gt
        n = len(out.radar_points)
        self.radar_gt = np.zeros((n, g, 3), np.float32)
        self.radar_gt_mask = np.zeros((n, g), bool)
        for i, p in enumerate(out.radar_points):
            k = min(len(p), g)
            self.radar_gt[i, :k] = p[:k, :3]
            self.radar_gt_mask[i, :k] = True

    @property
    def layout(self) -> SegmentLayout:
        c = self.config
        return SegmentLayout(
            num_cam=c.num_rgb_patches * c.patch_size**2,
            num_lidar=c.num_lidar_rays,
            num_radar_scans=c.num_radar_scans,
            rays_per_scan=int(self.tables.radars.rays_per_scan),
            patch_size=(c.patch_size, c.patch_size),
        )

    def sample_eval_batch(self) -> Dict[str, np.ndarray]:
        """A batch of the train layout drawn from the eval split."""
        return self.sample_train_batch(split="eval")

    def sample_train_batch(self, split: str = "train") -> Dict[str, np.ndarray]:
        c = self.config
        out = self.outputs
        H, W = out.image_size
        gt_patch = c.patch_size * self.u
        train = split == "train"
        cam_split = out.camera_split.train if train else out.camera_split.eval
        radar_split = out.radar_split.train if train else out.radar_split.eval
        packed_pts = self.lidar_points_packed if train else self.eval_lidar_points_packed
        packed_ids = self.lidar_scan_ids_packed if train else self.eval_lidar_scan_ids_packed

        rng = self.rng if train else self.eval_rng
        cam_frames = rng.choice(cam_split, size=c.num_rgb_patches)
        tl_r = rng.randint(0, H - gt_patch + 1, size=c.num_rgb_patches)
        tl_c = rng.randint(0, W - gt_patch + 1, size=c.num_rgb_patches)
        if self._mask_integral is not None:
            tl_r, tl_c = self._reject_masked_patches(rng, cam_frames, tl_r, tl_c, gt_patch, H, W)
        offs = np.arange(gt_patch)
        rows = (tl_r[:, None] + offs)[:, :, None]
        cols = (tl_c[:, None] + offs)[:, None, :]
        rgb = self.images_u8[cam_frames[:, None, None], rows, cols]  # [B, p, p, 3] uint8

        pt_idx = rng.randint(0, len(packed_pts), size=c.num_lidar_rays)
        lidar_points = packed_pts[pt_idx].astype(np.float32)
        lidar_scan_idx = packed_ids[pt_idx]
        radar_scan_idx = rng.choice(radar_split, size=c.num_radar_scans)
        lidar_dist = np.linalg.norm(lidar_points[:, :3], axis=-1, keepdims=True).astype(np.float32)
        return {
            "cam_frame_idx": cam_frames.astype(np.int32),
            "patch_tl": np.stack([tl_r, tl_c], axis=1).astype(np.int32),
            "image": rgb,
            "lidar_scan_idx": lidar_scan_idx.astype(np.int32),
            "lidar_points": lidar_points,
            "lidar_distance": lidar_dist,
            "lidar_intensity": lidar_points[:, 3:4].astype(np.float32),
            "did_return": lidar_dist < 1e3,
            "radar_scan_idx": radar_scan_idx.astype(np.int32),
            "radar_gt": self.radar_gt[radar_scan_idx],
            "radar_gt_mask": self.radar_gt_mask[radar_scan_idx],
        }

    def _masked_counts(self, cam_frames, tl_r, tl_c, gt_patch):
        """Masked-pixel count per candidate patch, from the integral image."""
        ii = self._mask_integral[cam_frames]
        b = np.arange(len(cam_frames))
        return (ii[b, tl_r + gt_patch, tl_c + gt_patch] - ii[b, tl_r, tl_c + gt_patch]
                - ii[b, tl_r + gt_patch, tl_c] + ii[b, tl_r, tl_c])

    def _reject_masked_patches(self, rng, cam_frames, tl_r, tl_c, gt_patch, H, W, max_iters: int = 20):
        """Redraw patch corners whose footprint touches masked pixels, keeping the least-masked
        candidate seen."""
        best_r, best_c = tl_r.copy(), tl_c.copy()
        best_bad = self._masked_counts(cam_frames, best_r, best_c, gt_patch)
        for _ in range(max_iters):
            redo = best_bad > 0
            if not redo.any():
                break
            n = int(redo.sum())
            cand_r = rng.randint(0, H - gt_patch + 1, size=n)
            cand_c = rng.randint(0, W - gt_patch + 1, size=n)
            cand_bad = self._masked_counts(cam_frames[redo], cand_r, cand_c, gt_patch)
            improve = cand_bad < best_bad[redo]
            idx = np.flatnonzero(redo)[improve]
            best_r[idx], best_c[idx] = cand_r[improve], cand_c[improve]
            best_bad[idx] = cand_bad[improve]
        return best_r, best_c

    def start_prefetch(self) -> None:
        if self._queue is not None:
            return
        self._queue = queue.Queue(maxsize=self.config.prefetch_depth)

        def worker():
            try:
                while not self._stop.is_set():
                    batch = self.sample_train_batch()
                    while not self._stop.is_set():
                        try:
                            self._queue.put(batch, timeout=0.5)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # noqa: BLE001 - raised again in next_train
                self._worker_error = e

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next_train(self) -> Dict[str, np.ndarray]:
        if self._queue is not None:
            while True:  # bounded waits, so a dead worker raises instead of hanging
                try:
                    return self._queue.get(timeout=5.0)
                except queue.Empty:
                    if self._worker_error is not None:
                        raise RuntimeError("prefetch worker died") from self._worker_error
        return self.sample_train_batch()

    def stop(self) -> None:
        """Stop the prefetch thread and wait for it."""
        self._stop.set()
        if getattr(self, "_thread", None) is not None:
            self._thread.join(timeout=10.0)

    def eval_camera_indices(self) -> np.ndarray:
        return self.outputs.camera_split.eval

    def eval_radar_indices(self) -> np.ndarray:
        return self.outputs.radar_split.eval

    def eval_lidar_indices(self) -> np.ndarray:
        return self.outputs.lidar_split.eval
