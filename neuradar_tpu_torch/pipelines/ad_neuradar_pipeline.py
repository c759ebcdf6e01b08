"""AD NeuRadar pipeline: datamanager + model, the train and eval losses, the
render entry points and the eval-metric loops (port of the JAX package's
pipelines/ad_neuradar_pipeline.py: the constructor, ``make_train_loss_fn``,
``make_eval_loss_fn``, ``render_camera``, ``render_lidar``, ``render_radar``,
``get_average_eval_{image,lidar,radar}_metrics`` and the shifted-view FID
evals, ``compute_fid_metrics``). The renders take actor edits, and
``render_camera`` a world offset of its ray origins.

Everything runs on one explicit ``device``; there is no fallback to another.
The render methods return tensors on that device (the JAX package returns
numpy arrays), apart from the host-side lidar ``points`` and ``num_valid``.
The metric loops render on the device and compute the metrics on the host
with numpy and scipy, as the JAX package does. Under a bf16 ``compute_dtype``
with ``hoist_table_cast`` the train loss, the eval loss and every render cast
the hash tables once (``NeuRadarModel.cast_tables``) and hand them down, as
the JAX package's ``_cast_variables`` / ``make_train_loss_fn`` do.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from neuradar_tpu_torch.cameras.cameras import generate_camera_rays
from neuradar_tpu_torch.data.datamanager import (
    ADDataManager,
    ADDataManagerConfig,
    batch_to_device,
    build_train_bundle,
    merge_modality_bundles,
)
from neuradar_tpu_torch.data.dataparsers.base import DataparserOutputs
from neuradar_tpu_torch.model_components import radar_utils
from neuradar_tpu_torch.model_components.dynamic_actors import ActorEdits, trajectories_from_dicts
from neuradar_tpu_torch.model_components.fid import FeatureExtractor, PerceptualDistance, frechet_distance
from neuradar_tpu_torch.model_components.gospa import calculate_gospa
from neuradar_tpu_torch.model_components.vgg import has_pretrained_weights
from neuradar_tpu_torch.models.neuradar import NeuRadarModel, NeuRadarModelConfig, SceneMeta, SegmentLayout
from neuradar_tpu_torch.utils.params import init_params


@dataclass
class ADNeuRadarPipelineConfig:
    datamanager: ADDataManagerConfig = field(default_factory=ADDataManagerConfig)
    model: NeuRadarModelConfig = field(default_factory=NeuRadarModelConfig)
    calc_fid_steps: Tuple[int, ...] = (99999999,)  # the steps after which the trainer runs the FID evals
    radar_sampling_rounds: int = 10


class ADNeuRadarPipeline:
    """Owns the datamanager (with the device sensor tables) and the model (seeded weights)."""

    def __init__(self, config: ADNeuRadarPipelineConfig, outputs: DataparserOutputs,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        self.config = config
        self.outputs = outputs
        self.device = torch.device(device)
        self.datamanager = ADDataManager(outputs, config.datamanager, self.device,
                                         rgb_upsample_factor=config.model.rgb_upsample_factor)
        self.tables = self.datamanager.tables
        self.layout = self.datamanager.layout
        scene = SceneMeta(
            static_scale=float(np.abs(outputs.scene_box.aabb).max()),
            duration=float(outputs.duration),
            num_sensors=len(outputs.sensor_idx_to_name),
            num_train_frames=len(outputs.camera_to_worlds) + len(outputs.lidar_to_worlds)
            + len(outputs.radar_to_worlds),
        )
        with self.device:
            self.model = NeuRadarModel(config.model, scene, trajectories_from_dicts(outputs.trajectories),
                                       decode_radar=self.layout.num_radar_scans > 0)
        self.model.to(self.device).eval()
        init_params(self.model, seed)

    def make_train_loss_fn(self) -> Callable:
        """loss_fn(host_batch, generator) -> (total, loss_dict, metrics): the training forward
        and losses of one batch, differentiable in the model's parameters; batch-norm
        statistics are updated on the way."""
        u = self.config.model.rgb_upsample_factor

        def loss_fn(batch: Dict[str, np.ndarray], generator: torch.Generator):
            dev = batch_to_device(batch, self.device)
            bundle = build_train_bundle(self.tables, dev, self.layout, u)
            total, loss_dict, metrics, _ = self.model.loss_and_metrics(bundle, dev, self.layout, True, generator,
                                                                       self.model.cast_tables())
            return total, loss_dict, metrics

        return loss_fn

    def make_eval_loss_fn(self) -> Callable:
        """eval_loss(host_batch) -> (total, loss_dict, metrics): the same graph in eval
        (deterministic sampling, no dropout, running batch-norm statistics), no gradients."""
        u = self.config.model.rgb_upsample_factor

        @torch.no_grad()
        def eval_loss(batch: Dict[str, np.ndarray]):
            dev = batch_to_device(batch, self.device)
            bundle = build_train_bundle(self.tables, dev, self.layout, u)
            total, loss_dict, metrics, _ = self.model.loss_and_metrics(bundle, dev, self.layout, False,
                                                                       tables=self.model.cast_tables())
            return total, loss_dict, metrics

        return eval_loss

    @torch.inference_mode()
    def render_camera(self, cam_idx: int, actor_edits: Optional[ActorEdits] = None,
                      origin_shift: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
        """Full-image render: one ray per u x u pixel block, chunked at
        eval_num_rays_per_chunk (the last chunk padded by repeating its last
        ray), then the upsampling CNN -> rgb [H, W, 3], depth and
        accumulation [H/u, W/u]. ``actor_edits`` moves or removes actors;
        ``origin_shift`` [3] is added to every ray origin (the world offset of
        the shifted-view FID evals)."""
        m = self.config.model
        u = m.rgb_upsample_factor
        H, W = self.outputs.image_size
        h, w = H // u, W // u
        rows = torch.arange(h, device=self.device) * u + u // 2
        cols = torch.arange(w, device=self.device) * u + u // 2
        rr, cc = torch.meshgrid(rows, cols, indexing="ij")
        coords = torch.stack([rr.reshape(-1), cc.reshape(-1)], dim=1)
        n_rays = coords.shape[0]
        chunk = min(m.eval_num_rays_per_chunk, n_rays)
        n_pad = (-n_rays) % chunk
        if n_pad:
            coords = torch.cat([coords, coords[-1:].expand(n_pad, 2)])
        layout = SegmentLayout(num_cam=chunk, patch_size=(h, w))

        tables = self.model.cast_tables()
        shift = None if origin_shift is None else torch.as_tensor(origin_shift, dtype=torch.float32, device=self.device)
        outs = []
        for i in range(0, coords.shape[0], chunk):
            cam_ids = torch.full((chunk,), cam_idx, dtype=torch.long, device=self.device)
            rays = generate_camera_rays(self.tables.cameras, cam_ids, coords[i : i + chunk])
            if shift is not None:
                rays = dataclasses.replace(rays, origins=rays.origins + shift)
            bundle = merge_modality_bundles(rays, None, None)
            outs.append(self.model.get_nff_outputs(bundle, layout, tables=tables, actor_edits=actor_edits))
        features = torch.cat([o["features"] for o in outs])[:n_rays]
        depth = torch.cat([o["depth"] for o in outs])[:n_rays]
        acc = torch.cat([o["accumulation"] for o in outs])[:n_rays]
        rgb = self.model.decode_camera_features(features, (h, w))[0]
        return {"rgb": rgb, "depth": depth.reshape(h, w), "accumulation": acc.reshape(h, w)}

    @torch.inference_mode()
    def render_lidar(self, scan_idx: int, max_points: int = 16384,
                     actor_edits: Optional[ActorEdits] = None) -> Dict[str, object]:
        """Render a lidar scan subsampled (seeded) or padded to max_points rays, the actors edited by
        ``actor_edits``."""
        pts = self.outputs.lidar_points[scan_idx]
        num_valid = min(len(pts), max_points)
        if len(pts) > max_points:
            pts = pts[np.random.RandomState(0).choice(len(pts), max_points, replace=False)]
        elif len(pts) == 0:  # empty scan: all-padding bundle, num_valid = 0
            pts = np.zeros((max_points, 4), np.float32)
            pts[:, 0] = 1.0
        else:
            pts = np.concatenate([pts, np.repeat(pts[-1:], max_points - len(pts), axis=0)], axis=0)
        bundle = self.tables.lidars.generate_rays(
            torch.full((max_points,), scan_idx, dtype=torch.long, device=self.device),
            torch.as_tensor(pts, dtype=torch.float32, device=self.device),
        )
        outputs = self.model.get_outputs(merge_modality_bundles(None, bundle, None),
                                         SegmentLayout(num_lidar=max_points), tables=self.model.cast_tables(),
                                         actor_edits=actor_edits)
        return {
            "depth": outputs["depth"],
            "intensity": outputs["intensity"],
            "ray_drop_prob": torch.sigmoid(outputs["ray_drop_logits"]),
            "points": pts,
            "num_valid": num_valid,  # rows past it repeat the last point
        }

    @torch.inference_mode()
    def render_radar(self, scan_idx: Union[int, Sequence[int]],
                     actor_edits: Optional[ActorEdits] = None) -> Dict[str, torch.Tensor]:
        """Multi-Bernoulli radar output: [n_mb, 7] for one scan index, or [n_scans, n_mb, 7] for a
        sequence rendered as one batch; n_mb is the scan's rays, or the set decoder's queries. The
        actors are edited by ``actor_edits``."""
        single = isinstance(scan_idx, (int, np.integer))
        ids = torch.as_tensor([scan_idx] if single else list(scan_idx), dtype=torch.long, device=self.device)
        radars = self.tables.radars
        layout = SegmentLayout(num_radar_scans=len(ids), rays_per_scan=radars.rays_per_scan)
        outputs = self.model.get_outputs(merge_modality_bundles(None, None, radars.generate_rays(ids)), layout,
                                         tables=self.model.cast_tables(), actor_edits=actor_edits)
        radar_output = outputs["radar_output"]
        return {"radar_output": radar_output[0] if single else radar_output}

    def _driving_direction(self, cam_idx: int) -> np.ndarray:
        """The ego's unit driving direction at a camera frame: the parser's camera velocity where it
        is not ~0, else the difference of the sensor's neighbouring camera positions (+x for a
        sensor with one frame)."""
        out = self.outputs
        v = None
        if out.camera_velocities is not None:
            v = np.asarray(out.camera_velocities[cam_idx], np.float64)
            if np.linalg.norm(v) < 1e-3:
                v = None
        if v is None:
            same = np.where(out.camera_sensor_idxs == out.camera_sensor_idxs[cam_idx])[0]
            if len(same) < 2:
                return np.array([1.0, 0.0, 0.0])
            pos = out.camera_to_worlds[same, :3, 3].astype(np.float64)
            j = int(np.nonzero(same == cam_idx)[0][0])
            j0, j1 = (j - 1, j) if j == len(same) - 1 else (j, j + 1)
            v = pos[j1] - pos[j0]
        n = np.linalg.norm(v)
        return (v / n) if n > 1e-6 else np.array([1.0, 0.0, 0.0])

    def _fid_render(self, cam_idx: int, hw: Tuple[int, int], actor_edits: Optional[ActorEdits] = None,
                    origin_shift: Optional[np.ndarray] = None) -> torch.Tensor:
        """One render's rgb cut to ``hw`` and clipped to [0, 1] (on the device)."""
        rgb = self.render_camera(cam_idx, actor_edits=actor_edits, origin_shift=origin_shift)["rgb"]
        return rgb[: hw[0], : hw[1]].clamp(0.0, 1.0)

    def compute_fid_metrics(self, max_frames: int = 16) -> Dict[str, float]:
        """The shifted-view FIDs of the first ``max_frames`` eval frames against their images:

        * lane_shift_{0,2,3}_fid: the ray origins moved 0, 2 and 3 m sideways, along the driving
          direction x z in the ground plane, to the side the parser's ``lane_shift_sign`` gives;
        * vertical_shift_1_fid: the origins moved 1 m up;
        * actor_shift_rot_fid / actor_shift_trans_fid: the actors turned by +-0.5 rad, or moved
          +-2 m sideways in their box frames (two renders a frame).

        Features come from ``FeatureExtractor`` (the VGG-19 trunk); without $NEURADAR_VGG19_WEIGHTS
        its filters are random and every key ends in ``_vggsurrogate``."""
        out = self.outputs
        u = self.config.model.rgb_upsample_factor
        H, W = out.image_size[0] // u * u, out.image_size[1] // u * u
        extractor = FeatureExtractor(self.device)
        cam_ids = [int(c) for c in self.datamanager.eval_camera_indices()][:max_frames]
        real_feats = extractor(out.images[cam_ids][:, :H, :W].astype(np.float32) / 255.0)
        sign = float(out.lane_shift_sign or 1)
        z_up = np.array([0.0, 0.0, 1.0])
        actor_edits = {
            "actor_shift_rot": [ActorEdits(rotation=0.5), ActorEdits(rotation=-0.5)],
            "actor_shift_trans": [ActorEdits(lateral=2.0), ActorEdits(lateral=-2.0)],
        }
        fakes = {k: [] for k in ("lane_shift_0", "lane_shift_2", "lane_shift_3", "vertical_shift_1", *actor_edits)}
        for cam_idx in cam_ids:
            right = np.cross(self._driving_direction(cam_idx), z_up)
            right[2] = 0.0  # sideways in the ground plane
            fakes["lane_shift_0"].append(self._fid_render(cam_idx, (H, W)))
            for shift in (2.0, 3.0):
                fakes[f"lane_shift_{shift:g}"].append(self._fid_render(cam_idx, (H, W),
                                                                       origin_shift=shift * sign * right))
            fakes["vertical_shift_1"].append(self._fid_render(cam_idx, (H, W), origin_shift=z_up))
            for family, edits in actor_edits.items():
                fakes[family] += [self._fid_render(cam_idx, (H, W), actor_edits=e) for e in edits]
        suffix = "" if has_pretrained_weights() else "_vggsurrogate"
        return {f"{family}_fid{suffix}": frechet_distance(real_feats, extractor(torch.stack(imgs)))
                for family, imgs in fakes.items()}

    def get_average_eval_image_metrics(self) -> Dict[str, float]:
        """PSNR, SSIM and the LPIPS surrogate over the eval images, with eval rays/s and fps."""
        psnrs, ssims, lpips_vals = [], [], []
        u = self.config.model.rgb_upsample_factor
        total_rays = n_images = 0
        lpips = None
        t0 = time.perf_counter()
        for cam_idx in self.datamanager.eval_camera_indices():
            rgb = self.render_camera(int(cam_idx))["rgb"]
            h, w = rgb.shape[:2]
            gt = (self.outputs.images[int(cam_idx)].astype(np.float32) / 255.0)[:h, :w]
            total_rays += (h // u) * (w // u)
            n_images += 1
            if lpips is None:
                lpips = PerceptualDistance(self.device)
            lpips_vals.append(lpips(rgb, gt))
            rgb = rgb.cpu().numpy()
            psnrs.append(-10.0 * np.log10(max(float(np.mean((rgb - gt) ** 2)), 1e-10)))
            ssims.append(_ssim_np(rgb, gt))
        dt = max(time.perf_counter() - t0, 1e-9)
        lpips_key = "lpips_vgg" if has_pretrained_weights() else "lpips_vggsurrogate"
        return {
            "psnr": float(np.mean(psnrs)) if psnrs else 0.0,
            "ssim": float(np.mean(ssims)) if ssims else 0.0,
            lpips_key: float(np.mean(lpips_vals)) if lpips_vals else 0.0,
            "eval_rays_per_sec": total_rays / dt,
            "fps": n_images / dt,
        }

    def get_average_eval_lidar_metrics(self, max_points: int = 16384) -> Dict[str, float]:
        """Depth, intensity, ray-drop and chamfer metrics over the eval lidar scans; the padding
        rows past each scan's ``num_valid`` are left out of every statistic."""
        med_l2, rel_l2, rmses, drop_accs, chamfers = [], [], [], [], []
        for scan_idx in self.datamanager.eval_lidar_indices():
            rend = self.render_lidar(int(scan_idx), max_points=max_points)
            n = int(rend["num_valid"])
            if n == 0:
                continue
            pts = rend["points"][:n]
            pred = rend["depth"][:n].cpu().numpy()
            intensity = rend["intensity"][:n].cpu().numpy()
            gt_dist = np.linalg.norm(pts[:, :3], axis=1, keepdims=True)
            did_return = (gt_dist < 1e3)[:, 0]
            if did_return.any():
                err = (pred[did_return] - gt_dist[did_return])[:, 0]
                med_l2.append(float(np.median(err**2)))
                rel_l2.append(float(np.mean((err / gt_dist[did_return][:, 0]) ** 2)))
                rmses.append(float(np.sqrt(np.mean((intensity[did_return][:, 0] - pts[did_return, 3]) ** 2))))
            pred_drop = rend["ray_drop_prob"][:n, 0].cpu().numpy() > 0.5
            drop_accs.append(float((pred_drop == ~did_return).mean()))
            keep = ~pred_drop
            if keep.any() and did_return.any():
                # chamfer between predicted returns and ground-truth returns, 1000 of each at most
                dirs = pts[:, :3] / np.clip(np.linalg.norm(pts[:, :3], axis=1, keepdims=True), 1e-6, None)
                pred_pts = dirs[keep] * pred[keep]
                sel = np.random.RandomState(0)
                a = pred_pts[sel.choice(len(pred_pts), min(1000, len(pred_pts)), replace=False)]
                gt_pts = pts[did_return, :3]
                b = gt_pts[sel.choice(len(gt_pts), min(1000, len(gt_pts)), replace=False)]
                chamfers.append(radar_utils.chamfer_distance_np(a, b))
        return {
            "depth_median_l2": float(np.mean(med_l2)) if med_l2 else 0.0,
            "depth_mean_rel_l2": float(np.mean(rel_l2)) if rel_l2 else 0.0,
            "intensity_rmse": float(np.mean(rmses)) if rmses else 0.0,
            "ray_drop_accuracy": float(np.mean(drop_accs)) if drop_accs else 0.0,
            "lidar_chamfer_distance": float(np.mean(chamfers)) if chamfers else 0.0,
        }

    def get_average_eval_radar_metrics(
        self, sampling_rounds: Optional[int] = None,
        draw: Optional[Callable[[int], Tuple[torch.Tensor, torch.Tensor]]] = None,
    ) -> Dict[str, float]:
        """Chamfer, EMD and GOSPA over the eval radar scans, sampled as ``loss.radar_loss_type`` says:
        'nll' draws each scan ``sampling_rounds`` times (default ``radar_sampling_rounds``), and
        ``draw(n_mb)`` returns one round's uniforms, by default from a CPU generator seeded 0, so the
        card and the CPU draw alike; 'euclidean' is deterministic, one round by default."""
        loss_type = self.config.model.loss.radar_loss_type
        rounds = sampling_rounds or (self.config.radar_sampling_rounds if loss_type == "nll" else 1)
        if draw is None and loss_type == "nll":
            gen = torch.Generator().manual_seed(0)
            draw = lambda n_mb: radar_utils.nll_uniforms(n_mb, gen)  # noqa: E731
        chamfers, emds, gospas, locs, misses, falses = ([] for _ in range(6))
        n_empty_pred = 0
        scan_ids = [int(s) for s in self.datamanager.eval_radar_indices()]
        rendered = self.render_radar(scan_ids)["radar_output"].cpu() if scan_ids else []
        for scan_idx, ro in zip(scan_ids, rendered):
            gt = self.outputs.radar_points[scan_idx][:, :3]
            for _ in range(rounds):
                pts, keep = radar_utils.sample_radar_points(
                    ro, loss_type, draw(ro.shape[0]) if loss_type == "nll" else None,
                    threshold=self.config.model.existence_probability_threshold)
                pred = pts[keep].numpy()
                if len(pred) and len(gt):
                    chamfers.append(radar_utils.chamfer_distance_np(pred, gt))
                    emds.append(radar_utils.emd_distance_np(pred, gt))
                elif len(gt):
                    n_empty_pred += 1  # chamfer and EMD are undefined for an empty set; GOSPA counts the misses
                g, _, loc, miss, false = calculate_gospa(gt, pred)
                gospas.append(g)
                locs.append(loc)
                misses.append(miss)
                falses.append(false)
        return {
            "n_empty_pred_radar": n_empty_pred,
            "chamfer_distance_radar_mean": float(np.mean(chamfers)) if chamfers else 0.0,
            "chamfer_distance_radar_median": float(np.median(chamfers)) if chamfers else 0.0,
            "chamfer_distance_radar_std": float(np.std(chamfers)) if chamfers else 0.0,
            "emd_distance_radar_mean": float(np.mean(emds)) if emds else 0.0,
            "emd_distance_radar_median": float(np.median(emds)) if emds else 0.0,
            "gospa_mean": float(np.mean(gospas)) if gospas else 0.0,
            "gospa_loc_mean": float(np.mean(locs)) if locs else 0.0,
            "gospa_missed_mean": float(np.mean(misses)) if misses else 0.0,
            "gospa_false_mean": float(np.mean(falses)) if falses else 0.0,
        }


def _gaussian_kernel1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _ssim_np(a: np.ndarray, b: np.ndarray, c1=0.01**2, c2=0.03**2, win=11, sigma=1.5) -> float:
    """Gaussian-window SSIM with torchmetrics' semantics, data range 1: an 11 x 11 window of sigma
    1.5, population moments, and the SSIM map averaged over the valid windows only."""
    from scipy.ndimage import correlate1d

    h, w = a.shape[:2]
    win = min(win, h - (h + 1) % 2, w - (w + 1) % 2)  # the largest odd size that fits
    k = _gaussian_kernel1d(win, sigma)
    p = (win - 1) // 2

    def filt(img):
        out = correlate1d(img, k, axis=0, mode="constant")
        out = correlate1d(out, k, axis=1, mode="constant")
        return out[p : h - p, p : w - p]  # the windows that never touch the border

    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mu_a = filt(a)
    mu_b = filt(b)
    var_a = filt(a * a) - mu_a**2
    var_b = filt(b * b) - mu_b**2
    cov = filt(a * b) - mu_a * mu_b
    ssim = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return float(ssim.mean())
