"""Splatfacto: 3D Gaussian splatting (port of the JAX package's models/splatfacto.py).

A fixed-capacity set of gaussians with an alive mask (``GaussianSet``): densification and culling
write into free slots and clear the mask with masked operations, so no parameter changes shape and
the optimizer's state stays attached. A render projects every gaussian (the EWA projection with a
0.3 pixel blur, its depth, 3-sigma radius and in-view test), evaluates its colour at the
centre-to-camera direction (a sigmoid DC colour plus spherical harmonics up to ``sh_degree``,
clamped below at 0) and hands the ten per-gaussian features to K5 (``ops/splat.py``), which
composites each 16 x 16 tile's ``tile_top_k`` nearest gaussians front to back over a white
background. The loss is 0.8 L1 + 0.2 (1 - SSIM) over the whole image. Everything is float32.

``rasterize`` takes an optional zero ``mean2d_offset`` [G, 2] added to the projected means: its
gradient is the screen-space mean gradient that densification accumulates (gsplat's ``xys.grad``).
The spans ``splat/project`` (projection, colours and features) and K5's own spans time a render.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neuradar_tpu_torch.ops import splat as splat_ops
from neuradar_tpu_torch.utils import trace
from neuradar_tpu_torch.utils.poses import quaternion_to_matrix

TILE = splat_ops.TILE
PARAM_NAMES = ("means", "log_scales", "quats", "opacity_logits", "rgb_logits", "sh_rest")
STATE_NAMES = ("alive", "grad_accum", "grad_count")


@dataclass
class SplatfactoConfig:
    """The JAX package's SplatfactoConfig (cf. nerfstudio's SplatfactoModelConfig)."""

    max_gaussians: int = 262144  # fixed capacity; the alive mask governs the count
    tile_top_k: int = 256  # gaussians a tile composites; overflow is counted
    init_opacity: float = 0.1
    init_scale: float = 0.5
    sh_degree: int = 3  # view-dependent spherical-harmonics bands
    cull_alpha_thresh: float = 0.005
    densify_grad_thresh: float = 0.0004
    densify_scale_thresh: float = 2.0  # world units: split if larger
    refine_every: int = 100
    warmup_steps: int = 500
    ssim_lambda: float = 0.2
    reset_alpha_every: int = 30  # refine cycles between opacity resets
    cull_scale_thresh: float = 10.0  # world units; culls once the first opacity-reset cycle has passed
    stop_split_at: int = 15000  # no densification after this step


class GaussianSet(nn.Module):
    """The gaussians' parameters (``PARAM_NAMES``, each [G, ...]) and their state: ``alive`` [G]
    and the screen-space gradient statistics ``grad_accum`` and ``grad_count`` [G]."""

    def __init__(self, params: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor]):
        super().__init__()
        for name in PARAM_NAMES:
            if name in params:
                setattr(self, name, nn.Parameter(params[name]))
        for name in STATE_NAMES:
            self.register_buffer(name, state[name])

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        return {name: getattr(self, name) for name in PARAM_NAMES if hasattr(self, name)}

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in STATE_NAMES}


def sh_num_rest(degree: int) -> int:
    """The real-SH basis functions of bands 1..degree."""
    return (degree + 1) ** 2 - 1


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real spherical harmonics of bands 1..degree at unit directions [..., 3]: [..., B] (the
    standard 3DGS constants; the DC band is the sigmoid base colour)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = []
    if degree >= 1:
        out += [-0.4886025119029199 * y, 0.4886025119029199 * z, -0.4886025119029199 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [
            1.0925484305920792 * x * y,
            -1.0925484305920792 * y * z,
            0.31539156525252005 * (2.0 * zz - xx - yy),
            -1.0925484305920792 * x * z,
            0.5462742152960396 * (xx - yy),
        ]
    if degree >= 3:
        out += [
            -0.5900435899266435 * y * (3.0 * xx - yy),
            2.890611442640554 * x * y * z,
            -0.4570457994644658 * y * (4.0 * zz - xx - yy),
            0.3731763325901154 * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            -0.4570457994644658 * x * (4.0 * zz - xx - yy),
            1.445305721320277 * z * (xx - yy),
            -0.5900435899266435 * x * (xx - 3.0 * yy),
        ]
    if not out:
        return dirs.new_zeros(dirs.shape[:-1] + (0,))
    return torch.stack(out, dim=-1)


def gaussian_colors(params: Dict[str, torch.Tensor], cam_origin: torch.Tensor, sh_degree: int) -> torch.Tensor:
    """Each gaussian's RGB [G, 3] seen from ``cam_origin``: the sigmoid DC colour plus the SH bands
    at the centre-to-camera direction, clamped below at 0 only (an upper clip would freeze the SH
    bands of saturated gaussians)."""
    base = torch.sigmoid(params["rgb_logits"])
    if sh_degree <= 0 or "sh_rest" not in params:
        return base
    d = params["means"] - cam_origin[None, :]
    # dead slots sit at the origin: rsqrt(|d|^2 + eps) keeps their gradient finite
    d = d * torch.rsqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-12)
    basis = sh_basis(d, sh_degree)
    B = basis.shape[-1]
    view_dep = (basis[:, :, None] * params["sh_rest"].reshape(-1, B, 3)).sum(1)
    return torch.clamp(base + view_dep, min=0.0)


def _logit(p):
    return np.log(p / (1 - p))


def init_gaussians(config: SplatfactoConfig, points: np.ndarray, colors: np.ndarray,
                   device="cpu") -> GaussianSet:
    """Gaussians seeded from a point cloud [n, 3] with colours [n, 3] in [0, 1]; the capacity's
    remaining slots are dead."""
    G = config.max_gaussians
    n = min(len(points), G)
    means = np.zeros((G, 3), np.float32)
    means[:n] = points[:n]
    rgb = np.full((G, 3), 0.5, np.float32)
    rgb[:n] = colors[:n]
    params = {
        "means": torch.as_tensor(means),
        "log_scales": torch.full((G, 3), float(np.float32(np.log(config.init_scale)))),
        "quats": torch.tensor([1.0, 0.0, 0.0, 0.0]).repeat(G, 1),
        "opacity_logits": torch.full((G, 1), float(np.float32(_logit(config.init_opacity)))),
        "rgb_logits": torch.as_tensor(_logit(np.clip(rgb, 0.01, 0.99)).astype(np.float32)),
    }
    if config.sh_degree > 0:
        params["sh_rest"] = torch.zeros((G, sh_num_rest(config.sh_degree) * 3))
    state = {"alive": torch.arange(G) < n, "grad_accum": torch.zeros(G), "grad_count": torch.zeros(G)}
    return GaussianSet(params, state).to(device)


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for small batched matrices [..., m, k] @ [..., k, n] as one broadcast product and sum:
    cuBLAS' batched GEMM is slow on a million 3 x 3 products, elementwise kernels are not."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def project_gaussians(params: Dict[str, torch.Tensor], alive: torch.Tensor, w2c: torch.Tensor, fx: float,
                      fy: float, cx: float, cy: float, width: int, height: int):
    """The EWA projection (cf. gsplat's project_gaussians): (mean2d [G, 2] in pixels, cov2d [G, 3]
    (a, b, c) with the 0.3 blur, depth [G], 3-sigma radius [G], in_view [G]). The camera looks down
    its -z axis; ``w2c`` is [3, 4].

    A gaussian at depth 0.1 or less is never in view. The JAX package holds |z| at 1e-6 alone, and a
    mean within a fraction of a millimetre of the camera's plane then gives a 2D covariance that
    overflows, whose gradient is 0 x inf = NaN although the gaussian is not rendered; here such a
    gaussian is projected as if at depth 1, so its gradient is exactly 0. Every gaussian in view is
    projected as the JAX package projects it."""
    means = params["means"]
    R = quaternion_to_matrix(params["quats"])
    S = torch.exp(params["log_scales"])
    RS = R * S[:, None, :]
    cov3d = _matmul3(RS, RS.transpose(-1, -2))

    W, t = w2c[:3, :3], w2c[:3, 3]
    means_cam = (means[:, None, :] * W).sum(-1) + t
    depth = -means_cam[:, 2]
    x, y = means_cam[:, 0], means_cam[:, 1]
    z = torch.where(depth > 0.1, means_cam[:, 2], torch.full_like(depth, -1.0))
    mean2d = torch.stack([fx * (x / -z) + cx, fy * (-y / -z) + cy], dim=-1)

    zeros = torch.zeros_like(z)
    J = torch.stack([torch.stack([fx / -z, zeros, fx * x / (z * z)], -1),
                     torch.stack([zeros, -fy / -z, -fy * y / (z * z)], -1)], dim=-2)  # [G, 2, 3]
    cov_cam = _matmul3(_matmul3(W, cov3d), W.T)
    cov2d = _matmul3(_matmul3(J, cov_cam), J.transpose(-1, -2))
    a = cov2d[:, 0, 0] + 0.3
    b = cov2d[:, 0, 1]
    c = cov2d[:, 1, 1] + 0.3

    lam_max = 0.5 * (a + c) + torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=1e-8))
    radius = 3.0 * torch.sqrt(torch.clamp(lam_max, min=1e-8))
    in_view = (alive & (depth > 0.1)
               & (mean2d[:, 0] > -radius) & (mean2d[:, 0] < width + radius)
               & (mean2d[:, 1] > -radius) & (mean2d[:, 1] < height + radius))
    return mean2d, torch.stack([a, b, c], -1), depth, radius, in_view


def conic(cov2d: torch.Tensor) -> torch.Tensor:
    """The inverse of each 2D covariance (a, b, c) [G, 3] as (ia, ib, ic), the determinant held at
    1e-8 or above."""
    a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = torch.clamp(a * c - b * b, min=1e-8)
    return torch.stack([c / det, -b / det, a / det], -1)


def features(params: Dict[str, torch.Tensor], alive: torch.Tensor, w2c: torch.Tensor, fx: float, fy: float,
             cx: float, cy: float, height: int, width: int, sh_degree: int,
             mean2d_offset: Optional[torch.Tensor] = None):
    """K5's inputs: (features [G, 10]: the 2D mean (plus ``mean2d_offset``), the conic, opacity,
    colour and depth; 3-sigma radius [G]; in_view [G]), under the span ``splat/project``."""
    with trace.span("splat/project", device=w2c.is_cuda):
        mean2d, cov2d, depth, radius, in_view = project_gaussians(params, alive, w2c, fx, fy, cx, cy, width,
                                                                  height)
        if mean2d_offset is not None:
            mean2d = mean2d + mean2d_offset
        cam_origin = -w2c[:3, :3].T @ w2c[:3, 3]
        rgb = gaussian_colors(params, cam_origin, sh_degree)
        feats = torch.cat([mean2d, conic(cov2d), torch.sigmoid(params["opacity_logits"]), rgb, depth[:, None]], dim=1)
    return feats, radius, in_view


def rasterize(params: Dict[str, torch.Tensor], alive: torch.Tensor, w2c: torch.Tensor, fx: float, fy: float,
              cx: float, cy: float, height: int, width: int, top_k: int, sh_degree: int = 0,
              mean2d_offset: Optional[torch.Tensor] = None):
    """(rgb [H, W, 3], alpha [H, W, 1], depth [H, W, 1], (mean2d, radius, in_view,
    overflow_frac)): the gaussians composited by K5 without a background; ``overflow_frac`` is the
    share of tiles with more than ``top_k`` overlapping gaussians."""
    feats, radius, in_view = features(params, alive, w2c, fx, fy, cx, cy, height, width, sh_degree, mean2d_offset)
    color, alpha, dep, (_, overflowed) = splat_ops.render(feats, radius, in_view, height, width, top_k)
    th, tw = splat_ops.tile_grid(height, width)
    return color, alpha, dep, (feats[:, :2], radius, in_view, overflowed / (th * tw))


def render_splats(config: SplatfactoConfig, params, alive, camera: Dict, background=None, mean2d_offset=None):
    """A whole image of ``camera`` {w2c [3, 4], fx, fy, cx, cy, height, width} over ``background``
    (white by default): {rgb, alpha, depth, aux}."""
    rgb, alpha, depth, aux = rasterize(params, alive, camera["w2c"], camera["fx"], camera["fy"], camera["cx"],
                                       camera["cy"], camera["height"], camera["width"], config.tile_top_k,
                                       sh_degree=config.sh_degree, mean2d_offset=mean2d_offset)
    if background is None:
        background = torch.ones(3, device=rgb.device)
    return {"rgb": rgb + (1 - alpha) * background, "alpha": alpha, "depth": depth, "aux": aux}


def ssim(a: torch.Tensor, b: torch.Tensor, c1: float = 0.01**2, c2: float = 0.03**2) -> torch.Tensor:
    """SSIM of two images [H, W, 3], 7 x 7 mean windows without padding, averaged."""
    def pool(x):
        return F.avg_pool2d(x.permute(2, 0, 1)[None], 7, stride=1)[0]

    mu_a, mu_b = pool(a), pool(b)
    var_a = pool(a * a) - mu_a**2
    var_b = pool(b * b) - mu_b**2
    cov = pool(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return torch.mean(s)


def splat_loss(config: SplatfactoConfig, params, alive, camera: Dict, gt_rgb: torch.Tensor, mean2d_offset=None):
    """(0.8 L1 + 0.2 (1 - SSIM) of the render against ``gt_rgb``, the render)."""
    out = render_splats(config, params, alive, camera, mean2d_offset=mean2d_offset)
    l1 = torch.mean(torch.abs(out["rgb"] - gt_rgb))
    loss = (1 - config.ssim_lambda) * l1 + config.ssim_lambda * (1 - ssim(out["rgb"], gt_rgb))
    return loss, out


@torch.no_grad()
def accumulate_grad_stats(state: Dict[str, torch.Tensor], grads_means2d_norm: torch.Tensor,
                          in_view: torch.Tensor) -> None:
    """Add a step's screen-space gradient norms of the in-view gaussians to the densification
    statistics, in place."""
    state["grad_accum"].add_(torch.where(in_view, grads_means2d_norm, torch.zeros_like(grads_means2d_norm)))
    state["grad_count"].add_(in_view.float())


@torch.no_grad()
def reset_opacities(config: SplatfactoConfig, params: Dict[str, torch.Tensor]) -> None:
    """Clamp every opacity to twice the cull threshold, in place: floaters must earn their
    opacity again or be culled at the next refine."""
    params["opacity_logits"].clamp_(max=float(_logit(min(config.cull_alpha_thresh * 2.0, 0.999))))


@torch.no_grad()
def refine_gaussians(config: SplatfactoConfig, params: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor],
                     noise: torch.Tensor, step: Optional[int] = None) -> torch.Tensor:
    """Cull, clone and split, in place, with masked operations only (no host read); returns the
    slots whose parameters were written [G] (the trainer resets their optimizer moments).

    Culled: dead, opacity at or under ``cull_alpha_thresh``, and (from the step after the first
    opacity-reset cycle) largest scale over ``cull_scale_thresh``. Candidates: kept gaussians whose
    mean screen-space gradient exceeds ``densify_grad_thresh`` (before ``stop_split_at``); those
    larger than ``densify_scale_thresh`` split (the copy moves by ``noise`` [G, 3], standard normal,
    scaled and rotated into the gaussian's frame, and both shrink by 1.6), the others clone. The
    best candidates are copied into the free slots, best first.
    """
    G = state["alive"].shape[0]
    alive = state["alive"]
    avg_grad = state["grad_accum"] / torch.clamp(state["grad_count"], min=1.0)
    opacity = torch.sigmoid(params["opacity_logits"][..., 0])
    scales = torch.exp(params["log_scales"]).amax(-1)

    keep = alive & (opacity > config.cull_alpha_thresh)
    if step is not None and step > config.refine_every * config.reset_alpha_every:
        keep = keep & ~(scales > config.cull_scale_thresh)
    wants = keep & (avg_grad > config.densify_grad_thresh)
    if step is not None and step >= config.stop_split_at:
        wants = torch.zeros_like(wants)
    split = wants & (scales > config.densify_scale_thresh)
    clone = wants & ~split

    free = ~keep
    n_free = free.sum()
    cand_score = torch.where(clone | split, avg_grad, torch.full_like(avg_grad, -math.inf))
    src = torch.argsort(-cand_score, stable=True)  # the best candidates first
    dst = torch.argsort((~free).to(torch.uint8), stable=True)  # the free slots first
    arange = torch.arange(G, device=alive.device)
    can_copy = (arange < n_free) & torch.isfinite(cand_score[src])

    log_scales, means = params["log_scales"], params["means"]
    log16 = torch.log(torch.tensor(1.6, device=alive.device))
    split_src = split[src][:, None]
    local = noise * torch.exp(log_scales[src])
    moved = torch.einsum("gij,gj->gi", quaternion_to_matrix(params["quats"][src]), local)
    new_vals = {
        "means": means[src] + torch.where(split_src, moved, torch.zeros_like(moved)),
        "log_scales": log_scales[src] - torch.where(split_src, log16, torch.zeros_like(log16)),
    }
    # rank i goes to slot dst[i]: each slot reads its rank through the inverse permutation
    rank = torch.empty_like(dst)
    rank[dst] = arange
    refreshed = can_copy[rank]
    for name, p in params.items():
        incoming = new_vals[name][rank] if name in new_vals else p[src[rank]]
        p.copy_(torch.where(refreshed[:, None], incoming, p))
    # a split also shrinks its source (a kept gaussian, never a free slot)
    log_scales.copy_(torch.where(split[:, None], log_scales - log16, log_scales))
    alive.copy_(keep | refreshed)
    state["grad_accum"].zero_()
    state["grad_count"].zero_()
    return refreshed


_SH_C0 = 0.28209479177387814


def export_gaussians_ply(path, params: Dict[str, np.ndarray], alive: np.ndarray) -> int:
    """The alive gaussians as a standard 3DGS PLY (x y z nx ny nz f_dc_* f_rest_* opacity scale_*
    rot_*, binary little endian), which gsplat's and INRIA's viewers read: the sigmoid DC colour
    maps to f_dc by (c - 0.5) / C0, the SH rest bands are stored channel-major as INRIA's f_rest.
    Returns the number of gaussians written."""
    keep = np.asarray(alive).astype(bool)
    means = np.asarray(params["means"])[keep]
    n = len(means)
    dc = (1.0 / (1.0 + np.exp(-np.asarray(params["rgb_logits"])[keep])) - 0.5) / _SH_C0
    if "sh_rest" in params:
        rest = np.asarray(params["sh_rest"])[keep]
        B = rest.shape[-1] // 3
        rest = rest.reshape(n, B, 3).transpose(0, 2, 1).reshape(n, 3 * B)
    else:
        rest = np.zeros((n, 0), np.float32)
    opac = np.asarray(params["opacity_logits"])[keep]
    scales = np.asarray(params["log_scales"])[keep]
    quats = np.asarray(params["quats"])[keep]
    quats = quats / np.linalg.norm(quats, axis=-1, keepdims=True).clip(1e-8)
    cols = (["x", "y", "z", "nx", "ny", "nz"] + [f"f_dc_{i}" for i in range(3)]
            + [f"f_rest_{i}" for i in range(rest.shape[1])]
            + ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"])
    data = np.concatenate([means, np.zeros((n, 3), np.float32), dc, rest, opac, scales, quats], axis=1).astype("<f4")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        header += [f"property float {c}" for c in cols] + ["end_header"]
        f.write(("\n".join(header) + "\n").encode())
        data.tofile(f)
    return n


def camera_dict(w2c: torch.Tensor, intrinsics, height: int, width: int) -> Dict:
    """The render's camera: ``w2c`` [3, 4] on the device, ``intrinsics`` (fx, fy, cx, cy) floats."""
    fx, fy, cx, cy = (float(v) for v in intrinsics[:4])
    return {"w2c": w2c, "fx": fx, "fy": fy, "cx": cx, "cy": cy, "height": height, "width": width}


def world_to_camera(c2w: np.ndarray) -> np.ndarray:
    """[3, 4] world-to-camera of a [3, 4] camera-to-world (float64 inverse, as the JAX trainer)."""
    return np.linalg.inv(np.vstack([c2w, [0, 0, 0, 1]]))[:3].astype(np.float32)

