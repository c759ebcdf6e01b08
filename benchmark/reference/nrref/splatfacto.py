"""The plain reference of splatfacto's train step (3D Gaussian splatting, Kerbl et al. 2023, as
nerfstudio's splatfacto runs it through gsplat 0.1.11), in plain PyTorch and float32, for the
``splatfacto-big.train`` cell. It imports nothing of the port; TF32 is off for matmuls and cuDNN
while it runs.

A step renders one whole training image and takes Adam's step on it:

* projection (EWA): camera-frame means, the 2D mean in pixels, the Jacobian of the perspective
  projection, the 2D covariance with a 0.3 pixel blur, depth, the 3-sigma radius of the larger
  eigenvalue, and the in-view test (alive, depth > 0.1, the mean within a radius of the image);
* colours: a sigmoid DC colour plus real spherical harmonics up to the configured degree at the
  unit centre-to-camera direction, clamped below at 0;
* tiles: 16 x 16 pixels over the image rounded up to whole tiles; a gaussian overlaps a tile where
  the distance from its mean to the tile's centre is under its radius plus 16 x 0.7071 + 1; each
  tile's overlapping gaussians are sorted by depth with a plain stable sort (ties to the lower index)
  and the first K kept;
* compositing: dense over [tiles, 256 pixels, K] in blocks of tiles, alpha = clip(opacity x
  exp(min(power, 0)), 0, 0.999), transmittance the product of (1 - alpha + 1e-10) before each
  gaussian, over a white background;
* the loss 0.8 L1 + 0.2 (1 - SSIM), SSIM over 7 x 7 mean windows without padding; gradients by
  autograd (the blocks are composited again with the graph, one at a time, against the loss's
  gradient of the whole image, so that memory stays a block's); a plain Adam per parameter group
  (optax's: eps 1e-8 outside the root, bias-corrected moments).

Where these definitions, the JAX package's, depart from gsplat's: gsplat bins a gaussian into the
tiles its 3-sigma box touches and composites every one of them, here a circle test of the tile's
centre decides and a tile keeps only its K nearest; gsplat skips a gaussian whose alpha is under
1/255 and stops a pixel once its transmittance falls under 1e-4, here every listed gaussian is
composited; gsplat clips alpha at 0.99 and uses no 1e-10 in the transmittance, here 0.999 and
1e-10; gsplat's splatfacto grows and shrinks its tensors, here a fixed capacity with an alive mask.

The reference follows steps from ``stop_split_at`` on, where a refine only culls (no gaussian is
cloned or split, no opacity is reset, so no optimizer moment is reset either): at a step index past
``warmup_steps`` that ``refine_every`` divides, a gaussian dies if its opacity is at or under
``cull_alpha_thresh`` or, once past the first opacity-reset cycle, its largest scale is over
``cull_scale_thresh``.

``lowered=True`` computes the same step one precision below float32: every parameter, the
per-gaussian features (2D mean, conic, opacity, colour, depth), alpha and each transmittance
factor are rounded to bfloat16 (the gradient passing straight through), the precision control of
the cell's correctness check.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

TILE = 16
TILE_RADIUS = TILE * 0.7071 + 1.0
NAMES = ("means", "log_scales", "quats", "opacity_logits", "rgb_logits", "sh_rest")
BETAS = (0.9, 0.999)
EPS = 1e-8
SH_C = {
    1: (0.4886025119029199,),
    2: (1.0925484305920792, 0.31539156525252005, 0.5462742152960396),
    3: (0.5900435899266435, 2.890611442640554, 0.4570457994644658, 0.3731763325901154, 1.445305721320277),
}


@dataclass
class SplatSettings:
    top_k: int
    sh_degree: int
    ssim_lambda: float
    learning_rates: Dict[str, float]
    cull_alpha_thresh: float
    cull_scale_thresh: float
    refine_every: int
    warmup_steps: int
    reset_alpha_every: int
    stop_split_at: int


def _sh(d: torch.Tensor, degree: int) -> torch.Tensor:
    """Real spherical harmonics of bands 1..degree at unit directions [G, 3]: [G, B]."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    out = []
    if degree >= 1:
        (c,) = SH_C[1]
        out += [-c * y, c * z, -c * x]
    if degree >= 2:
        c0, c1, c2 = SH_C[2]
        out += [c0 * x * y, -c0 * y * z, c1 * (2 * z * z - x * x - y * y), -c0 * x * z, c2 * (x * x - y * y)]
    if degree >= 3:
        c0, c1, c2, c3, c4 = SH_C[3]
        out += [-c0 * y * (3 * x * x - y * y), c1 * x * y * z, -c2 * y * (4 * z * z - x * x - y * y),
                c3 * z * (2 * z * z - 3 * x * x - 3 * y * y), -c2 * x * (4 * z * z - x * x - y * y),
                c4 * z * (x * x - y * y), -c0 * x * (x * x - 3 * y * y)]
    return torch.stack(out, -1)


def _rotation(q: torch.Tensor) -> torch.Tensor:
    q = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    w, x, y, z = q.unbind(-1)
    rows = [(1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
            (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
            (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y))]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two [H, W, 3] images over 7 x 7 mean windows, no padding."""
    c1, c2 = 0.01**2, 0.03**2
    x, y = a.permute(2, 0, 1)[None], b.permute(2, 0, 1)[None]

    def mean(t):
        return F.avg_pool2d(t, 7, stride=1)

    mx, my = mean(x), mean(y)
    vx, vy, cxy = mean(x * x) - mx * mx, mean(y * y) - my * my, mean(x * y) - mx * my
    return (((2 * mx * my + c1) * (2 * cxy + c2)) / ((mx * mx + my * my + c1) * (vx + vy + c2))).mean()


class SplatReference:
    """The step of ``settings`` on the cameras and images of a scene: ``images`` uint8 [N, H, W, 3]
    (whole tiles), ``w2cs`` [N, 3, 4] and ``intrinsics`` [N, 4] (fx, fy, cx, cy)."""

    def __init__(self, settings: SplatSettings, images: np.ndarray, w2cs: np.ndarray, intrinsics: np.ndarray,
                 device, tiles_per_block: int = 64, lowered: bool = False):
        self.s = settings
        self.device = torch.device(device)
        self.images = torch.as_tensor(np.ascontiguousarray(images)).to(self.device)
        self.w2cs = torch.as_tensor(np.asarray(w2cs, np.float32)).to(self.device)
        self.intrinsics = [tuple(float(v) for v in row[:4]) for row in intrinsics]
        self.height, self.width = self.images.shape[1:3]
        self.tiles_per_block = tiles_per_block
        self.lowered = lowered

    def _low(self, x: torch.Tensor) -> torch.Tensor:
        return x + (x.bfloat16().float() - x).detach() if self.lowered else x

    # ---- one render
    def _geometry(self, p: Dict[str, torch.Tensor], idx: int):
        """(2D means [n, 2], conics [n, 3], depths [n], radii [n]) of the gaussians ``p``."""
        fx, fy, cx, cy = self.intrinsics[idx]
        w2c = self.w2cs[idx]
        Rw, t = w2c[:, :3], w2c[:, 3]
        m = p["means"] @ Rw.T + t
        z = torch.where(m[:, 2].abs() < 1e-6, torch.full_like(m[:, 2], -1e-6), m[:, 2])
        xy = torch.stack([fx * (m[:, 0] / -z) + cx, fy * (-m[:, 1] / -z) + cy], -1)
        RS = _rotation(p["quats"]) * torch.exp(p["log_scales"])[:, None, :]
        cov3 = Rw @ (RS @ RS.transpose(1, 2)) @ Rw.T
        zero = torch.zeros_like(z)
        J = torch.stack([torch.stack([fx / -z, zero, fx * m[:, 0] / (z * z)], -1),
                         torch.stack([zero, fy / z, -fy * m[:, 1] / (z * z)], -1)], 1)
        cov2 = J @ cov3 @ J.transpose(1, 2)
        a, b, c = cov2[:, 0, 0] + 0.3, cov2[:, 0, 1], cov2[:, 1, 1] + 0.3
        lam = 0.5 * (a + c) + torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=1e-8))
        det = torch.clamp(a * c - b * b, min=1e-8)
        return xy, torch.stack([c / det, -b / det, a / det], -1), -m[:, 2], 3.0 * torch.sqrt(torch.clamp(lam, min=1e-8))

    def features(self, p: Dict[str, torch.Tensor], alive: torch.Tensor, idx: int):
        """The gaussians in view of image ``idx``: (features [n, 10]: x, y, conic (3), opacity, r,
        g, b, depth; radii [n]; their indices [n], ascending). Only they are differentiated: the
        others' features can overflow (a mean on the camera's plane) and have no gradient."""
        with torch.no_grad():
            xy, _, depth, radius = self._geometry(p, idx)
            in_view = (alive & (depth > 0.1) & (xy[:, 0] > -radius) & (xy[:, 0] < self.width + radius)
                       & (xy[:, 1] > -radius) & (xy[:, 1] < self.height + radius))
        ids = torch.nonzero(in_view)[:, 0]
        p = {k: v[ids] for k, v in p.items()}
        xy, conic, depth, radius = self._geometry(p, idx)
        w2c = self.w2cs[idx]
        origin = -(w2c[:, :3].T @ w2c[:, 3])
        color = torch.sigmoid(p["rgb_logits"])
        if self.s.sh_degree > 0:
            d = p["means"] - origin
            d = d * torch.rsqrt((d * d).sum(-1, keepdim=True) + 1e-12)
            basis = _sh(d, self.s.sh_degree)
            color = torch.clamp(color + (basis[:, :, None] * p["sh_rest"].reshape(len(d), -1, 3)).sum(1), min=0.0)
        feats = torch.cat([xy, conic, torch.sigmoid(p["opacity_logits"]), color, depth[:, None]], 1)
        return self._low(feats), radius.detach(), ids

    def _centers(self) -> torch.Tensor:
        th, tw = -(-self.height // TILE), -(-self.width // TILE)
        ty, tx = torch.meshgrid(torch.arange(th, device=self.device), torch.arange(tw, device=self.device),
                                indexing="ij")
        return torch.stack([tx.reshape(-1), ty.reshape(-1)], -1).float() * TILE + TILE / 2

    def lists(self, feats: torch.Tensor, radius: torch.Tensor, capacity: int) -> List:
        """Each block of tiles' (centres, rows of ``feats`` [B, K], valid [B, K]): the K = min(top_k,
        capacity) nearest overlapping gaussians, by a stable sort of depth (the rows ascend with the
        gaussians' indices, so ties go to the lower index)."""
        xy, depth, r2 = feats[:, :2].detach(), feats[:, 9].detach(), (radius + TILE_RADIUS) ** 2
        K = min(self.s.top_k, capacity)
        out = []
        for c in self._centers().split(self.tiles_per_block):
            hit = ((c[:, None, :] - xy[None]) ** 2).sum(-1) < r2[None]
            key = torch.where(hit, depth[None], torch.full_like(depth[None], math.inf))
            rows = torch.sort(key, dim=1, stable=True).indices[:, :K]
            valid = torch.gather(hit, 1, rows)
            if rows.shape[1] < K:  # fewer gaussians in view than K: pad with invalid entries
                pad = K - rows.shape[1]
                rows = torch.cat([rows, rows.new_zeros(len(c), pad)], 1)
                valid = torch.cat([valid, valid.new_zeros(len(c), pad)], 1)
            out.append((c, rows, valid))
        return out

    def composite(self, feats: torch.Tensor, c: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """[B, 256, 5]: r, g, b, alpha and depth of each pixel of a block of tiles."""
        g = feats[ids]  # [B, K, 10]
        off = torch.arange(TILE, device=self.device, dtype=torch.float32) + 0.5 - TILE / 2
        py, px = torch.meshgrid(off, off, indexing="ij")
        pix = c[:, None, :] + torch.stack([px.reshape(-1), py.reshape(-1)], -1)[None]  # [B, 256, 2]
        dx = pix[:, :, None, 0] - g[:, None, :, 0]
        dy = pix[:, :, None, 1] - g[:, None, :, 1]
        power = -0.5 * (g[:, None, :, 2] * dx * dx + 2 * g[:, None, :, 3] * dx * dy + g[:, None, :, 4] * dy * dy)
        alpha = torch.clamp(g[:, None, :, 5] * torch.exp(torch.clamp(power, max=0.0)), 0.0, 0.999)
        alpha = self._low(alpha * valid[:, None, :])
        keep = self._low(1.0 - alpha + 1e-10)
        trans = torch.cat([torch.ones_like(keep[..., :1]), torch.cumprod(keep, -1)[..., :-1]], -1)
        w = alpha * trans
        return torch.cat([w @ g[..., 6:9], w.sum(-1, keepdim=True), (w * g[:, None, :, 9]).sum(-1, keepdim=True)], -1)

    def _image(self, tiles: torch.Tensor) -> torch.Tensor:
        """[T, 256, 5] to the white-background RGB image [H, W, 3]."""
        th, tw = -(-self.height // TILE), -(-self.width // TILE)
        full = tiles.reshape(th, tw, TILE, TILE, 5).permute(0, 2, 1, 3, 4).reshape(th * TILE, tw * TILE, 5)
        full = full[:self.height, :self.width]
        return full[..., :3] + (1 - full[..., 3:4])

    def loss_and_grads(self, p: Dict[str, torch.Tensor], alive: torch.Tensor, idx: int):
        """(loss, gradient of every parameter, the rendered image) of image ``idx``."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        feats, radius, _ = self.features({k: self._low(v) for k, v in leaves.items()}, alive, idx)
        blocks = self.lists(feats, radius, len(alive))
        free = feats.detach().requires_grad_(True)
        with torch.no_grad():
            tiles = torch.cat([self.composite(free, *b) for b in blocks])
        tiles.requires_grad_(True)
        image = self._image(tiles)
        gt = self.images[idx].float() / 255.0
        lam = self.s.ssim_lambda
        loss = (1 - lam) * (image - gt).abs().mean() + lam * (1 - ssim(image, gt))
        loss.backward()
        for b, grad in zip(blocks, tiles.grad.split(self.tiles_per_block)):
            self.composite(free, *b).backward(grad)
        feats.backward(free.grad)
        return float(loss.detach()), {k: v.grad for k, v in leaves.items()}, image.detach()

    # ---- the steps
    def follow(self, params: Dict[str, torch.Tensor], alive: torch.Tensor, images: Sequence[int],
               start_step: int) -> Dict:
        """The steps of index ``start_step``, ``start_step`` + 1, ... on the training images
        ``images`` from ``params`` (not changed): {losses, grads (the first step's), image (the
        first step's render), after (the parameters after the last step)}."""
        if start_step < self.s.stop_split_at:
            raise ValueError("the reference follows steps from stop_split_at on, where a refine only culls")
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return self._follow(params, alive, images, start_step)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    def _follow(self, params, alive, images, start_step) -> Dict:
        p = {k: v.detach().clone() for k, v in params.items()}
        alive = alive.clone()
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        out: Dict = {"losses": []}
        s = self.s
        for n, idx in enumerate(images, start=1):
            loss, grads, image = self.loss_and_grads(p, alive, idx)
            out["losses"].append(loss)
            if n == 1:
                out["grads"], out["image"] = {k: g.detach().clone() for k, g in grads.items()}, image
            b1, b2 = BETAS
            for k in p:
                m[k] = b1 * m[k] + (1 - b1) * grads[k]
                v2[k] = b2 * v2[k] + (1 - b2) * grads[k] * grads[k]
                step = (m[k] / (1 - b1**n)) / (torch.sqrt(v2[k] / (1 - b2**n)) + EPS)
                p[k] = p[k] - s.learning_rates[k] * step
            i = start_step + n - 1
            if i > s.warmup_steps and i % s.refine_every == 0:
                alive = alive & (torch.sigmoid(p["opacity_logits"][:, 0]) > s.cull_alpha_thresh)
                if i > s.refine_every * s.reset_alpha_every:
                    alive = alive & ~(torch.exp(p["log_scales"]).amax(-1) > s.cull_scale_thresh)
        out["after"] = p
        out["alive"] = alive
        return out


def settings_of(model: Dict) -> SplatSettings:
    """The settings of a configuration file's ``model`` entry."""
    names = {"means": "lr_means", "log_scales": "lr_scales", "quats": "lr_quats", "opacity_logits": "lr_opacity",
             "rgb_logits": "lr_rgb", "sh_rest": "lr_sh_rest"}
    return SplatSettings(top_k=model["tile_top_k"], sh_degree=model["sh_degree"], ssim_lambda=model["ssim_lambda"],
                         learning_rates={k: float(model[v]) for k, v in names.items()},
                         cull_alpha_thresh=model["cull_alpha_thresh"], cull_scale_thresh=model["cull_scale_thresh"],
                         refine_every=model["refine_every"], warmup_steps=model["warmup_steps"],
                         reset_alpha_every=model["reset_alpha_every"], stop_split_at=model["stop_split_at"])

