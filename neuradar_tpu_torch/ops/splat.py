"""K5: the tile rasterizer of 3D Gaussian splatting (splatfacto's render).

``render(feats, radius, in_view, height, width, top_k)`` composites projected gaussians into an
image of ``height`` x ``width`` pixels and returns (color [H, W, 3], alpha [H, W, 1], depth [H, W, 1],
stats). ``feats`` [G, 10] float32 holds, per gaussian, its 2D mean in pixels (x, y), the conic (ia,
ib, ic: the inverse of its 2D covariance), its opacity, its colour (r, g, b) and its depth; the
gradient flows to all ten. ``radius`` [G] (3 sigma, in pixels) and ``in_view`` [G] only decide
which gaussians each tile lists, with no gradient. ``stats`` is (listed pairs, tiles overflowed):
the (tile, gaussian) pairs composited after truncation, and the tiles with more than ``top_k``
overlapping gaussians.

The mathematics is the JAX package's ``models/splatfacto.rasterize``. The canvas is the image
rounded up to whole 16 x 16 tiles (the pixels past the image are computed and cropped). A gaussian
overlaps a tile where it is in view and the distance from its mean to the tile's centre is under its
radius plus TILE_RADIUS (the tile's half-diagonal and a pixel). Each tile lists its ``top_k``
nearest overlapping gaussians by depth, ties to the lower index (``jax.lax.top_k``'s order), and
composites every listed gaussian front to back, with no cut for small alpha or low
transmittance: alpha = clip(opacity exp(min(power, 0)), 0, 0.999), power = -0.5 d^T conic d at the
pixel's centre, transmittance the product of (1 - alpha + 1e-10) before it.

On CPU tensors ``render`` runs the plain version (``render_plain``): the [tiles, G] overlap test,
a stable sort of each tile's scores, and dense compositing over [tiles, 256, K], in blocks of tiles
under ``torch.utils.checkpoint`` where more than one block is needed. On CUDA tensors it runs
``csrc/splat_raster.cu``: each in-view gaussian counts and then emits its (tile, depth) keys, which
one stable sort orders (torch.sort, a radix sort); a tile's list is its first ``top_k`` entries,
and one block a tile composites them, forward and backward. The total pair count is read on the
host to size the keys (``host_sync/splat_pairs``, with the two stats in the same read).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from neuradar_tpu_torch.ops import build
from neuradar_tpu_torch.utils import trace

TILE = 16
TILE_RADIUS = TILE * 0.7071 + 1.0
FEATS = 10  # x, y, ia, ib, ic, opacity, r, g, b, depth
# tiles a block of the plain version composites at once: [64, 256, K] intermediates
PLAIN_TILES_PER_BLOCK = 64


def tile_grid(height: int, width: int) -> Tuple[int, int]:
    """(tile rows, tile columns) of the canvas: the image rounded up to whole tiles."""
    return -(-height // TILE), -(-width // TILE)


def _centers(th: int, tw: int, device) -> torch.Tensor:
    """Tile centres [T, 2] (x, y) in pixels, row-major over the tiles."""
    ty, tx = torch.meshgrid(torch.arange(th, device=device), torch.arange(tw, device=device), indexing="ij")
    return torch.stack([tx.reshape(-1) * TILE + TILE / 2, ty.reshape(-1) * TILE + TILE / 2], -1).float()


def tile_lists_plain(xy: torch.Tensor, radius: torch.Tensor, depth: torch.Tensor, in_view: torch.Tensor,
                     centers: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each tile's ``top_k`` nearest overlapping gaussians: (indices [T, K] int64, valid [T, K],
    overlapping count [T]); K = min(top_k, G). Plain PyTorch over the dense [T, G] scores."""
    d2 = torch.sum((centers[:, None, :] - xy[None, :, :]) ** 2, -1)
    overlap = (d2 < (radius[None, :] + TILE_RADIUS) ** 2) & in_view[None, :]
    score = torch.where(overlap, -depth[None, :], torch.full_like(d2, -math.inf))
    K = min(top_k, xy.shape[0])
    top, idx = torch.sort(score, dim=1, descending=True, stable=True)
    return idx[:, :K], torch.isfinite(top[:, :K]), overlap.sum(1)


def composite_plain(feats: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                    centers: torch.Tensor) -> torch.Tensor:
    """The listed gaussians of each tile composited at its 256 pixels: [T, 256, 5] (r, g, b,
    alpha, depth)."""
    g = feats[idx]  # [T, K, 10]
    py, px = torch.meshgrid(torch.arange(TILE, device=feats.device), torch.arange(TILE, device=feats.device),
                            indexing="ij")
    pix = torch.stack([px.reshape(-1), py.reshape(-1)], -1).float() + 0.5
    pix_xy = (centers - TILE / 2)[:, None, :] + pix[None, :, :]  # [T, P, 2]
    dx = pix_xy[:, :, None, 0] - g[:, None, :, 0]
    dy = pix_xy[:, :, None, 1] - g[:, None, :, 1]
    ia, ib, ic = g[:, None, :, 2], g[:, None, :, 3], g[:, None, :, 4]
    power = -0.5 * (ia * dx * dx + 2 * ib * dx * dy + ic * dy * dy)
    alpha = torch.clamp(g[:, None, :, 5] * torch.exp(torch.clamp(power, max=0.0)), 0.0, 0.999)
    alpha = torch.where(valid[:, None, :], alpha, torch.zeros_like(alpha))
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    w = alpha * trans  # [T, P, K]
    rgb = torch.einsum("tpk,tkc->tpc", w, g[..., 6:9])
    acc = torch.sum(w, dim=-1, keepdim=True)
    dep = torch.einsum("tpk,tk->tp", w, g[..., 9])[..., None]
    return torch.cat([rgb, acc, dep], -1)


def _untile(x: torch.Tensor, th: int, tw: int, height: int, width: int) -> torch.Tensor:
    ch = x.shape[-1]
    full = x.reshape(th, tw, TILE, TILE, ch).permute(0, 2, 1, 3, 4).reshape(th * TILE, tw * TILE, ch)
    return full[:height, :width]


def render_plain(feats: torch.Tensor, radius: torch.Tensor, in_view: torch.Tensor, height: int, width: int,
                 top_k: int, tiles_per_block: int = PLAIN_TILES_PER_BLOCK):
    """The plain version of ``render`` (any device)."""
    th, tw = tile_grid(height, width)
    centers = _centers(th, tw, feats.device)
    xy, depth = feats[:, :2].detach(), feats[:, 9].detach()
    parts, listed, overflowed = [], 0, 0
    K = min(top_k, feats.shape[0])
    for t0 in range(0, th * tw, tiles_per_block):
        c = centers[t0:t0 + tiles_per_block]
        idx, valid, n_overlap = tile_lists_plain(xy, radius.detach(), depth, in_view, c, top_k)
        listed += int(valid.sum())
        overflowed += int((n_overlap > K).sum())
        if torch.is_grad_enabled() and feats.requires_grad and th * tw > tiles_per_block:
            parts.append(checkpoint(composite_plain, feats, idx, valid, c, use_reentrant=False))
        else:
            parts.append(composite_plain(feats, idx, valid, c))
    out = _untile(torch.cat(parts, 0), th, tw, height, width)
    return out[..., 0:3], out[..., 3:4], out[..., 4:5], (listed, overflowed)


def bin_sort(feats: torch.Tensor, radius: torch.Tensor, in_view: torch.Tensor, th: int, tw: int, top_k: int):
    """The tiles' lists on the card: (gaussian ids [pairs] int32 sorted by (tile, depth, id),
    each tile's first entry [T] int64 and pair count [T] int32, (listed pairs, tiles overflowed))."""
    G, T = feats.shape[0], th * tw
    device, lib = feats.device, build.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    view = in_view.contiguous()  # bool: one byte, 0 or 1
    counts = torch.empty(G, dtype=torch.int32, device=device)
    tile_counts = torch.zeros(T, dtype=torch.int32, device=device)
    gaussians = (feats.data_ptr(), radius.data_ptr(), view.data_ptr())
    build.check(lib.splat_bin_count(*gaussians, G, tw, th, TILE_RADIUS, counts.data_ptr(), tile_counts.data_ptr(),
                                    stream), "splat_bin_count")
    ends = torch.cumsum(counts, 0)
    tile_start = torch.cumsum(tile_counts, 0, dtype=torch.int64) - tile_counts
    stats = torch.stack([counts.sum(dtype=torch.int64), tile_counts.clamp(max=top_k).sum(dtype=torch.int64),
                         (tile_counts > top_k).sum()])
    with trace.host_sync("splat_pairs"):
        total, listed, overflowed = stats.tolist()
    keys = torch.empty(total, dtype=torch.int64, device=device)
    gids = torch.empty(total, dtype=torch.int32, device=device)
    build.check(lib.splat_bin_emit(*gaussians, ends.data_ptr(), counts.data_ptr(), G, tw, th, TILE_RADIUS,
                                   keys.data_ptr(), gids.data_ptr(), stream), "splat_bin_emit")
    _, order = torch.sort(keys, stable=True)
    return gids[order], tile_start, tile_counts, (listed, overflowed)


def _lists(*tensors):
    """The device pointers of the features and the tiles' lists, as the raster launchers take them."""
    return tuple(t.data_ptr() for t in tensors)


def raster_fwd(feats, gids, tile_start, tile_counts, top_k: int, tw: int, height: int, width: int):
    """K5's forward kernel over the tiles' lists: (color [H, W, 3], alpha [H, W, 1], depth [H, W, 1])."""
    device = feats.device
    color = torch.empty(height, width, 3, dtype=torch.float32, device=device)
    alpha = torch.empty(height, width, 1, dtype=torch.float32, device=device)
    depth = torch.empty(height, width, 1, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    build.check(build.load().splat_raster_fwd(
        *_lists(feats, gids, tile_start, tile_counts), tile_counts.numel(), top_k, tw, width, height,
        color.data_ptr(), alpha.data_ptr(), depth.data_ptr(), stream), "splat_raster_fwd")
    return color, alpha, depth


def raster_bwd(feats, gids, tile_start, tile_counts, top_k: int, tw: int, height: int, width: int, outputs,
               grads) -> torch.Tensor:
    """K5's backward kernel: the features' gradient [G, 10] from the forward's ``outputs`` (color,
    alpha, depth) and their gradients ``grads``."""
    dfeats = torch.zeros_like(feats)
    grads = [g.contiguous() for g in grads]
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    build.check(build.load().splat_raster_bwd(
        *_lists(feats, gids, tile_start, tile_counts), tile_counts.numel(), top_k, tw, width, height,
        *(t.data_ptr() for t in (*outputs, *grads, dfeats)), stream), "splat_raster_bwd")
    return dfeats


class _Raster(torch.autograd.Function):
    """K5's compositing on the card: forward and backward kernels over the tiles' lists."""

    @staticmethod
    def forward(ctx, feats, gids, tile_start, tile_counts, top_k, tw, height, width):
        outputs = raster_fwd(feats, gids, tile_start, tile_counts, top_k, tw, height, width)
        ctx.save_for_backward(feats, gids, tile_start, tile_counts, *outputs)
        ctx.shape = (top_k, tw, height, width)
        return outputs

    @staticmethod
    def backward(ctx, dcolor, dalpha, ddepth):
        feats, gids, tile_start, tile_counts, *outputs = ctx.saved_tensors
        with trace.span("splat/rasterize_bwd", device=True):
            dfeats = raster_bwd(feats, gids, tile_start, tile_counts, *ctx.shape, outputs, (dcolor, dalpha, ddepth))
        return dfeats, None, None, None, None, None, None, None


def _check(feats: torch.Tensor, radius: torch.Tensor, in_view: torch.Tensor) -> None:
    G = feats.shape[0]
    if feats.dtype != torch.float32 or feats.dim() != 2 or feats.shape[1] != FEATS or not feats.is_contiguous():
        raise ValueError(f"render takes contiguous float32 feats [G, {FEATS}], got {feats.dtype} {tuple(feats.shape)}")
    if radius.dtype != torch.float32 or tuple(radius.shape) != (G,) or tuple(in_view.shape) != (G,):
        raise ValueError(f"render: radius {radius.dtype} {tuple(radius.shape)}, in_view {tuple(in_view.shape)}")
    if in_view.dtype != torch.bool or any(t.device != feats.device for t in (radius, in_view)):
        raise ValueError("render: in_view must be bool, and every tensor on feats' device")


def render(feats: torch.Tensor, radius: torch.Tensor, in_view: torch.Tensor, height: int, width: int,
           top_k: int):
    """(color [H, W, 3], alpha [H, W, 1], depth [H, W, 1], (listed pairs, tiles overflowed)); see
    the module's docstring."""
    _check(feats, radius, in_view)
    if feats.device.type == "cpu":
        color, alpha, depth, stats = render_plain(feats, radius, in_view, height, width, top_k)
    else:
        th, tw = tile_grid(height, width)
        K = min(top_k, feats.shape[0])
        with trace.span("splat/bin_sort", device=True):
            gids, tile_start, tile_counts, stats = bin_sort(feats.detach(), radius.detach().contiguous(), in_view,
                                                            th, tw, K)
        with trace.span("splat/rasterize", device=True):
            color, alpha, depth = _Raster.apply(feats, gids, tile_start, tile_counts, K, tw, height, width)
    trace.count("splat_tile_pairs", stats[0])
    trace.count("splat_tiles_overflowed", stats[1])
    return color, alpha, depth, stats
