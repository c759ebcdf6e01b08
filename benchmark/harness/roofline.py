"""The yardstick's arithmetic: the card's peaks, the bytes and operations of the port's kernels K1
and K2, and the model FLOPs of a train step and of a render request.

Peaks: one NVIDIA H100 SXM by NVIDIA's data sheet, dense, at its 700 W limit. A kernel's bound is
the larger of its bytes (each input read once, each output written once) over the memory bandwidth
and its operations over the peak of their type; no faster kernel can beat it, so a share of it
cannot pass 100 %. K1's and K2's counts are those of the port's kernel table (chip_smoke.py).

Model FLOPs count the matrix products a request needs (2 per multiply-add): the proposal networks'
and the field's MLPs at their sample counts, the lidar decoder, the radar transformer (projections,
attention's two products, feed-forward) and its heads, the RGB CNN, and in training the VGG loss's
trunk; a backward is twice its forward (the VGG trunk, whose filters are frozen, only passes the
prediction's gradient back: once its forward, on the prediction's half of the batch), and the
recomputed chunks are not counted. Elementwise work, the hash-grid gathers and the sorts are not
FLOPs here; their time shows in the layers' device ms.
"""

from __future__ import annotations

from typing import Sequence, Tuple

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# conv widths of the VGG-19 trunk up to relu5_1 ("M": a 2 x 2 max pool), as the port's vgg.py
VGG19_LAYOUT = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512)


def bound_s(nbytes: float, ops: float, peak_flops: float) -> float:
    """The least time of a kernel: bytes over HBM bandwidth or operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak_flops)


def k1_fwd(R: int, S: int, C: int) -> Tuple[float, float]:
    """(bytes, ops) of K1's forward: alpha [R, S] and feats [R, S, C] in; w_sky [R, S], features
    [R, C] and accum [R, 1] out, float32; a multiply-add per sample and channel."""
    return 4.0 * (R * S + R * S * C + R * S + R * C + R), 2.0 * R * S * C + 4.0 * R * S


def k1_bwd(R: int, S: int, C: int) -> Tuple[float, float]:
    """(bytes, ops) of K1's backward: alpha, feats and the cotangents of (w_sky, features, accum) in;
    dalpha and dfeats out, float32."""
    return 4.0 * (R * S + R * S * C + R * S + R * C + R + R * S + R * S * C), 4.0 * R * S * C + 8.0 * R * S


def k2_fwd(B: int, S: int, D: int, elem_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, ops) of K2's forward without dropout or saved statistics: q, k, v in, out out;
    two products of 2 B S^2 D."""
    return float(elem_bytes * 4 * B * S * D), 4.0 * B * S * S * D


def mlp_flops(widths: Sequence[int]) -> float:
    """2 x the multiply-adds of a chain of dense layers in -> ... -> out, per row."""
    return 2.0 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def field_flops_per_ray(cfg) -> float:
    """The proposal networks at their sample counts, then the field at its samples plus the sky
    sample; ``cfg`` is the model configuration (the reference's ``NeuRadarModelConfig``)."""
    s, f = cfg.sampling, cfg.field
    total = 0.0
    for n, pf in zip(s.num_proposal_samples, (s.proposal_field_1, s.proposal_field_2)):
        grid = pf.grid.static.num_levels * pf.grid.static.hashgrid_dim
        total += n * mlp_flops([grid, pf.hidden_dim, 1])
    grid = f.grid.static.num_levels * f.grid.static.hashgrid_dim
    sh = 16  # spherical harmonics of 4 levels
    geo = mlp_flops([grid] + [f.geo_hidden_dim] * (f.geo_num_layers - 1) + [f.nff_out_dim + 1])
    feat = mlp_flops([f.nff_out_dim + sh] + [f.nff_hidden_dim] * (f.nff_num_layers - 1) + [f.nff_out_dim])
    return total + (s.num_nerf_samples + 1) * (geo + feat)


def lidar_flops_per_ray(cfg) -> float:
    return mlp_flops([cfg.field.nff_out_dim + cfg.appearance_dim, 32, 32, 2])


def radar_flops_per_scan(cfg, rays_per_scan: int, d_ff: int = 64, head_width: int = 16) -> float:
    """One scan through the encoder layer (q, k, v, out projections, QK^T and PV over the scan,
    feed-forward) and the four heads (offset 3, existence 1, uncertainty 3, angles 2)."""
    d = cfg.field.nff_out_dim + cfg.appearance_dim
    S = rays_per_scan
    per_ray = 4 * 2.0 * d * d + mlp_flops([d, d_ff, d])
    per_ray += sum(mlp_flops([d, head_width, head_width, k]) for k in (3, 1, 3, 2))
    return S * per_ray + 4.0 * S * S * d


def cnn_flops(cfg, h: int, w: int, images: int = 1) -> float:
    """The RGB decoder on ``images`` feature maps of h x w: 1x1 in, two 7x7 blocks, the transposed
    3x3 upsampling (stride 3), two 7x7 blocks at the upsampled size, 1x1 out."""
    c_in, c, u = cfg.field.nff_out_dim + cfg.appearance_dim, cfg.rgb_hidden_dim, cfg.rgb_upsample_factor
    lo, hi = h * w, h * w * u * u
    block = 2 * 2.0 * 49 * c * c
    return images * (2.0 * c_in * c * lo + 2 * block * lo + 2.0 * u * u * c * c * lo + 2 * block * hi
                     + 2.0 * c * 3 * hi)


def vgg_flops(h: int, w: int, images: int) -> float:
    """The VGG-19 trunk to relu5_1 on ``images`` images of h x w: 3 x 3 convolutions."""
    total, cin = 0.0, 3
    for item in VGG19_LAYOUT:
        if item == "M":
            h, w = h // 2, w // 2
            continue
        total += 2.0 * 9 * cin * item * h * w
        cin = item
    return images * total


def train_step_flops(cfg, layout, upsample: int) -> float:
    """Model FLOPs of one train step of ``layout`` (forward and backward)."""
    ph, pw = layout.patch_size
    patches = layout.num_cam // (ph * pw) if layout.num_cam else 0
    fwd = layout.total * field_flops_per_ray(cfg) + layout.num_lidar * lidar_flops_per_ray(cfg)
    if layout.num_radar_scans:
        fwd += layout.num_radar_scans * radar_flops_per_scan(cfg, layout.rays_per_scan)
    if patches:
        fwd += cnn_flops(cfg, ph, pw, patches)
    step = 3.0 * fwd
    if patches and cfg.loss.vgg_mult > 0:
        vgg_pred = vgg_flops(ph * upsample, pw * upsample, patches)
        step += 2 * vgg_pred + vgg_pred  # prediction and target forward, the prediction's backward
    return step


def camera_request_flops(cfg, h: int, w: int) -> float:
    """Model FLOPs of one camera request of h x w rays (before the upsampling)."""
    return h * w * field_flops_per_ray(cfg) + cnn_flops(cfg, h, w)


def radar_request_flops(cfg, rays_per_scan: int) -> float:
    """Model FLOPs of one radar scan's request."""
    return rays_per_scan * field_flops_per_ray(cfg) + radar_flops_per_scan(cfg, rays_per_scan)
