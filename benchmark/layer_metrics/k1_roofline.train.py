"""K1's share of its roofline in a train step, in %: the bound of every K1 forward and backward
launch in the traced steps (bytes moved, each input once and each output once, over 3.35 TB/s; the
forward runs twice a chunk, once more in the recompute) over their device time. A launch's rows are
a chunk's rays, its samples the field's plus the sky's, its channels the field's features."""

from harness.roofline import FP32_FLOPS, bound_s, k1_bwd, k1_fwd


def read(view):
    cfg, layout = view.model_config, view.layout
    chunks = cfg.nff_chunks if cfg.nff_chunks > 1 and layout.total % cfg.nff_chunks == 0 else 1
    R, S, C = layout.total // chunks, cfg.sampling.num_nerf_samples + 1, cfg.field.nff_out_dim
    n_fwd, us_fwd = view.kernel_us("composite_sky_fwd_kernel")
    n_bwd, us_bwd = view.kernel_us("composite_sky_bwd")
    if n_fwd + n_bwd == 0:
        return None
    bound = n_fwd * bound_s(*k1_fwd(R, S, C), FP32_FLOPS) + n_bwd * bound_s(*k1_bwd(R, S, C), FP32_FLOPS)
    return 100.0 * bound / ((us_fwd + us_bwd) * 1e-6)
