"""K2's share of its roofline in a radar request, in %: the bound of each bf16 forward launch (one
scan: q, k, v and the output in bf16 over 3.35 TB/s, or its two products of 2 S^2 D at 989 TFLOP/s,
whichever is longer) over their device time. Heads fold into the batch of a launch."""

from harness.roofline import BF16_FLOPS, bound_s, k2_fwd


def read(view):
    cfg, layout = view.model_config, view.layout
    n, us = view.kernel_us("attention_bf16_fwd_kernel")
    if n == 0:
        return None
    D = cfg.field.nff_out_dim + cfg.appearance_dim  # one head of the model's width
    return 100.0 * n * bound_s(*k2_fwd(1, layout.rays_per_scan, D), BF16_FLOPS) / (us * 1e-6)
