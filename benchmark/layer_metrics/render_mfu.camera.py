"""A render request's share of the card's bf16 peak: the model FLOPs of the traced requests (the
benchmark's count, harness/roofline.py) over the traced window times 989 TFLOP/s, in %."""

from harness.roofline import BF16_FLOPS


def read(view):
    if view.units == 0 or view.unit_flops <= 0:
        return None
    return 100.0 * view.units * view.unit_flops / (view.window_us * 1e-6 * BF16_FLOPS)
