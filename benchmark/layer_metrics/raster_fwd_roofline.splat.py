"""K5 forward's share of its roofline in the splatfacto train step, in %: the bound of its launches
in the traced steps (the larger of their operations over 67 TFLOP/s, float32, and their bytes over
3.35 TB/s; ``harness/splat_count.raster_fwd``, counted from the pairs the tiles listed, the port's
``splat_tile_pairs`` counter inside ``train/step``, times 256 pixels) over the device time of the
port's ``splat_raster_fwd_kernel``. None where the program has no such kernel or counter; the
reader reaches the program only through the ``utils/trace.py`` it has loaded."""

import sys

from harness.roofline import FP32_FLOPS, bound_s
from harness.splat_count import raster_fwd


def read(view):
    trace = sys.modules.get("neuradar_tpu_torch.utils.trace")
    if trace is None:
        return None
    snap = trace.snapshot()
    steps = snap.units("train/step")
    if not steps or len(steps) != view.units:
        return None
    pairs = snap.count("splat_tile_pairs", steps)
    n, us = view.kernel_us("splat_raster_fwd_kernel")
    if n == 0 or pairs == 0 or us <= 0:
        return None
    return 100.0 * bound_s(*raster_fwd(pairs, view.layout, n), FP32_FLOPS) / (us * 1e-6)
