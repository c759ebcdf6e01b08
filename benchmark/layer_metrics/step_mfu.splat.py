"""The splatfacto train step's share of the card's bf16 peak: the model FLOPs of the traced steps
(``harness/splat_count.step_flops``, from the pairs the port's K5 listed, its ``splat_tile_pairs``
counter inside ``train/step``) over the traced window times 989 TFLOP/s, in %. The harness reaches
the program only through ``harness/port.py``, so this reader imports none of it: it reads the port's
``utils/trace.py`` that the program has loaded, and gives None where the program has no such module
or counter."""

import sys

from harness.roofline import BF16_FLOPS
from harness.splat_count import step_flops


def read(view):
    trace = sys.modules.get("neuradar_tpu_torch.utils.trace")
    if trace is None or view.units == 0 or view.window_us <= 0:
        return None
    snap = trace.snapshot()
    steps = snap.units("train/step")
    if not steps or len(steps) != view.units:
        return None
    pairs = snap.count("splat_tile_pairs", steps)
    if pairs == 0:
        return None
    flops = len(steps) * step_flops(view.layout, pairs / len(steps))
    return 100.0 * flops / (view.window_us * 1e-6 * BF16_FLOPS)
