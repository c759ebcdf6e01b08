"""The nerfacto train step's share of the card's bf16 peak: the model FLOPs of the traced steps
(``harness/nerfacto_count.step_flops``: the MLPs' matrix products forward and backward, from the widths
and the samples the port counted, its ``nerfacto/proposal_samples`` and ``nerfacto/field_samples``
counters inside ``train/step``) over the traced window times 989 TFLOP/s, in %. The harness reaches the
program only through ``harness/port.py``, so this reader imports none of it: it reads the port's
``utils/trace.py`` that the program has loaded, and gives None where the program has no such module or
counter."""

import sys

from harness.nerfacto_count import step_flops
from harness.roofline import BF16_FLOPS


def read(view):
    trace = sys.modules.get("neuradar_tpu_torch.utils.trace")
    if trace is None or view.units == 0 or view.window_us <= 0:
        return None
    snap = trace.snapshot()
    steps = snap.units("train/step")
    if not steps or len(steps) != view.units:
        return None
    proposal, field = snap.count("nerfacto/proposal_samples", steps), snap.count("nerfacto/field_samples", steps)
    if proposal == 0 or field == 0:
        return None
    return 100.0 * step_flops(view.layout, proposal, field) / (view.window_us * 1e-6 * BF16_FLOPS)
