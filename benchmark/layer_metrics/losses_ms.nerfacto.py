"""Device ms of a nerfacto train step's two sampling losses' forwards: the CUDA event pairs of the
port's ``nerfacto/interlevel_loss`` and ``nerfacto/distortion_loss`` spans (models/nerfacto.py), summed
over the traced steps and divided by the program's own count of ``train/step`` spans; None off CUDA.
The reader reaches the program only through the ``utils/trace.py`` it has loaded, and gives None where
the program has no such module or span."""

import sys

NAMES = ("nerfacto/interlevel_loss", "nerfacto/distortion_loss")


def read(view):
    trace = sys.modules.get("neuradar_tpu_torch.utils.trace")
    if trace is None:
        return None
    snap = trace.snapshot()
    steps = snap.units("train/step")
    if not steps or len(steps) != view.units:
        return None
    times = [s.device_ms for s in snap.inside(steps) if s.name in NAMES]
    if not times or any(t is None for t in times):
        return None
    return sum(times) / len(steps)
