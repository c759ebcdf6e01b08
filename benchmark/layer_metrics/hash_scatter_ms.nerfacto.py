"""Device ms a nerfacto train step spends in K4's backward on its three grids: the CUDA event pairs of
the port's ``hash_encode/scatter`` spans (``ops/hash_encode.py``: the tables' gradients and, for the
camera optimizer, the positions'), summed over the traced steps and divided by the program's own count
of ``train/step`` spans; None off CUDA. The reader reaches the program only through the
``utils/trace.py`` it has loaded, and gives None where the program has no such module or span."""

import sys


def read(view):
    trace = sys.modules.get("neuradar_tpu_torch.utils.trace")
    if trace is None:
        return None
    snap = trace.snapshot()
    steps = snap.units("train/step")
    if not steps or len(steps) != view.units:
        return None
    times = [s.device_ms for s in snap.inside(steps) if s.name == "hash_encode/scatter"]
    if not times or any(t is None for t in times):
        return None
    return sum(times) / len(steps)
