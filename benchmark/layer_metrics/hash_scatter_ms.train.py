"""Device ms a train step spends in the hash tables' gradient scatter: the CUDA event pairs of the
port's ``hash_encode/scatter`` spans (``field_components/encodings.py``: each corner gather's zero
table and accumulating index put, on autograd's thread), summed over the traced steps and divided by
the program's own count of ``train/step`` spans; None off CUDA. The harness reaches the program only
through ``harness/port.py``, so this reader imports none of it: it reads the port's ``utils/trace.py``
that the program has loaded, and gives None where the program has no such module or span."""

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
