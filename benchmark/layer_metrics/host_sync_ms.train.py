"""Host ms a train step spends in calls that wait for the card: the port's ``host_sync/<site>``
spans inside ``train/step`` (``utils/trace.host_sync``), on every thread, over the program's own
count of ``train/step`` spans. The harness reaches the program only
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
    return sum(s.host_ms for s in snap.inside(steps) if s.name.startswith("host_sync/")) / len(steps)
