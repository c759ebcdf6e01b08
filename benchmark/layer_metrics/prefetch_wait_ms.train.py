"""Host ms a train step waits for its batch: the port's ``train/next_batch`` spans
(``data/datamanager.py``, the main thread's wait on the prefetch queue) over the program's own count
of ``train/step`` spans. The harness reaches the program only
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
    return sum(s.host_ms for s in snap.inside(steps) if s.name == "train/next_batch") / len(steps)
