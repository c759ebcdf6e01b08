"""Calls a radar request makes that wait for the card: the port's ``host_syncs`` counter inside
``request/radar`` (one per ``host_sync/<site>`` span), over the program's own count of
``request/radar`` spans. The harness reaches the program only
through ``harness/port.py``, so this reader imports none of it: it reads the port's ``utils/trace.py``
that the program has loaded, and gives None where the program has no such module or span."""

import sys


def read(view):
    trace = sys.modules.get("neuradar_tpu_torch.utils.trace")
    if trace is None:
        return None
    snap = trace.snapshot()
    requests = snap.units("request/radar")
    if not requests or len(requests) != view.units:
        return None
    return snap.count("host_syncs", requests) / len(requests)
