"""Host ms a radar request spends launching work: the port's ``request/radar`` span
(``pipelines/ad_neuradar_pipeline.render_radar``) less its ``host_sync/<site>`` spans, the calls
that wait for the card, over the program's own count of ``request/radar`` spans. The harness reaches the program only
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
    synced = sum(s.host_ms for s in snap.inside(requests) if s.name.startswith("host_sync/"))
    return (sum(r.host_ms for r in requests) - synced) / len(requests)
