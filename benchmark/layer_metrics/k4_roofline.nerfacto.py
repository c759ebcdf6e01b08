"""K4 forward's share of its roofline in the nerfacto train step, in %: the bytes bound of its launches
in the traced steps (``harness/nerfacto_count.k4_fwd_bytes`` over 3.35 TB/s: the positions read and the
output written once, and each level's reachable rows read once, the smallest of its table, its
lookups' corner rows and its cells' corners; a lower bound on DRAM traffic where the samples spread
over the scene, so the share cannot pass 100 %), at the samples the port counted (its
``nerfacto/proposal_samples`` and ``nerfacto/field_samples`` counters inside ``train/step``), over the
device time of the port's ``hash_encode_fwd_kernel``. None where the program has no such kernel or
counter, or where the launches are not one an encode; the reader reaches the program only through the
``utils/trace.py`` it has loaded."""

import sys

from harness.nerfacto_count import k4_fwd_bytes
from harness.roofline import HBM_BYTES_PER_S


def read(view):
    trace = sys.modules.get("neuradar_tpu_torch.utils.trace")
    if trace is None:
        return None
    snap = trace.snapshot()
    steps = snap.units("train/step")
    if not steps or len(steps) != view.units:
        return None
    proposal, field = snap.count("nerfacto/proposal_samples", steps), snap.count("nerfacto/field_samples", steps)
    n, us = view.kernel_us("hash_encode_fwd_kernel")
    if proposal == 0 or field == 0 or us <= 0:
        return None
    nbytes, encodes = k4_fwd_bytes(view.layout, proposal / len(steps), field / len(steps))
    if n != encodes * len(steps):
        return None
    return 100.0 * len(steps) * nbytes / HBM_BYTES_PER_S / (us * 1e-6)
