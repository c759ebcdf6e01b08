"""Reading a traced window: the profiler's events reduced to what the per-layer readers take.

The interval and label arithmetic is a frozen copy of the port's ``scripts/profile_train.py``:
device busy time is the union of the device intervals (kernels, copies, sets); a label's device
time is the sum of the kernels launched inside the host ranges of that name, their children
included. Autograd runs the backward on its own thread, outside the step's labelled ranges, so a
train step's backward is its busy time less its forward and its optimizer.

``TraceView`` is what a reader in ``layer_metrics/`` receives. ``breakdown`` gives the device
operations that took most time and the longest idle gaps, each named by the innermost host range
open at the gap's middle.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def union_intervals(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def kernels_under(events, label: str) -> Dict[str, float]:
    """Device us of each kernel launched inside the host ranges named ``label``."""
    sums: Dict[str, float] = {}

    def walk(e):
        for k in e.kernels:
            sums[k.name] = sums.get(k.name, 0.0) + k.duration
        for child in e.cpu_children:
            walk(child)

    for e in events:
        if e.name == label and e.device_type == CPU:
            walk(e)
    return sums


@dataclass
class TraceView:
    """One traced window. Times in us; ``units`` steps or requests ran in it; ``window_us`` is its
    length on the host clock, from before the first unit to after the last one's synchronize."""

    layout: object  # the reference's SegmentLayout of a unit (a train batch or a request)
    model_config: object  # the reference's NeuRadarModelConfig
    units: int
    window_us: float
    device: List[Tuple[str, float, float]]  # (name, start, end) of every device operation
    labels: Dict[str, Dict[str, float]] = field(default_factory=dict)  # label -> kernel -> us
    unit_flops: float = 0.0

    @property
    def busy_us(self) -> float:
        return sum(e - s for s, e in union_intervals([(s, e) for _, s, e in self.device]))

    def label_ms_per_unit(self, label: str) -> Optional[float]:
        """Device ms under ``label`` per unit, or None where the label launched nothing."""
        kernels = self.labels.get(label) or {}
        if not kernels or self.units == 0:
            return None
        return sum(kernels.values()) / 1e3 / self.units

    def kernel_us(self, fragment: str) -> Tuple[int, float]:
        """(launches, device us) of the device operations whose name holds ``fragment``."""
        hits = [e - s for name, s, e in self.device if fragment in name]
        return len(hits), sum(hits)


# the port's record_function ranges: the profiler mirrors each as a device-side annotation spanning
# its kernels, gaps included, which is no device operation
PORT_RANGES = frozenset(("train/forward", "train/optimizer", "ray_generation", "camera_optimizer",
                         "proposal_sampling", "field", "hash_encode", "composite_sky", "rgb_decoder",
                         "radar_decoder", "losses"))


def device_operations(events) -> List[Tuple[str, float, float]]:
    """(name, start, end) of every kernel, copy and set on the device; no range annotations."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == CUDA and not getattr(e, "is_user_annotation", False) and e.name not in PORT_RANGES]


def trace_view(prof, layout, model_config, units: int, window_us: float, labels: Tuple[str, ...],
               unit_flops: float) -> TraceView:
    events = prof.events()
    return TraceView(layout=layout, model_config=model_config, units=units, window_us=window_us,
                     device=device_operations(events), labels={label: kernels_under(events, label) for label in labels},
                     unit_flops=unit_flops)


def breakdown(prof, view: TraceView, top: int = 10) -> Dict[str, list]:
    """The ``top`` device operations by total seconds, and the ``top`` longest idle gaps between
    device operations, each named by the innermost host range open at its middle."""
    totals: Dict[str, float] = {}
    for name, s, e in view.device:
        totals[name[:100]] = totals.get(name[:100], 0.0) + (e - s)
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    busy = union_intervals([(s, e) for _, s, e in view.device])
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]), reverse=True)[:top]
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == CPU and e.time_range.end > e.time_range.start)
    starts = [h[0] for h in host]
    named = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        best = None
        for h in host[:bisect.bisect_right(starts, mid)]:
            if h[1] >= mid and (best is None or h[1] - h[0] < best[1] - best[0]):
                best = h
        named.append([best[2][:100] if best else "host (no traced range)", length / 1e6])
    return {"device_ops": [[n, us / 1e6] for n, us in ops], "idle_gaps": named}
