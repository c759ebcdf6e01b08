"""The port's spans and counters. Every span of the program goes through ``span``.

``span(name)`` always opens ``torch.profiler.record_function(name)``: under a profiler the range is
in the trace on the device trace's own clock, with the name the benchmark and the breakdown read.
While recording, it also appends one entry to an in-memory log: the span's name, its id and its
parent's id, the id of the step or request it belongs to, the thread, and its host start and end
(``time.perf_counter_ns``). With ``device=True`` the entry also holds a pair of CUDA timing events
recorded on the current stream around the span, which ``snapshot()`` resolves with one synchronize.
``count(name, n)`` adds to a counter of the current step or request; inside ``recording()`` alone,
``count_device(name, tensor)`` keeps a one-element tensor that kernels count into on the card under the
same key, and ``snapshot()`` adds its value after the synchronize it makes, so a count on the card
brings no sync into a step (a profiler alone keeps none: see ``counting_device``); ``host_sync(site)``
is the span ``host_sync/<site>`` around one call that makes the host wait for the card, and counts
``host_syncs``. Inside ``tally()`` a thread's counts go to a dictionary of their own instead, recording
or not: a CUDA graph's capture launches nothing, and each replay adds what its capture counted (a device
count has no value there and is not kept).

A span opened with ``unit=True`` is a step or a request (``train/step``, ``request/radar``,
``request/camera``): while recording it draws the next id of a sequence, which goes into
``record_function``'s ``args`` and which every span and count inside it carries. A span's parent is
the innermost span open on its thread, or, on a thread with none open, the step or request open on
the main thread; so the backward pass's spans, which autograd runs on its own threads while the
main thread waits in ``backward()``, belong to the step that called it.

Recording is on while a torch profiler records on the calling thread
(``torch.autograd._profiler_enabled()``), so a profiled window is recorded with no change to the
profiling code, and inside ``recording()``, for tests and operators. Otherwise a span costs its
``record_function`` and one flag check: no entry, no event, no allocation. Which threads record
under a profiler: its state is per thread, on in the thread that started it and carried by autograd
into the threads that run a backward pass; a Python thread started otherwise, such as the
datamanager's prefetch worker, finds it off. So the main thread and autograd's threads record, and
the prefetch worker does not (it opens no span). ``recording()`` holds for every thread.

A recording window starts on entering ``recording()``, or when a step or request finds a profiler
recording after the last one found none; the log and the counters are cleared then, so
``snapshot()`` gives the current or last window.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.profiler import record_function


@dataclass
class Span:
    """One logged span; times in ns on the host clock, ``device_ms`` from its event pair (None
    without one)."""

    name: str
    id: int
    parent: Optional[int]
    unit: Optional[int]  # the id of its step or request
    thread: int
    start_ns: int
    end_ns: int = 0
    is_unit: bool = False  # the span is the step or request itself
    device_ms: Optional[float] = None
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


@dataclass
class Snapshot:
    """The closed spans of a window in the order they opened, and its counters by (name, unit)."""

    spans: List[Span]
    counters: Dict[Tuple[str, Optional[int]], int]

    def units(self, name: str) -> List[Span]:
        """The steps or requests named ``name``."""
        return [s for s in self.spans if s.name == name and s.is_unit]

    def inside(self, units: List[Span]) -> List[Span]:
        """Every span that belongs to one of ``units``, the units themselves included."""
        ids = {u.unit for u in units}
        return [s for s in self.spans if s.unit in ids]

    def count(self, name: str, units: List[Span]) -> int:
        """The counter ``name`` summed over ``units``."""
        ids = {u.unit for u in units}
        return sum(n for (key, unit), n in self.counters.items() if key == name and unit in ids)

    def total(self, name: str) -> int:
        """The counter ``name`` over the whole window, inside steps and requests or not."""
        return sum(n for (key, _), n in self.counters.items() if key == name)


class Recorder:
    """The log, the counters and the per-thread span stacks of one process."""

    def __init__(self):
        self._spans: List[Span] = []
        self._counters: Dict[Tuple[str, Optional[int]], int] = {}
        self._device_counts: Dict[Tuple[str, Optional[int]], List[torch.Tensor]] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._unit_ids = itertools.count(1)
        self._local = threading.local()
        self._forced = 0  # depth of recording() blocks
        self._idle = True  # the last step or request found recording off
        self._open_unit: Optional[Span] = None  # the step or request open on the main thread

    def active(self) -> bool:
        return self._forced > 0 or torch.autograd._profiler_enabled()

    def clear(self) -> None:
        with self._lock:
            self._spans = []
            self._counters = {}
            self._device_counts = {}

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _context(self) -> Tuple[Optional[Span], Optional[int]]:
        """(the parent of a span opened now, the unit it belongs to)."""
        stack = self._stack()
        parent = stack[-1] if stack else self._open_unit
        return parent, parent.unit if parent is not None else None

    @contextmanager
    def span(self, name: str, device: bool = False, unit: bool = False) -> Iterator[None]:
        if not self.active():
            if unit:
                self._idle = True
            with record_function(name):
                yield
            return
        if unit and self._idle:
            self.clear()
            self._idle = False
        parent, unit_id = self._context()
        if unit:
            unit_id = next(self._unit_ids)
        entry = Span(name, next(self._ids), parent.id if parent is not None else None, unit_id,
                     threading.get_ident(), time.perf_counter_ns(), is_unit=unit)
        with self._lock:
            self._spans.append(entry)
        stack = self._stack()
        stack.append(entry)
        outer = self._open_unit
        on_main = unit and threading.current_thread() is threading.main_thread()
        if on_main:
            self._open_unit = entry
        try:
            with record_function(name, None if unit_id is None else f"unit={unit_id}"):
                if not device:
                    yield
                    return
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                entry.events = (start, end)
                start.record()
                try:
                    yield
                finally:
                    end.record()
        finally:
            entry.end_ns = time.perf_counter_ns()
            stack.pop()
            if on_main:
                self._open_unit = outer

    def count(self, name: str, n: int = 1) -> None:
        tally = getattr(self._local, "tally", None)
        if tally is not None:
            tally[name] = tally.get(name, 0) + n
            return
        if not self.active():
            return
        unit = self._context()[1]
        with self._lock:
            self._counters[(name, unit)] = self._counters.get((name, unit), 0) + n

    def counting_device(self) -> bool:
        return self._forced > 0 and getattr(self._local, "tally", None) is None

    def count_device(self, name: str, value: torch.Tensor) -> None:
        if not self.counting_device():
            return
        unit = self._context()[1]
        with self._lock:
            self._device_counts.setdefault((name, unit), []).append(value)

    @contextmanager
    def tally(self) -> Iterator[Dict[str, int]]:
        outer = getattr(self._local, "tally", None)
        counts: Dict[str, int] = {}
        self._local.tally = counts
        try:
            yield counts
        finally:
            self._local.tally = outer

    @contextmanager
    def recording(self) -> Iterator[None]:
        if self._forced == 0:
            self.clear()
            self._idle = False
        self._forced += 1
        try:
            yield
        finally:
            self._forced -= 1

    def snapshot(self) -> Snapshot:
        with self._lock:
            spans = [s for s in self._spans if s.end_ns]
            device_counts, self._device_counts = self._device_counts, {}
        pending = [s for s in spans if s.events is not None]
        if pending or any(t.is_cuda for values in device_counts.values() for t in values):
            torch.cuda.synchronize()
            for s in pending:
                s.device_ms = s.events[0].elapsed_time(s.events[1])
                s.events = None
        with self._lock:
            for key, values in device_counts.items():  # final after the synchronize: kept as numbers
                self._counters[key] = self._counters.get(key, 0) + sum(int(t) for t in values)
            counters = dict(self._counters)
        return Snapshot(spans, counters)


RECORDER = Recorder()


def span(name: str, device: bool = False, unit: bool = False):
    """A ``record_function(name)`` range, logged while recording (see the module's docstring).
    ``device``: time it on the card too (pass True only where the work is on CUDA). ``unit``: the
    span is a step or a request and draws its id."""
    return RECORDER.span(name, device, unit)


def operator_range(name: str):
    """A profiler range of an operator's scope around work that launches kernels through no operator
    (a CUDA graph's replay). The profiler links a kernel to the innermost operator open at its launch,
    and ``span``'s ``record_function`` is a user range, to which it links none; inside this range a
    replayed graph's kernels count under the spans around it, as an operator's do. Not logged."""
    return torch._C._profiler._RecordFunctionFast(name)


@contextmanager
def host_sync(site: str) -> Iterator[None]:
    """The span ``host_sync/<site>`` around one call that makes the host wait for the card; counts
    ``host_syncs``."""
    with RECORDER.span("host_sync/" + site):
        RECORDER.count("host_syncs")
        yield


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the current step or request, while recording."""
    RECORDER.count(name, n)


def count_device(name: str, value: torch.Tensor) -> None:
    """Add the one-element tensor ``value``, which kernels launched before ``snapshot()`` count into on
    its device, to the counter ``name`` of the current step or request, while ``counting_device()``.
    ``snapshot()`` reads it after its synchronize: no sync here."""
    RECORDER.count_device(name, value)


def counting_device() -> bool:
    """Whether ``count_device`` keeps counts now: inside ``recording()`` and not inside ``tally()``. A
    profiler alone keeps none, so a kernel asked to count only then runs under a profiler as it runs
    unprofiled."""
    return RECORDER.counting_device()


def tally():
    """The counts this thread makes inside the block, by name, kept out of the window whether it records
    or not (a CUDA graph's capture: its launches run at each replay)."""
    return RECORDER.tally()


def recording():
    """Record inside this block, profiler or not; entering it starts a new window."""
    return RECORDER.recording()


def snapshot() -> Snapshot:
    """The current or last window: its closed spans, device times resolved, and its counters, device counts
    read."""
    return RECORDER.snapshot()
