"""Kernel times on the card: the device's time alone (``device_ms``) and one call's time (``call_ms``).

``device_ms`` keeps the host out of the measure. It first queues a spin of the card
(``torch.cuda._sleep``) long enough to cover the host's enqueue of every timed call, then the
start event, ``reps`` calls back to back and the end event, and synchronises once: the calls
wait behind the spin and then run one after the other, so end - start is their device time
alone. It raises if the host's enqueue outlasted the spin, because the number would then
include host time again: the host's enqueue must outrun the card. The spin is 4x the
enqueue that two calls on an idle card predict, and at least 10 ms; Python's garbage collector
is paused while the calls are queued. A function that launches hundreds of kernels a call
overflows the card's queue of pending launches within a few calls, and the host then waits
for the card: time it with few ``reps``. ``call_ms`` is the older measure: an event pair around each single
call on an idle card, which also counts the wrapper's host work (checks, allocations, the
stream lookup, the launch); ``call_ms - device_ms`` is that host share. ``kernels_ms`` sums the
device times of the kernels a call launches, as the profiler records them: for a function that
synchronises the host inside (``device_ms`` refuses it), without the card's idle gaps.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile

_cycles_per_ms = None


def _spin_rate() -> float:
    """The card's clock cycles per ms of ``torch.cuda._sleep``, measured once per process."""
    global _cycles_per_ms
    if _cycles_per_ms is None:
        cycles = 2_000_000
        for _ in range(2):  # the first spin also pays for loading the sleep kernel
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda._sleep(cycles)
            end.record()
            end.synchronize()
        _cycles_per_ms = cycles / start.elapsed_time(end)
    return _cycles_per_ms


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms of one call of ``fn``: ``reps`` calls queued behind a spin of the card and timed
    by one event pair. ``device_ms.last`` keeps the run's host enqueue and spin, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        fn()
    per_call_ms = (time.perf_counter() - t0) * 1e3 / 2  # the host's enqueue of one call, on an idle card
    torch.cuda.synchronize()
    spin_ms = max(4.0 * reps * per_call_ms, 10.0)
    spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    collecting = gc.isenabled()
    gc.disable()
    try:
        t0 = time.perf_counter()
        spin.record()
        torch.cuda._sleep(int(spin_ms * _spin_rate()))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
    finally:
        if collecting:
            gc.enable()
    end.synchronize()
    slept_ms = spin.elapsed_time(start)
    # the spin cannot start on the card before the host queued it, at t0 or later
    if enqueue_ms >= slept_ms:
        raise RuntimeError(f"device_ms: the host took {enqueue_ms:.3f} ms to queue {reps} calls, longer than the "
                           f"card's {slept_ms:.3f} ms spin; the time would include host work")
    device_ms.last = {"enqueue_ms": enqueue_ms, "spin_ms": slept_ms}
    return start.elapsed_time(end) / reps


device_ms.last = None


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` calls, each between its own event pair and synchronised on its own:
    the device time plus the host work inside the call that the card waits for."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernels_ms(fn, reps: int = 5, warmup: int = 3) -> float:
    """The device time of the kernels (and copies) one call of ``fn`` runs, summed from a
    torch.profiler trace of ``reps`` calls: for functions that synchronise the host inside."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    on_device = [a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CUDA]
    if not on_device:
        raise RuntimeError("kernels_ms: the profiler recorded no device time")
    return sum(a.self_device_time_total for a in on_device) / 1e3 / reps
