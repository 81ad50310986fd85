"""The device trace of a profiled window, reduced to what the metrics read.

One ``torch.profiler`` session (CPU and CUDA activities) covers the window.
The harness marks its own spans with ``record_function("portbench.<span>")``;
from the raw Kineto events this module keeps:

- the device's busy seconds: the union of every device event's interval
  (kernels, copies, sets; each counted once, whatever launched it and
  however they overlap), as ``chip_smoke.py``'s ``device_busy_ms`` takes it;
- per span name, the busy seconds inside the span's host ranges, and inside
  its device ranges: Kineto's GPU user annotation of a span runs from the
  first to the last device operation launched inside it, kernels of ctypes
  libraries included (their launches carry no correlation to the host);
- the device operations that took most time, and the idle gaps summed by
  the innermost host event (operator, runtime call or span) open at each
  gap's midpoint.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

from portbench.core import log

PREFIX = "portbench."
TOP = 10
#: the longest profiled window: the trace of a longer one takes minutes to read
SECONDS = 10.0
#: the longest profiler session (see :func:`profiled`)
PART = 3.0


def merged(intervals):
    """The union of ``(start, end)`` intervals as sorted disjoint ones: each
    stretch counted once however many intervals overlap it."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clipped_seconds(busy, ranges) -> float:
    """Length of the disjoint sorted ``busy`` intervals inside ``ranges``."""
    total = 0.0
    starts = [a for a, _ in busy]
    for lo, hi in merged(ranges):
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        while i < len(busy) and busy[i][0] < hi:
            a, b = busy[i]
            total += max(0.0, min(b, hi) - max(a, lo))
            i += 1
    return total


class Summary:
    """What the profiled window leaves, in seconds (``window_s`` on the host
    clock), summed over its profiler sessions."""

    def __init__(self, window_s=0.0, busy_s=0.0, host_clipped=None, device_clipped=None, ops=None, gaps=None):
        self.window_s = window_s
        self.busy_s = busy_s
        #: span name -> busy seconds inside the span's host ranges
        self.host_clipped = host_clipped or {}
        #: span name -> busy seconds inside the span's device ranges: from the
        #: start of the first to the end of the last device operation that a
        #: call inside the span launched (Kineto's GPU user annotations)
        self.device_clipped = device_clipped or {}
        #: device operation name -> seconds; host event name -> idle seconds
        self.ops = ops or {}
        self.gaps = gaps or {}

    def add(self, other):
        self.window_s += other.window_s
        self.busy_s += other.busy_s
        for mine, theirs in ((self.host_clipped, other.host_clipped), (self.device_clipped, other.device_clipped),
                             (self.ops, other.ops), (self.gaps, other.gaps)):
            for k, v in theirs.items():
                if v is not None:
                    mine[k] = (mine.get(k) or 0.0) + v

    @staticmethod
    def top(d):
        """The ``TOP`` largest entries of ``d`` as ``[[name, seconds], ...]``."""
        return [[n, t] for n, t in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def _host_stacks(cpu):
    """Per host thread, the events sorted by start for a stack sweep."""
    by_thread = defaultdict(list)
    for name, a, b, tid in cpu:
        by_thread[tid].append((a, -b, name))
    for evs in by_thread.values():
        evs.sort()
    return by_thread


def _gap_owners(gaps, cpu):
    """For each gap, the innermost host event open at its midpoint on the
    thread with the most events (the harness's thread)."""
    if not cpu:
        return ["host idle"] * len(gaps)
    threads = _host_stacks(cpu)
    tid = max(threads, key=lambda t: len(threads[t]))
    evs = threads[tid]
    mid = [(a + b) / 2 for a, b in gaps]
    order = sorted(range(len(gaps)), key=mid.__getitem__)
    owners = [None] * len(gaps)
    stack, j = [], 0
    for i in order:
        t = mid[i]
        while j < len(evs) and evs[j][0] <= t:
            a, nb, name = evs[j]
            while stack and stack[-1][0] <= a:
                stack.pop()
            stack.append((-nb, name))
            j += 1
        while stack and stack[-1][0] <= t:
            stack.pop()
        owners[i] = stack[-1][1] if stack else "python"
    return owners


def summarize(prof, window_s, spans=()) -> Summary:
    """Reduce a finished ``torch.profiler.profile`` to a :class:`Summary`.
    ``spans``: the harness's span names (without the prefix) to attribute
    device time to."""
    from torch.autograd import DeviceType

    t0 = time.perf_counter()
    device, cpu = [], []
    host_ranges, device_ranges = defaultdict(list), defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        a, b, name = e.start_ns(), e.end_ns(), e.name()
        mine = name.startswith(PREFIX) and e.is_user_annotation()
        if e.device_type() == DeviceType.CPU:
            if mine:
                host_ranges[name[len(PREFIX):]].append((a, b))
            cpu.append((name, a, b, e.start_thread_id()))
        elif e.is_user_annotation():  # Kineto's GPU user annotation of a span
            if mine:
                device_ranges[name[len(PREFIX):]].append((a, b))
        else:
            device.append((name, a, b))
    busy = merged((a, b) for _, a, b in device)

    def within(ranges):
        return {s: clipped_seconds(busy, ranges[s]) / 1e9 if ranges.get(s) else None for s in spans}

    per_op = defaultdict(int)
    for name, a, b in device:
        per_op[name] += b - a
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1) if busy[i + 1][0] > busy[i][1]]
    per_owner = defaultdict(int)
    for (a, b), owner in zip(gaps, _gap_owners(gaps, cpu)):
        per_owner[owner] += b - a
    window = host_ranges.get("window")
    if busy and window:
        lo, hi = window[0]
        if busy[-1][1] < hi - 0.05 * (hi - lo):
            raise RuntimeError(f"the profiler kept device events only up to {(busy[-1][1] - lo) / 1e9:.3f} s of a "
                               f"{(hi - lo) / 1e9:.3f} s session ({len(device)} events): its buffer is full")
    busy_s = sum(b - a for a, b in busy) / 1e9
    log(f"trace of {len(device)} device and {len(cpu)} host events read {time.perf_counter() - t0:.3f} s")
    return Summary(window_s, busy_s, within(host_ranges), within(device_ranges),
                   {k: v / 1e9 for k, v in per_op.items()}, {k: v / 1e9 for k, v in per_owner.items()})


def profiled(run, seconds, spans):
    """``run(part)`` (traffic for ``part`` seconds, returning its wall
    seconds) under profiler sessions of at most :data:`PART` seconds, until
    ``seconds`` are profiled: one session keeps only so many device events
    (CUPTI's buffers; ~920,000 on the card), and the plate launches
    ~140,000 a second. Returns the sessions' summed :class:`Summary`."""
    total = Summary()
    while total.window_s < seconds:
        with profiler() as prof:
            with span("window", True):
                elapsed = run(min(PART, seconds - total.window_s))
        total.add(summarize(prof, elapsed, spans))
    return total


def span(name, on):
    """``record_function("portbench.<name>")`` where the window is
    profiled, else nothing."""
    from contextlib import nullcontext

    from torch.profiler import record_function

    return record_function(PREFIX + name) if on else nullcontext()


def profiler():
    """A ``torch.profiler.profile`` of host and device activity. Its first
    start in a process takes seconds (CUPTI's set-up): the window's clock
    starts inside it."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
