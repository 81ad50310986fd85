"""Namespaced wall-clock timers (the reference's Timer taxonomy) and counters.

A process-global registry of (count, total seconds), read back with
:func:`timing` / :func:`list_timings`, and of integer counters, added to with
:func:`count` and read back with :func:`counters`. Both keep apart what was
recorded while a ``torch.profiler`` session recorded in this process, which
the profiler slows, from the rest (their ``profiled`` argument). CUDA work is
asynchronous, so an unsynchronised scope times the enqueue; pass a tensor or
a device (or a list of them) in ``block_on`` to synchronise its card before
the scope closes, as the JAX package's timers call ``block_until_ready``, or
name the card the scope's work runs on in ``device``, and
:func:`list_timings` marks its total as enqueue time.

Tracing (:func:`set_tracing`): while it is on, each scope is also a profiler
span of the same name, on the profiler's (Kineto's) clock, so that the
device's idle gaps can be placed inside it. With no profiler recording, a
scope with a card ``device`` and no ``block_on`` records a CUDA event pair
(reused from a pool) around its work on the card's current stream, resolved
into device seconds only when :func:`device_timing` or :func:`list_timings`
reads them; under a profiler, which records the device's work itself, it
does not (there an event pair costs the host more than the span). By default
tracing is on while a ``torch.profiler`` session records in this process.
While it is off a scope costs a flag test and the registry update: no span,
no event, no synchronisation.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _profiler

#: None: tracing while a torch profiler records; True / False: always / never
_TRACING = None
#: unresolved event pairs a name keeps before the finished ones are folded in
_PENDING = 1024


class _Entry:
    __slots__ = ("count", "seconds", "profiled", "profiled_seconds", "card", "traced", "traced_seconds",
                 "device_seconds", "pending")

    def __init__(self):
        self.count = self.profiled = self.traced = 0
        self.seconds = self.profiled_seconds = self.traced_seconds = self.device_seconds = 0.0
        self.card = None
        self.pending = []


_REGISTRY: dict = defaultdict(_Entry)
#: name -> [total, the part counted while a profiler recorded]
_COUNTERS: dict = defaultdict(lambda: [0, 0])
#: CUDA device index -> timing events free to record again
_EVENTS: dict = defaultdict(list)


def set_tracing(on):
    """Tracing on (True), off (False), or on while a ``torch.profiler``
    session records (None, the default)."""
    global _TRACING
    _TRACING = None if on is None else bool(on)


def _span(name):
    """A profiler span at function scope. A user annotation
    (``record_function``) would take the device range of the work it
    launches from any annotation around it: Kineto gives a kernel to the
    innermost one only."""
    return torch._C._profiler._RecordFunctionFast(name)


def _synchronize(block_on):
    devices = set()
    for t in block_on if isinstance(block_on, (list, tuple)) else [block_on]:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            devices.add(t.device)
        elif isinstance(t, torch.device) and t.type == "cuda":
            devices.add(t)
    for d in devices:
        torch.cuda.synchronize(d)


def _is_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _event_pair(device):
    """``(start, end, stream)``: a pair of timing events from the pool, the
    start recorded on ``device``'s current stream; None where the stream is
    being captured into a graph."""
    if torch.cuda.is_current_stream_capturing():
        return None
    stream = torch.cuda.current_stream(device)
    free = _EVENTS[stream.device_index]
    start, end = (free.pop() if free else torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record(stream)
    return start, end, stream


def _fold(entry, finished_only):
    """Move the pending event pairs' elapsed seconds into the entry and
    their events back to the pool: the pairs whose end has been reached, or
    (``finished_only`` False) all of them, waiting for each."""
    keep = []
    for start, end, index in entry.pending:
        if finished_only and not end.query():
            keep.append((start, end, index))
            continue
        end.synchronize()
        entry.device_seconds += start.elapsed_time(end) / 1e3
        _EVENTS[index] += (start, end)
    entry.pending = keep


def _part(total, profiled_part, profiled):
    """All of a sum (``profiled`` None), or its part recorded while a
    profiler recorded (True) or while none did (False)."""
    if profiled is None:
        return total
    return profiled_part if profiled else total - profiled_part


@contextmanager
def timer(name: str, block_on=None, device=None):
    profiling = _profiler._is_profiler_enabled
    traced = profiling if _TRACING is None else _TRACING
    span = pair = None
    if traced:
        span = _span(name)
        span.__enter__()
        if block_on is None and not profiling and _is_card(device):
            pair = _event_pair(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if pair is not None:
            pair[1].record(pair[2])
        if block_on is not None:
            _synchronize(block_on)
        dt = time.perf_counter() - t0
        if span is not None:
            span.__exit__(None, None, None)
        entry = _REGISTRY[name]
        entry.count += 1
        entry.seconds += dt
        if entry.card is None:
            entry.card = block_on is None and _is_card(device)
        if profiling:
            entry.profiled += 1
            entry.profiled_seconds += dt
        if traced:
            entry.traced += 1
            entry.traced_seconds += dt
            if pair is not None:
                entry.pending.append((pair[0], pair[1], pair[2].device_index))
                if len(entry.pending) >= _PENDING:
                    _fold(entry, True)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    c = _COUNTERS[name]
    c[0] += n
    if _profiler._is_profiler_enabled:
        c[1] += n


def counters(profiled=None) -> dict:
    """A snapshot of every counter: its total, or (``profiled`` True /
    False) what was added while a profiler recorded / while none did."""
    return {k: _part(total, part, profiled) for k, (total, part) in _COUNTERS.items()}


def timing(name: str, profiled=None):
    """Return ``(count, total_seconds)`` for a timer label: of every scope,
    or (``profiled`` True / False) of those opened while a profiler
    recorded / while none did."""
    entry = _REGISTRY[name]
    return (_part(entry.count, entry.profiled, profiled),
            _part(entry.seconds, entry.profiled_seconds, profiled))


def device_timing(name: str):
    """``(traced count, their host seconds, their device seconds)`` for a
    timer label: the scopes opened while tracing was on, and the card time
    between their event pairs (0 for scopes off a card, synchronised, or
    opened under a profiler)."""
    entry = _REGISTRY[name]
    _fold(entry, False)
    return entry.traced, entry.traced_seconds, entry.device_seconds


def list_timings():
    """Print all timers, reference-style, then the counters. A card scope's
    total is marked as enqueue time; a traced one's device seconds follow
    its traced host seconds."""
    width = max((len(k) for k in list(_REGISTRY) + list(_COUNTERS)), default=10)
    for name in sorted(_REGISTRY):
        entry = _REGISTRY[name]
        line = f"{name:<{width}}  count={entry.count:<6d} total={entry.seconds:.6f}s"
        if entry.card:
            line += " (enqueue)"
        if entry.traced:
            traced, host, device = device_timing(name)
            line += f"  traced={traced} host={host:.6f}s"
            if entry.card:
                line += f" device={device:.6f}s"
        print(line)
    for name in sorted(_COUNTERS):
        print(f"{name:<{width}}  counter={_COUNTERS[name][0]}")


def reset_timings():
    _REGISTRY.clear()
    _COUNTERS.clear()
