"""Utilities: timers, counters and tracing."""

from .timers import (  # noqa: F401
    count,
    counters,
    device_timing,
    list_timings,
    reset_timings,
    set_tracing,
    timer,
    timing,
)
