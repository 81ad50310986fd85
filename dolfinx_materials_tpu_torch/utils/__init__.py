"""Utilities: timers."""

from .timers import list_timings, reset_timings, timer, timing  # noqa: F401
