"""Utilities: timers."""
