"""Namespaced wall-clock timers (the reference's Timer taxonomy).

A process-global registry of (count, total seconds), read back with
:func:`timing` / :func:`list_timings`. CUDA work is asynchronous, so an
unsynchronised scope times the enqueue; pass a tensor or a device (or a list
of them) in ``block_on`` to synchronise its card before the scope closes, as
the JAX package's timers call ``block_until_ready``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

_REGISTRY: dict = defaultdict(lambda: [0, 0.0])


def _synchronize(block_on):
    devices = set()
    for t in block_on if isinstance(block_on, (list, tuple)) else [block_on]:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            devices.add(t.device)
        elif isinstance(t, torch.device) and t.type == "cuda":
            devices.add(t)
    for d in devices:
        torch.cuda.synchronize(d)


@contextmanager
def timer(name: str, block_on=None):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if block_on is not None:
            _synchronize(block_on)
        entry = _REGISTRY[name]
        entry[0] += 1
        entry[1] += time.perf_counter() - t0


def timing(name: str):
    """Return ``(count, total_seconds)`` for a timer label."""
    count, total = _REGISTRY[name]
    return count, total


def list_timings():
    """Print all timers, reference-style."""
    width = max((len(k) for k in _REGISTRY), default=10)
    for name in sorted(_REGISTRY):
        count, total = _REGISTRY[name]
        print(f"{name:<{width}}  count={count:<6d} total={total:.6f}s")


def reset_timings():
    _REGISTRY.clear()
