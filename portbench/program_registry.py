"""The program's own counters and timer registry (``utils/timers.py`` of the
port), read when a run's metrics are read, and the profiled window's idle
gaps that the program's spans own. The registry holds the whole run; these
readers take its part recorded while no profiler recorded: the warm-up and
the instrumented window, not the profiled window (which the profiler slows
and which stops inside a cycle). A program without them gives nothing."""


def _timers():
    from dolfinx_materials_tpu_torch.utils import timers

    return timers


def _split():
    """The program's timers where they keep apart what was recorded under a
    profiler, else None."""
    t = _timers()
    return t if hasattr(t, "counters") else None


def counters() -> dict:
    """The program's counters added while no profiler recorded, or ``{}``."""
    t = _split()
    return t.counters(profiled=False) if t else {}


def unprofiled(name):
    """``(count, host seconds)`` of the scopes ``name`` opened while no
    profiler recorded, or ``(0, 0.0)``."""
    t = _split()
    return t.timing(name, profiled=False) if t else (0, 0.0)


def spanned(name) -> bool:
    """Whether the program opened a scope ``name`` with its tracing on, as a
    profiler span (by default: under the profiler)."""
    t = _split()
    return bool(t and t.device_timing(name)[0])


def idle_owned_pct(rec, spans):
    """The profiled window's idle gaps that the program's ``spans`` own
    (each the innermost host event open at a gap's midpoint), in % of the
    window; None where the window was not profiled or none of ``spans`` was
    a profiler span. A gap inside a span whose innermost event is a runtime
    call or an operator (a launch, a synchronisation, a copy) is that
    event's: the trace keeps each gap's innermost owner only."""
    t = rec.traced.trace if rec.traced else None
    if t is None or t.window_s <= 0 or not any(spanned(s) for s in spans):
        return None
    return 100.0 * sum(t.gaps.get(s, 0.0) for s in spans) / t.window_s
