"""Host microseconds an increment spends before its read: the update
call and the commit, up to the point where the host waits for the card
(the instrumented window, not profiled)."""


def read(rec):
    host = rec.timed.spans["host"]
    return 1e6 * sum(host) / len(host) if host else None
