"""100 less the device's busy share of the profiled window, in %."""

from portbench.metrics_common import idle_pct as read  # noqa: F401
