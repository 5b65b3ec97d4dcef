"""Cross-cutting utilities: phase timing, counters, profiler hooks, logging,
and the port's benchmark helpers (``benchtime``, ``sass``)."""

from .timing import (
    PhaseStat,
    phase_report,
    profile_trace,
    reset_phase_report,
    timed_phase,
)
from .metrics import (
    count,
    counter_report,
    gauge_max,
    gauge_report,
    gauge_set,
    histogram_report,
    observe,
    prometheus_text,
    reset_counters,
    reset_gauges,
    reset_histograms,
)
from .logsetup import configure_logging
from .env import env_float

__all__ = [
    "PhaseStat",
    "configure_logging",
    "count",
    "counter_report",
    "env_float",
    "gauge_max",
    "gauge_report",
    "gauge_set",
    "histogram_report",
    "observe",
    "phase_report",
    "profile_trace",
    "prometheus_text",
    "reset_counters",
    "reset_gauges",
    "reset_histograms",
    "reset_phase_report",
    "timed_phase",
]
