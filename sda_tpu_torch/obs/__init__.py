"""Observability: distributed tracing + the unified reset for the whole
observation plane (spans here, counters/gauges/histograms in
``utils/metrics``, phase stats in ``utils/timing``).

See ``docs/observability.md`` for the span model, the ``traceparent``
propagation header, the Chrome-trace export format, and how to merge the
span timeline with device traces. ``obs.devprof`` is the device plane:
the call/shape registry of the instrumented stages, counted costs and the
roofline, device-memory peaks and the watermark.
"""

from .trace import (
    REQUEST_ID_HEADER,
    SPAN_BUFFER_CAPACITY,
    TRACEPARENT_HEADER,
    TRACE_CONTEXT_HEADER,
    Span,
    SpanContext,
    add_event,
    chrome_trace,
    current_context,
    current_span,
    export_chrome_trace,
    finished_spans,
    format_traceparent,
    job_link,
    link_job,
    new_request_id,
    parse_traceparent,
    reset_spans,
    seed_ids,
    set_attribute,
    set_span_sink,
    span,
    span_sink,
)
from .timeline import (
    chrome_trace_from_records,
    clock_offsets,
    critical_path,
    merge_chrome_traces,
    normalize_span_records,
    round_timelines,
    slowest_spans,
    span_tree,
)
from . import devprof, recorder

__all__ = [
    "REQUEST_ID_HEADER",
    "SPAN_BUFFER_CAPACITY",
    "TRACEPARENT_HEADER",
    "TRACE_CONTEXT_HEADER",
    "Span",
    "SpanContext",
    "add_event",
    "chrome_trace",
    "chrome_trace_from_records",
    "clock_offsets",
    "critical_path",
    "current_context",
    "current_span",
    "devprof",
    "export_chrome_trace",
    "finished_spans",
    "format_traceparent",
    "job_link",
    "link_job",
    "merge_chrome_traces",
    "new_request_id",
    "normalize_span_records",
    "parse_traceparent",
    "recorder",
    "reset_all",
    "reset_spans",
    "round_timelines",
    "seed_ids",
    "set_attribute",
    "set_span_sink",
    "slowest_spans",
    "span",
    "span_sink",
    "span_tree",
]


def reset_all() -> None:
    """Clear EVERY observability registry together — counters, gauges,
    histograms, phase stats, the span ring buffer, job-trace links, and
    the devprof shape/cost registry (whose ``xla.compile.*`` counters and
    memory gauges live in the metrics registry) — so a fresh
    measurement window can never start half-reset
    (``utils/metrics.reset_all()`` + ``reset_phase_report()`` used to be
    separate calls and easy to desync in tests)."""
    from ..utils import metrics, timing

    metrics.reset_all()
    timing.reset_phase_report()
    reset_spans()
    devprof.reset()
