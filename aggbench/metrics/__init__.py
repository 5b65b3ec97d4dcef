"""Per-layer metric readers, one file a metric of ``BENCHMARK.json``:
``read(view)`` takes the ``traceparse.TraceView`` of a traced run's
window and returns the metric's value, or None where the trace holds
nothing for it."""
