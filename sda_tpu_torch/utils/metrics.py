"""Process-global metrics: counters, gauges, log-bucketed histograms.

The reference has structured logging but zero metrics anywhere (SURVEY.md
§5.5: "No metrics counters"). This registry closes that gap the same way
``timing.py`` does for spans: named instruments with a process-global,
thread-safe store, updated at the protocol choke points (server ops, HTTP
requests) and read back by benchmarks, the sim CLI, the loadgen driver,
and tests. Cost per hit is one lock + dict update — noise next to any I/O.

Three instrument kinds:

- **counters** — monotonic event tallies (``count`` / ``counter_report``);
- **gauges** — last-written point-in-time values, e.g. queue depth
  (``gauge_set`` / ``gauge_report``);
- **histograms** — log-bucketed latency/size distributions
  (``observe`` / ``histogram_report``). Buckets are geometric:
  boundary ``i`` is ``HIST_MIN * HIST_BASE**i`` with ``HIST_BASE = 2**0.25``
  (~19% bucket width), so quantile estimates carry at most one bucket of
  relative error across ~10 decades while a histogram stays a small sparse
  dict of int -> count. The same shape serves a 3µs field op and a 30s
  straggler round without pre-declaring ranges.

``prometheus_text()`` renders everything in the Prometheus text exposition
format (the ``GET /metrics`` endpoint of ``SdaHttpServer`` serves it);
instrument names stay dotted internally (``http.latency.GET:/v1/ping``)
and ride a ``name`` label on the wire, so arbitrary route templates never
have to be mangled into metric-name charset.

Naming convention: dotted paths, ``server.participation.created``,
``http.request``, ``http.status.200``, ``http.latency.<route>``.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional

_lock = threading.Lock()
_counts: Dict[str, int] = {}
_gauges: Dict[str, float] = {}
_hists: Dict[str, "_Histogram"] = {}

#: Geometric bucket layout shared by every histogram: boundary ``i`` is
#: ``HIST_MIN * HIST_BASE**i`` seconds (for latencies; the units are the
#: caller's).  2**0.25 per step = 4 buckets per doubling.
HIST_BASE = 2.0 ** 0.25
HIST_MIN = 1e-6
_LOG_BASE = math.log(HIST_BASE)


class _Histogram:
    """Sparse log-bucketed histogram. Mutated under the module lock."""

    __slots__ = ("buckets", "count", "total", "min", "max")

    def __init__(self):
        self.buckets: Dict[int, int] = {}  # bucket index -> count
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, value: float) -> None:
        if value <= HIST_MIN:
            idx = 0
        else:
            # smallest i with HIST_MIN * HIST_BASE**i >= value
            idx = max(0, math.ceil(math.log(value / HIST_MIN) / _LOG_BASE - 1e-9))
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket where the cumulative count crosses
        ``q`` — at most one bucket (~19%) of relative overestimate."""
        if not self.count:
            return 0.0
        need = q * self.count
        seen = 0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen >= need:
                return min(self.max, HIST_MIN * HIST_BASE ** idx)
        return self.max

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": self.total,
            "min": 0.0 if self.count == 0 else self.min,
            "max": 0.0 if self.count == 0 else self.max,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


# -- counters ---------------------------------------------------------------

def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the named counter (creating it at zero)."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counter_report(prefix: str = "") -> Dict[str, int]:
    """Snapshot of all counters (optionally filtered by name prefix)."""
    with _lock:
        return {k: v for k, v in sorted(_counts.items()) if k.startswith(prefix)}


def reset_counters() -> None:
    with _lock:
        _counts.clear()


# -- gauges -----------------------------------------------------------------

def gauge_set(name: str, value: float) -> None:
    """Record the current value of the named gauge (last write wins)."""
    with _lock:
        _gauges[name] = value


def gauge_max(name: str, value: float) -> None:
    """Raise the named gauge to ``value`` if larger (high-water marks)."""
    with _lock:
        if value > _gauges.get(name, -math.inf):
            _gauges[name] = value


def gauge_report(prefix: str = "") -> Dict[str, float]:
    with _lock:
        return {k: v for k, v in sorted(_gauges.items()) if k.startswith(prefix)}


def reset_gauges() -> None:
    with _lock:
        _gauges.clear()


# -- histograms -------------------------------------------------------------

def observe(name: str, value: float) -> None:
    """Record ``value`` into the named log-bucketed histogram."""
    with _lock:
        hist = _hists.get(name)
        if hist is None:
            hist = _hists[name] = _Histogram()
        hist.add(value)


def histogram_report(prefix: str = "") -> Dict[str, Dict[str, float]]:
    """``{name: {count, sum, min, max, p50, p95, p99}}`` snapshot.

    Quantiles are bucket upper bounds (clamped to the observed max), so
    they overestimate by at most one geometric bucket (~19%)."""
    with _lock:
        return {
            k: h.summary() for k, h in sorted(_hists.items())
            if k.startswith(prefix)
        }


def histogram_buckets(name: str) -> Optional[Dict[float, int]]:
    """Raw ``{upper_bound: count}`` buckets of one histogram (sorted), or
    ``None`` if it does not exist. For exposition and tests."""
    with _lock:
        hist = _hists.get(name)
        if hist is None:
            return None
        return {
            HIST_MIN * HIST_BASE ** idx: n
            for idx, n in sorted(hist.buckets.items())
        }


def reset_histograms() -> None:
    with _lock:
        _hists.clear()


def reset_all() -> None:
    """Clear counters, gauges, and histograms (fresh measurement window)."""
    reset_counters()
    reset_gauges()
    reset_histograms()


# -- exposition -------------------------------------------------------------

def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def unescape_label(value: str) -> str:
    """Invert :func:`_escape_label` — the round-trip parsers of the text
    exposition (tests, scrape tooling) rely on. Escapes are processed
    left-to-right, exactly as Prometheus label-value unescaping does."""
    out = []
    i = 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
            if nxt == '"':
                out.append('"')
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _bucket_rows(buckets: Dict[int, int], count: int):
    """Cumulative ``[le_string, cumulative_count]`` rows for one
    histogram, ``+Inf`` last — THE bucket-boundary format. Both the text
    exposition (``prometheus_text``'s ``_bucket``/``le`` lines) and the
    flight recorder's spooled metric snapshots (``snapshot()``) render
    from this one helper, so the scrape endpoint and the on-disk spools
    can never disagree about boundary formatting."""
    rows = []
    cumulative = 0
    for idx in sorted(buckets):
        cumulative += buckets[idx]
        rows.append(["%.6g" % (HIST_MIN * HIST_BASE ** idx), cumulative])
    rows.append(["+Inf", count])
    return rows


def snapshot() -> dict:
    """One consistent point-in-time view of every instrument: counters,
    gauges, and histograms WITH explicit bucket boundaries (the same
    ``le`` strings ``prometheus_text`` emits). This is the record shape
    the flight recorder spools (``obs/recorder.py``), taken under the
    registry lock so bucket rows stay consistent with their _sum/_count."""
    with _lock:
        counts = dict(_counts)
        gauges = dict(_gauges)
        hists = [
            (name, dict(h.buckets), h.count, h.total)
            for name, h in sorted(_hists.items())
        ]
    return {
        "counters": counts,
        "gauges": gauges,
        "histograms": {
            name: {"count": count_, "sum": total,
                   "buckets": _bucket_rows(buckets, count_)}
            for name, buckets, count_, total in hists
        },
    }


def prometheus_text(labels: Optional[Dict[str, str]] = None) -> str:
    """Render every instrument in the Prometheus text exposition format.

    Internal dotted names ride a ``name`` label (three fixed metric
    families) instead of being mangled into the metric-name charset, so
    route templates like ``GET:/v1/agents/{id}`` survive verbatim.
    ``labels`` adds constant labels to every sample — the fleet plane
    stamps ``node_id`` here so N workers scraped into one Prometheus
    keep their series apart (docs/scaling.md).
    """
    extra = "".join(
        ',%s="%s"' % (k, _escape_label(str(v)))
        for k, v in sorted((labels or {}).items())
    )
    with _lock:
        counts = sorted(_counts.items())
        gauges = sorted(_gauges.items())
        # deep-copy histogram state under the lock: concurrent observe()
        # may mint a new bucket key mid-scrape, and bucket lines must stay
        # consistent with the _sum/_count lines of the same instant
        hists = [
            (name, dict(h.buckets), h.count, h.total)
            for name, h in sorted(_hists.items())
        ]
    lines = []
    if counts:
        lines.append("# TYPE sda_events_total counter")
        for name, v in counts:
            lines.append('sda_events_total{name="%s"%s} %d'
                         % (_escape_label(name), extra, v))
    if gauges:
        lines.append("# TYPE sda_gauge gauge")
        for name, v in gauges:
            lines.append('sda_gauge{name="%s"%s} %s'
                         % (_escape_label(name), extra, v))
    if hists:
        lines.append("# TYPE sda_histogram histogram")
        for name, buckets, count_, total in hists:
            label = _escape_label(name)
            for le, cumulative in _bucket_rows(buckets, count_):
                lines.append('sda_histogram_bucket{name="%s"%s,le="%s"} %d'
                             % (label, extra, le, cumulative))
            lines.append('sda_histogram_sum{name="%s"%s} %.9g'
                         % (label, extra, total))
            lines.append('sda_histogram_count{name="%s"%s} %d'
                         % (label, extra, count_))
    return "\n".join(lines) + "\n"
