"""Span layer: in-process distributed tracing with W3C context propagation.

The SDA round is a four-role pipeline (participant -> server -> clerk ->
recipient) and the aggregate instruments (``utils/timing.py`` phase means,
``utils/metrics.py`` counters/histograms) cannot answer the Dapper-style
question "where did THIS round's two seconds go, and which retry or
lease-reissue caused it?". This module is the causal view:

- **Spans** carry ids (``trace_id``/``span_id``/``parent_id``), wall-clock
  start + duration, free-form attributes, and point-in-time events (chaos
  failpoint triggers land here, so a drill shows *which* injected fault
  lengthened *which* round).
- **Context** is a thread-local stack: ``span()`` nests under the current
  span unless an explicit ``parent`` (a remote ``SpanContext``) re-roots it
  into the originating caller's trace — that is how the HTTP server joins
  the client's trace and how a lease-reissued clerking job re-joins the
  round that enqueued it.
- **Propagation** rides a W3C ``traceparent`` header
  (``00-<trace32>-<span16>-01``); job-to-trace links ride the
  ``X-Trace-Context`` response header of clerking-job polls, mirrored in a
  bounded in-process registry (``link_job``/``job_link``).
- **Export**: finished spans land in a bounded ring buffer; ``chrome_trace``
  renders them in the Chrome trace-event format — the same format family
  ``utils/traceparse.py`` already reads, so ``jax.profiler`` device lanes
  merge into the same timeline (``timeline.merge_chrome_traces``).

Ids come from ``SystemRandom`` by default; ``seed_ids(seed)`` switches to a
deterministic stream so replay tests get byte-stable traces. Recording a
span costs two ``perf_counter`` calls, one dict, and a deque append — safe
to leave on permanently; tracing changes no protocol bytes.
"""

from __future__ import annotations

import collections
import contextlib
import os
import random
import re
import threading
import time
from typing import Dict, Iterator, List, Optional

#: W3C trace-context request header injected by ``SdaHttpClient`` and
#: extracted by ``SdaHttpServer``.
TRACEPARENT_HEADER = "traceparent"
#: Response header carrying the trace context a clerking job was enqueued
#: under (GET /v1/aggregations/any/jobs), so remote clerks parent their
#: processing to the round that created the job.
TRACE_CONTEXT_HEADER = "X-Trace-Context"
#: Request-correlation header echoed on every ``SdaHttpServer`` response
#: (reused when the client sent one, minted otherwise).
REQUEST_ID_HEADER = "X-Request-Id"

_TRACEPARENT_RE = re.compile(
    r"(?P<version>[0-9a-f]{2})-(?P<trace>[0-9a-f]{32})"
    r"-(?P<span>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})"
)

def _buffer_capacity() -> int:
    """Ring size: ``SDA_TRACE_BUFFER`` overrides the default 65536 —
    sized for the 200-participant overload load drill (~70 spans per
    participant across client attempts, server handling, and store ops,
    plus shed/retry pairs) with headroom, so the ``round`` root and early
    spans survive to export. Memory materializes only as spans are
    recorded (a few hundred bytes each)."""
    raw = os.environ.get("SDA_TRACE_BUFFER", "")
    try:
        return max(1024, int(raw)) if raw.strip() else 65536
    except ValueError:
        return 65536


#: Finished spans kept for export/timelines (oldest evicted first).
SPAN_BUFFER_CAPACITY = _buffer_capacity()
_JOB_LINKS_MAX = 4096


class SpanContext:
    """The propagatable identity of a span: ``(trace_id, span_id)``."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __eq__(self, other):
        return (
            isinstance(other, SpanContext)
            and self.trace_id == other.trace_id
            and self.span_id == other.span_id
        )

    def __hash__(self):
        return hash((self.trace_id, self.span_id))

    def __repr__(self):
        return f"SpanContext({self.trace_id}, {self.span_id})"


class Span:
    """One timed operation in a trace. Mutated only by its owning thread
    while open; immutable once it lands in the ring buffer."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "kind",
        "start_s", "start_mono", "duration_s", "attributes", "events",
        "status", "thread",
    )

    def __init__(self, name, trace_id, span_id, parent_id, kind, attributes):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.kind = kind  # "internal" | "client" | "server"
        self.start_s = time.time()
        #: ``perf_counter`` at open — the flight recorder spools it next
        #: to the wall stamp so cross-process merges can normalize each
        #: process's monotonic epoch against its wall-clock anchor
        #: (``timeline.clock_offsets``); set by ``span()``
        self.start_mono: Optional[float] = None
        self.duration_s: Optional[float] = None
        self.attributes: Dict[str, object] = dict(attributes or {})
        self.events: List[dict] = []
        self.status = "ok"
        self.thread = threading.get_ident()

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def end_s(self) -> float:
        return self.start_s + (self.duration_s or 0.0)

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, **attributes) -> None:
        self.events.append(
            {"name": name, "time_s": time.time(), "attributes": attributes}
        )

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"span={self.span_id}, parent={self.parent_id})")


class _IdSource:
    """Hex id generator: ``SystemRandom`` by default, a seeded ``Random``
    for replay-deterministic traces. All-zero ids are invalid per W3C and
    never emitted."""

    def __init__(self, seed=None):
        self._lock = threading.Lock()
        self._rng = random.SystemRandom() if seed is None else random.Random(seed)

    def _hex(self, bits: int) -> str:
        with self._lock:
            value = 0
            while value == 0:
                value = self._rng.getrandbits(bits)
        return format(value, f"0{bits // 4}x")

    def trace_id(self) -> str:
        return self._hex(128)

    def span_id(self) -> str:
        return self._hex(64)


_ids = _IdSource()
_buffer: "collections.deque[Span]" = collections.deque(maxlen=SPAN_BUFFER_CAPACITY)
_buffer_lock = threading.Lock()
#: Optional finished-span hook (the flight recorder's spool writer): called
#: with each Span as it closes, AFTER the ring-buffer append. Exceptions
#: are swallowed — the sink observes, it never participates.
_span_sink = None
_tls = threading.local()
_job_links: "collections.OrderedDict[str, SpanContext]" = collections.OrderedDict()
_job_links_lock = threading.Lock()


def seed_ids(seed: Optional[int]) -> None:
    """Make trace/span/request ids deterministic under ``seed`` (replay
    tests); ``None`` restores the cryptographically random source."""
    global _ids
    _ids = _IdSource(seed)


def new_request_id() -> str:
    """A fresh ``X-Request-Id`` value (16 hex chars, same id source as
    spans so seeding covers it too)."""
    return _ids.span_id()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current_span() -> Optional[Span]:
    """The innermost open span on this thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def current_context() -> Optional[SpanContext]:
    """The propagatable context of the current span, or None."""
    span_ = current_span()
    return None if span_ is None else span_.context


@contextlib.contextmanager
def span(
    name: str,
    *,
    parent: Optional[SpanContext] = None,
    kind: str = "internal",
    attributes: Optional[dict] = None,
) -> Iterator[Span]:
    """Open a span: child of ``parent`` when given (a remote
    ``SpanContext`` — the span adopts its trace id), else child of the
    thread's current span, else the root of a fresh trace. The span is
    pushed on the thread-local context stack for the duration and appended
    to the ring buffer when it closes; an escaping exception marks
    ``status="error"``."""
    if parent is None:
        parent = current_context()
    elif isinstance(parent, Span):
        parent = parent.context
    if parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    else:
        trace_id, parent_id = _ids.trace_id(), None
    span_ = Span(name, trace_id, _ids.span_id(), parent_id, kind, attributes)
    stack = _stack()
    stack.append(span_)
    t0 = time.perf_counter()
    span_.start_mono = t0
    try:
        yield span_
    except BaseException as e:
        span_.status = "error"
        span_.attributes.setdefault("error", f"{type(e).__name__}: {e}")
        raise
    finally:
        span_.duration_s = time.perf_counter() - t0
        stack.pop()
        with _buffer_lock:
            _buffer.append(span_)
        sink = _span_sink
        if sink is not None:
            try:
                sink(span_)
            except Exception:  # a broken sink must never fail the span's
                pass  # owner — observability stays side-effect-free


def add_event(name: str, **attributes) -> None:
    """Record a point-in-time event on the current span (no-op without
    one) — chaos failpoint triggers use this."""
    span_ = current_span()
    if span_ is not None:
        span_.add_event(name, **attributes)


def set_attribute(key: str, value) -> None:
    """Set an attribute on the current span (no-op without one)."""
    span_ = current_span()
    if span_ is not None:
        span_.set_attribute(key, value)


def finished_spans() -> List[Span]:
    """Snapshot of the ring buffer, oldest first."""
    with _buffer_lock:
        return list(_buffer)


def reset_spans() -> None:
    """Clear the finished-span ring buffer and the job-trace links."""
    with _buffer_lock:
        _buffer.clear()
    with _job_links_lock:
        _job_links.clear()


def set_span_sink(sink) -> None:
    """Install (or, with ``None``, remove) the finished-span hook. One
    sink at a time — the flight recorder owns it when installed."""
    global _span_sink
    _span_sink = sink


def span_sink():
    """The current finished-span hook, or None."""
    return _span_sink


# -- propagation ------------------------------------------------------------

def format_traceparent(ctx: SpanContext) -> str:
    """``00-<trace_id>-<span_id>-01`` (W3C trace-context, sampled flag)."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """Parse a ``traceparent`` header; None for absent/garbled values (a
    bad header must never fail the request it rode in on)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.fullmatch(header.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group("trace"), m.group("span")
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None  # all-zero ids are explicitly invalid per W3C
    return SpanContext(trace_id, span_id)


def link_job(job_id: str, ctx: Optional[SpanContext]) -> None:
    """Remember the trace context a clerking job was enqueued under, so a
    (possibly reissued) poll of the same job re-parents its processing to
    the ORIGINAL round trace. Bounded FIFO: observability metadata, never
    protocol state."""
    if ctx is None:
        return
    with _job_links_lock:
        _job_links[str(job_id)] = ctx
        _job_links.move_to_end(str(job_id))
        while len(_job_links) > _JOB_LINKS_MAX:
            _job_links.popitem(last=False)


def job_link(job_id: str) -> Optional[SpanContext]:
    """The trace context recorded for a clerking job, or None."""
    with _job_links_lock:
        return _job_links.get(str(job_id))


# -- export -----------------------------------------------------------------

def _lane(name: str) -> str:
    """Timeline lane for a span: the leading dotted/space-separated token
    of its name (``participant.mask`` -> ``participant``, ``http.server
    GET:/v1/ping`` -> ``http``)."""
    return name.split(" ", 1)[0].split(".", 1)[0]


def _jsonable(value):
    return value if isinstance(value, (str, int, float, bool, type(None))) \
        else str(value)


def chrome_trace(spans: Optional[List[Span]] = None) -> dict:
    """Render spans in the Chrome trace-event JSON format: one complete
    ("X") event per span (``ts``/``dur`` in microseconds of wall-clock
    epoch, trace/span/parent ids under ``args``), one instant ("i") event
    per span event, and ``process_name`` metadata naming each lane. The
    format family is what ``utils/traceparse.py`` parses and what
    ``chrome://tracing`` / Perfetto load directly."""
    if spans is None:
        spans = finished_spans()
    lanes: Dict[str, int] = {}
    events = []
    for s in spans:
        pid = lanes.setdefault(_lane(s.name), len(lanes) + 1)
        args = {"trace_id": s.trace_id, "span_id": s.span_id}
        if s.parent_id:
            args["parent_id"] = s.parent_id
        if s.status != "ok":
            args["status"] = s.status
        if s.kind != "internal":
            args["kind"] = s.kind
        for key, value in s.attributes.items():
            args.setdefault(key, _jsonable(value))
        events.append({
            "name": s.name, "ph": "X", "pid": pid, "tid": s.thread,
            "ts": round(s.start_s * 1e6, 3),
            "dur": round((s.duration_s or 0.0) * 1e6, 3),
            "args": args,
        })
        for ev in s.events:
            events.append({
                "name": ev["name"], "ph": "i", "s": "t",
                "pid": pid, "tid": s.thread,
                "ts": round(ev["time_s"] * 1e6, 3),
                "args": dict(
                    {"span_id": s.span_id, "trace_id": s.trace_id},
                    **{k: _jsonable(v) for k, v in ev["attributes"].items()},
                ),
            })
    meta = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": lane}}
        for lane, pid in lanes.items()
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str, spans: Optional[List[Span]] = None) -> dict:
    """Write ``chrome_trace()`` JSON to ``path``; returns the trace dict."""
    import json

    trace = chrome_trace(spans)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace
