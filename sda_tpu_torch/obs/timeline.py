"""Round timelines and critical paths over recorded spans.

Where ``trace.py`` records the causal structure, this module answers the
operator questions: which round was slowest, what chain of spans set its
duration (the critical path — at each node, follow the child that finished
last), and which chaos injections landed inside it. The secure-aggregation
literature (Bonawitz et al., CCS 2017) shows tail stragglers dominate round
time; these reports attribute the tail to a concrete span chain instead of
a histogram bucket.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .trace import Span, _lane, finished_spans


def span_tree(spans: List[Span]):
    """``(by_id, children, roots)`` — children sorted by start time; a span
    whose parent is unknown (evicted from the ring buffer, or remote and
    never recorded here) counts as a root."""
    by_id = {s.span_id: s for s in spans}
    children: Dict[str, List[Span]] = {}
    roots = []
    for s in spans:
        if s.parent_id and s.parent_id in by_id:
            children.setdefault(s.parent_id, []).append(s)
        else:
            roots.append(s)
    for kids in children.values():
        kids.sort(key=lambda c: c.start_s)
    return by_id, children, roots


def critical_path(root: Span, children: Dict[str, List[Span]]) -> List[Span]:
    """Walk from ``root`` following, at each level, the child that ended
    last — the chain that determined the subtree's duration."""
    path = [root]
    node = root
    while True:
        kids = children.get(node.span_id)
        if not kids:
            return path
        node = max(kids, key=lambda c: c.end_s)
        path.append(node)


def _path_entry(s: Span) -> dict:
    return {
        "name": s.name,
        "duration_ms": round((s.duration_s or 0.0) * 1e3, 3),
    }


def _chaos_events(spans: List[Span]) -> List[dict]:
    out = []
    for s in spans:
        for ev in s.events:
            if ev["name"].startswith("chaos."):
                out.append({
                    "event": ev["name"],
                    "span": s.name,
                    "span_id": s.span_id,
                    **{k: v for k, v in ev["attributes"].items()},
                })
    return out


def round_timelines(spans: Optional[List[Span]] = None) -> List[dict]:
    """One timeline report per trace, slowest first: wall-clock extent,
    span count, participating lanes, the critical path from the earliest
    root, and every chaos injection recorded inside the trace."""
    if spans is None:
        spans = finished_spans()
    by_trace: Dict[str, List[Span]] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    reports = []
    for trace_id, members in by_trace.items():
        _, children, roots = span_tree(members)
        start = min(s.start_s for s in members)
        end = max(s.end_s for s in members)
        root = min(roots, key=lambda s: s.start_s)
        reports.append({
            "trace_id": trace_id,
            "root": root.name,
            "start_s": round(start, 6),
            "duration_ms": round((end - start) * 1e3, 3),
            "spans": len(members),
            "lanes": sorted({_lane(s.name) for s in members}),
            "critical_path": [
                _path_entry(s) for s in critical_path(root, children)
            ],
            "chaos_events": _chaos_events(members),
        })
    reports.sort(key=lambda r: r["duration_ms"], reverse=True)
    return reports


def slowest_spans(
    name: str, n: int = 3, spans: Optional[List[Span]] = None
) -> List[dict]:
    """Exemplars: the ``n`` slowest spans named ``name`` with the critical
    path of their subtree — e.g. the slowest ``load.participant`` units in
    a loadgen capacity report."""
    if spans is None:
        spans = finished_spans()
    _, children, _ = span_tree(spans)
    matches = sorted(
        (s for s in spans if s.name == name),
        key=lambda s: s.duration_s or 0.0,
        reverse=True,
    )
    return [
        {
            "trace_id": s.trace_id,
            "span_id": s.span_id,
            "duration_ms": round((s.duration_s or 0.0) * 1e3, 3),
            "attributes": {k: str(v) for k, v in s.attributes.items()},
            "critical_path": [
                _path_entry(p) for p in critical_path(s, children)
            ],
        }
        for s in matches[:n]
    ]


def clock_offsets(anchors: List[dict]) -> Dict[tuple, float]:
    """Per-process clock offsets from spool ``proc`` anchor records.

    Python's ``perf_counter`` epoch is unspecified and per-process, so
    monotonic timestamps from two fleet workers are NOT comparable — and
    wall clocks can step mid-run, so wall stamps alone interleave events
    wrongly on skewed hosts. Each flight-recorder segment opens with an
    anchor pairing ``wall_s`` and ``mono_s`` sampled back-to-back; for
    process ``(node, pid)`` the offset is ``wall_anchor - mono_anchor``,
    and any of that process's monotonic stamps normalizes to a shared
    timeline as ``mono + offset``. With several anchors per process (one
    per segment) we keep the EARLIEST: later anchors would silently fold
    any wall-clock step into the offset and shear the merged timeline.

    Returns ``{(node_or_None, pid): offset_s}``.
    """
    offsets: Dict[tuple, tuple] = {}  # key -> (mono_anchor, offset)
    for rec in anchors:
        if rec.get("t") != "proc":
            continue
        wall = rec.get("wall_s")
        mono = rec.get("mono_s")
        if wall is None or mono is None:
            continue
        key = (rec.get("node"), rec.get("pid"))
        prev = offsets.get(key)
        if prev is None or mono < prev[0]:
            offsets[key] = (mono, wall - mono)
    return {key: off for key, (_, off) in offsets.items()}


def normalize_span_records(records: List[dict]) -> List[dict]:
    """Rewrite spooled span records from N processes onto one wall-clock
    timeline: each span's ``start_s`` becomes ``mono_s + offset`` of its
    process (falling back to the recorded wall stamp when the segment's
    anchor or the span's monotonic stamp is missing). Input records need
    a ``node``/``pid`` stamp or ride in segments whose anchor provides
    them — the forensics loader (``obs/forensics.py``) annotates both."""
    offsets = clock_offsets(records)
    out = []
    for rec in records:
        if rec.get("t") != "span":
            continue
        rec = dict(rec)
        key = (rec.get("node"), rec.get("pid"))
        off = offsets.get(key)
        mono = rec.get("mono_s")
        if off is not None and mono is not None:
            rec["norm_s"] = mono + off
        else:
            rec["norm_s"] = rec.get("start_s", 0.0)
        out.append(rec)
    out.sort(key=lambda r: r["norm_s"])
    return out


def chrome_trace_from_records(records: List[dict]) -> dict:
    """Chrome ``traceEvents`` dict from spooled span records, one pid
    lane per recording process, timestamps normalized via
    :func:`clock_offsets` so two workers' lanes truly interleave in
    causal order (satellite of the flight-recorder plane; load in
    ``chrome://tracing`` / Perfetto)."""
    events = []
    pids: Dict[tuple, int] = {}
    for rec in normalize_span_records(records):
        key = (rec.get("node"), rec.get("pid"))
        pid = pids.setdefault(key, len(pids) + 1)
        events.append({
            "name": rec.get("name", "?"),
            "ph": "X",
            "ts": rec["norm_s"] * 1e6,
            "dur": (rec.get("duration_s") or 0.0) * 1e6,
            "pid": pid,
            "tid": rec.get("thread", 0),
            "args": {
                "trace_id": rec.get("trace"),
                "span_id": rec.get("span"),
                **{k: str(v) for k, v in (rec.get("attrs") or {}).items()},
            },
        })
    meta = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": f"{node or 'proc'}[{rpid}]"}}
        for (node, rpid), pid in sorted(pids.items(), key=lambda kv: kv[1])
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def merge_chrome_traces(*traces: dict) -> dict:
    """Concatenate Chrome trace dicts (e.g. the span export plus a
    ``torch.profiler`` trace loaded via ``traceparse.load_latest_trace``),
    remapping pids so lanes from different sources never collide.

    The span layer writes epoch microseconds. A ``torch.profiler`` trace
    counts its ``ts`` from its own ``baseTimeNanoseconds``; such a trace is
    shifted onto the epoch by adding that base, so a span and a profiler
    range opened together land together. The merged trace carries no
    base."""
    events = []
    next_pid = 0
    for t in traces:
        remap: Dict[object, int] = {}
        shift = float(t.get("baseTimeNanoseconds", 0)) / 1000.0
        for e in t.get("traceEvents", []):
            e = dict(e)
            if shift and "ts" in e:
                e["ts"] = float(e["ts"]) + shift
            pid = e.get("pid")
            if pid is not None:
                if pid not in remap:
                    next_pid += 1
                    remap[pid] = next_pid
                e["pid"] = remap[pid]
            events.append(e)
    return {"traceEvents": events, "displayTimeUnit": "ms"}
