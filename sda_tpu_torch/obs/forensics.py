"""Round forensics over flight-recorder spools: the post-mortem story.

The flight recorder (``obs/recorder.py``) leaves behind a directory of
JSONL segments from every process that served a fleet — spans, chaos
fault marks, round-ledger entries, epoch mints, metric snapshots. This
module turns that directory back into the *causal story of one round*
(``sda-trace explain AGG_ID``) after every one of those processes has
exited: how many participations landed (and how many were replays or
equivocations), which HTTP calls retried and why, what got shed, which
clerk leases lapsed and were reissued, which chaos faults were injected
at which sites, how long each clerk job ran, and whether the reveal
completed — with its output digest, so a drill can assert the recorded
round was bit-exact without any process surviving.

Join discipline: spans carrying an ``aggregation`` attribute anchor the
round to its trace ids; every span in those traces (joined on
``trace_id`` across ALL processes' segments — that is what W3C
traceparent propagation buys) plus the round's ledger/fault/epoch
records compose the report. Spans amended after close (the async
plane's parked long-polls re-spool with their fixed-up duration) dedupe
by span id, longest duration wins. Timestamps normalize onto one wall
clock via the per-process anchors (``timeline.clock_offsets``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from . import recorder, timeline


class Spool:
    """Parsed, indexed view of one spool directory."""

    def __init__(self, records: List[dict], torn: int = 0):
        self.torn = torn
        self.procs: Dict[tuple, dict] = {}
        self.spans: List[dict] = []
        self.rounds: List[dict] = []
        self.epochs: List[dict] = []
        self.faults: List[dict] = []
        self.metrics: Dict[tuple, dict] = {}  # proc key -> LAST snapshot
        # segment -> (node, pid): every segment opens with its proc
        # anchor, so later records in the segment inherit its identity
        seg_proc: Dict[str, tuple] = {}
        best_span: Dict[str, dict] = {}
        order: List[str] = []
        for rec in records:
            seg = rec.get("_segment")
            t = rec.get("t")
            if t == "proc":
                key = (rec.get("node"), rec.get("pid"))
                self.procs.setdefault(key, rec)
                if seg is not None:
                    seg_proc[seg] = key
                continue
            key = seg_proc.get(seg)
            if key is not None:
                rec.setdefault("node", key[0])
                rec.setdefault("pid", key[1])
            if t == "span":
                sid = rec.get("span")
                prev = best_span.get(sid)
                if prev is None:
                    best_span[sid] = rec
                    order.append(sid)
                elif (rec.get("duration_s") or 0.0) > (
                    prev.get("duration_s") or 0.0
                ):
                    best_span[sid] = rec  # amended long-poll span wins
            elif t == "round":
                self.rounds.append(rec)
            elif t == "epoch":
                self.epochs.append(rec)
            elif t == "fault":
                self.faults.append(rec)
            elif t == "metrics":
                if key is None:
                    key = (rec.get("node"), rec.get("pid"))
                prev = self.metrics.get(key)
                if prev is None or rec.get("mono_s", 0.0) >= prev.get(
                    "mono_s", 0.0
                ):
                    self.metrics[key] = rec
        self.spans = [best_span[sid] for sid in order]
        # one normalized timeline across processes (satellite: clock merge)
        anchors = list(self.procs.values())
        self.offsets = timeline.clock_offsets(anchors)

    # -- lookups -----------------------------------------------------------
    def norm_time(self, rec: dict) -> float:
        off = self.offsets.get((rec.get("node"), rec.get("pid")))
        mono = rec.get("mono_s")
        if off is not None and mono is not None:
            return mono + off
        return rec.get("wall_s") or rec.get("start_s") or 0.0

    def aggregation_ids(self) -> List[str]:
        """Every aggregation id seen anywhere in the spool, newest last."""
        seen: Dict[str, float] = {}
        for rec in self.rounds + self.epochs:
            agg = rec.get("aggregation")
            if agg:
                seen[agg] = max(seen.get(agg, 0.0), self.norm_time(rec))
        for s in self.spans:
            agg = (s.get("attrs") or {}).get("aggregation")
            if agg:
                seen[agg] = max(seen.get(agg, 0.0), self.norm_time(s))
        return [a for a, _ in sorted(seen.items(), key=lambda kv: kv[1])]

    def resolve(self, prefix: str) -> str:
        """Full aggregation id from a unique prefix (operator ergonomics:
        ``sda-trace explain 3f2a`` beats pasting 32 hex chars)."""
        ids = self.aggregation_ids()
        if prefix in ids:
            return prefix
        hits = [a for a in ids if a.startswith(prefix)]
        if len(hits) == 1:
            return hits[0]
        if not hits:
            raise KeyError(
                f"no aggregation matching {prefix!r} in spool "
                f"({len(ids)} known)")
        raise KeyError(
            f"ambiguous prefix {prefix!r}: matches {sorted(hits)[:4]}")

    def counter_totals(self, prefix: str = "") -> Dict[str, int]:
        """Fleet-wide counter totals: the LAST metrics snapshot of each
        process, summed across processes. Periodic snapshots mean a
        SIGKILLed worker contributes its state as of <= snapshot_s ago."""
        totals: Dict[str, int] = {}
        for snap in self.metrics.values():
            for name, v in (snap.get("counters") or {}).items():
                if name.startswith(prefix):
                    totals[name] = totals.get(name, 0) + int(v)
        return totals


def load_spool(root: str) -> Spool:
    """Parse every segment under ``root`` (sealed and active, torn tails
    skipped) into an indexed :class:`Spool`."""
    records, torn = recorder.read_spool(root)
    return Spool(records, torn)


# -- the explain report ------------------------------------------------------

def _trace_ids_for(spool: Spool, agg_id: str) -> set:
    ids = set()
    for s in spool.spans:
        if (s.get("attrs") or {}).get("aggregation") == agg_id:
            if s.get("trace"):
                ids.add(s["trace"])
    return ids


def explain(spool: Spool, agg_or_prefix: str) -> dict:
    """The causal story of one round, reconstructed purely from spools."""
    agg_id = spool.resolve(agg_or_prefix)
    traces = _trace_ids_for(spool, agg_id)
    spans = [s for s in spool.spans if s.get("trace") in traces]
    by_name: Dict[str, List[dict]] = {}
    for s in spans:
        by_name.setdefault(s.get("name", "?"), []).append(s)

    def _count(name: str) -> int:
        return len(by_name.get(name, []))

    # participations: the server-side creations are authoritative (the
    # participant span exists even when the POST was shed/refused);
    # byte-identical replays (crash/retry, journal resume) and conflicts
    # are tagged on the span, so "created" counts DISTINCT admissions
    part_spans = by_name.get("server.create_participation", [])
    created = [
        s for s in part_spans
        if not (s.get("attrs") or {}).get("conflict")
        and not (s.get("attrs") or {}).get("replayed")
    ]
    replays = sum(
        1 for s in part_spans if (s.get("attrs") or {}).get("replayed"))
    conflicts = len(part_spans) - len(created) - replays

    # retries: op-level spans carry a "retries" attribute when >0
    retries = 0
    retry_causes: Dict[str, int] = {}
    for s in spans:
        attrs = s.get("attrs") or {}
        r = attrs.get("retries")
        if r:
            try:
                retries += int(r)
            except (TypeError, ValueError):
                pass
    for name, v in spool.counter_totals("http.retry.").items():
        retry_causes[name[len("http.retry."):]] = v

    sheds = [
        s for s in spans if (s.get("attrs") or {}).get("shed")
    ]

    # chaos faults: dedicated fault records, plus chaos.* span events.
    # An injection inside an open span produces BOTH (the record carries
    # the span id) — dedupe on it so each injection counts once; the
    # event-only path still catches spans whose fault record was evicted.
    faults = []
    recorded_sites = set()
    for f in spool.faults:
        if f.get("trace") in traces or f.get("aggregation") == agg_id:
            recorded_sites.add((f.get("span"), f.get("site")))
            faults.append({
                "site": f.get("site"),
                "kind": f.get("kind"),
                "node": f.get("node"),
                "time_s": round(spool.norm_time(f), 6),
            })
    for s in spans:
        for ev in s.get("events") or []:
            if str(ev.get("name", "")).startswith("chaos."):
                attrs = ev.get("attrs") or {}
                site = (attrs.get("fault.site")
                        or ev["name"][len("chaos."):])
                if (s.get("span"), site) in recorded_sites:
                    continue
                faults.append({
                    "site": site,
                    "kind": attrs.get("fault.kind") or attrs.get("kind"),
                    "node": s.get("node"),
                    "span": s.get("name"),
                    "time_s": None,
                })

    clerk_jobs = [
        {
            "job": (s.get("attrs") or {}).get("job"),
            "node": s.get("node"),
            "duration_ms": round((s.get("duration_s") or 0.0) * 1e3, 3),
            "abandoned": bool((s.get("attrs") or {}).get("abandoned")),
            "status": s.get("status"),
        }
        for s in by_name.get("clerk.job", [])
    ]
    clerk_jobs.sort(key=lambda j: j["duration_ms"], reverse=True)

    reveal = None
    for s in by_name.get("recipient.reveal", []):
        attrs = s.get("attrs") or {}
        reveal = {
            "status": s.get("status"),
            "duration_ms": round((s.get("duration_s") or 0.0) * 1e3, 3),
            "output_sha256": attrs.get("output.sha256"),
            "dim": attrs.get("output.dim"),
        }

    # round ledger: CAS state transitions recorded by server/lifecycle.py
    states = sorted(
        (
            {
                "state": r.get("state"),
                "time_s": round(spool.norm_time(r), 6),
                "node": r.get("node"),
                **({"reason": r["reason"]} if r.get("reason") else {}),
                **({"tenant": r["tenant"]} if r.get("tenant") else {}),
            }
            for r in spool.rounds
            if r.get("aggregation") == agg_id
        ),
        key=lambda r: r["time_s"],
    )
    tenant = next((r["tenant"] for r in states if r.get("tenant")), None)
    epoch = next(
        (
            {"schedule": e.get("schedule"), "epoch": e.get("epoch"),
             "action": e.get("action")}
            for e in spool.epochs if e.get("aggregation") == agg_id
        ),
        None,
    )

    span_times = [spool.norm_time(s) for s in spans]
    duration_s = (
        max(
            t + (s.get("duration_s") or 0.0)
            for t, s in zip(span_times, spans)
        ) - min(span_times)
        if spans else 0.0
    )

    reissued = spool.counter_totals("server.job.reissued").get(
        "server.job.reissued", 0)
    hedged = spool.counter_totals("server.job.hedged").get(
        "server.job.hedged", 0)

    return {
        "aggregation": agg_id,
        "tenant": tenant,
        "epoch": epoch,
        "traces": sorted(traces),
        # only processes whose spans are IN this round (a spool can hold
        # many rounds from many fleets; e.g. the scaling drill's baseline
        # rung workers must not count toward the top rung's story)
        "processes": sorted({
            f"{s.get('node') or 'proc'}[{s.get('pid')}]" for s in spans
        }),
        "duration_s": round(duration_s, 6),
        "states": states,
        "final_state": states[-1]["state"] if states else None,
        "participations": {
            "created": len(created),
            "replayed": replays,
            "conflicts": conflicts,
            "participant_spans": _count("participant.participate"),
            "resumed": _count("participant.resume"),
        },
        "retries": {"total": retries, "by_cause": retry_causes},
        "sheds": len(sheds),
        "lease_reissues": reissued,
        "hedged_jobs": hedged,
        "faults": faults,
        "clerk_jobs": clerk_jobs,
        "reveal": reveal,
        "spans": len(spans),
        "torn_lines": spool.torn,
    }


def format_explain(report: dict) -> str:
    """Operator-facing text rendering of an :func:`explain` report."""
    lines = []
    agg = report["aggregation"]
    lines.append(f"round {agg}")
    if report.get("tenant"):
        lines.append(f"  tenant: {report['tenant']}")
    if report.get("epoch"):
        e = report["epoch"]
        lines.append(
            f"  epoch: {e.get('schedule')}#{e.get('epoch')}"
            f" ({e.get('action')})")
    lines.append(
        f"  processes: {len(report['processes'])}"
        f" ({', '.join(report['processes'])})")
    lines.append(
        f"  spans: {report['spans']} across"
        f" {len(report['traces'])} trace(s),"
        f" {report['duration_s'] * 1e3:.1f} ms wall")
    if report["states"]:
        story = " -> ".join(
            s["state"] + (f"[{s['reason']}]" if s.get("reason") else "")
            for s in report["states"])
        lines.append(f"  states: {story}")
    p = report["participations"]
    lines.append(
        f"  participations: {p['created']} created"
        f" ({p['replayed']} replayed, {p['conflicts']} conflicts,"
        f" {p['resumed']} resumed)")
    r = report["retries"]
    causes = ", ".join(
        f"{k}={v}" for k, v in sorted(r["by_cause"].items())
        if k not in ("attempt", "recovered", "exhausted"))
    lines.append(
        f"  retries: {r['total']} on round spans"
        f" (fleet-wide attempts={r['by_cause'].get('attempt', 0)}"
        + (f"; {causes}" if causes else "") + ")")
    lines.append(
        f"  sheds: {report['sheds']}   lease reissues:"
        f" {report['lease_reissues']}   hedged: {report['hedged_jobs']}")
    if report["faults"]:
        lines.append(f"  faults injected: {len(report['faults'])}")
        for f in report["faults"][:20]:
            lines.append(
                f"    - {f.get('site')} kind={f.get('kind')}"
                + (f" node={f['node']}" if f.get("node") else ""))
    else:
        lines.append("  faults injected: none recorded")
    if report["clerk_jobs"]:
        lines.append(f"  clerk jobs: {len(report['clerk_jobs'])}")
        for j in report["clerk_jobs"][:10]:
            flags = " ABANDONED" if j["abandoned"] else ""
            lines.append(
                f"    - {j['duration_ms']:.1f} ms"
                f" node={j.get('node')}{flags}")
    rv = report["reveal"]
    if rv:
        lines.append(
            f"  reveal: {rv['status']} in {rv['duration_ms']:.1f} ms"
            + (f" dim={rv['dim']}" if rv.get("dim") else "")
            + (f" sha256={rv['output_sha256']}"
               if rv.get("output_sha256") else ""))
    else:
        lines.append("  reveal: NOT RECORDED")
    if report["torn_lines"]:
        lines.append(
            f"  ({report['torn_lines']} torn spool line(s) skipped)")
    return "\n".join(lines)


def chrome_trace(spool: Spool,
                 agg_or_prefix: Optional[str] = None) -> dict:
    """Merged, clock-normalized Chrome trace of the whole spool (or one
    round's traces) — every process its own pid lane."""
    records = list(spool.procs.values())
    if agg_or_prefix is None:
        records += spool.spans
    else:
        traces = _trace_ids_for(spool, spool.resolve(agg_or_prefix))
        records += [s for s in spool.spans if s.get("trace") in traces]
    return timeline.chrome_trace_from_records(records)
