"""Per-tenant SLOs and multi-window burn-rate alerts over the round ledger.

The scheduler mints recurring rounds per tenant (``service/scheduler.py``)
and the lifecycle ledger records every state transition into the flight
recorder spools; this module evaluates those outcomes against Service
Level Objectives the way the SRE workbook prescribes (Beyer et al.,
*Site Reliability Engineering*, 2016, ch. 4/alerting): an **availability
SLO** (fraction of rounds that reach ``revealed``) and an optional
**latency SLO** (rounds revealing within a target), alerted on via
**multi-window burn rates** — the error-budget spend *rate*, where 1.0
means exactly exhausting the budget over the SLO period. A page fires
only when BOTH a short and a long window burn above the factor: the
short window makes the alert fast, the long window keeps a single
transient blip from paging at 3am. The classic pairs ride as defaults:
5m/1h at 14.4x (2% of a 30-day budget in an hour) and 30m/6h at 6x.

Rounds come from ``sda-trace slo`` reading spools
(:func:`rounds_from_spool`), but the evaluator takes plain dicts so
tests and future live endpoints can feed it directly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

#: States that settle a round (mirrors server/lifecycle.py TERMINAL_STATES
#: plus the pre-reveal resting states a dead fleet can leave behind).
GOOD_FINAL = ("revealed",)
BAD_FINAL = ("failed", "expired")

#: (short_window_s, long_window_s, burn_factor) — page when BOTH windows
#: burn the error budget faster than ``factor``x.
DEFAULT_WINDOWS: Tuple[Tuple[float, float, float], ...] = (
    (300.0, 3600.0, 14.4),
    (1800.0, 21600.0, 6.0),
)


class SloPolicy:
    """One tenant-class policy: availability target plus optional reveal
    latency target, alerted over multi-window burn rates."""

    def __init__(
        self,
        availability_target: float = 0.99,
        latency_target_s: Optional[float] = None,
        windows: Sequence[Tuple[float, float, float]] = DEFAULT_WINDOWS,
    ):
        if not 0.0 < availability_target < 1.0:
            raise ValueError("availability_target must be in (0, 1)")
        self.availability_target = availability_target
        self.latency_target_s = latency_target_s
        self.windows = tuple(windows)

    @property
    def error_budget(self) -> float:
        return 1.0 - self.availability_target


def rounds_from_spool(spool) -> List[dict]:
    """Collapse the spooled round ledger into one outcome dict per round:
    ``{aggregation, tenant, end_s, duration_s, final_state, good, states}``.
    ``good`` is None while a round is still in flight (in-flight rounds
    spend no error budget either way — they are excluded from rates)."""
    by_agg: Dict[str, List[dict]] = {}
    for rec in spool.rounds:
        agg = rec.get("aggregation")
        if agg:
            by_agg.setdefault(agg, []).append(rec)
    out = []
    for agg, recs in by_agg.items():
        recs = sorted(recs, key=spool.norm_time)
        final = recs[-1].get("state")
        start_s = spool.norm_time(recs[0])
        end_s = spool.norm_time(recs[-1])
        tenant = next(
            (r["tenant"] for r in recs if r.get("tenant")), None)
        good: Optional[bool]
        if final in GOOD_FINAL:
            good = True
        elif final in BAD_FINAL:
            good = False
        else:
            good = None  # still in flight when the fleet died
        out.append({
            "aggregation": agg,
            "tenant": tenant or "?",
            "end_s": end_s,
            "duration_s": end_s - start_s,
            "final_state": final,
            "good": good,
            "states": [r.get("state") for r in recs],
        })
    out.sort(key=lambda r: r["end_s"])
    return out


def _window_rate(
    rounds: List[dict], now_s: float, window_s: float,
    latency_target_s: Optional[float],
) -> Tuple[int, int]:
    """``(bad, total)`` among settled rounds ending inside the window.
    A latency target makes a slow-but-revealed round count as bad — the
    latency SLO shares the availability budget (one page, one budget)."""
    bad = 0
    total = 0
    for r in rounds:
        if r["good"] is None or r["end_s"] < now_s - window_s:
            continue
        total += 1
        slow = (
            latency_target_s is not None
            and r["good"]
            and r["duration_s"] > latency_target_s
        )
        if not r["good"] or slow:
            bad += 1
    return bad, total


def evaluate(
    rounds: List[dict],
    policy: Optional[SloPolicy] = None,
    now_s: Optional[float] = None,
) -> dict:
    """Per-tenant SLO report with burn rates and page-worthy alerts.

    ``now_s`` defaults to the newest settled round's end time — the
    forensics case evaluates a spool written by processes that are all
    dead, so "now" is the end of recorded history, not the wall clock.
    """
    policy = policy or SloPolicy()
    settled = [r for r in rounds if r["good"] is not None]
    if now_s is None:
        now_s = max((r["end_s"] for r in settled), default=0.0)
    tenants: Dict[str, List[dict]] = {}
    for r in rounds:
        tenants.setdefault(r["tenant"], []).append(r)
    report = {
        "availability_target": policy.availability_target,
        "latency_target_s": policy.latency_target_s,
        "now_s": now_s,
        "tenants": {},
        "alerts": [],
    }
    for tenant, trounds in sorted(tenants.items()):
        tsettled = [r for r in trounds if r["good"] is not None]
        good = sum(1 for r in tsettled if r["good"])
        total = len(tsettled)
        windows = []
        paging = []
        for short_s, long_s, factor in policy.windows:
            rates = {}
            burns = {}
            for label, win in (("short", short_s), ("long", long_s)):
                bad, n = _window_rate(
                    trounds, now_s, win, policy.latency_target_s)
                rate = (bad / n) if n else 0.0
                rates[label] = {"bad": bad, "total": n,
                                "error_rate": round(rate, 6)}
                burns[label] = (
                    rate / policy.error_budget
                    if policy.error_budget else 0.0
                )
            page = (
                burns["short"] >= factor and burns["long"] >= factor
            )
            windows.append({
                "short_s": short_s,
                "long_s": long_s,
                "factor": factor,
                "short": dict(rates["short"],
                              burn=round(burns["short"], 3)),
                "long": dict(rates["long"],
                             burn=round(burns["long"], 3)),
                "page": page,
            })
            if page:
                paging.append(
                    f"{tenant}: burn {burns['short']:.1f}x over"
                    f" {short_s:.0f}s AND {burns['long']:.1f}x over"
                    f" {long_s:.0f}s (>= {factor}x)")
        report["tenants"][tenant] = {
            "rounds": len(trounds),
            "settled": total,
            "good": good,
            "in_flight": len(trounds) - total,
            "availability": round(good / total, 6) if total else None,
            "met": (good / total >= policy.availability_target)
            if total else None,
            "windows": windows,
        }
        report["alerts"].extend(paging)
    return report


def format_slo(report: dict) -> str:
    """Operator-facing text rendering of an :func:`evaluate` report."""
    lines = [
        "slo: availability >= %.4g%%" % (
            report["availability_target"] * 100)
        + (
            ", reveal latency <= %.3gs" % report["latency_target_s"]
            if report.get("latency_target_s") else ""
        )
    ]
    for tenant, t in report["tenants"].items():
        avail = (
            "%.4g%%" % (t["availability"] * 100)
            if t["availability"] is not None else "n/a"
        )
        met = (
            "MET" if t["met"] else "VIOLATED"
        ) if t["met"] is not None else "no settled rounds"
        lines.append(
            f"  {tenant}: {t['good']}/{t['settled']} good"
            f" ({t['in_flight']} in flight), availability {avail}"
            f" — {met}")
        for w in t["windows"]:
            flag = "PAGE" if w["page"] else "ok"
            lines.append(
                "    %5.0fs/%.0fs burn %.2fx/%.2fx (factor %.1fx) %s"
                % (w["short_s"], w["long_s"], w["short"]["burn"],
                   w["long"]["burn"], w["factor"], flag))
    if report["alerts"]:
        lines.append("  ALERTS:")
        for a in report["alerts"]:
            lines.append(f"    - {a}")
    else:
        lines.append("  alerts: none")
    return "\n".join(lines)
