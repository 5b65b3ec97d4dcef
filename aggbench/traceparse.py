"""Reading a ``torch.profiler`` Chrome trace for the per-layer metrics.

The busy union, the split of device time by kernel name and the union of
host ranges are frozen copies of the arithmetic of
``sda_tpu_torch/utils/traceparse.py`` (``busy_share``,
``device_module_stats``, the range matching of ``device_split``), so a
later change to the program cannot move them.

Device lanes hold the complete ("X") events whose ``cat`` is ``kernel``,
``gpu_memcpy`` or ``gpu_memset``; timestamps and durations are in
microseconds on the host's clock. ``TraceView`` restricts a trace to the
complete rounds of the measured window: the profiler drops device events
at the start of a session, so the metrics read whole rounds only, and a
kernel's time is read only from rounds that hold all of its launches.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: ``cat`` values of the events that occupy a device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: ... and of every event on a device lane (the profiler mirrors host
#: ranges there as ``gpu_user_annotation``)
_NOT_HOST = DEVICE_CATEGORIES + ("gpu_user_annotation",)

Span = Tuple[float, float]


def device_events(trace: dict) -> List[dict]:
    """The trace's device events (kernels, copies, memsets)."""
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
            and "dur" in e]


def host_ranges(trace: dict, name: str) -> List[Span]:
    """Sorted (start, end) of the host events named ``name`` (such as a
    ``record_function`` range), device lanes' mirrors left out."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("name") == name
                  and e.get("cat") not in _NOT_HOST and "dur" in e)


def union_us(spans: Iterable[Span], lo: float = float("-inf"),
             hi: float = float("inf")) -> float:
    """Length of the union of ``spans``, clipped to [lo, hi]."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted((max(a, lo), min(b, hi)) for a, b in spans):
        if end <= start:
            continue
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def gaps(spans: Iterable[Span], lo: float, hi: float) -> List[Span]:
    """The intervals of [lo, hi] that no span covers."""
    out, cursor = [], lo
    for start, end in sorted(spans):
        if start > cursor:
            out.append((cursor, min(start, hi)))
        cursor = max(cursor, end)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]


def short_name(event: dict) -> str:
    """A kernel's name without its return type and parameter list; a copy
    or memset keeps its name, prefixed by its ``cat``."""
    name = event.get("name", "")
    if event.get("cat") != "kernel":
        return f"{event.get('cat')}: {name}"
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return name.split("(", 1)[0].strip() or event.get("name", "")


def by_name(events: Iterable[dict]) -> Dict[str, float]:
    """{short name: total device microseconds}."""
    out: Dict[str, float] = {}
    for e in events:
        key = short_name(e)
        out[key] = out.get(key, 0.0) + float(e["dur"])
    return out


class TraceView:
    """A trace restricted to the rounds of the measured window.

    ``round_range``: the name of the host range the harness opens around
    each measured round; ``cell``: what the metric readers need of the
    cell (its configuration, its traffic, the tiles of one round)."""

    def __init__(self, trace: dict, round_range: str, cell: dict):
        self.cell = cell
        self.rounds = host_ranges(trace, round_range)
        self.lo = self.rounds[0][0] if self.rounds else 0.0
        self.hi = self.rounds[-1][1] if self.rounds else 0.0
        self._trace = trace
        self.device = [e for e in device_events(trace)
                       if self.lo <= float(e["ts"]) <= self.hi]

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    def busy_us(self) -> float:
        """The union of device events over the window."""
        return union_us(((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                         for e in self.device), self.lo, self.hi)

    def range_us(self, name: str) -> float:
        """The union of the host ranges named ``name`` over the window."""
        return union_us(host_ranges(self._trace, name), self.lo, self.hi)

    def kernel_us(self, hints: Sequence[str]) -> Tuple[float, int]:
        """(device microseconds, rounds) of the kernels whose names hold one
        of ``hints``, over the rounds that hold the most launches of them
        (a round that lost events to the profiler is left out); (0, 0) when
        no round launched one."""
        per_round = [[0, 0.0] for _ in self.rounds]
        starts = [a for a, _ in self.rounds]
        for e in self.device:
            if e.get("cat") != "kernel" or not any(
                    h in e.get("name", "") for h in hints):
                continue
            ts = float(e["ts"])
            i = _last_at_or_before(starts, ts)
            if i is not None and ts <= self.rounds[i][1]:
                per_round[i][0] += 1
                per_round[i][1] += float(e["dur"])
        most = max((n for n, _ in per_round), default=0)
        if most == 0:
            return 0.0, 0
        kept = [us for n, us in per_round if n == most]
        return sum(kept), len(kept)

    def top_device_ops(self, limit: int = 10) -> List[list]:
        """[[name, seconds]] of the device operations that took most time
        in the window."""
        ranked = sorted(by_name(self.device).items(), key=lambda kv: -kv[1])
        return [[name, us * 1e-6] for name, us in ranked[:limit]]

    def idle_gaps(self, limit: int = 10) -> List[list]:
        """[[what the host was doing, seconds]] of the longest device idle
        gaps in the window: the innermost host event around each gap's
        middle."""
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in self.device]
        longest = sorted(gaps(spans, self.lo, self.hi),
                         key=lambda g: g[0] - g[1])[:limit]
        host = [e for e in self._trace.get("traceEvents", [])
                if e.get("ph") == "X" and "dur" in e
                and e.get("cat") not in _NOT_HOST
                and e.get("cat") != "Trace"]
        out = []
        for a, b in longest:
            mid = (a + b) / 2
            around = [e for e in host if float(e["ts"]) <= mid
                      <= float(e["ts"]) + float(e["dur"])]
            inner = min(around, key=lambda e: float(e["dur"]), default=None)
            out.append([inner.get("name", "?") if inner else "no host event",
                        (b - a) * 1e-6])
        return out


def _last_at_or_before(starts: List[float], ts: float) -> Optional[int]:
    i = bisect.bisect_right(starts, ts) - 1
    return i if i >= 0 else None
