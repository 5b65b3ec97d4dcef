"""Parse ``torch.profiler`` Chrome traces for device-side kernel durations —
counterpart of ``sda_tpu/utils/traceparse.py``, which reads the
``/device:TPU:0`` lanes of ``jax.profiler`` traces.

The bench's round times come from host clocks ending in a synchronize
(``utils/benchtime.py``); this parser is the independent device-time
cross-check: profile a few rounds under ``torch.profiler`` with the CUDA
activity, export the Chrome trace (``export_chrome_trace`` or
``tensorboard_trace_handler``), and read the device lanes: the processes
whose complete ("X") events have a ``cat`` of ``kernel``, ``gpu_memcpy``
or ``gpu_memset``, one event per kernel or copy (name = the kernel's
name, ``dur`` in microseconds). A CPU-only capture has no such lane —
callers treat an empty result as "no device lane", not an error. In a
torch built for the CPU, profile with ``ProfilerActivity.CPU`` alone: the
CUDA activity hangs there.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Dict, Optional

#: ``cat`` values of the events that occupy a device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: ... and of every event on a device lane (the profiler mirrors host
#: ranges there as ``gpu_user_annotation``)
_NOT_HOST = DEVICE_CATEGORIES + ("gpu_user_annotation",)


def load_latest_trace(logdir: str) -> Optional[dict]:
    """The most recent ``*.json`` / ``*.json.gz`` trace under ``logdir``."""
    files = [f for pattern in ("*.json", "*.json.gz")
             for f in glob.glob(os.path.join(logdir, "**", pattern),
                                recursive=True)]
    if not files:
        return None
    newest = max(files, key=os.path.getmtime)
    opener = gzip.open if newest.endswith(".gz") else open
    with opener(newest, "rt") as f:
        return json.load(f)


def _device_events(trace: dict):
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
            and "dur" in e]


def device_lane_pids(trace: dict) -> Dict[int, str]:
    """{pid: lane name} of the trace processes that hold device events
    (the name from the trace's ``process_name`` metadata, when present)."""
    pids = {e["pid"] for e in _device_events(trace)}
    names = {e["pid"]: (e.get("args") or {}).get("name", "")
             for e in trace.get("traceEvents", [])
             if e.get("ph") == "M" and e.get("name") == "process_name"
             and e.get("pid") in pids}
    return {pid: names.get(pid) or f"device {pid}" for pid in sorted(pids)}


def device_module_stats(trace: dict, name_hint: str = "") -> Dict[str, dict]:
    """{kernel name: {count, total_us, median_us}} for the device events
    whose name contains ``name_hint``."""
    durs: Dict[str, list] = {}
    for e in _device_events(trace):
        if name_hint in e.get("name", ""):
            durs.setdefault(e["name"], []).append(float(e["dur"]))
    out = {}
    for name, ds in durs.items():
        ds.sort()
        n = len(ds)
        median = ds[n // 2] if n % 2 else (ds[n // 2 - 1] + ds[n // 2]) / 2
        out[name] = {
            "count": n,
            "total_us": round(sum(ds), 3),
            "median_us": round(median, 3),
        }
    return out


def dominant_module(stats: Dict[str, dict]) -> Optional[str]:
    """The kernel name carrying the most total device time."""
    if not stats:
        return None
    return max(stats, key=lambda n: stats[n]["total_us"])


def busy_share(trace: dict) -> Optional[float]:
    """The union of device-event time over the traced window, or None
    when the trace has no device lane. The window runs from the first
    complete event's start to the last one's end, host events included
    (the profiler's own session event, ``cat`` "Trace", excluded)."""
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in _device_events(trace))
    if not device:
        return None
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in trace.get("traceEvents", [])
             if e.get("ph") == "X" and e.get("cat") != "Trace" and "ts" in e]
    window = max(end for _, end in spans) - min(start for start, _ in spans)
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in device:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return busy / window if window > 0 else None


def _range_of(trace: dict, ranges: Dict[str, str]):
    """-> fn(device event) -> the first group of ``ranges`` ({group: the
    name of a host ``record_function`` range}) one of whose ranges
    encloses the host call that launched the event (matched by the
    events' ``correlation``), or None."""
    events = trace.get("traceEvents", [])
    spans = {group: sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in events
                           if e.get("ph") == "X" and e.get("name") == name
                           and e.get("cat") not in _NOT_HOST and "dur" in e)
             for group, name in ranges.items()}
    launched = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if (e.get("ph") == "X" and corr is not None
                and e.get("cat") not in _NOT_HOST):
            launched[corr] = float(e["ts"])

    def group_of(e):
        ts = launched.get((e.get("args") or {}).get("correlation"))
        return next((g for g, sp in spans.items() if ts is not None
                     and any(a <= ts <= b for a, b in sp)), None)
    return group_of


def device_split(trace: dict, kernels: Dict[str, str],
                 ranges: Dict[str, str]) -> Dict[str, float]:
    """Device time (us) of a trace split into groups: a device event goes
    to the first group of ``kernels`` ({group: a substring of the kernel's
    name}) its name holds, else to the first group of ``ranges`` ({group:
    the name of a host ``record_function`` range, such as a
    ``utils.timed_phase``}) one of whose ranges encloses the host call
    that launched it (matched by the events' ``correlation``), else to
    "rest". Every group is in the result, "rest" included."""
    group_of = _range_of(trace, ranges)
    out = dict.fromkeys([*kernels, *ranges, "rest"], 0.0)
    for e in _device_events(trace):
        name, dur = e.get("name", ""), float(e["dur"])
        group = next((g for g, hint in kernels.items() if hint in name), None)
        if group is None:
            group = group_of(e) or "rest"
        out[group] += dur
    return out


def device_events_in(trace: dict, ranges: Dict[str, str]
                     ) -> Dict[str, Dict[str, int]]:
    """{group: {device event name: count}} of the device events (kernels,
    copies, memsets; a copy's or memset's name prefixed by its ``cat``)
    launched inside the host ranges of each group of ``ranges`` ({group:
    the name of a ``record_function`` range}), as ``device_split``
    attributes them. Every group is in the result."""
    group_of = _range_of(trace, ranges)
    out = {group: {} for group in ranges}
    for e in _device_events(trace):
        group = group_of(e)
        if group is None:
            continue
        cat = e.get("cat")
        name = e.get("name", "")
        key = name if cat == "kernel" else f"{cat}: {name}"
        out[group][key] = out[group].get(key, 0) + 1
    return out


def overlaps(trace: dict, first: str, second: str) -> Dict[str, float]:
    """How the device events named like ``second`` overlap in time those
    named like ``first`` (substrings of an event's name, a copy's or
    memset's prefixed by its ``cat`` as in ``device_events_in``; on
    different streams two events can run at once): {"first": count,
    "second": count, "overlapping": the ``second`` events that overlap
    some ``first`` event, "overlap_us": their time inside ``first``
    events, "second_us": the ``second`` events' time}."""
    def spans(hint):
        out = []
        for e in _device_events(trace):
            cat, name = e.get("cat"), e.get("name", "")
            key = name if cat == "kernel" else f"{cat}: {name}"
            if hint in key:
                start = float(e["ts"])
                out.append((start, start + float(e["dur"])))
        return sorted(out)

    a, b = spans(first), spans(second)
    overlapping, inside = 0, 0.0
    for start, end in b:
        cut = sum(max(0.0, min(end, a_end) - max(start, a_start))
                  for a_start, a_end in a)
        if cut > 0:
            overlapping += 1
            inside += min(cut, end - start)
    return {"first": len(a), "second": len(b), "overlapping": overlapping,
            "overlap_us": inside,
            "second_us": sum(end - start for start, end in b)}
