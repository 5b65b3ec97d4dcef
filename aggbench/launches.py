"""Device events matched to the host range they were launched from.

A ``torch.profiler`` trace ties each device event (kernel, copy, memset)
to the host runtime call that launched it (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ...) by the ``correlation`` both carry under
``args``. An event was launched inside a host range when that call's
start lies within one of the range's occurrences: the matching of
``sda_tpu_torch/utils/traceparse.py::_range_of``, with the ranges merged
and searched by bisection, since a window holds thousands of them.
"""

from __future__ import annotations

import bisect
from typing import Callable, List

from aggbench.traceparse import _NOT_HOST, host_ranges


def launched_inside(trace: dict, name: str) -> Callable[[dict], bool]:
    """-> fn(device event) -> whether the host call that launched it
    started inside a host range named ``name``. An event whose
    ``correlation`` names no host call is not."""
    starts: List[float] = []
    ends: List[float] = []
    for a, b in host_ranges(trace, name):  # sorted: merge the overlaps
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    launched = {}
    for e in trace.get("traceEvents", []):
        corr = (e.get("args") or {}).get("correlation")
        if (corr is not None and e.get("ph") == "X"
                and e.get("cat") not in _NOT_HOST):
            launched[corr] = float(e["ts"])

    def inside(event: dict) -> bool:
        ts = launched.get((event.get("args") or {}).get("correlation"))
        if ts is None:
            return False
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= ends[i]
    return inside
