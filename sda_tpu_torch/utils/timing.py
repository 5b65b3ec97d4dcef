"""Per-phase timing and PyTorch profiler hooks — counterpart of
``sda_tpu/utils/timing.py``.

Every protocol phase (participant mask/share/encrypt, clerk
decrypt/combine/encrypt, recipient reconstruct/unmask, server snapshot
steps) runs under ``timed_phase``, which

- accumulates wall-clock stats in a process-global registry
  (``phase_report()`` returns them; smoke runs and tests read it), and
- opens a ``torch.profiler.record_function`` range so the phase shows up
  as a named span on the trace timeline when a profiler session is active
  (``profile_trace`` context manager, which exports a Chrome trace). A
  process that has not imported torch has no such session, and the phase
  does not import it.

Timing costs one ``perf_counter`` pair + dict update per phase — noise next
to any device math, safe to leave on permanently.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator

from .._lazy import torch


@dataclass
class PhaseStat:
    count: int = 0
    total_s: float = 0.0
    min_s: float = field(default=float("inf"))
    max_s: float = 0.0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        self.min_s = min(self.min_s, seconds)
        self.max_s = max(self.max_s, seconds)

    def to_obj(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "total_s": self.total_s,
            "mean_s": self.mean_s,
            "min_s": self.min_s,
            "max_s": self.max_s,
        }


_lock = threading.Lock()
_stats: Dict[str, PhaseStat] = {}


@contextlib.contextmanager
def timed_phase(name: str) -> Iterator[None]:
    """Time a protocol phase, annotate it on any active profiler trace, and
    record it as a span in the distributed-tracing layer
    (``sda_tpu_torch.obs``) so the phase joins the round's causal timeline,
    parented to whatever span is active on this thread (an HTTP server
    span, a client role span, ...)."""
    from .. import obs

    # a process that never imported torch runs no profiler session
    loaded = sys.modules.get("torch")
    start = time.perf_counter()
    try:
        with (loaded.profiler.record_function(name) if loaded is not None
              else contextlib.nullcontext()):
            with obs.span(name):
                yield
    finally:
        elapsed = time.perf_counter() - start
        with _lock:
            stat = _stats.get(name)
            if stat is None:
                stat = _stats[name] = PhaseStat()
            stat.add(elapsed)


def phase_report() -> Dict[str, Dict[str, float]]:
    """Snapshot of all phase stats since the last reset, keyed by phase."""
    with _lock:
        return {name: stat.to_obj() for name, stat in sorted(_stats.items())}


def reset_phase_report() -> None:
    with _lock:
        _stats.clear()


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Capture a PyTorch profiler trace (host ranges, with ``timed_phase``
    spans, and the CUDA timeline when a card is present) and export it as
    ``logdir/trace.json`` in Chrome trace format."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
