"""Flight recorder: durable, crash-safe span + metric spools.

Everything the span layer (``trace.py``) and the metrics registry
(``utils/metrics.py``) know lives in per-process memory: a fleet worker's
ring buffer, counters and clock anchors die with the process — exactly
when an operator most needs them (a SIGKILLed worker, a drained fleet, a
round that degraded an hour ago). This module is the durable half of the
observability plane, in the Dapper mold (Sigelman et al., 2010): every
role — server/fleet workers, the async HTTP plane, scheduler ticks,
clients — spools finished spans, chaos fault marks, round-ledger entries
and periodic metric snapshots into bounded JSONL **segments** on disk,
so ``sda-trace explain`` (``obs/forensics.py``) can reconstruct a round's
causal story after every process that served it has exited.

Disk discipline (the jsonfs rules, ``server/jsonfs.py``):

- the **active** segment is ``spool-<node>-<pid>-<seq>.jsonl.part``, one
  JSON record per line, flushed per write — a SIGKILL loses at most the
  current torn line (readers skip it);
- **rotation** (size or age cap) seals the active segment by fsync +
  atomic rename to ``.jsonl`` — a reader never observes a half-renamed
  segment;
- **eviction** keeps the whole spool directory under a byte cap by
  deleting the oldest *sealed* segments first (concurrent evictors
  tolerate each other's unlinks).

Every segment opens with a ``proc`` record carrying the process's
wall-clock + ``perf_counter`` pair sampled back-to-back — the clock
anchor ``timeline.clock_offsets`` uses to merge segments from N
processes onto one timeline even when their monotonic epochs (and a
stepped wall clock) disagree.

Opt-in via ONE knob: the ``SDA_FLIGHT_RECORDER=DIR`` environment
variable (inherited by spawned fleet workers) or the ``sdad
--flight-recorder DIR`` flag. Recording changes no protocol bytes and
costs one dict + one buffered line write per span; the overhead is
benched (``loadgen/recorderbench.py``) and regression-gated in ci.sh.
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional

from . import trace

#: THE opt-in knob: spool directory. Unset = recorder off everywhere.
RECORDER_DIR_ENV = "SDA_FLIGHT_RECORDER"
#: Rotation caps and snapshot cadence (advanced tuning; the DIR knob is
#: the only one a drill needs).
SEGMENT_BYTES_ENV = "SDA_RECORDER_SEGMENT_BYTES"
SEGMENT_AGE_ENV = "SDA_RECORDER_SEGMENT_AGE_S"
MAX_BYTES_ENV = "SDA_RECORDER_MAX_BYTES"
SNAPSHOT_ENV = "SDA_RECORDER_SNAPSHOT_S"

DEFAULT_SEGMENT_BYTES = 1 << 20  # 1 MiB per segment
DEFAULT_SEGMENT_AGE_S = 30.0
DEFAULT_MAX_BYTES = 64 << 20  # 64 MiB per spool directory
DEFAULT_SNAPSHOT_S = 1.0

SEGMENT_SUFFIX = ".jsonl"
ACTIVE_SUFFIX = ".jsonl.part"


def _jsonable_attrs(attributes: dict) -> dict:
    return {k: trace._jsonable(v) for k, v in (attributes or {}).items()}


def span_record(span: trace.Span) -> dict:
    """Serialize one finished :class:`~sda_tpu_torch.obs.trace.Span` into the
    spool record shape (``"t": "span"``). Events ride inline; attribute
    values go through the same jsonable coercion as the Chrome export."""
    rec = {
        "t": "span",
        "name": span.name,
        "trace": span.trace_id,
        "span": span.span_id,
        "parent": span.parent_id,
        "kind": span.kind,
        "status": span.status,
        "start_s": span.start_s,
        "mono_s": span.start_mono,
        "duration_s": span.duration_s,
        "thread": span.thread,
        "attrs": _jsonable_attrs(span.attributes),
    }
    if span.events:
        rec["events"] = [
            {"name": ev["name"], "time_s": ev["time_s"],
             "attrs": _jsonable_attrs(ev["attributes"])}
            for ev in span.events
        ]
    return rec


class FlightRecorder:
    """One process's spool writer. Thread-safe; never raises out of
    ``record`` (observability must not become a failure mode — write
    errors are counted in ``dropped`` and reported, not thrown)."""

    def __init__(
        self,
        root: str,
        *,
        node_id: Optional[str] = None,
        segment_bytes: int = DEFAULT_SEGMENT_BYTES,
        segment_age_s: float = DEFAULT_SEGMENT_AGE_S,
        max_bytes: int = DEFAULT_MAX_BYTES,
        snapshot_s: float = 0.0,
    ):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.node_id = node_id or ""
        self.pid = os.getpid()
        self.segment_bytes = max(4096, int(segment_bytes))
        self.segment_age_s = float(segment_age_s)
        self.max_bytes = max(self.segment_bytes, int(max_bytes))
        self.snapshot_s = float(snapshot_s)
        self.dropped = 0
        self.records = 0
        self._lock = threading.Lock()
        self._seq = 0
        self._fh = None
        self._active_path: Optional[str] = None
        self._segment_bytes_written = 0
        self._segment_opened_mono = 0.0
        self._closed = False
        self._stop = threading.Event()
        self._snap_thread: Optional[threading.Thread] = None
        with self._lock:
            self._open_segment_locked()
        if self.snapshot_s > 0:
            self._snap_thread = threading.Thread(
                target=self._snapshot_loop, name="flight-recorder-snap",
                daemon=True)
            self._snap_thread.start()

    # -- segment lifecycle -------------------------------------------------
    def _stem(self) -> str:
        node = self.node_id or "p"
        return f"spool-{node}-{self.pid}-{self._seq:06d}"

    def _open_segment_locked(self) -> None:
        self._seq += 1
        self._active_path = os.path.join(
            self.root, self._stem() + ACTIVE_SUFFIX)
        self._fh = open(self._active_path, "w", encoding="utf-8")
        self._segment_bytes_written = 0
        self._segment_opened_mono = time.perf_counter()
        # the clock anchor: wall + mono sampled back-to-back, first line
        # of EVERY segment, so any single segment is mergeable on its own
        anchor = {
            "t": "proc",
            "pid": self.pid,
            "node": self.node_id or None,
            "host": socket.gethostname(),
            "wall_s": time.time(),
            "mono_s": time.perf_counter(),
            "seq": self._seq,
        }
        self._write_locked(anchor)

    def _seal_segment_locked(self) -> None:
        if self._fh is None:
            return
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            sealed = self._active_path[: -len(ACTIVE_SUFFIX)] + SEGMENT_SUFFIX
            os.replace(self._active_path, sealed)
        except OSError:
            self.dropped += 1
        self._fh = None
        self._active_path = None

    def _write_locked(self, obj: dict) -> None:
        line = json.dumps(obj, separators=(",", ":"), default=str) + "\n"
        try:
            self._fh.write(line)
            self._fh.flush()  # SIGKILL-safe: bytes reach the kernel now
        except (OSError, ValueError, AttributeError):
            self.dropped += 1
            return
        self._segment_bytes_written += len(line)
        self.records += 1

    def _maybe_rotate_locked(self) -> None:
        if self._segment_bytes_written < self.segment_bytes and (
            time.perf_counter() - self._segment_opened_mono
        ) < self.segment_age_s:
            return
        self._seal_segment_locked()
        self._evict()
        self._open_segment_locked()

    def _evict(self) -> None:
        """Drop the oldest SEALED segments (any process's) until the
        directory is under the byte cap. Active ``.part`` files are never
        evicted — a writer's open segment is its own liveness token."""
        try:
            entries = []
            total = 0
            for name in os.listdir(self.root):
                path = os.path.join(self.root, name)
                try:
                    st = os.stat(path)
                except OSError:
                    continue  # a concurrent evictor/sealer won the race
                total += st.st_size
                if name.endswith(SEGMENT_SUFFIX):
                    entries.append((st.st_mtime, name, path, st.st_size))
            entries.sort()
            while total > self.max_bytes and entries:
                _, _, path, size = entries.pop(0)
                try:
                    os.unlink(path)
                except OSError:
                    pass
                total -= size
        except OSError:
            pass

    # -- recording ---------------------------------------------------------
    def record(self, obj: dict) -> None:
        """Append one record. Stamps ``wall_s``/``mono_s`` when absent,
        rotates on the size/age caps. Never raises."""
        if self._closed:
            return
        rec = dict(obj)
        rec.setdefault("wall_s", time.time())
        rec.setdefault("mono_s", time.perf_counter())
        with self._lock:
            if self._closed or self._fh is None:
                return
            self._write_locked(rec)
            self._maybe_rotate_locked()

    def record_span(self, span: trace.Span) -> None:
        self.record(span_record(span))

    def record_metrics(self, reason: str = "interval") -> None:
        """Spool one consistent metrics snapshot — counters, gauges, and
        histograms WITH bucket boundaries (``utils/metrics.snapshot()``,
        the same ``le`` strings the ``/metrics`` scrape emits)."""
        from ..utils import metrics

        snap = metrics.snapshot()
        snap["t"] = "metrics"
        snap["reason"] = reason
        snap["node"] = self.node_id or None
        snap["pid"] = self.pid
        self.record(snap)

    def _snapshot_loop(self) -> None:
        while not self._stop.wait(self.snapshot_s):
            try:
                self.record_metrics()
            except Exception:  # pragma: no cover - defensive
                self.dropped += 1

    # -- teardown / introspection -----------------------------------------
    def close(self) -> None:
        """Final metrics snapshot, then seal the active segment. Safe to
        call twice; called by the atexit hook on clean exits (a SIGKILL
        skips it — that is what the periodic snapshots are for)."""
        if self._closed:
            return
        self._stop.set()
        try:
            self.record_metrics(reason="close")
        except Exception:
            pass
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._seal_segment_locked()
        if self._snap_thread is not None:
            self._snap_thread.join(timeout=2.0)

    def report(self) -> dict:
        with self._lock:
            return {
                "root": self.root,
                "node": self.node_id or None,
                "pid": self.pid,
                "records": self.records,
                "dropped": self.dropped,
                "segments_written": self._seq,
                "active_segment": self._active_path,
            }


# -- process-global installation --------------------------------------------

_install_lock = threading.Lock()
_installed: Optional[FlightRecorder] = None


def installed() -> Optional[FlightRecorder]:
    """The process's active recorder, or None (the common case)."""
    return _installed


def install(root: str, *, node_id: Optional[str] = None,
            **caps) -> FlightRecorder:
    """Create a recorder over ``root``, hook it into the span layer
    (``trace.set_span_sink``), and register the atexit seal. Idempotent
    per-process: installing while installed returns the existing
    recorder (one process, one spool writer)."""
    global _installed
    with _install_lock:
        if _installed is not None:
            return _installed
        rec = FlightRecorder(root, node_id=node_id, **caps)
        trace.set_span_sink(rec.record_span)
        atexit.register(rec.close)
        _installed = rec
        return rec


def uninstall() -> None:
    """Seal and detach the process recorder (test hygiene)."""
    global _installed
    with _install_lock:
        rec = _installed
        _installed = None
        trace.set_span_sink(None)
        if rec is not None:
            rec.close()


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw.strip() else default
    except ValueError:
        return default


def maybe_install_from_env(
    node_id: Optional[str] = None,
) -> Optional[FlightRecorder]:
    """Install the recorder iff ``SDA_FLIGHT_RECORDER`` names a spool
    directory — the one-knob opt-in every role entry point calls
    (``sdad``, ``sda-sim``, ``sda-fleet``). No env var, no recorder, no
    cost beyond this lookup."""
    root = os.environ.get(RECORDER_DIR_ENV, "").strip()
    if not root:
        return None
    return install(
        root,
        node_id=node_id,
        segment_bytes=int(_env_float(SEGMENT_BYTES_ENV,
                                     DEFAULT_SEGMENT_BYTES)),
        segment_age_s=_env_float(SEGMENT_AGE_ENV, DEFAULT_SEGMENT_AGE_S),
        max_bytes=int(_env_float(MAX_BYTES_ENV, DEFAULT_MAX_BYTES)),
        snapshot_s=_env_float(SNAPSHOT_ENV, DEFAULT_SNAPSHOT_S),
    )


def record(obj: dict) -> None:
    """Spool one record if a recorder is installed; no-op otherwise.
    The call sites that narrate the round ledger (``server/lifecycle.py``
    transitions, ``service/scheduler.py`` epoch mints, ``chaos``
    injections) use this — one dict check when the recorder is off."""
    rec = _installed
    if rec is not None:
        rec.record(obj)


def amend_span(span: trace.Span) -> None:
    """Re-spool a span whose duration was fixed up AFTER it closed (the
    async plane's parked long-polls). Readers dedupe by span id keeping
    the longest duration, so the amended record wins."""
    rec = _installed
    if rec is not None:
        rec.record_span(span)


# -- spool reading (shared with forensics) ----------------------------------

def list_segments(root: str) -> List[dict]:
    """Every segment in ``root`` (sealed + active), oldest first, with
    byte sizes — the ``sda-trace segments`` listing."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in sorted(names):
        sealed = name.endswith(SEGMENT_SUFFIX)
        active = name.endswith(ACTIVE_SUFFIX)
        if not sealed and not active:
            continue
        path = os.path.join(root, name)
        try:
            st = os.stat(path)
        except OSError:
            continue
        out.append({
            "segment": name,
            "path": path,
            "bytes": st.st_size,
            "mtime_s": st.st_mtime,
            "sealed": sealed and not active,
        })
    out.sort(key=lambda e: (e["mtime_s"], e["segment"]))
    return out


def iter_records(root: str):
    """Yield ``(record, segment_name)`` for every parseable line in every
    segment. Torn lines (a crash mid-write) and garbage are skipped, and
    tallied: the generator's final yield is ``(None, torn_count)`` —
    use :func:`read_spool` for the friendly wrapper."""
    torn = 0
    for seg in list_segments(root):
        try:
            with open(seg["path"], "r", encoding="utf-8",
                      errors="replace") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        obj = json.loads(line)
                    except ValueError:
                        torn += 1
                        continue
                    if isinstance(obj, dict):
                        yield obj, seg["segment"]
                    else:
                        torn += 1
        except OSError:
            continue
    yield None, torn


def read_spool(root: str):
    """``(records, torn_lines)``: every record (annotated with its
    segment under ``"_segment"``), plus the torn-line tally."""
    records: List[dict] = []
    torn = 0
    for obj, seg in iter_records(root):
        if obj is None:
            torn = seg
            break
        obj["_segment"] = seg
        records.append(obj)
    return records, torn
