"""Fleet health plane: worker heartbeats + the gray-failure detector.

The fleet once recovered held clerking-job leases only through GRACEFUL
drain (SIGTERM → ``release_held_leases``), and the round supervisor only
noticed a missing clerk after the full clerking deadline lapsed. A
SIGKILL'd worker, a kernel panic, or a partition between one worker and
the backend therefore stalled every lease that worker held until its
visibility timeout — minutes of round-stall for a millisecond failure.

This module closes that gap with the standard heartbeat/φ-style failure
detector shape (Bonawitz et al., MLSys 2019 single out exactly this
flakiness as what deployment must absorb):

- every ``sdad`` worker runs a :class:`HeartbeatWriter` that upserts a
  heartbeat row into the SHARED store (``put_worker_heartbeat``) every
  ``interval_s`` — the store arbitrates, so no gossip mesh is needed;
- the :class:`~sda_tpu_torch.server.lifecycle.RoundSweeper` calls
  :func:`sweep_worker_health` each tick: a worker whose heartbeat is
  older than ``suspect_after_s`` is declared **suspect** (still maybe
  alive — straggler hedging may shadow its held jobs, ``server/core.py``),
  older than ``dead_after_s`` is declared **dead** and its held
  clerking-job leases are proactively RECALLED
  (``recall_clerking_job_leases``) so any peer's next poll reissues the
  work immediately instead of waiting out per-job lease expiry;
- both declarations are single-winner CAS transitions on the heartbeat
  row (``transition_worker_state`` — the same conditional-write contract
  as the round-state ``rounds`` table), so N sweeping workers recall a dead
  node's leases exactly once between them;
- a revived worker (partition healed) simply resumes writing ``alive``
  heartbeats — its recalled jobs may have been re-executed by a peer,
  which is safe because result commit is store-arbitrated single-winner
  (duplicate partial sums are impossible; docs/robustness.md).

Observability: ``server.fleet.{alive,suspect,dead}`` gauges,
``server.fleet.suspect``/``server.fleet.dead`` transition counters,
``server.job.lease_recalled`` recall tally, span events per transition,
and the ``fleet_health`` table on ``/statusz`` / ``sda-fleet``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional

from .. import obs
from ..utils import metrics

log = logging.getLogger(__name__)

#: Heartbeat states. ``alive`` is written by the worker itself; the
#: detector CASes ``alive -> suspect -> dead``; a clean drain writes the
#: terminal ``drained`` so the detector never has to diagnose it.
STATES = ("alive", "suspect", "dead", "drained")


def heartbeat_doc(node_id: str, *, state: str = "alive", seq: int = 0,
                  started_at: Optional[float] = None,
                  now: Optional[float] = None) -> dict:
    now = time.time() if now is None else now
    return {
        "node": str(node_id),
        "state": state,
        "ts": now,
        "seq": int(seq),
        "started_at": now if started_at is None else started_at,
    }


class HeartbeatWriter:
    """Background thread: one ``alive`` heartbeat row per ``interval_s``,
    written through the shared job store; a clean stop writes the
    terminal ``drained`` row so peers never diagnose this worker."""

    def __init__(self, store, node_id: str, interval_s: float = 1.0):
        self.store = store
        self.node_id = str(node_id)
        self.interval_s = float(interval_s)
        self._seq = 0
        self._started_at = time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self, now: Optional[float] = None) -> None:
        """One heartbeat, synchronously (also used as the first beat so
        the row exists before the worker serves traffic)."""
        self._seq += 1
        self.store.put_worker_heartbeat(heartbeat_doc(
            self.node_id, seq=self._seq, started_at=self._started_at,
            now=now))

    def start(self) -> "HeartbeatWriter":
        self.beat()
        self._thread = threading.Thread(
            target=self._run, name=f"heartbeat-{self.node_id}", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.beat()
            except Exception:  # a beat lost to a store hiccup is just a
                # stale-r heartbeat; the writer must outlive it
                log.exception("heartbeat write failed; retrying next tick")
                metrics.count("server.fleet.heartbeat_error")

    def stop(self, drained: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if drained:
            try:
                self._seq += 1
                self.store.put_worker_heartbeat(heartbeat_doc(
                    self.node_id, state="drained", seq=self._seq,
                    started_at=self._started_at))
            except Exception:
                log.debug("drained heartbeat write failed", exc_info=True)


def fleet_health_report(store, now: Optional[float] = None) -> dict:
    """The live health table (``/statusz``, ``sda-fleet``): every known
    worker with its state and heartbeat age."""
    now = time.time() if now is None else now
    try:
        docs = store.list_worker_heartbeats()
    except Exception:
        return {}
    return {
        doc["node"]: {
            "state": doc.get("state"),
            "age_s": round(max(0.0, now - float(doc.get("ts") or 0.0)), 3),
            "seq": doc.get("seq"),
        }
        for doc in docs
    }


def suspect_nodes(store, suspect_after_s: float,
                  now: Optional[float] = None,
                  exclude: Optional[str] = None) -> List[str]:
    """Workers that LOOK unhealthy right now — explicitly marked suspect,
    or with a stale-but-not-yet-diagnosed heartbeat. The hedging plane
    reads this (it must not wait for a sweeper to run the CAS); ``dead``
    nodes are excluded because their leases are already recalled."""
    now = time.time() if now is None else now
    out = []
    try:
        docs = store.list_worker_heartbeats()
    except Exception:
        return out
    for doc in docs:
        node = doc.get("node")
        if node is None or node == exclude:
            continue
        state = doc.get("state")
        stale = now - float(doc.get("ts") or 0.0)
        if state == "suspect" or (state == "alive"
                                  and stale > suspect_after_s):
            out.append(node)
    return sorted(out)


def sweep_worker_health(server, now: Optional[float] = None, *,
                        suspect_after_s: float,
                        dead_after_s: float) -> List[dict]:
    """One failure-detector pass over the shared heartbeat table; returns
    the transitions THIS sweeper won (the fleet CAS contract: N sweepers
    race, each declaration happens exactly once fleet-wide).

    A worker is *suspect* after ``suspect_after_s`` without a beat and
    *dead* after ``dead_after_s`` — crossing straight to dead is allowed
    (a sweeper that was itself stalled must not need two passes). The
    winner of the dead CAS recalls the node's held clerking-job leases,
    turning a SIGKILL'd or partitioned worker from a round-stalling event
    into a bounded-MTTR blip."""
    now = time.time() if now is None else now
    store = server.clerking_job_store
    actions: List[dict] = []
    try:
        docs = store.list_worker_heartbeats()
    except Exception:
        log.exception("heartbeat census failed; skipping health sweep")
        return actions
    tally = {state: 0 for state in STATES}
    own = getattr(server, "node_id", None)
    for doc in docs:
        node = doc.get("node")
        state = doc.get("state")
        if state in tally:
            tally[state] += 1
        if node is None or node == own or state not in ("alive", "suspect"):
            continue  # terminal (dead/drained) rows need no diagnosis;
            # never diagnose ourselves — our own writer is the evidence
        stale = now - float(doc.get("ts") or 0.0)
        if stale > dead_after_s:
            dead = dict(doc, state="dead", diagnosed_at=now,
                        stale_s=round(stale, 3))
            if store.transition_worker_state(node, ("alive", "suspect"),
                                             dead):
                recalled = 0
                try:
                    recalled = store.recall_clerking_job_leases(node)
                except Exception:
                    log.exception("lease recall for dead node %s failed "
                                  "(per-job expiry still covers it)", node)
                metrics.count("server.fleet.dead")
                if recalled:
                    metrics.count("server.job.lease_recalled", recalled)
                    # recalled jobs are poll-visible again RIGHT NOW: wake
                    # every clerk parked on this worker's long-poll plane
                    # (the recall doesn't know which clerks the dead node
                    # served; waking all is cheap and correct)
                    server.job_wakeup.notify_all()
                obs.add_event("fleet.dead", node=node, recalled=recalled,
                              stale_s=round(stale, 3))
                log.warning("fleet worker %s declared dead (%.2fs since "
                            "last heartbeat); recalled %d held lease(s)",
                            node, stale, recalled)
                actions.append({"node": node, "to": "dead",
                                "recalled_leases": recalled,
                                "stale_s": round(stale, 3)})
        elif state == "alive" and stale > suspect_after_s:
            suspect = dict(doc, state="suspect", diagnosed_at=now,
                           stale_s=round(stale, 3))
            if store.transition_worker_state(node, ("alive",), suspect):
                metrics.count("server.fleet.suspect")
                obs.add_event("fleet.suspect", node=node,
                              stale_s=round(stale, 3))
                log.info("fleet worker %s suspect (%.2fs since last "
                         "heartbeat); peers may hedge its held jobs",
                         node, stale)
                actions.append({"node": node, "to": "suspect",
                                "stale_s": round(stale, 3)})
    for state in ("alive", "suspect", "dead"):
        metrics.gauge_set(f"server.fleet.{state}", tally[state])
    return actions
