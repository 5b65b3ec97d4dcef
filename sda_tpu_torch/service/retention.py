"""Retention: terminal rounds expire and are cascade-purged.

A recurring-round service accumulates one revealed round per tenant per
period — forever. Left alone, every backend grows without bound (round
docs, participations and owner markers, clerk job payloads the size of a
whole clerk column, results, snapshot mask chunks) and ``/statusz``
drowns in history. This module closes the loop:

- a terminal round past its TTL (``RetentionPolicy``: ``revealed_ttl_s``
  for clean rounds, ``failed_ttl_s`` for failed/expired ones) first
  transitions to terminal ``expired`` via the lifecycle CAS — a
  single-winner store-arbitrated step, so exactly one sweeping worker
  owns the purge (and a late clerk-result post can never resurrect the
  round: terminal verdicts are never left, ``server/lifecycle.py``);
- the winner then cascade-purges the aggregation from all four backends
  (``SdaServer.purge_aggregation``): aggregation doc, round doc,
  participations + owner markers, clerking jobs/leases/results, snapshot
  records, freezes and mask chunks. After the purge the round has left
  the store entirely — store size stays flat over hundreds of rounds,
  which the soak drill (``service/soak.py``) asserts.

The pass rides the existing ``RoundSweeper`` cadence (armed via
``SdaServer.retention_policy`` / ``sdad --retain-revealed`` /
``--retain-failed``), so retention needs no extra thread and inherits
the sweeper's fleet arbitration.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import List, Optional

from .. import obs
from ..protocol import AggregationId
from ..server import lifecycle
from ..utils import metrics

log = logging.getLogger(__name__)


@dataclass
class RetentionPolicy:
    """TTLs for terminal rounds; ``None`` keeps that class forever.

    ``revealed_ttl_s`` ages out cleanly completed rounds (the recipient
    has fetched the result; the artifacts are pure history).
    ``failed_ttl_s`` ages out ``failed``/``expired`` rounds — kept a
    while for diagnosis, then purged. TTLs are measured from the round's
    last transition (``updated_at``).

    A schedule's CURRENT epoch is never purged, whatever its state or
    age: the scheduler's reconcile pass cannot tell a purged round from
    a never-minted one, so purging the current epoch would re-mint its
    deterministic aggregation id as an empty zombie round (and a later
    close would fabricate an empty result under the original epoch id).
    ``sweep_retention`` therefore skips every aggregation id named by an
    installed schedule's current epoch; the round becomes purgeable the
    moment the schedule advances past it."""

    revealed_ttl_s: Optional[float] = None
    failed_ttl_s: Optional[float] = None

    @property
    def enabled(self) -> bool:
        return self.revealed_ttl_s is not None or self.failed_ttl_s is not None

    def ttl_for(self, state: str) -> Optional[float]:
        if state == "revealed":
            return self.revealed_ttl_s
        if state in ("failed", "expired"):
            return self.failed_ttl_s
        return None


def expire_round(server, aggregation: AggregationId, from_states,
                 reason: str) -> bool:
    """CAS a terminal round to ``expired`` ahead of its purge — the
    single-winner step that arbitrates WHICH sweeping worker owns the
    cascade. Returns whether THIS call performed the transition."""
    return lifecycle.transition(
        server.aggregation_store, aggregation, tuple(from_states),
        "expired", reason=reason)


def purge_round(server, aggregation: AggregationId) -> dict:
    """Cascade-purge one aggregation from every backend (idempotent)."""
    purged = server.purge_aggregation(aggregation)
    metrics.count("server.round.purged")
    obs.add_event("round.purged", aggregation=str(aggregation),
                  snapshots=purged["snapshots"], jobs=purged["jobs"])
    return purged


def _protected_epoch_ids(server) -> set:
    """Aggregation ids of every installed schedule's CURRENT epoch —
    rounds retention must never purge (see the policy docstring)."""
    from .scheduler import epoch_aggregation_id

    protected = set()
    try:
        schedules = server.aggregation_store.list_schedule_states()
    except Exception:  # a third-party store without schedule support
        return protected
    for doc in schedules:
        try:
            protected.add(str(epoch_aggregation_id(
                doc["schedule"], int(doc["epoch"]))))
        except (KeyError, TypeError, ValueError):
            continue
    return protected


def sweep_retention(server, docs=None, now: Optional[float] = None
                    ) -> List[dict]:
    """One retention pass over the round documents: expire-and-purge
    every terminal round past its TTL. Runs inside ``RoundSweeper``
    (``docs`` is the sweep's own listing) or standalone."""
    policy: RetentionPolicy = server.retention_policy
    if policy is None or not policy.enabled:
        return []
    now = time.time() if now is None else now
    if docs is None:
        docs = server.aggregation_store.list_round_states()
    protected = _protected_epoch_ids(server)
    actions: List[dict] = []
    for doc in docs:
        state = doc.get("state")
        ttl = policy.ttl_for(state or "")
        if ttl is None:
            continue
        if doc.get("aggregation") in protected:
            # a schedule's current epoch: purging it would make the
            # scheduler's reconcile re-mint the deterministic id as an
            # empty zombie round — wait for the schedule to advance
            metrics.count("server.round.retention_deferred")
            continue
        updated = float(doc.get("updated_at") or 0.0)
        if now < updated + ttl:
            continue
        aggregation = AggregationId(doc["aggregation"])
        if state in ("revealed", "failed"):
            reason = (f"retention: {state} round exceeded its "
                      f"{ttl:g}s TTL")
            if not expire_round(server, aggregation, (state,), reason):
                continue  # a peer's sweep won; it owns the purge
            metrics.count("server.round.retention_expired")
            actions.append({"aggregation": str(aggregation),
                            "tenant": doc.get("tenant"),
                            "to": "expired", "reason": reason})
        # state was already "expired" (a deadline expiry past its TTL),
        # or we just expired it above: purge. The purge is idempotent,
        # so a rare double-purge under two racing sweeps is harmless.
        purged = purge_round(server, aggregation)
        log.info("round %s purged by retention (%d snapshot(s), %d job "
                 "doc(s))", aggregation, purged["snapshots"], purged["jobs"])
        actions.append({"aggregation": str(aggregation),
                        "tenant": doc.get("tenant"), "to": "purged",
                        **purged})
    return actions


# ---------------------------------------------------------------------------
# store-size accounting (the soak drill's flat-store verdict)

def sqlite_row_counts(path) -> dict:
    """Row count per table of a SQLite store file (read-only side
    connection — safe next to a live fleet under WAL)."""
    import sqlite3

    conn = sqlite3.connect(str(path))
    try:
        tables = [
            r[0] for r in conn.execute(
                "SELECT name FROM sqlite_master WHERE type = 'table' "
                "AND name NOT LIKE 'sqlite_%' ORDER BY name")
        ]
        return {
            table: conn.execute(
                f"SELECT COUNT(*) FROM {table}").fetchone()[0]
            for table in tables
        }
    finally:
        conn.close()


def live_sqlite_rows_total(db) -> int:
    """Total rows via a live :class:`~sda_tpu_torch.server.SqliteDb` handle —
    the only way to count a ``":memory:"`` database (per-connection)."""
    with db.lock:
        tables = [
            r[0] for r in db.conn.execute(
                "SELECT name FROM sqlite_master WHERE type = 'table' "
                "AND name NOT LIKE 'sqlite_%'")
        ]
        return sum(
            db.conn.execute(f"SELECT COUNT(*) FROM {table}").fetchone()[0]
            for table in tables
        )


def jsonfs_file_counts(root) -> dict:
    """JSON document count per top-level subtree of a jsonfs store."""
    from pathlib import Path

    root = Path(root)
    counts: dict = {}
    for path in root.rglob("*.json"):
        if path.name.startswith("."):
            continue  # dot-leases and temp files are not documents
        relative = path.relative_to(root)
        top = relative.parts[0] if len(relative.parts) > 1 else "."
        counts[top] = counts.get(top, 0) + 1
    return counts


def memory_row_counts(server) -> dict:
    """Document counts of an in-process memory store pair."""
    aggregations = server.aggregation_store
    jobs = server.clerking_job_store
    return {
        "aggregations": len(aggregations._aggregations),
        "participations": sum(
            len(p) for p in aggregations._participations.values()),
        "part_owners": sum(
            len(o) for o in aggregations._part_owners.values()),
        "snapshots": sum(len(s) for s in aggregations._snapshots.values()),
        "snapshot_parts": len(aggregations._snapshot_parts),
        "snapshot_masks": len(aggregations._snapshot_masks),
        "rounds": len(aggregations._rounds),
        "jobs_queued": sum(len(q) for q in jobs._queues.values()),
        "jobs_done": sum(len(d) for d in jobs._done.values()),
        "results": sum(len(r) for r in jobs._results.values()),
    }


def store_rows_total(kind: str, *, path=None, server=None) -> int:
    """Total stored documents/rows — the soak drill's flat-store metric."""
    if kind == "sqlite":
        return sum(sqlite_row_counts(path).values())
    if kind == "jsonfs":
        return sum(jsonfs_file_counts(path).values())
    if kind == "memory":
        return sum(memory_row_counts(server).values())
    raise ValueError(f"unknown store kind {kind!r}")
