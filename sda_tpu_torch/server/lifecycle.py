"""Round lifecycle supervisor: explicit state machine + deadline sweeper.

SDA's whole premise is weak, sporadic devices, and packed-Shamir sharing
exists precisely so a round survives missing clerks — but nothing ever
*decided* a clerk was gone: a permanently dead clerk's job lease-reissued
forever and an additive round hung silently with no terminal state. This
module closes that gap (secure-aggregation systems at population scale
treat dropout recovery as a first-class protocol phase — Bonawitz et al.,
MLSys 2019): every aggregation round carries an explicit, store-persisted
state machine, and a background sweeper drives the terminal transitions
under configurable per-phase deadlines.

States::

    collecting --snapshot--> frozen --jobs enqueued--> clerking
    clerking --all C results--> ready --reveal--> revealed        (terminal)
    clerking --dead clerks, quorum reachable--> degraded --reveal--> revealed
    clerking --dead clerks, quorum unreachable OR additive--> failed (terminal)
    collecting/frozen --deadline--> expired                       (terminal)

``ready`` means the FULL committee reported; ``degraded`` means the
sweeper detected permanently dead clerks but the surviving quorum can
(or already did) satisfy ``reconstruction_threshold``, so the existing
quorum reconstruction (``crypto/sharing.py``) completes the round from
survivors. Additive sharing cannot lose a single share
(``reconstruction_threshold == committee size``), so a dead clerk
transitions the round to ``failed`` with a machine-readable reason
instead of hanging forever.

Dead-clerk detection: past the clerking deadline, an undone clerking job
with no ACTIVE lease (``leased_until <= now`` — lapsed, or never polled
at all) marks its clerk dead. A slow-but-alive clerk always holds a live
lease while working and is spared; a clerk that died holding a lease is
detected one lease period after the deadline at the latest.

Fleet safety: every transition is a store-arbitrated compare-and-swap
(``transition_round_state`` on all four backends — the fleet's single-winner
conditional-write pattern), so in an N-worker fleet over one shared store
exactly one worker performs each sweep action per round; the losers
observe the winner's transition and move on.

Observability: transitions count ``server.round.state.<state>``, sweep
latency lands in the ``server.round.sweep`` histogram (``/metrics``),
per-state gauges ride ``server.rounds.<state>``, transitions emit span
events, and ``/statusz`` serves the rounds table (``rounds_report``).
The recipient-facing view is ``GET /v1/aggregations/{id}/round``
(:class:`~sda_tpu_torch.protocol.RoundStatus`) and the blocking client call
``SdaClient.await_result(deadline=...)``, which raises typed
``RoundFailed`` / ``RoundExpired`` carrying the server's diagnosis.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from .. import obs
from ..obs import recorder
from ..utils import metrics
from ..protocol import (
    AdditiveSharing,
    AggregationId,
    RoundStatus,
    SnapshotId,
)

log = logging.getLogger(__name__)

#: Every state the machine can be in, in rough lifecycle order.
STATES = (
    "collecting", "frozen", "clerking", "ready", "revealed",
    "degraded", "failed", "expired",
)

#: States no sweeper or protocol event ever leaves.
TERMINAL_STATES = frozenset({"revealed", "failed", "expired"})

#: Bounded transition history kept in the round document.
_HISTORY_LIMIT = 16


@dataclass
class RoundDeadlines:
    """Per-phase wall-clock budgets; ``None`` disables that deadline.

    ``collecting_s``: aggregation creation -> snapshot (else ``expired``).
    ``clerking_s``: job fan-out -> every result in; past it the sweeper
    runs dead-clerk detection (``degraded`` / ``failed``) and expires
    rounds stuck mid-snapshot (``frozen``).
    """

    collecting_s: Optional[float] = None
    clerking_s: Optional[float] = None


def scheme_kind(scheme) -> str:
    """``"additive"`` (no share may be lost) vs ``"shamir"`` (any quorum
    of ``reconstruction_threshold`` shares reconstructs)."""
    return "additive" if isinstance(scheme, AdditiveSharing) else "shamir"


def new_round_doc(aggregation, deadlines: Optional[RoundDeadlines]) -> dict:
    """Fresh ``collecting`` record for a just-created aggregation. The
    scheme facts the sweeper needs later (kind, committee size,
    reconstruction threshold) are denormalized in so a sweep never has to
    re-parse the aggregation resource — and so is the tree linkage
    (``parent``/``children``/``level``, from ``Aggregation.tree``): the
    sweeper's leaf-failure propagation and the ``/statusz`` tree view
    walk round documents alone, never the aggregation resources."""
    scheme = aggregation.committee_sharing_scheme
    now = time.time()
    deadline = None
    if deadlines is not None and deadlines.collecting_s:
        deadline = now + deadlines.collecting_s
    tree = getattr(aggregation, "tree", None)
    return {
        "aggregation": str(aggregation.id),
        # tenant = the aggregation's recipient: the multi-tenant service
        # plane rolls /statusz up per recipient and retention reports
        # name the tenant whose round was purged (service/)
        "tenant": str(aggregation.recipient),
        "state": "collecting",
        "snapshot": None,
        "scheme": scheme_kind(scheme),
        "committee_size": int(scheme.output_size),
        "reconstruction_threshold": int(scheme.reconstruction_threshold),
        "dead_clerks": [],
        "reason": None,
        "deadline_at": deadline,
        "updated_at": now,
        "history": [["collecting", round(now, 3)]],
        "parent": (str(tree.parent)
                   if tree is not None and tree.parent is not None else None),
        "children": ([str(c) for c in tree.children]
                     if tree is not None else []),
        "level": (int(tree.level) if tree is not None else None),
        "group": (tree.group if tree is not None else None),
    }


def _advanced(doc: dict, state: str, *, snapshot=None, deadline_at=...,
              reason=None, dead_clerks=None) -> dict:
    """The successor document for a transition (pure; the CAS publishes)."""
    now = time.time()
    new = dict(doc)
    new["state"] = state
    if snapshot is not None:
        new["snapshot"] = str(snapshot)
    if deadline_at is not ...:
        new["deadline_at"] = deadline_at
    if reason is not None:
        new["reason"] = reason
    if dead_clerks is not None:
        new["dead_clerks"] = [str(c) for c in dead_clerks]
    new["updated_at"] = now
    history = list(doc.get("history") or [])
    history.append([state, round(now, 3)])
    new["history"] = history[-_HISTORY_LIMIT:]
    return new


def transition(store, aggregation, from_states, state: str, **changes) -> bool:
    """Store-arbitrated state transition: read the current document, build
    the successor, publish with a conditional write keyed on the FROM
    state. Exactly one of N racing workers wins (the fleet contract);
    returns whether THIS call performed the transition."""
    doc = store.get_round_state(aggregation)
    if doc is None or doc.get("state") not in from_states:
        return False
    new = _advanced(doc, state, **changes)
    if not store.transition_round_state(aggregation, from_states, new):
        return False
    metrics.count(f"server.round.state.{state}")
    obs.add_event(f"round.{state}", aggregation=str(aggregation),
                  previous=doc.get("state"))
    # durable round ledger: the flight recorder spools every transition
    # so sda-trace can replay the state story after the fleet is gone
    recorder.record({
        "t": "round",
        "aggregation": str(aggregation),
        "state": state,
        "previous": doc.get("state"),
        **({"reason": changes["reason"]} if changes.get("reason") else {}),
        **({"tenant": doc["tenant"]} if doc.get("tenant") else {}),
    })
    return True


# ---------------------------------------------------------------------------
# protocol-event notes (called from server core / the snapshot pipeline)

def note_collecting(server, aggregation) -> None:
    """A fresh aggregation starts its round in ``collecting``.

    Create-if-absent: ``create_aggregation`` is a retry-safe upsert
    (``_IDEMPOTENT_POST_ROUTES``), so a replayed create after a lost
    response must NOT reset an in-flight round back to collecting —
    deleting the aggregation removes the record, so a genuinely new
    aggregation always starts fresh."""
    if server.aggregation_store.get_round_state(aggregation.id) is not None:
        return
    server.aggregation_store.put_round_state(
        new_round_doc(aggregation, getattr(server, "round_deadlines", None)))
    metrics.count("server.round.state.collecting")
    recorder.record({
        "t": "round",
        "aggregation": str(aggregation.id),
        "state": "collecting",
        "previous": None,
        # the round's tenant: recipients are the scheduler's tenant key
        # (service/scheduler.py), which sda-trace slo groups budgets by
        "tenant": str(aggregation.recipient),
    })


def note_frozen(server, aggregation, snapshot_id) -> None:
    """The snapshot pipeline froze the participation set."""
    store = server.aggregation_store
    doc = store.get_round_state(aggregation.id)
    if doc is None:
        # pre-supervisor aggregation (or a store emptied under us): mint
        # the record on the fly so the rest of the lifecycle is tracked
        store.put_round_state(_advanced(
            new_round_doc(aggregation, getattr(server, "round_deadlines",
                                               None)),
            "frozen", snapshot=snapshot_id, deadline_at=_clerking_deadline(
                server)))
        return
    if doc["state"] in TERMINAL_STATES:
        return  # terminal verdicts are never resurrected (a stale
        # snapshot pipeline racing an expired round keeps the verdict)
    if doc["state"] == "frozen" and doc.get("snapshot") == str(snapshot_id):
        return  # replay of the same pipeline: already noted
    transition(store, aggregation.id, (doc["state"],), "frozen",
               snapshot=snapshot_id, deadline_at=_clerking_deadline(server))


def _clerking_deadline(server) -> Optional[float]:
    deadlines = getattr(server, "round_deadlines", None)
    if deadlines is not None and deadlines.clerking_s:
        return time.time() + deadlines.clerking_s
    return None


def note_clerking(server, aggregation_id, snapshot_id) -> None:
    """The snapshot pipeline enqueued the clerking jobs: the round is
    live for the committee (also re-entered by a later pipelined snapshot
    of the same aggregation — the record tracks the current round)."""
    store = server.aggregation_store
    doc = store.get_round_state(aggregation_id)
    if doc is None:
        return  # nothing tracked for this aggregation; stay silent
    if doc["state"] in TERMINAL_STATES:
        return  # terminal verdicts are never resurrected
    if doc["state"] == "clerking" and doc.get("snapshot") == str(snapshot_id):
        return  # contended/replayed pipeline already converged here
    transition(store, aggregation_id, (doc["state"],), "clerking",
               snapshot=snapshot_id, deadline_at=_clerking_deadline(server))


def note_result(server, job) -> None:
    """A clerking result landed; when the FULL committee has reported the
    round is ``ready`` (threshold-satisfying partial sets stay
    ``clerking``/``degraded`` — ``result_ready`` is the recipient's
    signal, ``ready`` is the everything-done state)."""
    store = server.aggregation_store
    doc = store.get_round_state(job.aggregation)
    if (doc is None or doc.get("snapshot") != str(job.snapshot)
            or doc["state"] != "clerking"):
        return
    results = len(server.clerking_job_store.list_results(job.snapshot))
    if results >= int(doc.get("committee_size") or 0):
        transition(store, job.aggregation, ("clerking",), "ready")


def note_revealed(server, aggregation_id, snapshot_id, results: int) -> None:
    """The recipient fetched a reconstruction-grade snapshot result."""
    store = server.aggregation_store
    doc = store.get_round_state(aggregation_id)
    if doc is None or doc.get("snapshot") != str(snapshot_id):
        return
    if doc["state"] not in ("clerking", "ready", "degraded"):
        return
    if results >= int(doc.get("reconstruction_threshold") or 0):
        transition(store, aggregation_id, (doc["state"],), "revealed")


def round_status(server, aggregation_id) -> Optional[RoundStatus]:
    """The recipient-facing view: the stored round document plus the LIVE
    result count (never denormalized — it changes under the round)."""
    doc = server.aggregation_store.get_round_state(aggregation_id)
    if doc is None:
        return None
    results = 0
    if doc.get("snapshot"):
        results = len(server.clerking_job_store.list_results(
            SnapshotId(doc["snapshot"])))
    return RoundStatus(
        aggregation=AggregationId(doc["aggregation"]),
        state=doc["state"],
        snapshot=SnapshotId(doc["snapshot"]) if doc.get("snapshot") else None,
        scheme=doc.get("scheme"),
        committee_size=doc.get("committee_size") or 0,
        reconstruction_threshold=doc.get("reconstruction_threshold") or 0,
        results=results,
        dead_clerks=doc.get("dead_clerks") or [],
        reason=doc.get("reason"),
        deadline_at=doc.get("deadline_at"),
        updated_at=doc.get("updated_at"),
        history=doc.get("history") or [],
        parent=doc.get("parent"),
        children=doc.get("children") or [],
    )


def rounds_report(server, limit: int = 16) -> dict:
    """The ``/statusz`` rounds table, built for LONG-LIVED services: a
    thousand-round deployment is mostly terminal history, and the rounds
    an operator needs are the live ones. The ``recent`` table therefore
    fills with live (non-terminal) rounds first, most recently updated
    first, and only pads the remainder with terminal rounds — and the
    output stays O(limit) regardless of how many rounds the store holds.
    ``by_tenant`` is the multi-tenant rollup (state counts per recipient,
    bounded to the ``limit`` busiest tenants; ``tenants_omitted`` says
    how many fell off)."""
    docs = server.aggregation_store.list_round_states()
    by_state: dict = {}
    by_tenant: dict = {}
    live = 0
    for doc in docs:
        state = doc.get("state", "?")
        by_state[state] = by_state.get(state, 0) + 1
        if state not in TERMINAL_STATES:
            live += 1
        tenant = doc.get("tenant") or "?"
        by_tenant.setdefault(tenant, {})[state] = (
            by_tenant.get(tenant, {}).get(state, 0) + 1)
    freshest = sorted(docs, key=lambda d: d.get("updated_at") or 0.0,
                      reverse=True)
    recent = [d for d in freshest
              if d.get("state") not in TERMINAL_STATES][:limit]
    if len(recent) < limit:
        recent += [d for d in freshest
                   if d.get("state") in TERMINAL_STATES
                   ][:limit - len(recent)]
    tenants = sorted(by_tenant.items(),
                     key=lambda kv: (-sum(kv[1].values()), kv[0]))
    return {
        "count": len(docs),
        "live": live,
        "by_state": dict(sorted(by_state.items())),
        "by_tenant": {tenant: dict(sorted(states.items()))
                      for tenant, states in tenants[:limit]},
        "tenants_omitted": max(0, len(tenants) - limit),
        "recent": [
            {
                "aggregation": d.get("aggregation"),
                "tenant": d.get("tenant"),
                "state": d.get("state"),
                "snapshot": d.get("snapshot"),
                "reason": d.get("reason"),
                "dead_clerks": d.get("dead_clerks") or None,
                "updated_at": d.get("updated_at"),
                # tree linkage: a stuck hierarchical round is diagnosable
                # from ANY worker's /statusz — the root row names its
                # children, each leaf row names its parent and level
                "parent": d.get("parent"),
                "children": d.get("children") or None,
                "level": d.get("level"),
            }
            for d in recent
        ],
    }


# ---------------------------------------------------------------------------
# the sweeper

class RoundSweeper:
    """Background deadline/dead-clerk sweeper for one ``sdad`` worker.

    Every ``interval_s`` it lists the store's round records and, for each
    non-terminal round past its phase deadline, performs the terminal
    diagnosis — expired collection, stalled snapshot, dead clerks with
    quorum-degraded completion or unrecoverable failure. All actions are
    CAS transitions, so N workers sweeping one shared store perform each
    action exactly once between them.

    ``heartbeat_suspect_s`` / ``heartbeat_dead_s`` additionally arm the
    FLEET failure detector (``server/health.py``) on the same cadence: a
    peer worker whose heartbeat goes stale past the suspect threshold is
    declared suspect (hedging may shadow its jobs), past the dead
    threshold it is declared dead and its held clerking-job leases are
    proactively recalled — bounded MTTR instead of per-job lease expiry.
    Both declarations ride the same single-winner CAS discipline.
    """

    def __init__(self, server, interval_s: float = 1.0, *,
                 heartbeat_suspect_s: Optional[float] = None,
                 heartbeat_dead_s: Optional[float] = None):
        self.server = server
        self.interval_s = float(interval_s)
        self.heartbeat_suspect_s = heartbeat_suspect_s
        self.heartbeat_dead_s = heartbeat_dead_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "RoundSweeper":
        self._thread = threading.Thread(
            target=self._run, name="round-sweeper", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sweep_once()
            except Exception:  # the sweeper must outlive store hiccups
                log.exception("round sweep failed; retrying next tick")
                metrics.count("server.round.sweep_error")

    def sweep_once(self, now: Optional[float] = None) -> dict:
        """One sweep pass; returns ``{"rounds", "actions"}`` where each
        action names a transition THIS worker won."""
        now = time.time() if now is None else now
        t0 = time.perf_counter()
        actions: List[dict] = []
        with obs.span("server.round.sweep") as sweep_span:
            if self.heartbeat_dead_s is not None:
                # fleet health first: a recalled lease makes the jobs of a
                # SIGKILL'd worker pollable before the round diagnosis
                # below could mistake them for dead-clerk work
                from . import health

                suspect_s = (self.heartbeat_suspect_s
                             if self.heartbeat_suspect_s is not None
                             else self.heartbeat_dead_s / 2)
                actions.extend(health.sweep_worker_health(
                    self.server, now, suspect_after_s=suspect_s,
                    dead_after_s=self.heartbeat_dead_s))
            docs = self.server.aggregation_store.list_round_states()
            by_state: dict = {}
            for doc in docs:
                state = doc.get("state", "?")
                by_state[state] = by_state.get(state, 0) + 1
            for state in STATES:
                metrics.gauge_set(f"server.rounds.{state}",
                                  by_state.get(state, 0))
            for doc in docs:
                if doc.get("state") in TERMINAL_STATES \
                        or doc.get("state") == "ready":
                    continue  # ready waits on the recipient, not on us
                action = self._sweep_round(doc, now)
                if action is not None:
                    # fold the verdict into OUR listing too: the tree
                    # pass below reads these docs, and the store write
                    # inside transition() doesn't update them
                    doc["state"] = action["to"]
                    if action.get("reason") is not None:
                        doc["reason"] = action["reason"]
                    if action.get("dead_clerks") is not None:
                        doc["dead_clerks"] = action["dead_clerks"]
                    actions.append(action)
                    obs.add_event("round.sweep_action", **action)
            # tree propagation AFTER per-round diagnosis: a leaf the pass
            # above just declared failed/expired fails its ancestors in
            # the SAME sweep (no extra tick of latency)
            actions.extend(self._sweep_tree(docs))
            # retention LAST: a round the diagnosis above just made
            # terminal starts its TTL clock now; rounds whose TTL lapsed
            # are expired (CAS) and cascade-purged from every backend
            # (service/retention.py; armed via server.retention_policy)
            policy = getattr(self.server, "retention_policy", None)
            if policy is not None and policy.enabled:
                from ..service import retention

                actions.extend(retention.sweep_retention(
                    self.server, docs, now=now))
            sweep_span.set_attribute("rounds", len(docs))
            sweep_span.set_attribute("actions", len(actions))
        metrics.observe("server.round.sweep", time.perf_counter() - t0)
        return {"rounds": len(docs), "actions": actions}

    # -- tree propagation ---------------------------------------------------
    def _sweep_tree(self, docs: List[dict]) -> List[dict]:
        """Hierarchical-round failure propagation (``sda_tpu_torch/tree``).

        A leaf that went ``degraded`` needs no propagation — its relay
        completes from the surviving quorum and feeds the parent round
        normally. But a leaf that reached a DEAD terminal state
        (``failed``/``expired``) can never produce its partial aggregate,
        so every ancestor is unrecoverable: fail the parent round with a
        machine-readable reason NAMING the leaf, instead of letting the
        root hang until its own deadline with no diagnosis. CAS
        transitions keep this exactly-once across a sweeping fleet, and
        re-listing is unnecessary — a parent failed here is seen by its
        own parent on the next sweep tick (one tick per tree level)."""
        by_id = {d.get("aggregation"): d for d in docs}
        actions: List[dict] = []
        for doc in docs:
            state = doc.get("state")
            if state in TERMINAL_STATES or not doc.get("children"):
                continue
            for child_id in doc["children"]:
                child = by_id.get(str(child_id))
                if child is None or child.get("state") not in ("failed",
                                                               "expired"):
                    continue
                where = ""
                if child.get("level") is not None:
                    where = (f" (level {child['level']}"
                             + (f", group {child['group']}"
                                if child.get("group") is not None else "")
                             + ")")
                reason = (
                    f"child round {child_id}{where} is {child['state']}: "
                    f"{child.get('reason') or 'no reason recorded'}")
                aggregation = AggregationId(doc["aggregation"])
                if transition(self.server.aggregation_store, aggregation,
                              (state,), "failed", reason=reason,
                              dead_clerks=child.get("dead_clerks") or None):
                    # fold into our listing: an ancestor later in this
                    # same pass sees the propagated failure immediately
                    doc["state"] = "failed"
                    doc["reason"] = reason
                    metrics.count("server.round.tree_failed")
                    log.warning("round %s -> failed (tree): %s",
                                aggregation, reason)
                    actions.append({"aggregation": str(aggregation),
                                    "to": "failed", "reason": reason})
                break  # one verdict per parent per sweep is enough
        return actions

    # -- per-round diagnosis ------------------------------------------------
    def _sweep_round(self, doc: dict, now: float) -> Optional[dict]:
        deadline = doc.get("deadline_at")
        if deadline is None or now < deadline:
            return None
        state = doc["state"]
        aggregation = AggregationId(doc["aggregation"])
        if state == "collecting":
            reason = ("no snapshot within the collecting deadline "
                      f"({doc['deadline_at']:.3f})")
            if transition(self.server.aggregation_store, aggregation,
                          ("collecting",), "expired", reason=reason):
                return {"aggregation": str(aggregation), "to": "expired",
                        "reason": reason}
            return None
        if state == "frozen":
            reason = ("snapshot pipeline stalled past the clerking "
                      "deadline (frozen set installed, jobs never "
                      "enqueued)")
            if transition(self.server.aggregation_store, aggregation,
                          ("frozen",), "expired", reason=reason):
                return {"aggregation": str(aggregation), "to": "expired",
                        "reason": reason}
            return None
        if state in ("clerking", "degraded"):
            return self._sweep_clerking(doc, aggregation, now)
        return None

    def _sweep_clerking(self, doc: dict, aggregation,
                        now: float) -> Optional[dict]:
        """Dead-clerk detection past the clerking deadline. A job is dead
        when undone with no ACTIVE lease — lapsed (the clerk died holding
        it, past reissue) or never polled at all (the clerk never showed
        up); an actively leased job means someone is working right now."""
        snapshot = SnapshotId(doc["snapshot"])
        jobs = self.server.clerking_job_store.list_snapshot_jobs(snapshot)
        if not jobs:
            return None  # backend cannot enumerate: no diagnosis possible
        dead = sorted(
            str(clerk)
            for (_job, clerk, done, leased_until) in jobs
            if not done and leased_until <= now
        )
        if not dead:
            return None  # every missing job is actively leased: alive
        results = len(self.server.clerking_job_store.list_results(snapshot))
        threshold = int(doc.get("reconstruction_threshold") or 0)
        committee = int(doc.get("committee_size") or len(jobs))
        reachable = committee - len(dead)
        if doc.get("scheme") == "additive":
            to = "failed"
            reason = (f"additive sharing cannot recover {len(dead)} dead "
                      f"clerk(s): every share is required "
                      f"(reconstruction_threshold == committee size "
                      f"{committee})")
        elif reachable >= threshold or results >= threshold:
            to = "degraded"
            reason = (f"{len(dead)} dead clerk(s) detected past the "
                      f"clerking deadline; completing from the surviving "
                      f"quorum ({max(reachable, results)} >= "
                      f"reconstruction threshold {threshold})")
        else:
            to = "failed"
            reason = (f"quorum unreachable: {len(dead)} dead clerk(s) "
                      f"leave at most {reachable} results, below the "
                      f"reconstruction threshold {threshold}")
        if doc["state"] == "degraded" and to == "degraded":
            return None  # already diagnosed; nothing new to record
        if transition(self.server.aggregation_store, aggregation,
                      (doc["state"],), to, reason=reason, dead_clerks=dead):
            metrics.count("server.round.dead_clerks", len(dead))
            log.warning("round %s -> %s: %s", aggregation, to, reason)
            return {"aggregation": str(aggregation), "to": to,
                    "reason": reason, "dead_clerks": dead}
        return None
