"""Recurring-round scheduler: epochs of a schedule, minted exactly once.

A :class:`ScheduleSpec` describes one tenant's recurring aggregation —
the resource template (dimension, modulus, schemes, recipient), the
committee policy (which clerks and keys serve every epoch), the epoch
period and how many epochs may be in flight at once. The
:class:`RoundScheduler` turns specs into an endless sequence of rounds:

- **deterministic epoch ids**: epoch *e*'s aggregation id is
  ``uuid5(schedule, e)`` (and its closing snapshot ``uuid5(schedule, e,
  "snapshot")``), so every scheduler worker, every crash-replay and
  every device journal agrees on WHICH aggregation epoch *e* is —
  participation stays exactly-once across epochs by construction (the
  ingest key is ``(aggregation, participant)``);
- **single-winner minting**: advancing a schedule from epoch *e* to
  *e+1* is a store-arbitrated CAS on the schedule document's epoch
  number (``transition_schedule_state`` on all four backends — the same
  conditional-write discipline as ``RoundSweeper`` transitions), so a
  fleet of ``sdad --schedule`` workers mints each epoch exactly once;
  the loser converges on the winner's epoch via the reconcile pass;
- **pipelined epochs**: minting epoch *e+1* also CLOSES epoch *e* (its
  deterministic snapshot freezes the participation set and fans out the
  clerking jobs), so epoch *e+1* collects while epoch *e* clerks. A
  schedule never holds more than ``max_pipelined`` non-terminal epochs:
  with the default 2 that is exactly "one collecting + one clerking";
  1 degenerates to strictly sequential rounds;
- **crash convergence**: every tick re-ensures the current epoch's
  aggregation + committee exist and the previous epoch's snapshot is
  recorded — all idempotent (upserts + the contended-idempotent snapshot
  pipeline), so a worker that died between the CAS and the mint is
  repaired by any peer's next tick.

The scheduler acts on an :class:`~sda_tpu_torch.server.SdaServer` directly
(like the sweeper): it is a trusted server-side plane, minting on the
tenant's behalf per the spec the operator installed.
"""

from __future__ import annotations

import logging
import re
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import List, Optional

from .. import obs
from ..obs import recorder
from ..protocol import (
    Aggregation,
    AggregationId,
    AgentId,
    Committee,
    EncryptionKeyId,
    NotFound,
    Snapshot,
    SnapshotId,
)
from ..server import lifecycle
from ..utils import metrics

log = logging.getLogger(__name__)

#: Namespace for deterministic epoch ids (uuid5 over schedule:epoch).
SERVICE_NAMESPACE = uuid.UUID("b3f9d7a1-52c4-4f7e-9a0e-8f6a2d1c5b42")

#: Schedule names become store keys (files on jsonfs): token charset only.
_NAME_RE = re.compile(r"[A-Za-z0-9._-]{1,64}")


def epoch_aggregation_id(schedule: str, epoch: int) -> AggregationId:
    """Epoch *e*'s aggregation id — deterministic, so schedulers, replays
    and device journals all agree (exactly-once across epochs)."""
    return AggregationId(
        uuid.uuid5(SERVICE_NAMESPACE, f"schedule:{schedule}:epoch:{int(epoch)}"))


def epoch_snapshot_id(schedule: str, epoch: int) -> SnapshotId:
    """The snapshot that closes epoch *e*'s collection — deterministic so
    a crashed or contended close converges on one pipeline run."""
    return SnapshotId(uuid.uuid5(
        SERVICE_NAMESPACE, f"schedule:{schedule}:epoch:{int(epoch)}:snapshot"))


@dataclass
class ScheduleSpec:
    """One tenant's recurring aggregation.

    ``template`` is an :class:`~sda_tpu_torch.protocol.Aggregation` document
    (``Aggregation.to_obj`` shape) whose ``id`` and ``title`` are
    replaced per epoch; its ``recipient`` IS the tenant. ``committee``
    is the committee policy: the ``[agent id, encryption key id]`` pairs
    every epoch's committee is created with (a fixed committee per
    schedule — the simplest policy that keeps epoch minting a pure
    server-side act). ``max_pipelined`` bounds non-terminal epochs in
    flight (2 = one collecting + one clerking).
    """

    name: str
    period_s: float
    template: dict
    committee: List[list] = field(default_factory=list)
    max_pipelined: int = 2

    def __post_init__(self):
        if not _NAME_RE.fullmatch(self.name or ""):
            raise ValueError(
                f"schedule name {self.name!r} must match {_NAME_RE.pattern} "
                "(it becomes a store key)")
        if self.period_s <= 0:
            raise ValueError("period_s must be positive")
        if self.max_pipelined < 1:
            raise ValueError("max_pipelined must be >= 1")
        if not self.committee:
            raise ValueError("a schedule needs a committee policy "
                             "(clerk/key pairs)")

    @property
    def tenant(self) -> str:
        """The recipient agent id this schedule belongs to."""
        return str(self.template["recipient"])

    def aggregation_for_epoch(self, epoch: int) -> Aggregation:
        obj = dict(self.template)
        obj["id"] = str(epoch_aggregation_id(self.name, epoch))
        obj["title"] = f"{self.name} epoch {int(epoch)}"
        return Aggregation.from_obj(obj)

    def committee_for_epoch(self, epoch: int) -> Committee:
        return Committee(
            aggregation=epoch_aggregation_id(self.name, epoch),
            clerks_and_keys=[(AgentId(clerk), EncryptionKeyId(key))
                             for clerk, key in self.committee],
        )

    def to_obj(self) -> dict:
        return {
            "name": self.name,
            "period_s": self.period_s,
            "max_pipelined": self.max_pipelined,
            "template": self.template,
            "committee": [[str(c), str(k)] for c, k in self.committee],
        }

    @classmethod
    def from_obj(cls, obj: dict) -> "ScheduleSpec":
        return cls(
            name=obj["name"],
            period_s=float(obj["period_s"]),
            max_pipelined=int(obj.get("max_pipelined", 2)),
            template=obj["template"],
            committee=[list(pair) for pair in obj.get("committee", [])],
        )


def load_specs(path) -> List[ScheduleSpec]:
    """Read a ``sdad --schedule`` spec file: a JSON list of spec objects,
    or ``{"schedules": [...]}``."""
    import json

    with open(path) as f:
        obj = json.load(f)
    if isinstance(obj, dict):
        obj = obj.get("schedules", [])
    return [ScheduleSpec.from_obj(entry) for entry in obj]


def schedules_report(server) -> dict:
    """The ``/statusz`` schedules block: every installed schedule's
    current epoch, tenant and cadence — the fleet's shared-store view."""
    docs = server.aggregation_store.list_schedule_states()
    return {
        "count": len(docs),
        "schedules": [
            {
                "schedule": d.get("schedule"),
                "tenant": d.get("tenant"),
                "epoch": d.get("epoch"),
                "next_epoch_at": d.get("next_epoch_at"),
                "updated_at": d.get("updated_at"),
            }
            for d in sorted(docs, key=lambda d: str(d.get("schedule")))
        ],
    }


class RoundScheduler:
    """Drives a set of :class:`ScheduleSpec` against one server handle.

    Fleet-safe by construction: every mutation is either a conditional
    insert (schedule install, snapshot record, deterministic job ids) or
    an epoch-keyed CAS (the advance), so any number of scheduler workers
    over one shared store cooperate — exactly one mints each epoch, the
    rest converge. ``tick_once`` is the whole algorithm; ``start`` runs
    it on a background cadence (the ``sdad --schedule`` mode).
    """

    def __init__(self, server, specs, interval_s: float = 1.0):
        self.server = server
        self.specs: List[ScheduleSpec] = list(specs)
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "RoundScheduler":
        self._thread = threading.Thread(
            target=self._run, name="round-scheduler", daemon=True)
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
                self.tick_once()
            except Exception:  # the scheduler must outlive store hiccups
                log.exception("schedule tick failed; retrying next tick")
                metrics.count("service.schedule.tick_error")

    def tick_once(self, now: Optional[float] = None) -> dict:
        """One pass over every spec; returns ``{"schedules", "actions"}``
        where each action names a mint/close/install THIS worker won."""
        now = time.time() if now is None else now
        t0 = time.perf_counter()
        actions: List[dict] = []
        with obs.span("service.schedule.tick") as tick_span:
            for spec in self.specs:
                try:
                    actions.extend(self._tick_schedule(spec, now))
                except Exception:
                    # one broken schedule (lost key, store hiccup) must
                    # not starve the other tenants' schedules
                    log.exception("schedule %s tick failed", spec.name)
                    metrics.count("service.schedule.tick_error")
            tick_span.set_attribute("schedules", len(self.specs))
            tick_span.set_attribute("actions", len(actions))
        metrics.observe("service.schedule.tick", time.perf_counter() - t0)
        return {"schedules": len(self.specs), "actions": actions}

    # -- per-schedule pass ---------------------------------------------------
    def _tick_schedule(self, spec: ScheduleSpec, now: float) -> List[dict]:
        store = self.server.aggregation_store
        actions: List[dict] = []
        doc = store.get_schedule_state(spec.name)
        if doc is None:
            installed = {
                "schedule": spec.name,
                "tenant": spec.tenant,
                "epoch": 0,
                "next_epoch_at": now + spec.period_s,
                "updated_at": now,
            }
            if store.create_schedule_state(installed):
                metrics.count("service.schedule.installed")
                obs.add_event("schedule.installed", schedule=spec.name)
                actions.append({"schedule": spec.name, "action": "installed",
                                "epoch": 0})
            else:
                # a peer installed first: converge on its document
                metrics.count("service.schedule.contended")
            doc = store.get_schedule_state(spec.name) or installed
        epoch = int(doc["epoch"])
        # reconcile BEFORE advancing: the current epoch's resources exist
        # (repairs a worker that died between CAS and mint, and makes a
        # CAS loser converge), and the previous epoch is closed
        actions.extend(self._ensure_epoch(spec, epoch))
        if epoch > 0:
            actions.extend(self._ensure_closed(spec, epoch - 1))
        if now < float(doc.get("next_epoch_at") or 0.0):
            return actions
        if self._live_epochs(spec, epoch) >= spec.max_pipelined:
            # the pipeline is full: do NOT advance next_epoch_at — the
            # moment a round terminates, the next tick mints immediately
            metrics.count("service.schedule.pipeline_full")
            return actions
        advanced = dict(doc)
        advanced["epoch"] = epoch + 1
        advanced["next_epoch_at"] = now + spec.period_s
        advanced["updated_at"] = now
        if not store.transition_schedule_state(spec.name, epoch, advanced):
            # a peer won this epoch's mint; its reconcile (or ours, next
            # tick) materializes the resources
            metrics.count("service.schedule.contended")
            return actions
        metrics.count("service.schedule.epoch_minted")
        obs.add_event("schedule.epoch_minted", schedule=spec.name,
                      epoch=epoch + 1)
        recorder.record({
            "t": "epoch",
            "action": "minted",
            "schedule": spec.name,
            "tenant": spec.tenant,
            "epoch": epoch + 1,
            "aggregation": str(epoch_aggregation_id(spec.name, epoch + 1)),
        })
        actions.append({"schedule": spec.name, "action": "minted",
                        "epoch": epoch + 1})
        # mint FIRST, close second: epoch e+1 must already be collecting
        # when epoch e's snapshot starts clerking — that ordering is what
        # makes the round-state history prove pipelined collection
        actions.extend(self._ensure_epoch(spec, epoch + 1))
        actions.extend(self._ensure_closed(spec, epoch))
        return actions

    def _ensure_epoch(self, spec: ScheduleSpec, epoch: int) -> List[dict]:
        """Idempotently materialize epoch *e*: aggregation + committee."""
        aggregation_id = epoch_aggregation_id(spec.name, epoch)
        store = self.server.aggregation_store
        actions: List[dict] = []
        if store.get_aggregation(aggregation_id) is None:
            # a PURGED epoch (retention) must not be re-minted as an
            # empty zombie round: only the CURRENT epoch is ever ensured
            # here, and retention defers the current epoch's purge until
            # the schedule advances past it (sweep_retention's protected
            # set) — so a missing aggregation really means never-minted
            self.server.create_aggregation(
                spec.aggregation_for_epoch(epoch))
            metrics.count("service.schedule.aggregation_minted")
            actions.append({"schedule": spec.name, "action": "aggregation",
                            "epoch": epoch,
                            "aggregation": str(aggregation_id)})
        if store.get_committee(aggregation_id) is None:
            self.server.create_committee(spec.committee_for_epoch(epoch))
            actions.append({"schedule": spec.name, "action": "committee",
                            "epoch": epoch})
        return actions

    def close_epoch(self, spec: ScheduleSpec, epoch: int) -> List[dict]:
        """Close epoch *e* WITHOUT minting a successor — the drill/
        shutdown spelling (a finite workload's last round must freeze and
        clerk without leaving a dangling empty epoch behind; the FL
        scenario runner uses this for its final round). Idempotent and
        contended-safe exactly like the tick-driven close."""
        return self._ensure_closed(spec, epoch)

    def _ensure_closed(self, spec: ScheduleSpec, epoch: int) -> List[dict]:
        """Idempotently close epoch *e*'s collection: run the snapshot
        pipeline under the epoch's deterministic snapshot id. Replays and
        contended peers converge on one frozen set (the pipeline's
        contended-idempotency contract)."""
        aggregation_id = epoch_aggregation_id(spec.name, epoch)
        state = self.server.aggregation_store.get_round_state(aggregation_id)
        if state is None or state.get("state") != "collecting":
            return []  # already closed, terminal, or purged by retention
        snapshot_id = epoch_snapshot_id(spec.name, epoch)
        try:
            self.server.create_snapshot(
                Snapshot(id=snapshot_id, aggregation=aggregation_id))
        except NotFound:
            # aggregation/committee vanished under us (raced purge):
            # nothing to close anymore
            return []
        metrics.count("service.schedule.epoch_closed")
        obs.add_event("schedule.epoch_closed", schedule=spec.name,
                      epoch=epoch)
        recorder.record({
            "t": "epoch",
            "action": "closed",
            "schedule": spec.name,
            "tenant": spec.tenant,
            "epoch": epoch,
            "aggregation": str(aggregation_id),
        })
        return [{"schedule": spec.name, "action": "closed", "epoch": epoch,
                 "snapshot": str(snapshot_id)}]

    def _live_epochs(self, spec: ScheduleSpec, epoch: int) -> int:
        """Non-terminal epochs of this schedule, checked over a bounded
        trailing window (older epochs were gated to <= max_pipelined live
        when minted, so nothing before the window can still be live; a
        retention-purged round document reads as terminal)."""
        store = self.server.aggregation_store
        live = 0
        for e in range(max(0, epoch - 2 * spec.max_pipelined), epoch + 1):
            doc = store.get_round_state(epoch_aggregation_id(spec.name, e))
            if doc is not None \
                    and doc.get("state") not in lifecycle.TERMINAL_STATES:
                live += 1
        return live
