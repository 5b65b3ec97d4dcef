"""Storage interfaces for the server core.

Mirrors reference: server/src/stores.rs — four store traits behind which the
server is a thin delegation layer, so backends (memory, JSON-files, real
databases) are swappable. The snapshot *transpose* — turning N participations
x C clerks into C per-clerk job payloads — has a default implementation here
(stores.rs:86-101), which concrete stores may override with something
smarter (the reference's Mongo store uses an aggregation pipeline;
server-store-mongodb/src/aggregations.rs:164-195).
"""

from __future__ import annotations

import abc
import time
from typing import Iterable, List, Optional, Tuple

from ..protocol import (
    Agent,
    AgentId,
    Aggregation,
    AggregationId,
    ClerkCandidate,
    ClerkingJob,
    ClerkingJobId,
    ClerkingResult,
    Committee,
    Encryption,
    EncryptionKeyId,
    Labelled,
    Participation,
    Profile,
    Signed,
    Snapshot,
    SnapshotId,
)

#: Auth token: an agent id labelled with its secret token string
#: (stores.rs:7 ``AuthToken = Labelled<AgentId, String>``).
AuthToken = Labelled


def auth_token(id: AgentId, body: str) -> AuthToken:
    return Labelled(id, body)


class BaseStore(abc.ABC):
    @abc.abstractmethod
    def ping(self) -> None:
        """Raise if the backend is unhealthy."""


class AuthTokensStore(BaseStore):
    @abc.abstractmethod
    def upsert_auth_token(self, token: AuthToken) -> None: ...

    @abc.abstractmethod
    def get_auth_token(self, id: AgentId) -> Optional[AuthToken]: ...

    @abc.abstractmethod
    def delete_auth_token(self, id: AgentId) -> None: ...


class AgentsStore(BaseStore):
    @abc.abstractmethod
    def create_agent(self, agent: Agent) -> None: ...

    @abc.abstractmethod
    def get_agent(self, id: AgentId) -> Optional[Agent]: ...

    @abc.abstractmethod
    def upsert_profile(self, profile: Profile) -> None: ...

    @abc.abstractmethod
    def get_profile(self, owner: AgentId) -> Optional[Profile]: ...

    @abc.abstractmethod
    def create_encryption_key(self, key: Signed) -> None: ...

    @abc.abstractmethod
    def get_encryption_key(self, key: EncryptionKeyId) -> Optional[Signed]: ...

    @abc.abstractmethod
    def suggest_committee(self) -> List[ClerkCandidate]:
        """All agents owning encryption keys, sorted by agent id, with their
        keys — the (temporary, like the reference's) committee heuristic
        (jfs_stores/agents.rs:66-83)."""


class AggregationsStore(BaseStore):
    @abc.abstractmethod
    def list_aggregations(
        self, filter: Optional[str] = None, recipient: Optional[AgentId] = None
    ) -> List[AggregationId]: ...

    @abc.abstractmethod
    def create_aggregation(self, aggregation: Aggregation) -> None: ...

    @abc.abstractmethod
    def get_aggregation(self, aggregation: AggregationId) -> Optional[Aggregation]: ...

    @abc.abstractmethod
    def delete_aggregation(self, aggregation: AggregationId) -> None: ...

    @abc.abstractmethod
    def get_committee(self, aggregation: AggregationId) -> Optional[Committee]: ...

    @abc.abstractmethod
    def create_committee(self, committee: Committee) -> None: ...

    @abc.abstractmethod
    def create_participation(self, participation: Participation) -> bool:
        """Exactly-once ingestion: a single-winner conditional insert
        keyed by ``(aggregation, participant)`` with the participation's
        canonical content digest stored alongside (the same
        contended-idempotency discipline as ``create_snapshot``, arbitrated
        at the store so it holds across competing server processes).

        - fresh key: insert, return True (this call created it);
        - byte-identical replay (same key, same digest — a crash/retry or
          journal resume re-uploading the SAME sealed bytes): change
          nothing, return False (idempotent success);
        - same key, different digest (a device that recomputed with fresh
          randomness under a new participation id, or an equivocator
          submitting a second input), or an existing participation id
          being re-uploaded with different content: raise
          ``ParticipationConflict`` — never silently replace.

        Post-freeze arrivals are NOT this method's concern: they insert
        normally and the frozen id set keeps them out of the running
        round (``snapshot_participations``)."""

    @abc.abstractmethod
    def create_snapshot(self, snapshot: Snapshot) -> bool:
        """Conditional insert: record the snapshot iff no record with its
        id exists yet, and return whether THIS call created it. The
        record is the snapshot pipeline's commit point, so the insert
        must be single-winner even across competing server processes
        (contended-idempotency contract, docs/scaling.md): the loser's
        pipeline has already upserted the exact same deterministic job
        set, so losing is convergence, not failure. Never overwrites."""

    @abc.abstractmethod
    def list_snapshots(self, aggregation: AggregationId) -> List[SnapshotId]: ...

    @abc.abstractmethod
    def get_snapshot(
        self, aggregation: AggregationId, snapshot: SnapshotId
    ) -> Optional[Snapshot]: ...

    @abc.abstractmethod
    def count_participations(self, aggregation: AggregationId) -> int: ...

    @abc.abstractmethod
    def snapshot_participations(
        self, aggregation: AggregationId, snapshot: SnapshotId
    ) -> bool:
        """Freeze the current participation set under the snapshot id — the
        consistency point that keeps late arrivals out of a running round.

        Single-winner across competing server processes: the freeze
        marker and the frozen id set commit ATOMICALLY, exactly once.
        Returns True when this call performed the freeze, False when a
        concurrent (or earlier crashed) attempt already did — in which
        case the caller must proceed with the WINNER'S frozen set, which
        is guaranteed readable the moment this returns False. Two
        processes must never install different frozen sets for one
        snapshot id: that would mix share generations across clerk
        columns (docs/scaling.md, contended-idempotency contract)."""

    def has_snapshot_freeze(
        self, aggregation: AggregationId, snapshot: SnapshotId
    ) -> bool:
        """Whether ``snapshot_participations`` already ran for this
        snapshot. The snapshot pipeline's first-write-wins replay guard:
        a frozen-but-EMPTY set must read as frozen, or a crash-replay
        with a late participation would re-freeze a superset. Backends
        should override with a durable marker; this fallback (count > 0)
        cannot tell frozen-empty from unfrozen."""
        return self.count_participations_snapshot(aggregation, snapshot) > 0

    @abc.abstractmethod
    def iter_snapped_participations(
        self, aggregation: AggregationId, snapshot: SnapshotId
    ) -> Iterable[Participation]: ...

    def count_participations_snapshot(
        self, aggregation: AggregationId, snapshot: SnapshotId
    ) -> int:
        return sum(1 for _ in self.iter_snapped_participations(aggregation, snapshot))

    def iter_snapshot_clerk_jobs_data(
        self, aggregation: AggregationId, snapshot: SnapshotId, clerks_number: int
    ) -> List[List[Encryption]]:
        """THE server-side transpose (stores.rs:86-101): participation rows ->
        per-clerk encryption columns, positionally by committee index."""
        columns: List[List[Encryption]] = [[] for _ in range(clerks_number)]
        for participation in self.iter_snapped_participations(aggregation, snapshot):
            for ix, (_, encryption) in enumerate(participation.clerk_encryptions):
                columns[ix].append(encryption)
        return columns

    def iter_snapped_recipient_encryptions(
        self, aggregation: AggregationId, snapshot: SnapshotId
    ) -> List[Optional[Encryption]]:
        """The recipient-mask column of the frozen set, in participation
        order (``None`` where a participation carried no mask). Backends
        that store documents can extract just this field instead of
        re-materializing every full participation a second time."""
        return [
            p.recipient_encryption
            for p in self.iter_snapped_participations(aggregation, snapshot)
        ]

    def iter_snapped_forwarded_masks(
        self, aggregation: AggregationId, snapshot: SnapshotId
    ) -> Iterable[Encryption]:
        """Flattened ``forwarded_masks`` ciphertexts of the frozen set, in
        participation order — the leaf-mask ciphertexts tree relays carry
        upward in-band (``Participation.forwarded_masks``). Empty for
        flat rounds; the snapshot pipeline only walks this for tree
        parents, so the full-document fallback below costs nothing
        elsewhere."""
        for p in self.iter_snapped_participations(aggregation, snapshot):
            for encryption in (p.forwarded_masks or ()):
                yield encryption

    @abc.abstractmethod
    def create_snapshot_mask(
        self, snapshot: SnapshotId, mask: List[Encryption]
    ) -> None: ...

    def put_snapshot_mask_chunk(
        self, snapshot: SnapshotId, index: int, encryptions: List[Encryption]
    ) -> None:
        """Chunked snapshot-mask write — the O(batch) half of the
        streamed mask collection (``server/snapshot.py``): the pipeline
        writes the recipient-mask column as bounded chunks keyed by
        ``(snapshot, chunk index)`` instead of materializing the whole
        list in memory first. Contract:

        - chunks are pure upserts keyed by index — NEVER a wipe. The
          chunk stream is deterministic from the frozen set (single-
          winner across the fleet) and the batch size, so a crash-replay
          or a contended peer rewrites byte-identical chunks: any
          interleaving converges bit-exactly, and a reader that already
          holds the committed snapshot record always sees a COMPLETE
          mask (the atomicity the old single-row write had). This
          REQUIRES every fleet worker to chunk at the same batch size
          (``SDA_SNAPSHOT_MASK_BATCH``) — like every per-worker protocol
          knob (lease seconds, deadlines, premix), it must be uniform
          across the fleet: writers chunking one snapshot at different
          boundaries cannot converge under concurrency, trim or no trim;
        - ``trim_snapshot_mask_chunks`` finishes the stream, dropping
          chunks past the end (a leftover from an attempt chunked with a
          different batch size);
        - ``get_snapshot_mask`` returns the concatenation in index order.

        The four in-repo backends override with durable chunk rows; this
        read-modify-write fallback keeps third-party stores working (NOT
        fleet-safe, like the round-state fallbacks above)."""
        if index == 0:
            self.create_snapshot_mask(snapshot, list(encryptions))
            return
        existing = self.get_snapshot_mask(snapshot) or []
        self.create_snapshot_mask(snapshot, existing + list(encryptions))

    def trim_snapshot_mask_chunks(
        self, snapshot: SnapshotId, count: int
    ) -> None:
        """Drop mask chunks with index >= ``count`` — the end-of-stream
        marker of the chunked mask write above. A no-op everywhere
        except after an attempt that chunked the same snapshot with a
        LARGER batch size (fewer chunks) than a crashed predecessor.
        Backends with durable chunk rows override; the fallback's
        whole-list writes never leave excess chunks."""
        return None

    @abc.abstractmethod
    def get_snapshot_mask(self, snapshot: SnapshotId) -> Optional[List[Encryption]]: ...

    # -- recurring-round schedules (service/scheduler.py) -------------------
    # One document per ScheduleSpec, keyed by ``doc["schedule"]`` and
    # carrying the schedule's current epoch number. The scheduler plane
    # uses two conditional writes — create-if-absent installation and an
    # epoch-keyed CAS advance — so a fleet of schedulers mints each epoch
    # exactly once (the same single-winner discipline as
    # ``transition_round_state``). The four in-repo backends override
    # with durable, contended-safe implementations; the base fallbacks
    # keep third-party stores working (in-memory, NOT crash- or
    # fleet-safe).

    def _fallback_schedules(self) -> dict:
        schedules = getattr(self, "_base_schedules", None)
        if schedules is None:
            schedules = self._base_schedules = {}
        return schedules

    def create_schedule_state(self, doc: dict) -> bool:
        """Conditional insert: record the schedule document iff none with
        its ``doc["schedule"]`` name exists yet; returns whether THIS
        call installed it. Installation must be single-winner so a fleet
        of schedulers booting against one shared store cannot reset a
        schedule that already advanced past epoch 0."""
        schedules = self._fallback_schedules()
        if doc["schedule"] in schedules:
            return False
        schedules[doc["schedule"]] = dict(doc)
        return True

    def get_schedule_state(self, schedule: str) -> Optional[dict]:
        doc = self._fallback_schedules().get(str(schedule))
        return None if doc is None else dict(doc)

    def list_schedule_states(self) -> List[dict]:
        return [dict(d) for d in self._fallback_schedules().values()]

    def transition_schedule_state(
        self, schedule: str, from_epoch: int, doc: dict
    ) -> bool:
        """Single-winner epoch advance: install ``doc`` iff the stored
        document's current ``epoch`` equals ``from_epoch``. N racing
        scheduler workers CAS epoch e -> e+1; exactly one wins and mints
        the epoch's aggregation, the losers observe the winner's advance
        and converge (service/scheduler.py)."""
        schedules = self._fallback_schedules()
        current = schedules.get(str(schedule))
        if current is None or int(current.get("epoch", -1)) != int(from_epoch):
            return False
        schedules[str(schedule)] = dict(doc)
        return True

    # -- round lifecycle (server/lifecycle.py) ------------------------------
    # The four in-repo backends override all of these with durable,
    # contended-safe implementations; the base fallbacks below keep
    # third-party stores working (in-memory, NOT crash- or fleet-safe).

    def _fallback_rounds(self) -> dict:
        rounds = getattr(self, "_base_rounds", None)
        if rounds is None:
            rounds = self._base_rounds = {}
        return rounds

    def put_round_state(self, doc: dict) -> None:
        """Unconditionally upsert a round lifecycle document (keyed by its
        ``doc["aggregation"]`` id string)."""
        self._fallback_rounds()[doc["aggregation"]] = dict(doc)

    def get_round_state(self, aggregation: AggregationId) -> Optional[dict]:
        doc = self._fallback_rounds().get(str(aggregation))
        return None if doc is None else dict(doc)

    def list_round_states(self) -> List[dict]:
        return [dict(d) for d in self._fallback_rounds().values()]

    def transition_round_state(
        self, aggregation: AggregationId, from_states, doc: dict
    ) -> bool:
        """Conditional publish: install ``doc`` iff the stored record's
        current ``state`` is one of ``from_states`` — the single-winner
        CAS that lets N fleet workers race a lifecycle transition and
        guarantees exactly one performs it (the same conditional-write
        contract as ``create_snapshot``; docs/robustness.md)."""
        rounds = self._fallback_rounds()
        current = rounds.get(str(aggregation))
        if current is None or current.get("state") not in from_states:
            return False
        rounds[str(aggregation)] = dict(doc)
        return True


class ClerkingJobsStore(BaseStore):
    @abc.abstractmethod
    def enqueue_clerking_job(self, job: ClerkingJob) -> None:
        """Queue a job for its clerk. Must be an upsert keyed by
        ``(clerk, id)`` and must NOT resurrect a completed job — snapshot
        creation relies on this to be retry-idempotent."""

    def enqueue_clerking_jobs(self, jobs: Iterable[ClerkingJob]) -> None:
        """Bulk enqueue — the snapshot pipeline queues one job per
        committee member in a single store transaction where the backend
        supports it. The fallback loops; overrides must preserve the
        per-job upsert + never-resurrect-done semantics."""
        for job in jobs:
            self.enqueue_clerking_job(job)

    @abc.abstractmethod
    def poll_clerking_job(self, clerk: AgentId) -> Optional[ClerkingJob]:
        """Peek the clerk's next undone job (reference semantics: the job
        stays visible until its result lands)."""

    def lease_clerking_job(
        self, clerk: AgentId, lease_seconds: float,
        now: Optional[float] = None, owner: Optional[str] = None,
    ) -> Optional[Tuple[ClerkingJob, float]]:
        """Pull the clerk's next undone job that is not under an active
        lease and stamp a new lease on it; returns ``(job, expires_at)``.

        A lease is a visibility timeout (the SQS model): while held, other
        pollers of the same clerk identity get the NEXT job instead of
        duplicating this one; once it expires without a result the job is
        *reissued* — returned again to whichever live poller asks first
        (``server.job.reissued``). Backends without native lease support
        inherit this fallback, which degrades to the plain visible-poll.

        ``owner`` names the fleet worker granting the lease (the server's
        ``node_id``): backends record it so the gray-failure plane can
        proactively recall EVERY lease a dead worker held
        (``recall_clerking_job_leases``) and hedge a suspect worker's
        jobs (``hedge_clerking_job``) without waiting out per-job expiry.
        """
        job = self.poll_clerking_job(clerk)
        if job is None:
            return None
        now = time.time() if now is None else now
        return job, now + lease_seconds

    def release_clerking_job_lease(
        self, clerk: AgentId, job: ClerkingJobId,
        expires: Optional[float] = None,
    ) -> bool:
        """Drop an active lease early so the NEXT poller (on any worker
        process) gets the job immediately instead of waiting out the
        visibility timeout — the graceful-drain path: a terminating
        worker hands its in-flight clerking work back to the fleet.

        ``expires`` is the expiry instant the caller was granted: when
        given, ONLY the lease expiring at exactly that instant is
        released (compare-and-release) — a lease that lapsed and was
        re-granted to a peer belongs to that peer now and must be left
        alone, or the drain would expose the peer's in-flight job to a
        third worker. Returns whether a lease was actually released.
        No-op (False) on done jobs and on backends without lease
        support."""
        return False

    def recall_clerking_job_leases(self, node_id: str) -> int:
        """Drop EVERY active lease granted by fleet worker ``node_id`` —
        the failure detector's recovery step once that worker is declared
        dead (``server/health.py``): any peer's next poll reissues the
        work immediately instead of waiting out per-job lease expiry.
        Done jobs are untouched (their results already landed). Returns
        how many leases were recalled; 0 on backends without lease-owner
        support (per-job expiry remains the fallback)."""
        return 0

    def hedge_clerking_job(
        self, clerk: AgentId, suspect_nodes, lease_seconds: float,
        now: Optional[float] = None, owner: Optional[str] = None,
    ) -> Optional[Tuple[ClerkingJob, float]]:
        """Straggler hedging (the Tail-at-Scale hedged-request move, at
        clerking-job granularity): grant THIS caller a lease on the
        clerk's next undone job even though it is actively leased — but
        ONLY when the current holder is one of ``suspect_nodes`` (a
        worker whose heartbeat went stale without being declared dead).
        The hedged copy races the original; commit stays single-winner
        via the store-arbitrated conditional result insert, so duplicate
        partial sums are impossible and the verdict stays bit-exact.
        Returns ``(job, expires_at)`` or None; None on backends without
        lease-owner support."""
        return None

    # -- fleet heartbeats (server/health.py) --------------------------------
    # The four in-repo backends override these with durable, contended-safe
    # implementations; the base fallbacks keep third-party stores working
    # (in-memory, NOT crash- or fleet-safe).

    def _fallback_heartbeats(self) -> dict:
        beats = getattr(self, "_base_heartbeats", None)
        if beats is None:
            beats = self._base_heartbeats = {}
        return beats

    def put_worker_heartbeat(self, doc: dict) -> None:
        """Unconditionally upsert a worker heartbeat row (keyed by
        ``doc["node"]``) — each worker writes only its own."""
        self._fallback_heartbeats()[doc["node"]] = dict(doc)

    def get_worker_heartbeat(self, node: str) -> Optional[dict]:
        doc = self._fallback_heartbeats().get(str(node))
        return None if doc is None else dict(doc)

    def list_worker_heartbeats(self) -> List[dict]:
        return [dict(d) for d in self._fallback_heartbeats().values()]

    def transition_worker_state(self, node: str, from_states,
                                doc: dict) -> bool:
        """Conditional publish: install ``doc`` iff the stored heartbeat's
        current ``state`` is one of ``from_states`` — the single-winner
        CAS that lets N fleet sweepers race a suspect/dead declaration
        and guarantees exactly one performs it (and recalls the dead
        node's leases exactly once); same contract as
        ``transition_round_state``."""
        beats = self._fallback_heartbeats()
        current = beats.get(str(node))
        if current is None or current.get("state") not in from_states:
            return False
        beats[str(node)] = dict(doc)
        return True

    @abc.abstractmethod
    def get_clerking_job(
        self, clerk: AgentId, job: ClerkingJobId
    ) -> Optional[ClerkingJob]: ...

    @abc.abstractmethod
    def create_clerking_result(self, result: ClerkingResult) -> None: ...

    def list_snapshot_jobs(
        self, snapshot: SnapshotId
    ) -> List[Tuple[ClerkingJobId, AgentId, bool, float]]:
        """Every clerking job of the snapshot as ``(job id, clerk, done,
        leased_until)`` — the round sweeper's dead-clerk census
        (``server/lifecycle.py``): past the clerking deadline, an undone
        job with no active lease (``leased_until <= now``) marks its
        clerk dead. ``leased_until`` is 0 for never-leased jobs and on
        backends without lease support. The base fallback returns ``[]``
        (no census possible → the sweeper stays silent)."""
        return []

    def purge_snapshot_jobs(self, snapshot: SnapshotId) -> int:
        """Remove EVERY clerking job, lease, and result of ``snapshot`` —
        the job-store half of the aggregation delete/retention cascade
        (``SdaServer.purge_aggregation``): a long-running service expires
        revealed rounds and their artifacts must actually leave all four
        backends, or fleet memory and store size grow forever
        (service/retention.py). Idempotent: purging an already-purged
        snapshot removes nothing. Returns how many documents (jobs +
        results) were removed; 0 on backends without purge support (the
        base fallback — artifacts then leak, as pre-retention stores
        always did)."""
        return 0

    @abc.abstractmethod
    def list_results(self, snapshot: SnapshotId) -> List[ClerkingJobId]: ...

    @abc.abstractmethod
    def get_result(
        self, snapshot: SnapshotId, job: ClerkingJobId
    ) -> Optional[ClerkingResult]: ...
