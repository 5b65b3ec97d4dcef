"""Server core: raw operations + the ACL-enforcing service wrapper.

Reference: server/src/server.rs. ``SdaServer`` is a thin delegation over the
four store interfaces plus auth-token checking; ``SdaServerService`` is the
``SdaService`` implementation that guards every mutating call with
"caller is the owner" checks (acl_agent_is, :203-209) and recipient-only /
clerk-only rules (:270-360). The server holds no in-memory protocol state —
every object is durable in a store the moment it exists, which is the
framework's checkpoint/resume story (SURVEY.md §5.4).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from ..protocol import (
    Agent,
    AgentId,
    Aggregation,
    AggregationId,
    AggregationStatus,
    ClerkCandidate,
    ClerkingJob,
    ClerkingJobId,
    ClerkingResult,
    Committee,
    EncryptionKeyId,
    InvalidCredentials,
    InvalidRequest,
    NotFound,
    Participation,
    ParticipationConflict,
    PermissionDenied,
    Pong,
    Profile,
    SdaService,
    Signed,
    Snapshot,
    SnapshotId,
    SnapshotResult,
    SnapshotStatus,
)
from .. import obs
from ..utils import metrics
from . import lifecycle
from . import snapshot as snapshot_mod
from .wakeup import JobWakeup, clamp_wait, longpoll_tick
from .stores import (
    AgentsStore,
    AggregationsStore,
    AuthToken,
    AuthTokensStore,
    ClerkingJobsStore,
)


class SdaServer:
    """Raw server operations over pluggable stores (server.rs:5-191)."""

    def __init__(
        self,
        agents_store: AgentsStore,
        auth_tokens_store: AuthTokensStore,
        aggregation_store: AggregationsStore,
        clerking_job_store: ClerkingJobsStore,
    ):
        self.agents_store = agents_store
        self.auth_tokens_store = auth_tokens_store
        self.aggregation_store = aggregation_store
        self.clerking_job_store = clerking_job_store
        #: opt-in: homomorphically combine each clerk's ciphertext column at
        #: snapshot time when the committee scheme is PackedPaillier
        #: (snapshot.py premixing) — clerk downloads shrink ~N x
        self.premix_paillier = False
        #: opt-in (like premixing): when set, a polled clerking job is
        #: LEASED for this many seconds — invisible to the clerk's other
        #: workers while held, reissued to the next live poller once the
        #: lease expires without a result. None keeps the reference's
        #: visible-poll semantics (the job is returned on every poll).
        self.clerking_lease_seconds: Optional[float] = None
        # serializes the snapshot pipeline WITHIN this process: a timed-out
        # client retrying a slow snapshot POST must queue behind the
        # original, not race its freeze/enqueue. ACROSS processes the
        # store-level single-winner freeze/record inserts arbitrate
        # (snapshot.py, contended-idempotency contract)
        self._snapshot_lock = threading.Lock()
        #: node identity in a fleet (sda_tpu_torch/server/fleet.py); None when
        #: running solo. Flows into span attributes, /statusz, /metrics
        #: labels and the X-SDA-Node response header.
        self.node_id: Optional[str] = None
        # leases THIS worker granted and has not yet seen a result for —
        # what graceful drain hands back to the fleet (release_held_leases)
        self._granted_leases: dict = {}
        self._granted_lock = threading.Lock()
        #: long-poll push plane (server/wakeup.py): snapshot fan-out,
        #: drain lease handback and dead-worker lease recall notify the
        #: clerks that might now have work, so a parked
        #: ``GET /v1/clerking-jobs?wait=S`` wakes immediately instead of
        #: polling the store. Per-process: cross-worker events degrade to
        #: the long-poll re-check tick.
        self.job_wakeup = JobWakeup()
        # enqueue stamps for the server.job.pickup histogram: job id ->
        # monotonic enqueue time, observed (and popped) when THIS worker
        # grants the lease. A job picked up via a fleet peer has no stamp
        # here — counted, not observed (the latency is unknowable locally).
        self._job_enqueued_at: dict = {}
        self._job_enqueued_lock = threading.Lock()
        #: straggler hedging (server/health.py): when set to a staleness
        #: threshold in seconds, an empty lease poll may hedge a job whose
        #: holder's heartbeat is that stale — the hedged copy races the
        #: suspect, result commit stays single-winner. None = off.
        self.hedge_suspect_after_s: Optional[float] = None
        # suspect-set cache: one heartbeat census per poll would make the
        # hot empty-poll path a store scan; a short TTL is plenty (the
        # detector's own cadence is coarser than this)
        self._suspects_cache: tuple = (0.0, [])
        #: per-phase round deadlines for the lifecycle supervisor
        #: (lifecycle.py); the default (all None) tracks states but never
        #: expires anything — arm via sdad --round-collect-deadline /
        #: --round-clerk-deadline and sweep with --round-sweep
        self.round_deadlines = lifecycle.RoundDeadlines()
        #: retention policy for terminal rounds (service/retention.py);
        #: None keeps every revealed/failed round forever (the
        #: pre-service behavior) — arm via sdad --retain-revealed /
        #: --retain-failed and sweep with --round-sweep
        self.retention_policy = None

    # -- health ------------------------------------------------------------
    def ping(self) -> Pong:
        self.agents_store.ping()
        return Pong(running=True)

    # -- agents ------------------------------------------------------------
    def create_agent(self, agent: Agent) -> None:
        self.agents_store.create_agent(agent)

    def get_agent(self, id: AgentId) -> Optional[Agent]:
        return self.agents_store.get_agent(id)

    def upsert_profile(self, profile: Profile) -> None:
        self.agents_store.upsert_profile(profile)

    def get_profile(self, agent: AgentId) -> Optional[Profile]:
        return self.agents_store.get_profile(agent)

    def create_encryption_key(self, key: Signed) -> None:
        self.agents_store.create_encryption_key(key)

    def get_encryption_key(self, key: EncryptionKeyId) -> Optional[Signed]:
        return self.agents_store.get_encryption_key(key)

    # -- aggregations ------------------------------------------------------
    def list_aggregations(self, filter=None, recipient=None) -> List[AggregationId]:
        return self.aggregation_store.list_aggregations(filter, recipient)

    def get_aggregation(self, aggregation: AggregationId) -> Optional[Aggregation]:
        return self.aggregation_store.get_aggregation(aggregation)

    def get_committee(self, aggregation: AggregationId) -> Optional[Committee]:
        return self.aggregation_store.get_committee(aggregation)

    def create_aggregation(self, aggregation: Aggregation) -> None:
        self.aggregation_store.create_aggregation(aggregation)
        # lifecycle: the aggregation's round starts collecting the moment
        # the resource exists (the supervisor's state machine is durable
        # in the same store the aggregation is)
        lifecycle.note_collecting(self, aggregation)

    def delete_aggregation(self, aggregation: AggregationId) -> None:
        """Full cascade, not just the aggregation doc: every artifact the
        round ever produced leaves both stores (the aggregation store's
        own cascade covers round doc, participations + owner markers,
        snapshots, freezes and mask chunks; the clerking-job store purge
        covers jobs, leases and results per snapshot). Retention
        (service/retention.py) depends on this being a FULL purge — a
        long-running service deleting revealed rounds must leave store
        size flat, not leak job payloads forever."""
        self.purge_aggregation(aggregation)

    def purge_aggregation(self, aggregation: AggregationId) -> dict:
        """The delete/retention cascade; returns ``{"snapshots", "jobs"}``
        tallies (jobs = clerking jobs + results removed). Idempotent —
        purging an unknown or already-purged aggregation removes
        nothing."""
        snapshots = self.aggregation_store.list_snapshots(aggregation)
        jobs = 0
        for snapshot_id in snapshots:
            jobs += int(self.clerking_job_store.purge_snapshot_jobs(
                snapshot_id) or 0)
        self.aggregation_store.delete_aggregation(aggregation)
        if jobs:
            metrics.count("server.purge.jobs", jobs)
        return {"snapshots": len(snapshots), "jobs": jobs}

    def suggest_committee(self, aggregation: AggregationId) -> List[ClerkCandidate]:
        if self.aggregation_store.get_aggregation(aggregation) is None:
            raise NotFound("aggregation not found")
        return self.agents_store.suggest_committee()

    def create_committee(self, committee: Committee) -> None:
        agg = self.aggregation_store.get_aggregation(committee.aggregation)
        if agg is None:
            raise NotFound("aggregation not found")
        expected = agg.committee_sharing_scheme.output_size
        if expected != len(committee.clerks_and_keys):
            raise InvalidRequest(
                f"expected {expected} clerks in the committee, "
                f"found {len(committee.clerks_and_keys)} instead"
            )
        self.aggregation_store.create_committee(committee)

    # -- participation -----------------------------------------------------
    def create_participation(self, participation: Participation) -> None:
        with obs.span("server.create_participation",
                      attributes={"participation": str(participation.id),
                                  "aggregation":
                                  str(participation.aggregation)}
                      ) as span:
            try:
                created = self.aggregation_store.create_participation(
                    participation)
            except ParticipationConflict:
                # detected equivocation / double participation: counted
                # here (every backend raises through this seam), mapped
                # to HTTP 409 by the transport
                span.set_attribute("conflict", True)
                metrics.count("server.participation.equivocation")
                raise
            if created is False:
                # byte-identical replay (crash/retry or journal resume):
                # idempotent success, nothing changed — tagged so a
                # forensics pass counts distinct participations exactly
                span.set_attribute("replayed", True)
                metrics.count("server.participation.replayed")
            else:
                # True, or None from a pre-exactly-once third-party store
                metrics.count("server.participation.created")

    # -- status / snapshots ------------------------------------------------
    def get_aggregation_status(
        self, aggregation: AggregationId
    ) -> Optional[AggregationStatus]:
        agg = self.aggregation_store.get_aggregation(aggregation)
        if agg is None:
            return None
        threshold = agg.committee_sharing_scheme.reconstruction_threshold
        snapshots = []
        for sid in self.aggregation_store.list_snapshots(aggregation):
            count = len(self.clerking_job_store.list_results(sid))
            snapshots.append(
                SnapshotStatus(
                    id=sid,
                    number_of_clerking_results=count,
                    result_ready=count >= threshold,
                )
            )
        return AggregationStatus(
            aggregation=aggregation,
            number_of_participations=self.aggregation_store.count_participations(aggregation),
            snapshots=snapshots,
        )

    def create_snapshot(self, snapshot: Snapshot) -> None:
        with obs.span("server.snapshot",
                      attributes={"snapshot": str(snapshot.id),
                                  "aggregation": str(snapshot.aggregation)}):
            if snapshot_mod.snapshot(self, snapshot):
                metrics.count("server.snapshot.created")

    # -- clerking ----------------------------------------------------------
    def note_jobs_enqueued(self, job_ids) -> None:
        """Stamp the enqueue instant of freshly fanned-out clerking jobs
        (snapshot.py) so the grant path can observe enqueue->lease latency
        as the ``server.job.pickup`` histogram — the metric the long-poll
        plane exists to collapse (docs/load.md). Bounded: past the size
        threshold, aged-out stamps (jobs granted via a peer) are swept
        and the oldest evicted, so fleet-mode fan-out faster than the
        age cutoff still can't grow the table or turn every fan-out into
        an O(table) rebuild."""
        now = time.monotonic()
        with self._job_enqueued_lock:
            if len(self._job_enqueued_at) >= 4096:
                cutoff = now - 600.0
                self._job_enqueued_at = {
                    j: t for j, t in self._job_enqueued_at.items()
                    if t > cutoff
                }
                overflow = len(self._job_enqueued_at) - 4096
                if overflow > 0:
                    stamps = self._job_enqueued_at
                    for job in sorted(stamps, key=stamps.get)[:overflow]:
                        del stamps[job]
            for job_id in job_ids:
                self._job_enqueued_at[job_id] = now

    def _observe_pickup(self, job_id) -> None:
        with self._job_enqueued_lock:
            enqueued = self._job_enqueued_at.pop(job_id, None)
        if enqueued is not None:
            metrics.observe("server.job.pickup", time.monotonic() - enqueued)
        else:
            # granted here, enqueued elsewhere (a fleet peer's fan-out or
            # a pre-restart round): the latency is unknowable locally
            metrics.count("server.job.pickup_unstamped")

    def sweep_granted_leases(self, now: Optional[float] = None) -> int:
        """Drop lapsed entries from the per-worker granted-lease table —
        a result posted via a PEER worker (or a lapsed lease a peer
        reissued) never comes back through this worker's create_result,
        so lapsed entries would otherwise accumulate forever. Shared by
        both HTTP planes (grant path + /statusz), so fleet-mode lease
        accounting cannot drift between implementations. Returns how many
        entries were swept."""
        now = time.time() if now is None else now
        with self._granted_lock:
            before = len(self._granted_leases)
            self._granted_leases = {
                j: ce for j, ce in self._granted_leases.items()
                if ce[1] > now
            }
            return before - len(self._granted_leases)

    def held_lease_count(self) -> int:
        """Live (unlapsed) leases this worker currently holds — the
        shared /statusz figure for both HTTP planes."""
        self.sweep_granted_leases()
        with self._granted_lock:
            return len(self._granted_leases)

    def _suspect_nodes(self) -> list:
        """Fleet workers that currently look unhealthy (stale heartbeat or
        an explicit suspect mark) — the hedging plane's shadow-execution
        targets. TTL-cached so empty polls stay cheap."""
        if self.hedge_suspect_after_s is None:
            return []
        now = time.monotonic()
        cached_at, suspects = self._suspects_cache
        if now - cached_at < 0.5:
            return suspects
        from . import health

        suspects = health.suspect_nodes(
            self.clerking_job_store, self.hedge_suspect_after_s,
            exclude=self.node_id)
        self._suspects_cache = (now, suspects)
        return suspects

    def poll_clerking_job(self, clerk: AgentId) -> Optional[ClerkingJob]:
        with obs.span("server.poll_job",
                      attributes={"clerk": str(clerk)}) as poll_span:
            if self.clerking_lease_seconds is not None:
                leased = self.clerking_job_store.lease_clerking_job(
                    clerk, self.clerking_lease_seconds, owner=self.node_id
                )
                if leased is None:
                    # straggler hedging: nothing unleased, but a job held
                    # by a SUSPECT worker may be hedged — the poller runs
                    # a speculative copy; whichever result lands first
                    # wins the single-winner commit, so a slow-but-alive
                    # holder costs duplicated work, never correctness
                    suspects = self._suspect_nodes()
                    if suspects:
                        leased = self.clerking_job_store.hedge_clerking_job(
                            clerk, suspects, self.clerking_lease_seconds,
                            owner=self.node_id)
                        if leased is not None:
                            poll_span.set_attribute("hedged", True)
                            metrics.count("server.job.hedged")
                            obs.add_event("job.hedged",
                                          job=str(leased[0].id),
                                          suspects=",".join(suspects))
                job = None
                if leased is not None:
                    job, expires = leased
                    poll_span.set_attribute("leased", True)
                    metrics.count("server.job.leased")
                    with self._granted_lock:
                        oversized = len(self._granted_leases) >= 256
                    if oversized:
                        self.sweep_granted_leases()
                    with self._granted_lock:
                        self._granted_leases[job.id] = (clerk, expires)
            else:
                job = self.clerking_job_store.poll_clerking_job(clerk)
            if job is not None:
                poll_span.set_attribute("job", str(job.id))
                # enqueue->lease latency: the polling-vs-long-poll headline
                self._observe_pickup(job.id)
            metrics.count("server.job.polled" if job else "server.job.poll_empty")
            return job

    def get_clerking_job(
        self, clerk: AgentId, job: ClerkingJobId
    ) -> Optional[ClerkingJob]:
        return self.clerking_job_store.get_clerking_job(clerk, job)

    def create_clerking_result(
        self, result: ClerkingResult, job: Optional[ClerkingJob] = None
    ) -> None:
        with obs.span("server.create_result",
                      attributes={"job": str(result.job)}):
            self.clerking_job_store.create_clerking_result(result)
        with self._granted_lock:
            self._granted_leases.pop(result.job, None)
        metrics.count("server.clerking_result.created")
        # lifecycle: a full committee's worth of results flips the round
        # to ready (threshold-satisfying partial sets stay clerking —
        # the sweeper decides whether the stragglers are dead). The
        # service wrapper already fetched the (payload-heavy) job for its
        # ACL check and passes it down; only direct core callers pay the
        # extra read.
        if job is None:
            job = self.clerking_job_store.get_clerking_job(
                result.clerk, result.job)
        if job is not None:
            lifecycle.note_result(self, job)

    def release_held_leases(self) -> int:
        """Graceful-drain step: hand every clerking-job lease this worker
        granted (and has no result for yet) back to the shared store, so
        a fleet peer's next poll reissues the job immediately instead of
        waiting out the visibility timeout. Returns how many leases were
        actually released (already-expired or just-completed ones are
        not)."""
        with self._granted_lock:
            held = list(self._granted_leases.items())
            self._granted_leases.clear()
        released = 0
        now = time.time()
        for job_id, (clerk, expires) in held:
            if expires <= now:
                # lapsed: a peer may already hold a fresh lease on this
                # job — it is not ours to release anymore
                continue
            try:
                if self.clerking_job_store.release_clerking_job_lease(
                    clerk, job_id, expires=expires
                ):
                    released += 1
            except Exception:  # drain must not die on one store hiccup
                continue
        if released:
            metrics.count("server.job.lease_released_on_drain", released)
            # same-process clerks parked on a long-poll should pick the
            # handed-back work up immediately; fleet peers' parked polls
            # catch it on their re-check tick
            self.job_wakeup.notify(clerk for _, (clerk, _) in held)
        return released

    def get_snapshot_result(
        self, aggregation: AggregationId, snapshot: SnapshotId
    ) -> Optional[SnapshotResult]:
        # the snapshot must exist under THIS aggregation — otherwise a caller
        # could read another aggregation's snapshot artifacts by id
        if self.aggregation_store.get_snapshot(aggregation, snapshot) is None:
            return None
        results = []
        for job_id in self.clerking_job_store.list_results(snapshot):
            result = self.clerking_job_store.get_result(snapshot, job_id)
            if result is None:
                raise NotFound("inconsistent storage")
            results.append(result)
        # lifecycle: a reconstruction-grade fetch is the reveal — the
        # round (ready, or degraded-completing-from-quorum) is done
        lifecycle.note_revealed(self, aggregation, snapshot, len(results))
        return SnapshotResult(
            snapshot=snapshot,
            number_of_participations=self.aggregation_store.count_participations_snapshot(
                aggregation, snapshot
            ),
            clerk_encryptions=results,
            recipient_encryptions=self.aggregation_store.get_snapshot_mask(snapshot),
        )

    def get_round_status(self, aggregation: AggregationId):
        """Lifecycle state of the aggregation's current round (the stored
        state-machine document plus the live result count), or None when
        nothing is tracked (pre-supervisor data)."""
        return lifecycle.round_status(self, aggregation)

    # -- auth tokens (used by the HTTP layer) ------------------------------
    def upsert_auth_token(self, token: AuthToken) -> None:
        self.auth_tokens_store.upsert_auth_token(token)

    def check_auth_token(self, token: AuthToken) -> Agent:
        import hmac

        stored = self.auth_tokens_store.get_auth_token(token.id)
        if stored is not None and hmac.compare_digest(
            stored.body.encode(), token.body.encode()
        ):
            agent = self.agents_store.get_agent(token.id)
            if agent is None:
                raise NotFound("agent not found")
            return agent
        raise InvalidCredentials()

    def delete_auth_token(self, agent: AgentId) -> None:
        self.auth_tokens_store.delete_auth_token(agent)


def _acl_agent_is(caller: Agent, agent_id: AgentId) -> None:
    """Every mutating call is guarded by caller identity (server.rs:203-209)."""
    if caller.id != agent_id:
        raise PermissionDenied()


class SdaServerService(SdaService):
    """ACL-enforcing SdaService over an SdaServer (server.rs:193-361)."""

    def __init__(self, server: SdaServer):
        self.server = server

    def ping(self) -> Pong:
        return self.server.ping()

    # -- agent service -----------------------------------------------------
    def create_agent(self, caller, agent):
        _acl_agent_is(caller, agent.id)
        self.server.create_agent(agent)

    def get_agent(self, caller, agent):
        return self.server.get_agent(agent)  # public, no acl

    def upsert_profile(self, caller, profile):
        _acl_agent_is(caller, profile.owner)
        self.server.upsert_profile(profile)

    def get_profile(self, caller, owner):
        return self.server.get_profile(owner)  # public, no acl

    def create_encryption_key(self, caller, key):
        _acl_agent_is(caller, key.signer)
        self.server.create_encryption_key(key)

    def get_encryption_key(self, caller, key):
        return self.server.get_encryption_key(key)  # public, no acl

    # -- aggregation service -----------------------------------------------
    def list_aggregations(self, caller, filter=None, recipient=None):
        return self.server.list_aggregations(filter, recipient)

    def get_aggregation(self, caller, aggregation):
        return self.server.get_aggregation(aggregation)

    def get_committee(self, caller, aggregation):
        return self.server.get_committee(aggregation)

    # -- recipient service -------------------------------------------------
    def _recipient_only(self, caller: Agent, aggregation: AggregationId) -> Aggregation:
        agg = self.server.get_aggregation(aggregation)
        if agg is None:
            raise NotFound("no aggregation found")
        _acl_agent_is(caller, agg.recipient)
        return agg

    def create_aggregation(self, caller, aggregation):
        _acl_agent_is(caller, aggregation.recipient)
        self.server.create_aggregation(aggregation)

    def delete_aggregation(self, caller, aggregation):
        self._recipient_only(caller, aggregation)
        self.server.delete_aggregation(aggregation)

    def suggest_committee(self, caller, aggregation):
        self._recipient_only(caller, aggregation)
        return self.server.suggest_committee(aggregation)

    def create_committee(self, caller, committee):
        self._recipient_only(caller, committee.aggregation)
        self.server.create_committee(committee)

    def get_aggregation_status(self, caller, aggregation):
        self._recipient_only(caller, aggregation)
        return self.server.get_aggregation_status(aggregation)

    def create_snapshot(self, caller, snapshot):
        self._recipient_only(caller, snapshot.aggregation)
        self.server.create_snapshot(snapshot)

    def get_snapshot_result(self, caller, aggregation, snapshot):
        self._recipient_only(caller, aggregation)
        return self.server.get_snapshot_result(aggregation, snapshot)

    def get_round_status(self, caller, aggregation):
        # recipient-only like status: the round's failure diagnosis names
        # dead clerks, which is committee topology the public cannot see
        self._recipient_only(caller, aggregation)
        return self.server.get_round_status(aggregation)

    # -- participation service ---------------------------------------------
    def create_participation(self, caller, participation):
        _acl_agent_is(caller, participation.participant)
        self.server.create_participation(participation)

    # -- clerking service --------------------------------------------------
    def get_clerking_job(self, caller, clerk):
        _acl_agent_is(caller, clerk)
        return self.server.poll_clerking_job(clerk)

    def await_clerking_job(self, caller, clerk, wait_s: float = 0.0):
        """Long-poll flavor of :meth:`get_clerking_job`: block up to
        ``wait_s`` (clamped to the long-poll bound) for a job to appear,
        parked on the server's job wakeup between store checks — the
        in-process mirror of ``GET /v1/clerking-jobs?wait=S``. Returns
        the job, or None when the wait expires empty. Not part of the
        ``SdaService`` seam: callers probe for it with ``getattr`` and
        fall back to plain polling (old peers, third-party seams)."""
        _acl_agent_is(caller, clerk)
        give_up = time.monotonic() + clamp_wait(wait_s)
        tick = longpoll_tick()
        while True:
            sub = self.server.job_wakeup.subscribe(clerk)
            try:
                # poll AFTER subscribing so an enqueue between the two
                # cannot be missed (it fires the live subscription)
                job = self.server.poll_clerking_job(clerk)
                remaining = give_up - time.monotonic()
                if job is not None or remaining <= 0:
                    return job
                sub.wait(min(tick, remaining))
            finally:
                self.server.job_wakeup.unsubscribe(sub)

    def create_clerking_result(self, caller, result):
        # double-check the job really belongs to the caller — a spoofed
        # result.clerk must not let one clerk overwrite another's work
        # (server.rs:345-360)
        job = self.server.get_clerking_job(result.clerk, result.job)
        if job is None:
            raise NotFound("job not found")
        _acl_agent_is(caller, job.clerk)
        self.server.create_clerking_result(result, job=job)
