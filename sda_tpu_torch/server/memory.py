"""In-memory store backend: dicts under a lock.

The fastest fixture backend (the reference's analog is the jfs tempdir
store used by integration tests); also the store of choice for
simulated-pod runs where the server is pure control plane.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from .. import chaos
from ..utils import metrics
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
    NotFound,
    Participation,
    ParticipationConflict,
    ParticipationId,
    Snapshot,
    SnapshotId,
)
from .stores import (
    AgentsStore,
    AggregationsStore,
    AuthTokensStore,
    BaseStore,
    ClerkingJobsStore,
)


class _Locked(BaseStore):
    def __init__(self):
        self._lock = threading.RLock()

    def ping(self) -> None:
        pass


class MemoryAuthTokensStore(_Locked, AuthTokensStore):
    def __init__(self):
        super().__init__()
        self._tokens = {}

    def upsert_auth_token(self, token):
        with self._lock:
            self._tokens[token.id] = token

    def get_auth_token(self, id):
        with self._lock:
            return self._tokens.get(id)

    def delete_auth_token(self, id):
        with self._lock:
            self._tokens.pop(id, None)


class MemoryAgentsStore(_Locked, AgentsStore):
    def __init__(self):
        super().__init__()
        self._agents: Dict[AgentId, Agent] = {}
        self._profiles = {}
        self._keys = {}

    def create_agent(self, agent):
        with self._lock:
            self._agents[agent.id] = agent

    def get_agent(self, id):
        with self._lock:
            return self._agents.get(id)

    def upsert_profile(self, profile):
        with self._lock:
            self._profiles[profile.owner] = profile

    def get_profile(self, owner):
        with self._lock:
            return self._profiles.get(owner)

    def create_encryption_key(self, key):
        with self._lock:
            self._keys[key.body.id] = key

    def get_encryption_key(self, key):
        with self._lock:
            return self._keys.get(key)

    def suggest_committee(self):
        with self._lock:
            by_signer: Dict[AgentId, List] = {}
            for signed in self._keys.values():
                by_signer.setdefault(signed.signer, []).append(signed.body.id)
            return [
                ClerkCandidate(id=signer, keys=keys)
                for signer, keys in sorted(by_signer.items(), key=lambda kv: kv[0])
            ]


class MemoryAggregationsStore(_Locked, AggregationsStore):
    def __init__(self):
        super().__init__()
        self._aggregations: Dict[AggregationId, Aggregation] = {}
        self._committees: Dict[AggregationId, Committee] = {}
        # insertion-ordered so snapshots freeze a deterministic set
        self._participations: Dict[AggregationId, OrderedDict] = {}
        # exactly-once ingestion index: (aggregation, participant) ->
        # (participation id, canonical digest) — the single-winner key
        self._part_owners: Dict[AggregationId, Dict] = {}
        self._snapshots: Dict[AggregationId, OrderedDict] = {}
        self._snapshot_parts: Dict[SnapshotId, List[ParticipationId]] = {}
        self._snapshot_masks = {}
        self._rounds: Dict[str, dict] = {}  # aggregation id str -> doc
        self._schedules: Dict[str, dict] = {}  # schedule name -> doc

    def list_aggregations(self, filter=None, recipient=None):
        with self._lock:
            out = []
            for agg in self._aggregations.values():
                if filter is not None and filter not in agg.title:
                    continue
                if recipient is not None and agg.recipient != recipient:
                    continue
                out.append(agg.id)
            return out

    def create_aggregation(self, aggregation):
        with self._lock:
            self._aggregations[aggregation.id] = aggregation
            self._participations.setdefault(aggregation.id, OrderedDict())
            self._snapshots.setdefault(aggregation.id, OrderedDict())

    def get_aggregation(self, aggregation):
        with self._lock:
            return self._aggregations.get(aggregation)

    def delete_aggregation(self, aggregation):
        with self._lock:
            self._aggregations.pop(aggregation, None)
            self._committees.pop(aggregation, None)
            self._participations.pop(aggregation, None)
            self._part_owners.pop(aggregation, None)
            self._rounds.pop(str(aggregation), None)
            for sid in self._snapshots.pop(aggregation, OrderedDict()):
                self._snapshot_parts.pop(sid, None)
                self._snapshot_masks.pop(sid, None)

    def get_committee(self, aggregation):
        with self._lock:
            return self._committees.get(aggregation)

    def create_committee(self, committee):
        with self._lock:
            self._committees[committee.aggregation] = committee

    def create_participation(self, participation):
        chaos.fail("store.create_participation")
        digest = participation.canonical_digest()
        # the whole check-and-insert under ONE lock hold is the arbiter:
        # two racing uploaders of one (aggregation, participant) key admit
        # exactly one winner (exactly-once ingestion contract, stores.py)
        with self._lock:
            if participation.aggregation not in self._aggregations:
                raise NotFound("aggregation not found")
            parts = self._participations[participation.aggregation]
            existing = parts.get(participation.id)
            if existing is not None:
                # same participation id: byte-identical replay is an
                # idempotent success; different content must never
                # silently replace the earlier bundle
                if existing.canonical_digest() == digest:
                    return False
                raise ParticipationConflict(
                    f"participation {participation.id} already exists "
                    "with different content",
                    participant=participation.participant,
                    aggregation=participation.aggregation)
            owners = self._part_owners.setdefault(participation.aggregation, {})
            owned = owners.get(participation.participant)
            if owned is not None:
                # the same agent under a NEW id: a recompute-with-fresh-
                # randomness (or equivocation) that would double-count
                raise ParticipationConflict(
                    f"agent {participation.participant} already "
                    f"participated in {participation.aggregation} "
                    f"(participation {owned[0]})",
                    participant=participation.participant,
                    aggregation=participation.aggregation)
            owners[participation.participant] = (participation.id, digest)
            parts[participation.id] = participation
            return True

    def create_snapshot(self, snapshot):
        chaos.fail("store.create_snapshot")
        # conditional insert: first writer wins, the record never changes
        # after it exists (contended-idempotency contract, stores.py)
        with self._lock:
            snapshots = self._snapshots[snapshot.aggregation]
            if snapshot.id in snapshots:
                return False
            snapshots[snapshot.id] = snapshot
            return True

    def list_snapshots(self, aggregation):
        with self._lock:
            return list(self._snapshots.get(aggregation, OrderedDict()))

    def get_snapshot(self, aggregation, snapshot):
        with self._lock:
            return self._snapshots.get(aggregation, OrderedDict()).get(snapshot)

    def count_participations(self, aggregation):
        with self._lock:
            return len(self._participations.get(aggregation, OrderedDict()))

    def snapshot_participations(self, aggregation, snapshot):
        # single-winner: the dict insert under the lock is the arbiter;
        # a loser returns False and the winner's frozen set is already
        # readable (same lock serializes freeze and read)
        with self._lock:
            if snapshot in self._snapshot_parts:
                return False
            self._snapshot_parts[snapshot] = list(
                self._participations.get(aggregation, OrderedDict())
            )
            return True

    def has_snapshot_freeze(self, aggregation, snapshot):
        with self._lock:
            return snapshot in self._snapshot_parts  # even when frozen empty

    def iter_snapped_participations(self, aggregation, snapshot):
        with self._lock:
            part_ids = self._snapshot_parts.get(snapshot, [])
            parts = self._participations.get(aggregation, OrderedDict())
            return [parts[pid] for pid in part_ids if pid in parts]

    # -- round lifecycle ----------------------------------------------------
    def put_round_state(self, doc):
        with self._lock:
            self._rounds[doc["aggregation"]] = dict(doc)

    def get_round_state(self, aggregation):
        with self._lock:
            doc = self._rounds.get(str(aggregation))
            return None if doc is None else dict(doc)

    def list_round_states(self):
        with self._lock:
            return [dict(d) for d in self._rounds.values()]

    def transition_round_state(self, aggregation, from_states, doc):
        # single-winner CAS: the state check + publish under one lock is
        # the arbiter (same contract the sqlite/jsonfs/mongo stores keep
        # across OS processes)
        with self._lock:
            current = self._rounds.get(str(aggregation))
            if current is None or current.get("state") not in from_states:
                return False
            self._rounds[str(aggregation)] = dict(doc)
            return True

    # -- recurring-round schedules -------------------------------------------
    def create_schedule_state(self, doc):
        # conditional insert under the store lock: installation is
        # single-winner, a booting scheduler can never reset an advanced
        # schedule (stores.py schedule contract)
        with self._lock:
            if doc["schedule"] in self._schedules:
                return False
            self._schedules[doc["schedule"]] = dict(doc)
            return True

    def get_schedule_state(self, schedule):
        with self._lock:
            doc = self._schedules.get(str(schedule))
            return None if doc is None else dict(doc)

    def list_schedule_states(self):
        with self._lock:
            return [dict(d) for d in self._schedules.values()]

    def transition_schedule_state(self, schedule, from_epoch, doc):
        # single-winner epoch CAS: the epoch check + publish under one
        # lock hold is the arbiter (same contract the sqlite/jsonfs/mongo
        # stores keep across OS processes)
        with self._lock:
            current = self._schedules.get(str(schedule))
            if current is None \
                    or int(current.get("epoch", -1)) != int(from_epoch):
                return False
            self._schedules[str(schedule)] = dict(doc)
            return True

    def create_snapshot_mask(self, snapshot, mask):
        with self._lock:
            self._snapshot_masks[snapshot] = {0: list(mask)}

    def put_snapshot_mask_chunk(self, snapshot, index, encryptions):
        # pure chunk upsert keyed by index: replays/contended peers
        # rewrite identical chunks, so readers always see a complete
        # mask (stores.py contract); trim drops any excess at the end
        with self._lock:
            chunks = self._snapshot_masks.setdefault(snapshot, {})
            chunks[int(index)] = list(encryptions)

    def trim_snapshot_mask_chunks(self, snapshot, count):
        with self._lock:
            chunks = self._snapshot_masks.get(snapshot)
            if chunks is not None:
                for ix in [ix for ix in chunks if ix >= int(count)]:
                    del chunks[ix]

    def get_snapshot_mask(self, snapshot):
        with self._lock:
            chunks = self._snapshot_masks.get(snapshot)
            if chunks is None:
                return None
            return [e for ix in sorted(chunks) for e in chunks[ix]]


class MemoryClerkingJobsStore(_Locked, ClerkingJobsStore):
    def __init__(self):
        super().__init__()
        self._queues: Dict[AgentId, OrderedDict] = {}
        self._done: Dict[AgentId, Dict[ClerkingJobId, ClerkingJob]] = {}
        self._results: Dict[SnapshotId, OrderedDict] = {}
        self._leases: Dict[ClerkingJobId, float] = {}  # job id -> expires_at
        self._lease_owners: Dict[ClerkingJobId, str] = {}  # -> node_id
        self._heartbeats: Dict[str, dict] = {}  # node id -> heartbeat doc

    def enqueue_clerking_job(self, job):
        chaos.fail("store.enqueue_clerking_job")
        with self._lock:
            if job.id in self._done.get(job.clerk, {}):
                return  # snapshot retry: this job already completed
            self._queues.setdefault(job.clerk, OrderedDict())[job.id] = job

    def enqueue_clerking_jobs(self, jobs):
        jobs = list(jobs)
        for _ in jobs:
            chaos.fail("store.enqueue_clerking_job")
        with self._lock:  # one lock hold for the whole fan-out
            for job in jobs:
                if job.id in self._done.get(job.clerk, {}):
                    continue  # snapshot retry: this job already completed
                self._queues.setdefault(job.clerk, OrderedDict())[job.id] = job

    def poll_clerking_job(self, clerk):
        chaos.fail("store.poll_clerking_job")
        with self._lock:
            queue = self._queues.get(clerk)
            if not queue:
                return None
            return next(iter(queue.values()))

    def lease_clerking_job(self, clerk, lease_seconds, now=None, owner=None):
        chaos.fail("store.poll_clerking_job")
        now = time.time() if now is None else now
        with self._lock:
            for job in self._queues.get(clerk, OrderedDict()).values():
                expiry = self._leases.get(job.id)
                if expiry is not None and expiry > now:
                    continue  # actively leased by another worker of this clerk
                if expiry is not None:
                    metrics.count("server.job.reissued")
                expires = now + lease_seconds
                self._leases[job.id] = expires
                self._lease_owners[job.id] = owner
                return job, expires
            return None

    def release_clerking_job_lease(self, clerk, job, expires=None):
        # graceful drain: drop the visibility timeout so the next poller
        # (another worker of this clerk) gets the job immediately —
        # compare-and-release: a lapsed lease re-granted to a peer (new
        # expiry) is the peer's to release, not ours
        with self._lock:
            if job not in self._queues.get(clerk, OrderedDict()):
                return False  # done (or never enqueued): nothing to release
            current = self._leases.get(job)
            if current is None or (expires is not None and current != expires):
                return False
            del self._leases[job]
            self._lease_owners.pop(job, None)
            return True

    def recall_clerking_job_leases(self, node_id):
        # the dead-node recovery step: every lease the dead worker granted
        # goes back to "unleased" so any peer's next poll reissues it now
        with self._lock:
            recalled = [
                job_id for job_id, owner in self._lease_owners.items()
                if owner == node_id and job_id in self._leases
            ]
            for job_id in recalled:
                self._leases.pop(job_id, None)
                self._lease_owners.pop(job_id, None)
            return len(recalled)

    def hedge_clerking_job(self, clerk, suspect_nodes, lease_seconds,
                           now=None, owner=None):
        # hedged execution: re-grant a SUSPECT holder's active lease to
        # this caller; the original may still finish — result commit is
        # single-winner, so the race is safe
        now = time.time() if now is None else now
        suspects = set(suspect_nodes)
        if not suspects:
            return None
        with self._lock:
            for job in self._queues.get(clerk, OrderedDict()).values():
                expiry = self._leases.get(job.id)
                if expiry is None or expiry <= now:
                    continue  # unleased/lapsed: the normal poll covers it
                if self._lease_owners.get(job.id) not in suspects:
                    continue
                expires = now + lease_seconds
                self._leases[job.id] = expires
                self._lease_owners[job.id] = owner
                return job, expires
            return None

    # -- fleet heartbeats ---------------------------------------------------
    def put_worker_heartbeat(self, doc):
        with self._lock:
            self._heartbeats[doc["node"]] = dict(doc)

    def get_worker_heartbeat(self, node):
        with self._lock:
            doc = self._heartbeats.get(str(node))
            return None if doc is None else dict(doc)

    def list_worker_heartbeats(self):
        with self._lock:
            return [dict(d) for d in self._heartbeats.values()]

    def transition_worker_state(self, node, from_states, doc):
        # single-winner CAS under the store lock (the fleet contract:
        # exactly one sweeper declares a node suspect/dead)
        with self._lock:
            current = self._heartbeats.get(str(node))
            if current is None or current.get("state") not in from_states:
                return False
            self._heartbeats[str(node)] = dict(doc)
            return True

    def list_snapshot_jobs(self, snapshot):
        # the sweeper's dead-clerk census: queued jobs with their lease
        # expiry, done jobs flagged done (lease irrelevant once complete)
        with self._lock:
            out = []
            for clerk, queue in self._queues.items():
                for job in queue.values():
                    if str(job.snapshot) == str(snapshot):
                        out.append((job.id, clerk, False,
                                    float(self._leases.get(job.id, 0.0))))
            for clerk, done in self._done.items():
                for job in done.values():
                    if str(job.snapshot) == str(snapshot):
                        out.append((job.id, clerk, True, 0.0))
            return sorted(out, key=lambda entry: str(entry[0]))

    def get_clerking_job(self, clerk, job):
        with self._lock:
            found = self._queues.get(clerk, OrderedDict()).get(job)
            if found is None:
                found = self._done.get(clerk, {}).get(job)
            return found

    def create_clerking_result(self, result):
        chaos.fail("store.create_clerking_result")
        with self._lock:
            queue = self._queues.get(result.clerk, OrderedDict())
            job = queue.pop(result.job, None)
            if job is None and result.job not in self._done.get(result.clerk, {}):
                raise NotFound("job not found for clerk")
            if job is not None:
                self._leases.pop(job.id, None)
                self._lease_owners.pop(job.id, None)
                self._done.setdefault(result.clerk, {})[job.id] = job
                self._results.setdefault(job.snapshot, OrderedDict())[result.job] = result

    def purge_snapshot_jobs(self, snapshot):
        # the retention/delete cascade's job-store half: queued AND done
        # jobs of the snapshot leave, with their leases and results —
        # nothing the round ever produced survives the purge
        with self._lock:
            removed = 0
            for table in (self._queues, self._done):
                for clerk in list(table):
                    jobs = table[clerk]
                    for job_id in [jid for jid, job in jobs.items()
                                   if str(job.snapshot) == str(snapshot)]:
                        del jobs[job_id]
                        self._leases.pop(job_id, None)
                        self._lease_owners.pop(job_id, None)
                        removed += 1
                    if not jobs:
                        del table[clerk]
            removed += len(self._results.pop(snapshot, OrderedDict()))
            return removed

    def list_results(self, snapshot):
        with self._lock:
            return list(self._results.get(snapshot, OrderedDict()))

    def get_result(self, snapshot, job):
        with self._lock:
            return self._results.get(snapshot, OrderedDict()).get(job)
