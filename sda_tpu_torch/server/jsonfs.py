"""JSON-file store backend: one file per protocol object, durable on write.

The reference's jfs backend (server/src/jfs_stores/): every resource becomes
a JSON file the moment it exists, so the server is crash-safe by
construction — restart resumes from the directory tree. Layout:

Each store class takes its own root; with ``new_jsonfs_server(root)`` the
resulting tree is:

    <root>/agents/agents/<agent-id>.json
    <root>/agents/profiles/<agent-id>.json
    <root>/agents/keys/<key-id>.json
    <root>/auths/<agent-id>.json
    <root>/agg/aggregations/<agg-id>.json
    <root>/agg/committees/<agg-id>.json
    <root>/agg/participations/<agg-id>/<participation-id>.json
    <root>/agg/snapshots/<agg-id>/<snapshot-id>.json
    <root>/agg/snapshot_parts/<snapshot-id>.json   (frozen participation ids)
    <root>/agg/masks/<snapshot-id>.json
    <root>/jobs/queue/<clerk-id>/<job-id>.json
    <root>/jobs/done/<clerk-id>/<job-id>.json
    <root>/jobs/results/<snapshot-id>/<job-id>.json

The job queue mirrors the reference's per-clerk directory queue with
queue -> done moves on result creation (jfs_stores/clerking_jobs.rs:36-59).
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

from .. import chaos
from ..utils import metrics
from ..protocol import (
    Agent,
    AgentId,
    Aggregation,
    ClerkCandidate,
    ClerkingJob,
    ClerkingJobId,
    ClerkingResult,
    Committee,
    Encryption,
    NotFound,
    Participation,
    ParticipationConflict,
    Profile,
    Snapshot,
    SnapshotId,
    signed_encryption_key_from_obj,
)
from .stores import (
    AgentsStore,
    AggregationsStore,
    AuthTokensStore,
    BaseStore,
    ClerkingJobsStore,
    auth_token,
)


def _write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=".tmp-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _write_json_new(path: Path, obj) -> bool:
    """Create-if-absent, atomically even across OS processes: the payload
    lands in a temp file, then ``os.link`` publishes it — link(2) fails
    with EEXIST when the destination already exists, so exactly one of N
    racing writers wins and the losers see the winner's complete file
    (never a partial write). Returns whether THIS call created the file —
    the jsonfs arbiter for the contended-idempotency contract."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=".tmp-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _read_json(path: Path):
    if not path.exists():
        return None
    return json.loads(path.read_text())


def _ids_in(directory: Path) -> List[str]:
    if not directory.is_dir():
        return []
    return sorted(p.stem for p in directory.glob("*.json") if not p.name.startswith("."))


class _FsStore(BaseStore):
    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.RLock()

    def ping(self) -> None:
        if not self.root.is_dir():
            raise NotFound(f"store root {self.root} missing")

    @contextlib.contextmanager
    def _dir_lock(self, directory: Path):
        """Cross-PROCESS mutual exclusion over ``directory`` (flock on a
        dot-file inside it, so ``_ids_in`` never sees it). The in-process
        ``_lock`` only serializes threads; read-check-write sequences
        that must be atomic across fleet worker processes — the lease
        grant/release plane — take this too. Single-file publishes don't
        need it: ``os.link`` arbitration already is cross-process."""
        directory.mkdir(parents=True, exist_ok=True)
        fd = os.open(str(directory / ".dirlock"), os.O_CREAT | os.O_RDWR,
                     0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)


class JsonAuthTokensStore(_FsStore, AuthTokensStore):
    def upsert_auth_token(self, token):
        with self._lock:
            _write_json(self.root / f"{token.id}.json", {"id": str(token.id), "body": token.body})

    def get_auth_token(self, id):
        with self._lock:
            obj = _read_json(self.root / f"{id}.json")
            return None if obj is None else auth_token(type(id)(obj["id"]), obj["body"])

    def delete_auth_token(self, id):
        with self._lock:
            try:
                (self.root / f"{id}.json").unlink()
            except FileNotFoundError:
                pass


class JsonAgentsStore(_FsStore, AgentsStore):
    def create_agent(self, agent):
        with self._lock:
            _write_json(self.root / "agents" / f"{agent.id}.json", agent.to_obj())

    def get_agent(self, id):
        with self._lock:
            obj = _read_json(self.root / "agents" / f"{id}.json")
            return None if obj is None else Agent.from_obj(obj)

    def upsert_profile(self, profile):
        with self._lock:
            _write_json(self.root / "profiles" / f"{profile.owner}.json", profile.to_obj())

    def get_profile(self, owner):
        with self._lock:
            obj = _read_json(self.root / "profiles" / f"{owner}.json")
            return None if obj is None else Profile.from_obj(obj)

    def create_encryption_key(self, key):
        with self._lock:
            _write_json(self.root / "keys" / f"{key.body.id}.json", key.to_obj())

    def get_encryption_key(self, key):
        with self._lock:
            obj = _read_json(self.root / "keys" / f"{key}.json")
            return None if obj is None else signed_encryption_key_from_obj(obj)

    def suggest_committee(self):
        with self._lock:
            by_signer = {}
            for key_id in _ids_in(self.root / "keys"):
                signed = self.get_encryption_key(key_id)
                by_signer.setdefault(signed.signer, []).append(signed.body.id)
            return [
                ClerkCandidate(id=signer, keys=keys)
                for signer, keys in sorted(by_signer.items(), key=lambda kv: kv[0])
            ]


class JsonAggregationsStore(_FsStore, AggregationsStore):
    def list_aggregations(self, filter=None, recipient=None):
        with self._lock:
            out = []
            for agg_id in _ids_in(self.root / "aggregations"):
                agg = self.get_aggregation(agg_id)
                if filter is not None and filter not in agg.title:
                    continue
                if recipient is not None and agg.recipient != recipient:
                    continue
                out.append(agg.id)
            return out

    def create_aggregation(self, aggregation):
        with self._lock:
            _write_json(
                self.root / "aggregations" / f"{aggregation.id}.json", aggregation.to_obj()
            )

    def get_aggregation(self, aggregation):
        with self._lock:
            obj = _read_json(self.root / "aggregations" / f"{aggregation}.json")
            return None if obj is None else Aggregation.from_obj(obj)

    def delete_aggregation(self, aggregation):
        import shutil

        with self._lock:
            for sid in self.list_snapshots(aggregation):
                (self.root / "snapshot_parts" / f"{sid}.json").unlink(missing_ok=True)
                (self.root / "masks" / f"{sid}.json").unlink(missing_ok=True)
                shutil.rmtree(self.root / "masks" / str(sid),
                              ignore_errors=True)
            for sub in ("participations", "part_owners", "snapshots"):
                shutil.rmtree(self.root / sub / str(aggregation), ignore_errors=True)
            (self.root / "aggregations" / f"{aggregation}.json").unlink(missing_ok=True)
            (self.root / "committees" / f"{aggregation}.json").unlink(missing_ok=True)
            (self.root / "rounds" / f"{aggregation}.json").unlink(missing_ok=True)

    def get_committee(self, aggregation):
        with self._lock:
            obj = _read_json(self.root / "committees" / f"{aggregation}.json")
            return None if obj is None else Committee.from_obj(obj)

    def create_committee(self, committee):
        with self._lock:
            _write_json(
                self.root / "committees" / f"{committee.aggregation}.json", committee.to_obj()
            )

    def create_participation(self, participation):
        chaos.fail("store.create_participation")
        digest = participation.canonical_digest()
        agg = str(participation.aggregation)
        payload = (self.root / "participations" / agg
                   / f"{participation.id}.json")
        # the per-agent owner marker is the single-winner key: link(2)
        # create-if-absent arbitrates across OS processes, exactly like
        # the snapshot freeze (exactly-once ingestion contract,
        # stores.py). Marker FIRST, payload second: a crash between the
        # two leaves a claimed-but-unwritten slot that the replay below
        # repairs; payload-first would leave an UNclaimed payload a
        # recomputed bundle could double-count against.
        owner = (self.root / "part_owners" / agg
                 / f"{participation.participant}.json")
        with self._lock:
            if self.get_aggregation(participation.aggregation) is None:
                raise NotFound("aggregation not found")
            existing = _read_json(payload)
            if existing is not None:
                # same participation id: byte-identical replay succeeds
                # idempotently; different content never silently replaces
                if Participation.from_obj(existing).canonical_digest() \
                        == digest:
                    # heal the marker if a pre-exactly-once writer (or a
                    # crash) left the payload unclaimed
                    _write_json_new(owner, {"id": str(participation.id),
                                            "digest": digest})
                    return False
                raise ParticipationConflict(
                    f"participation {participation.id} already exists "
                    "with different content",
                    participant=participation.participant,
                    aggregation=participation.aggregation)
            if _write_json_new(owner, {"id": str(participation.id),
                                       "digest": digest}):
                _write_json_new(payload, participation.to_obj())
                return True
            claimed = _read_json(owner) or {}
            if claimed.get("digest") == digest:
                # replay of our own bytes; re-publish the payload in case
                # the original writer crashed between marker and payload
                _write_json_new(payload, participation.to_obj())
                return False
            raise ParticipationConflict(
                f"agent {participation.participant} already participated "
                f"in {participation.aggregation} "
                f"(participation {claimed.get('id')})",
                participant=participation.participant,
                aggregation=participation.aggregation)

    def create_snapshot(self, snapshot):
        chaos.fail("store.create_snapshot")
        # conditional create: link(2) beats N racing server processes
        # down to one winner; the record file never changes once present
        with self._lock:
            return _write_json_new(
                self.root / "snapshots" / str(snapshot.aggregation) / f"{snapshot.id}.json",
                snapshot.to_obj(),
            )

    def list_snapshots(self, aggregation):
        with self._lock:
            return [
                SnapshotId(s) for s in _ids_in(self.root / "snapshots" / str(aggregation))
            ]

    def get_snapshot(self, aggregation, snapshot):
        with self._lock:
            obj = _read_json(
                self.root / "snapshots" / str(aggregation) / f"{snapshot}.json"
            )
            return None if obj is None else Snapshot.from_obj(obj)

    def count_participations(self, aggregation):
        with self._lock:
            return len(_ids_in(self.root / "participations" / str(aggregation)))

    def snapshot_participations(self, aggregation, snapshot):
        # single-winner freeze: the frozen-id file IS both the marker and
        # the set, created atomically with link(2) — a loser returning
        # False can immediately read the winner's complete id list
        with self._lock:
            part_ids = _ids_in(self.root / "participations" / str(aggregation))
            return _write_json_new(
                self.root / "snapshot_parts" / f"{snapshot}.json", part_ids
            )

    def has_snapshot_freeze(self, aggregation, snapshot):
        with self._lock:
            # the frozen-id file is the durable marker (an empty list counts)
            return (self.root / "snapshot_parts" / f"{snapshot}.json").exists()

    def count_participations_snapshot(self, aggregation, snapshot):
        # the frozen id list already holds the answer — don't deserialize
        # every participation just to count them
        with self._lock:
            part_ids = _read_json(self.root / "snapshot_parts" / f"{snapshot}.json") or []
            return len(part_ids)

    def iter_snapped_participations(self, aggregation, snapshot):
        with self._lock:
            part_ids = _read_json(self.root / "snapshot_parts" / f"{snapshot}.json") or []
            out = []
            for pid in part_ids:
                obj = _read_json(
                    self.root / "participations" / str(aggregation) / f"{pid}.json"
                )
                if obj is not None:
                    out.append(Participation.from_obj(obj))
            return out

    def _iter_snapped_docs(self, aggregation, snapshot):
        """Streamed walk of the frozen set's documents: the id list is
        read once under the lock (small), then one document file is
        resident at a time — O(1) documents in memory at tree-scale
        counts, with the lock released between files so the snapshot
        pipeline's interleaved mask-chunk writes never queue behind a
        full-set scan."""
        with self._lock:
            part_ids = _read_json(
                self.root / "snapshot_parts" / f"{snapshot}.json") or []
        for pid in part_ids:
            with self._lock:
                obj = _read_json(
                    self.root / "participations" / str(aggregation)
                    / f"{pid}.json"
                )
            if obj is not None:
                yield obj

    def iter_snapped_recipient_encryptions(self, aggregation, snapshot):
        # mask-column read: decode only the recipient_encryption field of
        # each frozen document instead of re-materializing every
        # participation a second time
        for obj in self._iter_snapped_docs(aggregation, snapshot):
            enc = obj.get("recipient_encryption")
            yield None if enc is None else Encryption.from_obj(enc)

    def iter_snapped_forwarded_masks(self, aggregation, snapshot):
        # forwarded-mask column read (tree parents): same streamed walk
        for obj in self._iter_snapped_docs(aggregation, snapshot):
            for enc in obj.get("forwarded_masks") or ():
                yield Encryption.from_obj(enc)

    # -- round lifecycle ----------------------------------------------------
    def put_round_state(self, doc):
        with self._lock:
            _write_json(self.root / "rounds" / f"{doc['aggregation']}.json",
                        doc)

    def get_round_state(self, aggregation):
        with self._lock:
            return _read_json(self.root / "rounds" / f"{aggregation}.json")

    def list_round_states(self):
        with self._lock:
            out = []
            for agg_id in _ids_in(self.root / "rounds"):
                doc = _read_json(self.root / "rounds" / f"{agg_id}.json")
                if doc is not None:
                    out.append(doc)
            return out

    def transition_round_state(self, aggregation, from_states, doc):
        # single-winner CAS across fleet worker processes: the dir flock
        # makes the read-check-write atomic (link(2) arbitration only
        # covers create-if-absent; a transition REPLACES the file)
        with self._lock, self._dir_lock(self.root / "rounds"):
            path = self.root / "rounds" / f"{aggregation}.json"
            current = _read_json(path)
            if current is None or current.get("state") not in from_states:
                return False
            _write_json(path, doc)
            return True

    # -- recurring-round schedules -------------------------------------------
    def create_schedule_state(self, doc):
        # create-if-absent via link(2): installation is single-winner
        # across OS processes, so a booting scheduler can never reset an
        # advanced schedule (stores.py schedule contract)
        with self._lock:
            return _write_json_new(
                self.root / "schedules" / f"{doc['schedule']}.json", doc)

    def get_schedule_state(self, schedule):
        with self._lock:
            return _read_json(self.root / "schedules" / f"{schedule}.json")

    def list_schedule_states(self):
        with self._lock:
            out = []
            for name in _ids_in(self.root / "schedules"):
                doc = _read_json(self.root / "schedules" / f"{name}.json")
                if doc is not None:
                    out.append(doc)
            return out

    def transition_schedule_state(self, schedule, from_epoch, doc):
        # single-winner epoch CAS across fleet worker processes: the dir
        # flock makes the read-check-write atomic (same shape as
        # transition_round_state)
        with self._lock, self._dir_lock(self.root / "schedules"):
            path = self.root / "schedules" / f"{schedule}.json"
            current = _read_json(path)
            if current is None \
                    or int(current.get("epoch", -1)) != int(from_epoch):
                return False
            _write_json(path, doc)
            return True

    def create_snapshot_mask(self, snapshot, mask):
        self.put_snapshot_mask_chunk(snapshot, 0, mask)
        self.trim_snapshot_mask_chunks(snapshot, 1)

    def put_snapshot_mask_chunk(self, snapshot, index, encryptions):
        # one file per chunk under masks/<snapshot>/, pure upsert: file
        # writes are atomic (temp+replace) and a replaying or contended
        # pipeline rewrites byte-identical chunks (stores.py contract),
        # so readers always see a complete mask. Chunk 0 supersedes any
        # legacy single-file mask.
        with self._lock:
            directory = self.root / "masks" / str(snapshot)
            if index == 0:
                (self.root / "masks" / f"{snapshot}.json").unlink(
                    missing_ok=True)
            directory.mkdir(parents=True, exist_ok=True)
            _write_json(directory / f"{int(index):08d}.json",
                        [e.to_obj() for e in encryptions])

    def trim_snapshot_mask_chunks(self, snapshot, count):
        with self._lock:
            directory = self.root / "masks" / str(snapshot)
            if not directory.is_dir():
                return
            for path in directory.glob("*.json"):
                try:
                    if int(path.stem) >= int(count):
                        path.unlink(missing_ok=True)
                except ValueError:
                    continue  # not a chunk file

    def get_snapshot_mask(self, snapshot):
        with self._lock:
            directory = self.root / "masks" / str(snapshot)
            if directory.is_dir():
                out = []
                for path in sorted(directory.glob("*.json")):
                    out.extend(Encryption.from_obj(e)
                               for e in _read_json(path) or [])
                return out
            # pre-chunking layout: fall back to the legacy single file
            obj = _read_json(self.root / "masks" / f"{snapshot}.json")
            return None if obj is None else [Encryption.from_obj(e) for e in obj]


class JsonClerkingJobsStore(_FsStore, ClerkingJobsStore):
    def enqueue_clerking_job(self, job):
        chaos.fail("store.enqueue_clerking_job")
        with self._lock:
            if (self.root / "done" / str(job.clerk) / f"{job.id}.json").exists():
                return  # snapshot retry: this job already completed
            _write_json(
                self.root / "queue" / str(job.clerk) / f"{job.id}.json", job.to_obj()
            )

    def enqueue_clerking_jobs(self, jobs):
        jobs = list(jobs)
        for _ in jobs:
            chaos.fail("store.enqueue_clerking_job")
        with self._lock:  # one lock hold for the whole fan-out
            for job in jobs:
                if (self.root / "done" / str(job.clerk) / f"{job.id}.json").exists():
                    continue  # snapshot retry: this job already completed
                _write_json(
                    self.root / "queue" / str(job.clerk) / f"{job.id}.json",
                    job.to_obj(),
                )

    def poll_clerking_job(self, clerk):
        chaos.fail("store.poll_clerking_job")
        with self._lock:
            ids = _ids_in(self.root / "queue" / str(clerk))
            if not ids:
                return None
            obj = _read_json(self.root / "queue" / str(clerk) / f"{ids[0]}.json")
            return ClerkingJob.from_obj(obj)

    def lease_clerking_job(self, clerk, lease_seconds, now=None, owner=None):
        chaos.fail("store.poll_clerking_job")
        now = time.time() if now is None else now
        with self._lock, self._dir_lock(self.root / "queue" / str(clerk)):
            qdir = self.root / "queue" / str(clerk)
            # lease files are dot-prefixed so _ids_in never mistakes one
            # for a queued job; they survive restarts like everything else.
            # The dir lock makes the expiry-check -> lease-stamp sequence
            # atomic across fleet worker processes: two sdad's polling one
            # clerk identity cannot both stamp the same job
            for job_id in _ids_in(qdir):
                lease = _read_json(qdir / f".lease-{job_id}.json")
                if lease is not None and lease["expires"] > now:
                    continue  # actively leased by another worker
                obj = _read_json(qdir / f"{job_id}.json")
                if obj is None:
                    continue  # done-move by a peer since the listing
                if lease is not None:
                    metrics.count("server.job.reissued")
                expires = now + lease_seconds
                _write_json(qdir / f".lease-{job_id}.json",
                            {"expires": expires, "node": owner})
                return ClerkingJob.from_obj(obj), expires
            return None

    def release_clerking_job_lease(self, clerk, job, expires=None):
        # graceful drain: unlink the dot-lease file so any process's next
        # poll sees the job unleased; done jobs have left the queue dir.
        # Compare-and-release on the expiry instant: a lapsed lease
        # re-granted to a peer carries a NEW expiry and is left alone
        with self._lock, self._dir_lock(self.root / "queue" / str(clerk)):
            qdir = self.root / "queue" / str(clerk)
            if not (qdir / f"{job}.json").exists():
                return False
            lease_path = qdir / f".lease-{job}.json"
            lease = _read_json(lease_path)
            if lease is None or (expires is not None
                                 and lease["expires"] != expires):
                return False
            lease_path.unlink(missing_ok=True)
            return True

    def recall_clerking_job_leases(self, node_id):
        # the dead-node recovery step: unlink every lease file the dead
        # worker stamped, per clerk dir under that dir's flock (the same
        # arbitration the grant path takes, so a racing peer sweeper and
        # a racing poll serialize cleanly)
        recalled = 0
        base = self.root / "queue"
        with self._lock:
            if not base.is_dir():
                return 0
            for clerk_dir in sorted(p for p in base.iterdir() if p.is_dir()):
                with self._dir_lock(clerk_dir):
                    for job_id in _ids_in(clerk_dir):
                        lease_path = clerk_dir / f".lease-{job_id}.json"
                        lease = _read_json(lease_path)
                        if lease is None or lease.get("node") != node_id:
                            continue
                        lease_path.unlink(missing_ok=True)
                        recalled += 1
        return recalled

    def hedge_clerking_job(self, clerk, suspect_nodes, lease_seconds,
                           now=None, owner=None):
        # hedged execution: overwrite a SUSPECT holder's ACTIVE lease
        # with this caller's, under the clerk dir's flock (two hedging
        # processes race the same read-check-write; one wins). The
        # original holder may still finish — the done-move is what
        # commits, exactly once
        suspects = set(str(n) for n in suspect_nodes)
        if not suspects:
            return None
        now = time.time() if now is None else now
        with self._lock, self._dir_lock(self.root / "queue" / str(clerk)):
            qdir = self.root / "queue" / str(clerk)
            for job_id in _ids_in(qdir):
                lease = _read_json(qdir / f".lease-{job_id}.json")
                if lease is None or lease["expires"] <= now:
                    continue  # unleased/lapsed: the normal poll covers it
                if str(lease.get("node")) not in suspects:
                    continue
                obj = _read_json(qdir / f"{job_id}.json")
                if obj is None:
                    continue  # done-move by a peer since the listing
                expires = now + lease_seconds
                _write_json(qdir / f".lease-{job_id}.json",
                            {"expires": expires, "node": owner})
                return ClerkingJob.from_obj(obj), expires
            return None

    # -- fleet heartbeats ---------------------------------------------------
    def put_worker_heartbeat(self, doc):
        with self._lock:
            _write_json(self.root / "heartbeats" / f"{doc['node']}.json", doc)

    def get_worker_heartbeat(self, node):
        with self._lock:
            return _read_json(self.root / "heartbeats" / f"{node}.json")

    def list_worker_heartbeats(self):
        with self._lock:
            out = []
            base = self.root / "heartbeats"
            if not base.is_dir():
                return out
            for name in sorted(p.stem for p in base.glob("*.json")
                               if not p.name.startswith(".")):
                doc = _read_json(base / f"{name}.json")
                if doc is not None:
                    out.append(doc)
            return out

    def transition_worker_state(self, node, from_states, doc):
        # single-winner CAS across fleet worker processes: the dir flock
        # makes the read-check-write atomic (same shape as
        # transition_round_state)
        with self._lock, self._dir_lock(self.root / "heartbeats"):
            path = self.root / "heartbeats" / f"{node}.json"
            current = _read_json(path)
            if current is None or current.get("state") not in from_states:
                return False
            _write_json(path, doc)
            return True

    def list_snapshot_jobs(self, snapshot):
        # the sweeper's dead-clerk census: walk both queue trees, decode
        # only the snapshot field to filter — committee-width work, and
        # sweeps are rare control-plane reads
        with self._lock:
            out = []
            for sub, done in (("queue", False), ("done", True)):
                base = self.root / sub
                if not base.is_dir():
                    continue
                for clerk_dir in sorted(p for p in base.iterdir()
                                        if p.is_dir()):
                    for job_id in _ids_in(clerk_dir):
                        obj = _read_json(clerk_dir / f"{job_id}.json")
                        if obj is None or obj.get("snapshot") != str(snapshot):
                            continue
                        lease = 0.0
                        if not done:
                            lease_doc = _read_json(
                                clerk_dir / f".lease-{job_id}.json")
                            if lease_doc is not None:
                                lease = float(lease_doc.get("expires", 0.0))
                        out.append((ClerkingJobId(job_id),
                                    AgentId(clerk_dir.name), done, lease))
            return out

    def get_clerking_job(self, clerk, job):
        with self._lock:
            for sub in ("queue", "done"):
                obj = _read_json(self.root / sub / str(clerk) / f"{job}.json")
                if obj is not None:
                    return ClerkingJob.from_obj(obj)
            return None

    def create_clerking_result(self, result):
        chaos.fail("store.create_clerking_result")
        # the clerk dir flock makes the read-check-commit atomic across
        # fleet worker PROCESSES (the in-process lock cannot): when a
        # hedged copy races the original holder, exactly one performs the
        # queue->done move — the second finds the queue file gone, sees
        # the done marker, and drops its duplicate on the floor
        with self._lock, \
                self._dir_lock(self.root / "queue" / str(result.clerk)):
            queue_path = self.root / "queue" / str(result.clerk) / f"{result.job}.json"
            obj = _read_json(queue_path)
            if obj is None:
                if (self.root / "done" / str(result.clerk) / f"{result.job}.json").exists():
                    return  # duplicate result upload: idempotent
                raise NotFound("job not found for clerk")
            job = ClerkingJob.from_obj(obj)
            _write_json(
                self.root / "results" / str(job.snapshot) / f"{result.job}.json",
                result.to_obj(),
            )
            _write_json(self.root / "done" / str(result.clerk) / f"{job.id}.json", obj)
            queue_path.unlink(missing_ok=True)
            queue_path.with_name(f".lease-{result.job}.json").unlink(missing_ok=True)

    def purge_snapshot_jobs(self, snapshot):
        # the retention/delete cascade's job-store half: walk both queue
        # trees removing the snapshot's job files (and their dot-lease
        # files), then drop the whole results directory. Per-clerk dirs
        # are purged under their flock — the same arbitration the
        # grant/commit paths take, so a racing poll serializes cleanly
        import shutil

        removed = 0
        with self._lock:
            for sub in ("queue", "done"):
                base = self.root / sub
                if not base.is_dir():
                    continue
                for clerk_dir in sorted(p for p in base.iterdir()
                                        if p.is_dir()):
                    with self._dir_lock(clerk_dir):
                        for job_id in _ids_in(clerk_dir):
                            obj = _read_json(clerk_dir / f"{job_id}.json")
                            if obj is None \
                                    or obj.get("snapshot") != str(snapshot):
                                continue
                            (clerk_dir / f"{job_id}.json").unlink(
                                missing_ok=True)
                            (clerk_dir / f".lease-{job_id}.json").unlink(
                                missing_ok=True)
                            removed += 1
            results_dir = self.root / "results" / str(snapshot)
            if results_dir.is_dir():
                removed += len(_ids_in(results_dir))
                shutil.rmtree(results_dir, ignore_errors=True)
        return removed

    def list_results(self, snapshot):
        with self._lock:
            return [ClerkingJobId(i) for i in _ids_in(self.root / "results" / str(snapshot))]

    def get_result(self, snapshot, job):
        with self._lock:
            obj = _read_json(self.root / "results" / str(snapshot) / f"{job}.json")
            return None if obj is None else ClerkingResult.from_obj(obj)
