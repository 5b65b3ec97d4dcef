"""MongoDB store backend — document-database tier (reference parity).

Direct analog of the reference's production storage
(server-store-mongodb/src/lib.rs): one collection per resource holding the
JSON document keyed by ``_id``, upserts via ``replace_one(upsert=True)``
(the Mongo store's ``modisert``, lib.rs:118-151), snapshot freezing as an
``$addToSet`` of the snapshot id onto participation documents
(aggregations.rs:132-142), and a done-flag clerk-job queue with an atomic
``find_one_and_update`` flip (clerking_jobs.rs:32-75).

``pymongo`` is not part of this image, so the module is import-gated:
``available()`` is False without the driver and ``new_mongo_server``
raises a clear error. The semantics mirror the SQLite backend
(sqlite.py), which runs the same store test suites in-image; when a Mongo
deployment is present, point ``sdad --mongo URI`` at it.
"""

from __future__ import annotations

import time
from typing import List, Optional

from .. import chaos
from ..utils import metrics

try:  # driver not baked into this image; gate, don't fail at import
    import pymongo

    _PYMONGO = True
except ImportError:  # pragma: no cover - exercised only without the driver
    pymongo = None
    _PYMONGO = False

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


def available() -> bool:
    return _PYMONGO


class _MongoStore(BaseStore):
    def __init__(self, db):
        self.db = db

    def ping(self) -> None:
        self.db.command("ping")


class MongoAuthTokensStore(_MongoStore, AuthTokensStore):
    def upsert_auth_token(self, token):
        self.db.auth_tokens.replace_one(
            {"_id": str(token.id)}, {"_id": str(token.id), "body": token.body},
            upsert=True,
        )

    def get_auth_token(self, id):
        doc = self.db.auth_tokens.find_one({"_id": str(id)})
        return None if doc is None else auth_token(id, doc["body"])

    def delete_auth_token(self, id):
        self.db.auth_tokens.delete_one({"_id": str(id)})


class MongoAgentsStore(_MongoStore, AgentsStore):
    def create_agent(self, agent):
        self.db.agents.replace_one(
            {"_id": str(agent.id)}, {"_id": str(agent.id), "doc": agent.to_obj()},
            upsert=True,
        )

    def get_agent(self, id):
        doc = self.db.agents.find_one({"_id": str(id)})
        return None if doc is None else Agent.from_obj(doc["doc"])

    def upsert_profile(self, profile):
        self.db.profiles.replace_one(
            {"_id": str(profile.owner)},
            {"_id": str(profile.owner), "doc": profile.to_obj()},
            upsert=True,
        )

    def get_profile(self, owner):
        doc = self.db.profiles.find_one({"_id": str(owner)})
        return None if doc is None else Profile.from_obj(doc["doc"])

    def create_encryption_key(self, key):
        self.db.enc_keys.replace_one(
            {"_id": str(key.body.id)},
            {"_id": str(key.body.id), "signer": str(key.signer), "doc": key.to_obj()},
            upsert=True,
        )

    def get_encryption_key(self, key):
        doc = self.db.enc_keys.find_one({"_id": str(key)})
        return None if doc is None else signed_encryption_key_from_obj(doc["doc"])

    def suggest_committee(self):
        # group keys by signer, sorted — the reference does this with a
        # client-side itertools group (jfs_stores/agents.rs:66-83)
        candidates: List[ClerkCandidate] = []
        for doc in self.db.enc_keys.find().sort([("signer", 1), ("_id", 1)]):
            signer, key_id = doc["signer"], doc["_id"]
            if candidates and str(candidates[-1].id) == signer:
                candidates[-1].keys.append(EncryptionKeyId(key_id))
            else:
                candidates.append(
                    ClerkCandidate(id=AgentId(signer), keys=[EncryptionKeyId(key_id)])
                )
        return candidates


class MongoAggregationsStore(_MongoStore, AggregationsStore):
    def list_aggregations(self, filter=None, recipient=None):
        query = {}
        if filter is not None:
            import re

            # escape so this is plain substring matching, same as the
            # memory/jsonfs/sqlite backends (the reference's raw-$regex
            # behavior diverges per backend and errors on metacharacters)
            query["title"] = {"$regex": re.escape(filter)}
        if recipient is not None:
            query["recipient"] = str(recipient)
        return [
            AggregationId(d["_id"])
            for d in self.db.aggregations.find(query).sort("_id", 1)
        ]

    def create_aggregation(self, aggregation):
        self.db.aggregations.replace_one(
            {"_id": str(aggregation.id)},
            {
                "_id": str(aggregation.id),
                "title": aggregation.title,
                "recipient": str(aggregation.recipient),
                "doc": aggregation.to_obj(),
            },
            upsert=True,
        )

    def get_aggregation(self, aggregation):
        doc = self.db.aggregations.find_one({"_id": str(aggregation)})
        return None if doc is None else Aggregation.from_obj(doc["doc"])

    def delete_aggregation(self, aggregation):
        agg = str(aggregation)
        snap_ids = [d["_id"] for d in self.db.snapshots.find({"aggregation": agg})]
        if snap_ids:
            self.db.snapshot_masks.delete_many({"_id": {"$in": snap_ids}})
            self.db.snapshot_mask_chunks.delete_many(
                {"snapshot": {"$in": snap_ids}})
            self.db.snapshot_freezes.delete_many({"_id": {"$in": snap_ids}})
        self.db.participations.delete_many({"aggregation": agg})
        self.db.participation_owners.delete_many(
            {"_id": {"$regex": f"^{agg}:"}})
        self.db.snapshots.delete_many({"aggregation": agg})
        self.db.committees.delete_one({"_id": agg})
        self.db.rounds.delete_one({"_id": agg})
        self.db.aggregations.delete_one({"_id": agg})

    def get_committee(self, aggregation):
        doc = self.db.committees.find_one({"_id": str(aggregation)})
        return None if doc is None else Committee.from_obj(doc["doc"])

    def create_committee(self, committee):
        self.db.committees.replace_one(
            {"_id": str(committee.aggregation)},
            {"_id": str(committee.aggregation), "doc": committee.to_obj()},
            upsert=True,
        )

    @staticmethod
    def _participation_doc(participation, digest):
        return {
            "_id": str(participation.id),
            "aggregation": str(participation.aggregation),
            "participant": str(participation.participant),
            "digest": digest,
            "snapshots": [],
            "doc": participation.to_obj(),
        }

    @staticmethod
    def _doc_digest(doc):
        """A stored participation doc's canonical digest, recomputed for
        legacy docs written before the digest field existed."""
        if doc.get("digest"):
            return doc["digest"]
        return Participation.from_obj(doc["doc"]).canonical_digest()

    def create_participation(self, participation):
        chaos.fail("store.create_participation")
        if self.get_aggregation(participation.aggregation) is None:
            raise NotFound("aggregation not found")
        digest = participation.canonical_digest()
        pid = str(participation.id)
        existing = self.db.participations.find_one({"_id": pid})
        if existing is not None:
            # same participation id: byte-identical replay succeeds
            # idempotently; different content never silently replaces
            if self._doc_digest(existing) == digest:
                self._claim_owner(participation, digest)  # heal the marker
                return False
            raise ParticipationConflict(
                f"participation {pid} already exists with different "
                "content",
                participant=participation.participant,
                aggregation=participation.aggregation)
        result = self._claim_owner(participation, digest)
        if result.upserted_id is not None:
            # won the (aggregation, participant) key: publish the payload
            # with Mongo's atomic create-if-absent (a replayed loser of a
            # crash window republishes the same bytes harmlessly)
            self.db.participations.update_one(
                {"_id": pid},
                {"$setOnInsert": self._participation_doc(participation,
                                                         digest)},
                upsert=True,
            )
            return True
        marker = self.db.participation_owners.find_one(
            {"_id": self._owner_key(participation)}) or {}
        if marker.get("digest") == digest:
            # replay of our own bytes; re-publish the payload in case the
            # original writer crashed between marker and payload
            self.db.participations.update_one(
                {"_id": pid},
                {"$setOnInsert": self._participation_doc(participation,
                                                         digest)},
                upsert=True,
            )
            return False
        raise ParticipationConflict(
            f"agent {participation.participant} already participated in "
            f"{participation.aggregation} (participation "
            f"{marker.get('id')})",
            participant=participation.participant,
            aggregation=participation.aggregation)

    @staticmethod
    def _owner_key(participation):
        return f"{participation.aggregation}:{participation.participant}"

    def _claim_owner(self, participation, digest):
        """$setOnInsert upsert on the per-(aggregation, participant)
        marker — Mongo's atomic create-if-absent is the single-winner
        arbiter (marker first, payload second: same crash-window
        reasoning as the jsonfs backend)."""
        return self.db.participation_owners.update_one(
            {"_id": self._owner_key(participation)},
            {"$setOnInsert": {"_id": self._owner_key(participation),
                              "id": str(participation.id),
                              "digest": digest}},
            upsert=True,
        )

    def create_snapshot(self, snapshot):
        chaos.fail("store.create_snapshot")
        # conditional insert via $setOnInsert upsert — Mongo's atomic
        # create-if-absent; upserted_id says whether THIS call won the
        # race (contended-idempotency contract, stores.py)
        result = self.db.snapshots.update_one(
            {"_id": str(snapshot.id)},
            {"$setOnInsert": {
                "_id": str(snapshot.id),
                "aggregation": str(snapshot.aggregation),
                "doc": snapshot.to_obj(),
            }},
            upsert=True,
        )
        return result.upserted_id is not None

    def list_snapshots(self, aggregation):
        return [
            SnapshotId(d["_id"])
            for d in self.db.snapshots.find(
                {"aggregation": str(aggregation)}).sort("_id", 1)
        ]

    def get_snapshot(self, aggregation, snapshot):
        doc = self.db.snapshots.find_one(
            {"_id": str(snapshot), "aggregation": str(aggregation)}
        )
        return None if doc is None else Snapshot.from_obj(doc["doc"])

    def count_participations(self, aggregation):
        return self.db.participations.count_documents(
            {"aggregation": str(aggregation)}
        )

    def snapshot_participations(self, aggregation, snapshot):
        # single-winner freeze in ONE atomic document write: the marker
        # doc itself carries the frozen participation-id list, installed
        # with a $setOnInsert upsert — Mongo's create-if-absent — so two
        # racing server processes cannot install different sets and the
        # loser (upserted_id None) can read the winner's complete list
        # the moment this returns. This replaces the reference's
        # two-write $addToSet + marker freeze (aggregations.rs:132-142),
        # which was crash-replay-safe but not contended-safe: two
        # processes interleaving $addToSet sweeps could freeze different
        # supersets. Legacy $addToSet-frozen data (marker without "ids")
        # still reads through the snapshots-array fallback below.
        part_ids = sorted(
            d["_id"]
            for d in self.db.participations.find(
                {"aggregation": str(aggregation)})
        )
        result = self.db.snapshot_freezes.update_one(
            {"_id": str(snapshot)},
            {"$setOnInsert": {"_id": str(snapshot), "ids": part_ids}},
            upsert=True,
        )
        return result.upserted_id is not None

    def has_snapshot_freeze(self, aggregation, snapshot):
        return self.db.snapshot_freezes.find_one({"_id": str(snapshot)}) is not None

    def _frozen_ids(self, snapshot) -> Optional[List[str]]:
        """The marker doc's frozen id list, or None for pre-fleet data
        frozen via $addToSet (read those through the snapshots array)."""
        marker = self.db.snapshot_freezes.find_one({"_id": str(snapshot)})
        if marker is None or "ids" not in marker:
            return None
        return marker["ids"]

    def count_participations_snapshot(self, aggregation, snapshot):
        ids = self._frozen_ids(snapshot)
        if ids is not None:
            return len(ids)
        return self.db.participations.count_documents(
            {"aggregation": str(aggregation), "snapshots": str(snapshot)}
        )

    def iter_snapped_participations(self, aggregation, snapshot):
        ids = self._frozen_ids(snapshot)
        if ids is not None:
            cursor = self.db.participations.find(
                {"aggregation": str(aggregation), "_id": {"$in": ids}}
            )
        else:  # legacy $addToSet freeze
            cursor = self.db.participations.find(
                {"aggregation": str(aggregation), "snapshots": str(snapshot)}
            )
        return [
            Participation.from_obj(d["doc"]) for d in cursor.sort("_id", 1)
        ]

    def _iter_snapped_docs(self, aggregation, snapshot):
        """Streamed walk of the frozen set's documents (cursor-batched by
        the driver — O(batch) resident, never the whole population)."""
        ids = self._frozen_ids(snapshot)
        if ids is not None:
            cursor = self.db.participations.find(
                {"aggregation": str(aggregation), "_id": {"$in": ids}}
            )
        else:  # legacy $addToSet freeze
            cursor = self.db.participations.find(
                {"aggregation": str(aggregation), "snapshots": str(snapshot)}
            )
        for d in cursor.sort("_id", 1):
            yield d["doc"]

    def iter_snapped_recipient_encryptions(self, aggregation, snapshot):
        # mask-column read: decode only the recipient_encryption field
        for doc in self._iter_snapped_docs(aggregation, snapshot):
            enc = doc.get("recipient_encryption")
            yield None if enc is None else Encryption.from_obj(enc)

    def iter_snapped_forwarded_masks(self, aggregation, snapshot):
        # forwarded-mask column read (tree parents): same streamed walk
        for doc in self._iter_snapped_docs(aggregation, snapshot):
            for enc in doc.get("forwarded_masks") or ():
                yield Encryption.from_obj(enc)

    # -- round lifecycle ----------------------------------------------------
    def put_round_state(self, doc):
        self.db.rounds.replace_one(
            {"_id": doc["aggregation"]},
            {"_id": doc["aggregation"], "state": doc["state"], "doc": doc},
            upsert=True,
        )

    def get_round_state(self, aggregation):
        found = self.db.rounds.find_one({"_id": str(aggregation)})
        return None if found is None else found["doc"]

    def list_round_states(self):
        return [d["doc"] for d in self.db.rounds.find({}).sort("_id", 1)]

    def transition_round_state(self, aggregation, from_states, doc):
        # single-winner CAS: one atomic find_one_and_update filtered on
        # the FROM state — N sweeping workers race, exactly one matches
        found = self.db.rounds.find_one_and_update(
            {"_id": str(aggregation), "state": {"$in": list(from_states)}},
            {"$set": {"state": doc["state"], "doc": doc}},
        )
        return found is not None

    # -- recurring-round schedules -------------------------------------------
    def create_schedule_state(self, doc):
        # conditional insert via $setOnInsert upsert — Mongo's atomic
        # create-if-absent; installation is single-winner, so a booting
        # scheduler can never reset an advanced schedule
        result = self.db.schedules.update_one(
            {"_id": doc["schedule"]},
            {"$setOnInsert": {"_id": doc["schedule"],
                              "epoch": int(doc["epoch"]), "doc": doc}},
            upsert=True,
        )
        return result.upserted_id is not None

    def get_schedule_state(self, schedule):
        found = self.db.schedules.find_one({"_id": str(schedule)})
        return None if found is None else found["doc"]

    def list_schedule_states(self):
        return [d["doc"] for d in self.db.schedules.find({}).sort("_id", 1)]

    def transition_schedule_state(self, schedule, from_epoch, doc):
        # single-winner epoch CAS: one atomic find_one_and_update keyed
        # on the FROM epoch (same shape as transition_round_state)
        found = self.db.schedules.find_one_and_update(
            {"_id": str(schedule), "epoch": int(from_epoch)},
            {"$set": {"epoch": int(doc["epoch"]), "doc": doc}},
        )
        return found is not None

    def create_snapshot_mask(self, snapshot, mask):
        self.put_snapshot_mask_chunk(snapshot, 0, mask)
        self.trim_snapshot_mask_chunks(snapshot, 1)

    def put_snapshot_mask_chunk(self, snapshot, index, encryptions):
        # one document per chunk, _id "<snapshot>:<ix>", pure upsert: a
        # replaying or contended pipeline rewrites byte-identical chunks
        # (stores.py contract), so readers always see a complete mask.
        # Chunk 0 supersedes any legacy single-document mask.
        snap = str(snapshot)
        if index == 0:
            self.db.snapshot_masks.delete_many({"_id": snap})
        self.db.snapshot_mask_chunks.replace_one(
            {"_id": f"{snap}:{int(index):08d}"},
            {"_id": f"{snap}:{int(index):08d}", "snapshot": snap,
             "chunk_ix": int(index), "doc": [e.to_obj() for e in encryptions]},
            upsert=True,
        )

    def trim_snapshot_mask_chunks(self, snapshot, count):
        self.db.snapshot_mask_chunks.delete_many(
            {"snapshot": str(snapshot), "chunk_ix": {"$gte": int(count)}})

    def get_snapshot_mask(self, snapshot):
        chunks = list(self.db.snapshot_mask_chunks.find(
            {"snapshot": str(snapshot)}))
        if chunks:
            chunks.sort(key=lambda d: d.get("chunk_ix", 0))
            return [Encryption.from_obj(e) for c in chunks for e in c["doc"]]
        # pre-chunking database: fall back to the legacy single document
        doc = self.db.snapshot_masks.find_one({"_id": str(snapshot)})
        if doc is None:
            return None
        return [Encryption.from_obj(e) for e in doc["doc"]]


class MongoClerkingJobsStore(_MongoStore, ClerkingJobsStore):
    @staticmethod
    def _job_doc(job):
        return {
            "_id": str(job.id),
            "clerk": str(job.clerk),
            "snapshot": str(job.snapshot),
            "done": False,
            "doc": job.to_obj(),
        }

    def _enqueue_doc(self, payload):
        # refresh only a still-QUEUED job; a snapshot replay must never
        # resurrect a done job or wipe its embedded result
        res = self.db.clerking_jobs.replace_one(
            {"_id": payload["_id"], "done": False}, payload
        )
        if res.matched_count == 0:
            self.db.clerking_jobs.update_one(
                {"_id": payload["_id"]}, {"$setOnInsert": payload}, upsert=True
            )

    def enqueue_clerking_job(self, job):
        chaos.fail("store.enqueue_clerking_job")
        self._enqueue_doc(self._job_doc(job))

    def enqueue_clerking_jobs(self, jobs):
        # the snapshot fan-out in three round trips under the real driver
        # (refresh-queued bulk, existence probe, insert-missing bulk)
        # instead of 2C; same never-resurrect-done semantics per job
        jobs = list(jobs)
        if not jobs:
            return
        for _ in jobs:
            chaos.fail("store.enqueue_clerking_job")
        payloads = [self._job_doc(job) for job in jobs]
        if not _PYMONGO:
            for payload in payloads:
                self._enqueue_doc(payload)
            return
        self.db.clerking_jobs.bulk_write(
            [pymongo.ReplaceOne({"_id": p["_id"], "done": False}, p)
             for p in payloads],
            ordered=False,
        )
        existing = {
            d["_id"]
            for d in self.db.clerking_jobs.find(
                {"_id": {"$in": [p["_id"] for p in payloads]}},
                {"_id": 1})  # ids only: don't re-download the clerk columns
        }
        missing = [p for p in payloads if p["_id"] not in existing]
        if missing:
            self.db.clerking_jobs.bulk_write(
                [pymongo.UpdateOne({"_id": p["_id"]}, {"$setOnInsert": p},
                                   upsert=True)
                 for p in missing],
                ordered=False,
            )

    def poll_clerking_job(self, clerk):
        chaos.fail("store.poll_clerking_job")
        doc = self.db.clerking_jobs.find_one(
            {"clerk": str(clerk), "done": False}, sort=[("_id", 1)]
        )
        return None if doc is None else ClerkingJob.from_obj(doc["doc"])

    def lease_clerking_job(self, clerk, lease_seconds, now=None, owner=None):
        chaos.fail("store.poll_clerking_job")
        now = time.time() if now is None else now
        expires = now + lease_seconds
        doc = self.db.clerking_jobs.find_one_and_update(
            {
                "clerk": str(clerk),
                "done": False,
                "$or": [
                    {"leased_until": {"$exists": False}},
                    {"leased_until": {"$lte": now}},
                ],
            },
            {"$set": {"leased_until": expires, "leased_by": owner}},
            sort=[("_id", 1)],
        )
        if doc is None:
            return None
        if doc.get("leased_until") is not None:
            metrics.count("server.job.reissued")
        return ClerkingJob.from_obj(doc["doc"]), expires

    def release_clerking_job_lease(self, clerk, job, expires=None):
        # graceful drain: zero the visibility timeout on a still-undone
        # job so any process's next lease poll picks it up immediately.
        # Compare-and-release: with `expires` only the exact granted
        # lease matches — a reissued lease (new leased_until) is the
        # peer's to keep
        result = self.db.clerking_jobs.update_one(
            {"_id": str(job), "clerk": str(clerk), "done": False,
             "leased_until": {"$gt": 0} if expires is None else expires},
            {"$set": {"leased_until": 0, "leased_by": None}},
        )
        return result.matched_count > 0

    def recall_clerking_job_leases(self, node_id):
        # the dead-node recovery step: one bulk conditional update drops
        # every active lease the dead worker granted
        result = self.db.clerking_jobs.update_many(
            {"leased_by": str(node_id), "done": False,
             "leased_until": {"$gt": 0}},
            {"$set": {"leased_until": 0, "leased_by": None}},
        )
        return int(getattr(result, "modified_count", None)
                   or getattr(result, "matched_count", 0) or 0)

    def hedge_clerking_job(self, clerk, suspect_nodes, lease_seconds,
                           now=None, owner=None):
        # hedged execution: one atomic find_one_and_update re-grants a
        # SUSPECT holder's active lease to this caller (two hedgers race,
        # the filter matches exactly once); result commit stays
        # single-winner on the done flag
        suspects = [str(n) for n in suspect_nodes]
        if not suspects:
            return None
        now = time.time() if now is None else now
        expires = now + lease_seconds
        doc = self.db.clerking_jobs.find_one_and_update(
            {"clerk": str(clerk), "done": False,
             "leased_until": {"$gt": now},
             "leased_by": {"$in": suspects}},
            {"$set": {"leased_until": expires, "leased_by": owner}},
            sort=[("_id", 1)],
        )
        if doc is None:
            return None
        return ClerkingJob.from_obj(doc["doc"]), expires

    # -- fleet heartbeats ---------------------------------------------------
    def put_worker_heartbeat(self, doc):
        self.db.worker_heartbeats.replace_one(
            {"_id": doc["node"]},
            {"_id": doc["node"], "state": doc["state"], "doc": doc},
            upsert=True,
        )

    def get_worker_heartbeat(self, node):
        found = self.db.worker_heartbeats.find_one({"_id": str(node)})
        return None if found is None else found["doc"]

    def list_worker_heartbeats(self):
        return [d["doc"]
                for d in self.db.worker_heartbeats.find({}).sort("_id", 1)]

    def transition_worker_state(self, node, from_states, doc):
        # single-winner CAS: one atomic find_one_and_update filtered on
        # the FROM state (same shape as transition_round_state)
        found = self.db.worker_heartbeats.find_one_and_update(
            {"_id": str(node), "state": {"$in": list(from_states)}},
            {"$set": {"state": doc["state"], "doc": doc}},
        )
        return found is not None

    def list_snapshot_jobs(self, snapshot):
        # the sweeper's dead-clerk census: only the queue metadata fields
        # are decoded (the embedded payload/result docs stay untouched)
        out = []
        for d in self.db.clerking_jobs.find(
                {"snapshot": str(snapshot)}).sort("_id", 1):
            out.append((
                ClerkingJobId(d["_id"]),
                AgentId(d["clerk"]),
                bool(d.get("done")),
                float(d.get("leased_until") or 0.0),
            ))
        return out

    def get_clerking_job(self, clerk, job):
        doc = self.db.clerking_jobs.find_one({"_id": str(job), "clerk": str(clerk)})
        return None if doc is None else ClerkingJob.from_obj(doc["doc"])

    def create_clerking_result(self, result):
        chaos.fail("store.create_clerking_result")
        # ONE atomic single-document update sets the result and flips done —
        # a crash can never consume the job without storing the result (the
        # reference's clerking_jobs.rs create_clerking_result does the same
        # single $set; the round-1 two-write version lost the result if it
        # died between the flip and the separate results-collection insert)
        doc = self.db.clerking_jobs.find_one_and_update(
            {"_id": str(result.job), "clerk": str(result.clerk), "done": False},
            {"$set": {"done": True, "result": result.to_obj()}},
        )
        if doc is None:
            already = self.db.clerking_jobs.find_one(
                {"_id": str(result.job), "clerk": str(result.clerk)}
            )
            if already is not None and already.get("done"):
                return  # duplicate result upload: idempotent
            raise NotFound("job not found for clerk")

    def purge_snapshot_jobs(self, snapshot):
        # the retention/delete cascade's job-store half: job docs carry
        # their result embedded (post-atomic-fix schema), so one
        # delete_many covers jobs + leases + results; the legacy results
        # collection is swept for pre-fix data
        jobs = self.db.clerking_jobs.delete_many(
            {"snapshot": str(snapshot)})
        legacy = self.db.clerking_results.delete_many(
            {"snapshot": str(snapshot)})
        return (int(getattr(jobs, "deleted_count", 0) or 0)
                + int(getattr(legacy, "deleted_count", 0) or 0))

    def list_results(self, snapshot):
        ids = {
            d["_id"]
            for d in self.db.clerking_jobs.find(
                {"snapshot": str(snapshot), "done": True,
                 "result": {"$exists": True}})
        }
        # legacy schema (pre-atomic fix): result in its own collection
        ids.update(
            d["_id"]
            for d in self.db.clerking_results.find({"snapshot": str(snapshot)})
        )
        return [ClerkingJobId(i) for i in sorted(ids)]

    def get_result(self, snapshot, job):
        doc = self.db.clerking_jobs.find_one(
            {"_id": str(job), "snapshot": str(snapshot),
             "result": {"$exists": True}}
        )
        if doc is not None:
            return ClerkingResult.from_obj(doc["result"])
        legacy = self.db.clerking_results.find_one(
            {"_id": str(job), "snapshot": str(snapshot)}
        )
        return None if legacy is None else ClerkingResult.from_obj(legacy["doc"])
