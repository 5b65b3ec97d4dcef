"""SQLite store backend — the production-database store.

The reference ships a production MongoDB backend next to its JSON-file one
(server-store-mongodb/src/lib.rs:86-151); this is the same tier for sda-tpu,
built on the stdlib ``sqlite3`` so it needs no external service. Design
follows the Mongo store's shape, not the file store's:

- one document table per resource, JSON text keyed by id, upserts via
  ``INSERT .. ON CONFLICT`` (the Mongo store's ``modisert`` helper,
  lib.rs:118-151);
- snapshotting marks frozen participations in a join table — the analog of
  ``$addToSet``-ing the snapshot id onto participation docs
  (server-store-mongodb/src/aggregations.rs:132-142);
- the clerk-job queue is a done-flag column, result creation flips it in the
  same transaction (clerking_jobs.rs:32-75 done-flag queue);
- snapshot reads fetch frozen participations with one SQL join
  (``iter_snapped_participations``); the per-clerk transpose itself uses the
  shared default from ``stores.py`` (the Mongo store instead pushes it into a
  $match→$unwind→$group pipeline, aggregations.rs:164-195).

All four stores share one database handle (single writer, WAL) so a whole
server lives in one ``.db`` file — durable-by-construction like every other
backend (SURVEY.md §5.4).
"""

from __future__ import annotations

import contextlib
import json
import os
import sqlite3
import threading
import time
from typing import List

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

_SCHEMA = """
CREATE TABLE IF NOT EXISTS auth_tokens (
    id TEXT PRIMARY KEY, body TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS agents (
    id TEXT PRIMARY KEY, doc TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS profiles (
    owner TEXT PRIMARY KEY, doc TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS enc_keys (
    id TEXT PRIMARY KEY, signer TEXT NOT NULL, doc TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS aggregations (
    id TEXT PRIMARY KEY, title TEXT NOT NULL, recipient TEXT NOT NULL,
    doc TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS committees (
    aggregation TEXT PRIMARY KEY, doc TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS participations (
    id TEXT NOT NULL, aggregation TEXT NOT NULL,
    participant TEXT NOT NULL DEFAULT '',
    digest TEXT NOT NULL DEFAULT '',
    doc TEXT NOT NULL,
    PRIMARY KEY (aggregation, id));
CREATE INDEX IF NOT EXISTS ix_parts_agent
    ON participations (aggregation, participant);
CREATE TABLE IF NOT EXISTS snapshots (
    id TEXT NOT NULL, aggregation TEXT NOT NULL, doc TEXT NOT NULL,
    PRIMARY KEY (aggregation, id));
CREATE TABLE IF NOT EXISTS snapshot_parts (
    snapshot TEXT NOT NULL, participation TEXT NOT NULL,
    PRIMARY KEY (snapshot, participation));
CREATE TABLE IF NOT EXISTS snapshot_freezes (
    snapshot TEXT PRIMARY KEY);
CREATE TABLE IF NOT EXISTS snapshot_masks (
    snapshot TEXT PRIMARY KEY, doc TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS snapshot_mask_chunks (
    snapshot TEXT NOT NULL, chunk_ix INTEGER NOT NULL, doc TEXT NOT NULL,
    PRIMARY KEY (snapshot, chunk_ix));
CREATE TABLE IF NOT EXISTS clerking_jobs (
    id TEXT NOT NULL, clerk TEXT NOT NULL, snapshot TEXT NOT NULL,
    done INTEGER NOT NULL DEFAULT 0, leased_until REAL NOT NULL DEFAULT 0,
    leased_by TEXT NOT NULL DEFAULT '',
    doc TEXT NOT NULL,
    PRIMARY KEY (clerk, id));
CREATE INDEX IF NOT EXISTS ix_jobs_queue ON clerking_jobs (clerk, done, id);
CREATE TABLE IF NOT EXISTS clerking_results (
    job TEXT NOT NULL, snapshot TEXT NOT NULL, doc TEXT NOT NULL,
    PRIMARY KEY (snapshot, job));
CREATE TABLE IF NOT EXISTS rounds (
    aggregation TEXT PRIMARY KEY, state TEXT NOT NULL, doc TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS schedules (
    schedule TEXT PRIMARY KEY, epoch INTEGER NOT NULL, doc TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS worker_heartbeats (
    node TEXT PRIMARY KEY, state TEXT NOT NULL, doc TEXT NOT NULL);
"""


class SqliteDb:
    """Shared per-process handle; ``":memory:"`` works for tests.

    One database file can be shared by SEVERAL OS processes (the fleet
    plane, ``sda_tpu_torch/server/fleet.py``): WAL lets readers proceed under a
    writer, ``busy_timeout`` makes competing writers queue instead of
    throwing ``database is locked``, and every multi-statement write runs
    inside an explicit ``BEGIN IMMEDIATE`` transaction so it takes the
    write lock up front — no deferred-transaction upgrade deadlocks
    between two processes mid-write. Within one process the ``lock``
    RLock serializes threads over the single connection.
    """

    def __init__(self, path, busy_timeout_s: float = None):
        self.path = str(path)
        self.lock = threading.RLock()
        if busy_timeout_s is None:
            busy_timeout_s = float(os.environ.get("SDA_SQLITE_BUSY_MS", 10000)) / 1e3
        # isolation_level=None = autocommit: single statements commit
        # themselves; transactions are explicit BEGIN IMMEDIATE via
        # immediate() (python's implicit deferred transactions would
        # upgrade read->write locks mid-transaction, the classic
        # two-process SQLITE_BUSY deadlock)
        self.conn = sqlite3.connect(
            self.path, check_same_thread=False, isolation_level=None
        )
        with self.lock:
            self.conn.execute(f"PRAGMA busy_timeout={int(busy_timeout_s * 1e3)}")
            if self.path != ":memory:":
                # the rollback->WAL transition needs an exclusive lock and
                # does NOT always consult the busy handler (it returns
                # SQLITE_BUSY straight away mid-transition) — N fleet
                # workers opening one fresh database file race exactly
                # that, so retry by hand under the same time budget
                deadline = time.monotonic() + busy_timeout_s
                while True:
                    try:
                        self.conn.execute("PRAGMA journal_mode=WAL")
                        break
                    except sqlite3.OperationalError as e:
                        if "locked" not in str(e) \
                                or time.monotonic() >= deadline:
                            raise
                        time.sleep(0.05)
                # WAL's standard durability pairing: fsync on checkpoint,
                # not on every commit — the cross-process write path is
                # hot (every participation is one commit)
                self.conn.execute("PRAGMA synchronous=NORMAL")
            self.conn.executescript(_SCHEMA)
            # migrate pre-lease databases: CREATE IF NOT EXISTS won't add
            # the column to an existing clerking_jobs table
            cols = {
                r[1] for r in self.conn.execute("PRAGMA table_info(clerking_jobs)")
            }
            if "leased_until" not in cols:
                self.conn.execute(
                    "ALTER TABLE clerking_jobs "
                    "ADD COLUMN leased_until REAL NOT NULL DEFAULT 0"
                )
            if "leased_by" not in cols:
                # pre-gray-failure databases: the lease-owner column the
                # heartbeat recall / hedging plane keys on
                self.conn.execute(
                    "ALTER TABLE clerking_jobs "
                    "ADD COLUMN leased_by TEXT NOT NULL DEFAULT ''"
                )
            # migrate pre-exactly-once databases: the participant/digest
            # columns the single-winner participation insert keys on.
            # Legacy rows keep '' (never matches a real agent id or
            # digest); the read path recomputes their digest from doc.
            part_cols = {
                r[1] for r in self.conn.execute(
                    "PRAGMA table_info(participations)")
            }
            for column in ("participant", "digest"):
                if column not in part_cols:
                    self.conn.execute(
                        f"ALTER TABLE participations "
                        f"ADD COLUMN {column} TEXT NOT NULL DEFAULT ''"
                    )
            self.conn.execute(
                "CREATE INDEX IF NOT EXISTS ix_parts_agent "
                "ON participations (aggregation, participant)")

    @contextlib.contextmanager
    def immediate(self):
        """One multi-statement write as a single ``BEGIN IMMEDIATE``
        transaction: the write lock is taken at BEGIN (queueing behind
        other processes under busy_timeout), statements run, COMMIT
        publishes all of them atomically."""
        with self.lock:
            self.conn.execute("BEGIN IMMEDIATE")
            try:
                yield self.conn
            except BaseException:
                self.conn.execute("ROLLBACK")
                raise
            else:
                self.conn.execute("COMMIT")

    def ping(self) -> None:
        with self.lock:
            self.conn.execute("SELECT 1").fetchone()


class _SqliteStore(BaseStore):
    def __init__(self, db: SqliteDb):
        self.db = db

    def ping(self) -> None:
        self.db.ping()

    def _one(self, sql: str, args=()):
        with self.db.lock:
            row = self.db.conn.execute(sql, args).fetchone()
        return row

    def _all(self, sql: str, args=()):
        with self.db.lock:
            return self.db.conn.execute(sql, args).fetchall()

    def _exec(self, sql: str, args=()):
        # autocommit connection: a single statement is its own transaction
        with self.db.lock:
            return self.db.conn.execute(sql, args)


class SqliteAuthTokensStore(_SqliteStore, AuthTokensStore):
    def upsert_auth_token(self, token):
        self._exec(
            "INSERT INTO auth_tokens (id, body) VALUES (?, ?) "
            "ON CONFLICT (id) DO UPDATE SET body = excluded.body",
            (str(token.id), token.body),
        )

    def get_auth_token(self, id):
        row = self._one("SELECT body FROM auth_tokens WHERE id = ?", (str(id),))
        return None if row is None else auth_token(id, row[0])

    def delete_auth_token(self, id):
        self._exec("DELETE FROM auth_tokens WHERE id = ?", (str(id),))


class SqliteAgentsStore(_SqliteStore, AgentsStore):
    def create_agent(self, agent):
        self._exec(
            "INSERT INTO agents (id, doc) VALUES (?, ?) "
            "ON CONFLICT (id) DO UPDATE SET doc = excluded.doc",
            (str(agent.id), json.dumps(agent.to_obj())),
        )

    def get_agent(self, id):
        row = self._one("SELECT doc FROM agents WHERE id = ?", (str(id),))
        return None if row is None else Agent.from_obj(json.loads(row[0]))

    def upsert_profile(self, profile):
        self._exec(
            "INSERT INTO profiles (owner, doc) VALUES (?, ?) "
            "ON CONFLICT (owner) DO UPDATE SET doc = excluded.doc",
            (str(profile.owner), json.dumps(profile.to_obj())),
        )

    def get_profile(self, owner):
        row = self._one("SELECT doc FROM profiles WHERE owner = ?", (str(owner),))
        return None if row is None else Profile.from_obj(json.loads(row[0]))

    def create_encryption_key(self, key):
        self._exec(
            "INSERT INTO enc_keys (id, signer, doc) VALUES (?, ?, ?) "
            "ON CONFLICT (id) DO UPDATE SET signer = excluded.signer, "
            "doc = excluded.doc",
            (str(key.body.id), str(key.signer), json.dumps(key.to_obj())),
        )

    def get_encryption_key(self, key):
        row = self._one("SELECT doc FROM enc_keys WHERE id = ?", (str(key),))
        return None if row is None else signed_encryption_key_from_obj(json.loads(row[0]))

    def suggest_committee(self):
        rows = self._all("SELECT signer, id FROM enc_keys ORDER BY signer, id")
        candidates: List[ClerkCandidate] = []
        for signer, key_id in rows:
            if candidates and str(candidates[-1].id) == signer:
                candidates[-1].keys.append(EncryptionKeyId(key_id))
            else:
                candidates.append(
                    ClerkCandidate(id=AgentId(signer), keys=[EncryptionKeyId(key_id)])
                )
        return candidates


class SqliteAggregationsStore(_SqliteStore, AggregationsStore):
    def list_aggregations(self, filter=None, recipient=None):
        sql = "SELECT id FROM aggregations"
        clauses, args = [], []
        if filter is not None:
            clauses.append("instr(title, ?) > 0")
            args.append(filter)
        if recipient is not None:
            clauses.append("recipient = ?")
            args.append(str(recipient))
        if clauses:
            sql += " WHERE " + " AND ".join(clauses)
        sql += " ORDER BY id"
        return [AggregationId(r[0]) for r in self._all(sql, tuple(args))]

    def create_aggregation(self, aggregation):
        self._exec(
            "INSERT INTO aggregations (id, title, recipient, doc) VALUES (?, ?, ?, ?) "
            "ON CONFLICT (id) DO UPDATE SET title = excluded.title, "
            "recipient = excluded.recipient, doc = excluded.doc",
            (
                str(aggregation.id),
                aggregation.title,
                str(aggregation.recipient),
                json.dumps(aggregation.to_obj()),
            ),
        )

    def get_aggregation(self, aggregation):
        row = self._one("SELECT doc FROM aggregations WHERE id = ?", (str(aggregation),))
        return None if row is None else Aggregation.from_obj(json.loads(row[0]))

    def delete_aggregation(self, aggregation):
        agg = str(aggregation)
        with self.db.immediate():
            for table in ("snapshot_parts", "snapshot_masks",
                          "snapshot_mask_chunks", "snapshot_freezes"):
                self.db.conn.execute(
                    f"DELETE FROM {table} WHERE snapshot IN "
                    "(SELECT id FROM snapshots WHERE aggregation = ?)",
                    (agg,),
                )
            self.db.conn.execute(
                "DELETE FROM participations WHERE aggregation = ?", (agg,)
            )
            self.db.conn.execute("DELETE FROM snapshots WHERE aggregation = ?", (agg,))
            self.db.conn.execute("DELETE FROM committees WHERE aggregation = ?", (agg,))
            self.db.conn.execute("DELETE FROM rounds WHERE aggregation = ?", (agg,))
            self.db.conn.execute("DELETE FROM aggregations WHERE id = ?", (agg,))

    def get_committee(self, aggregation):
        row = self._one(
            "SELECT doc FROM committees WHERE aggregation = ?", (str(aggregation),)
        )
        return None if row is None else Committee.from_obj(json.loads(row[0]))

    def create_committee(self, committee):
        self._exec(
            "INSERT INTO committees (aggregation, doc) VALUES (?, ?) "
            "ON CONFLICT (aggregation) DO UPDATE SET doc = excluded.doc",
            (str(committee.aggregation), json.dumps(committee.to_obj())),
        )

    @staticmethod
    def _row_digest(digest, doc):
        """A row's canonical digest, recomputed from the stored doc for
        legacy rows written before the digest column existed."""
        if digest:
            return digest
        return Participation.from_obj(json.loads(doc)).canonical_digest()

    def create_participation(self, participation):
        chaos.fail("store.create_participation")
        digest = participation.canonical_digest()
        # the checks and the insert share one BEGIN IMMEDIATE transaction:
        # the write lock is the cross-process arbiter, so two racing
        # uploaders of one key admit exactly one winner (exactly-once
        # ingestion contract, stores.py)
        with self.db.immediate():
            exists = self.db.conn.execute(
                "SELECT 1 FROM aggregations WHERE id = ?",
                (str(participation.aggregation),),
            ).fetchone()
            if exists is None:
                raise NotFound("aggregation not found")
            row = self.db.conn.execute(
                "SELECT digest, doc FROM participations "
                "WHERE aggregation = ? AND id = ?",
                (str(participation.aggregation), str(participation.id)),
            ).fetchone()
            if row is not None:
                # same participation id: byte-identical replay succeeds
                # idempotently; different content never silently replaces
                if self._row_digest(row[0], row[1]) == digest:
                    return False
                raise ParticipationConflict(
                    f"participation {participation.id} already exists "
                    "with different content",
                    participant=participation.participant,
                    aggregation=participation.aggregation)
            owned = self.db.conn.execute(
                "SELECT id FROM participations "
                "WHERE aggregation = ? AND participant = ?",
                (str(participation.aggregation),
                 str(participation.participant)),
            ).fetchone()
            if owned is not None:
                # same agent under a NEW id: a recompute-with-fresh-
                # randomness (or equivocation) that would double-count
                raise ParticipationConflict(
                    f"agent {participation.participant} already "
                    f"participated in {participation.aggregation} "
                    f"(participation {owned[0]})",
                    participant=participation.participant,
                    aggregation=participation.aggregation)
            self.db.conn.execute(
                "INSERT INTO participations "
                "(id, aggregation, participant, digest, doc) "
                "VALUES (?, ?, ?, ?, ?)",
                (
                    str(participation.id),
                    str(participation.aggregation),
                    str(participation.participant),
                    digest,
                    json.dumps(participation.to_obj()),
                ),
            )
            return True

    def create_snapshot(self, snapshot):
        chaos.fail("store.create_snapshot")
        # conditional insert (single-winner across competing server
        # processes): OR IGNORE makes the existing row win and rowcount
        # says whether THIS statement inserted — the contended-idempotency
        # commit point (stores.py contract)
        cursor = self._exec(
            "INSERT OR IGNORE INTO snapshots (id, aggregation, doc) "
            "VALUES (?, ?, ?)",
            (
                str(snapshot.id),
                str(snapshot.aggregation),
                json.dumps(snapshot.to_obj()),
            ),
        )
        return cursor.rowcount > 0

    def list_snapshots(self, aggregation):
        rows = self._all(
            "SELECT id FROM snapshots WHERE aggregation = ? ORDER BY id",
            (str(aggregation),),
        )
        return [SnapshotId(r[0]) for r in rows]

    def get_snapshot(self, aggregation, snapshot):
        row = self._one(
            "SELECT doc FROM snapshots WHERE aggregation = ? AND id = ?",
            (str(aggregation), str(snapshot)),
        )
        return None if row is None else Snapshot.from_obj(json.loads(row[0]))

    def count_participations(self, aggregation):
        row = self._one(
            "SELECT COUNT(*) FROM participations WHERE aggregation = ?",
            (str(aggregation),),
        )
        return row[0]

    def snapshot_participations(self, aggregation, snapshot):
        # the $addToSet moment, made single-winner for the fleet plane:
        # the freeze-marker insert inside BEGIN IMMEDIATE is the race
        # arbiter (OR IGNORE + rowcount), and the frozen id set commits in
        # the SAME transaction — a loser observing rowcount 0 is
        # guaranteed the winner's set is already durable, because the
        # winner's transaction committed before ours could see its marker
        with self.db.immediate():
            cursor = self.db.conn.execute(
                "INSERT OR IGNORE INTO snapshot_freezes (snapshot) VALUES (?)",
                (str(snapshot),),
            )
            if cursor.rowcount == 0:
                return False  # a concurrent/earlier freeze already won
            self.db.conn.execute(
                "INSERT OR IGNORE INTO snapshot_parts (snapshot, participation) "
                "SELECT ?, id FROM participations WHERE aggregation = ?",
                (str(snapshot), str(aggregation)),
            )
        return True

    def has_snapshot_freeze(self, aggregation, snapshot):
        row = self._one(
            "SELECT 1 FROM snapshot_freezes WHERE snapshot = ?", (str(snapshot),)
        )
        return row is not None

    def count_participations_snapshot(self, aggregation, snapshot):
        row = self._one(
            "SELECT COUNT(*) FROM snapshot_parts WHERE snapshot = ?", (str(snapshot),)
        )
        return row[0]

    def iter_snapped_participations(self, aggregation, snapshot):
        rows = self._all(
            "SELECT p.doc FROM snapshot_parts s "
            "JOIN participations p ON p.id = s.participation AND p.aggregation = ? "
            "WHERE s.snapshot = ? ORDER BY p.id",
            (str(aggregation), str(snapshot)),
        )
        return [Participation.from_obj(json.loads(r[0])) for r in rows]

    def iter_snapshot_clerk_jobs_data(self, aggregation, snapshot, clerks_number):
        # the snapshot transpose without the detour through full
        # Participation objects: one join read (one lock hold), decode
        # ONLY the clerk_encryptions field of each document — at committee
        # width C that skips 3 uuid parses + a recipient-mask decode per row
        rows = self._all(
            "SELECT p.doc FROM snapshot_parts s "
            "JOIN participations p ON p.id = s.participation AND p.aggregation = ? "
            "WHERE s.snapshot = ? ORDER BY p.id",
            (str(aggregation), str(snapshot)),
        )
        columns: List[List[Encryption]] = [[] for _ in range(clerks_number)]
        for (doc,) in rows:
            for ix, (_, enc) in enumerate(json.loads(doc)["clerk_encryptions"]):
                columns[ix].append(Encryption.from_obj(enc))
        return columns

    #: rows per keyset page of the streamed mask-column reads below —
    #: each page completes its statement before the caller's interleaved
    #: chunk writes, so reader memory is O(page) at tree-scale counts
    _MASK_PAGE = 256

    def _iter_snapped_docs(self, aggregation, snapshot):
        """Keyset-paginated walk of the frozen set's documents, in
        participation-id order: only one page of JSON is ever resident,
        and no cursor stays open across the mask-chunk writes the
        snapshot pipeline interleaves with this read."""
        last = ""
        while True:
            rows = self._all(
                "SELECT p.id, p.doc FROM snapshot_parts s "
                "JOIN participations p ON p.id = s.participation AND p.aggregation = ? "
                "WHERE s.snapshot = ? AND p.id > ? ORDER BY p.id LIMIT ?",
                (str(aggregation), str(snapshot), last, self._MASK_PAGE),
            )
            if not rows:
                return
            for _pid, doc in rows:
                yield json.loads(doc)
            last = rows[-1][0]

    def iter_snapped_recipient_encryptions(self, aggregation, snapshot):
        # mask-column read: decode only the recipient_encryption field,
        # streamed page by page
        for doc in self._iter_snapped_docs(aggregation, snapshot):
            enc = doc.get("recipient_encryption")
            yield None if enc is None else Encryption.from_obj(enc)

    def iter_snapped_forwarded_masks(self, aggregation, snapshot):
        # forwarded-mask column read (tree parents): same streamed walk,
        # decode only the forwarded_masks field
        for doc in self._iter_snapped_docs(aggregation, snapshot):
            for enc in doc.get("forwarded_masks") or ():
                yield Encryption.from_obj(enc)

    # -- round lifecycle ----------------------------------------------------
    def put_round_state(self, doc):
        self._exec(
            "INSERT INTO rounds (aggregation, state, doc) VALUES (?, ?, ?) "
            "ON CONFLICT (aggregation) DO UPDATE SET "
            "state = excluded.state, doc = excluded.doc",
            (doc["aggregation"], doc["state"], json.dumps(doc)),
        )

    def get_round_state(self, aggregation):
        row = self._one(
            "SELECT doc FROM rounds WHERE aggregation = ?", (str(aggregation),)
        )
        return None if row is None else json.loads(row[0])

    def list_round_states(self):
        rows = self._all("SELECT doc FROM rounds ORDER BY aggregation")
        return [json.loads(r[0]) for r in rows]

    def transition_round_state(self, aggregation, from_states, doc):
        # single-winner CAS across OS processes: ONE conditional UPDATE —
        # autocommit makes it its own transaction, rowcount says whether
        # THIS worker's sweep performed the transition (fleet contract,
        # same shape as the snapshot-freeze conditional insert)
        from_states = tuple(str(s) for s in from_states)
        cursor = self._exec(
            "UPDATE rounds SET state = ?, doc = ? WHERE aggregation = ? "
            f"AND state IN ({','.join('?' * len(from_states))})",
            (doc["state"], json.dumps(doc), str(aggregation), *from_states),
        )
        return cursor.rowcount > 0

    # -- recurring-round schedules -------------------------------------------
    def create_schedule_state(self, doc):
        # conditional insert (single-winner across OS processes): OR
        # IGNORE + rowcount, same arbitration shape as create_snapshot —
        # a booting scheduler can never reset an advanced schedule
        cursor = self._exec(
            "INSERT OR IGNORE INTO schedules (schedule, epoch, doc) "
            "VALUES (?, ?, ?)",
            (doc["schedule"], int(doc["epoch"]), json.dumps(doc)),
        )
        return cursor.rowcount > 0

    def get_schedule_state(self, schedule):
        row = self._one(
            "SELECT doc FROM schedules WHERE schedule = ?", (str(schedule),)
        )
        return None if row is None else json.loads(row[0])

    def list_schedule_states(self):
        rows = self._all("SELECT doc FROM schedules ORDER BY schedule")
        return [json.loads(r[0]) for r in rows]

    def transition_schedule_state(self, schedule, from_epoch, doc):
        # single-winner epoch CAS across OS processes: ONE conditional
        # UPDATE keyed on the FROM epoch; rowcount says whether THIS
        # scheduler's advance won (same shape as transition_round_state)
        cursor = self._exec(
            "UPDATE schedules SET epoch = ?, doc = ? "
            "WHERE schedule = ? AND epoch = ?",
            (int(doc["epoch"]), json.dumps(doc), str(schedule),
             int(from_epoch)),
        )
        return cursor.rowcount > 0

    def create_snapshot_mask(self, snapshot, mask):
        self.put_snapshot_mask_chunk(snapshot, 0, mask)
        self.trim_snapshot_mask_chunks(snapshot, 1)

    def put_snapshot_mask_chunk(self, snapshot, index, encryptions):
        # pure chunk upsert keyed by (snapshot, chunk_ix): a replaying or
        # contended pipeline rewrites byte-identical chunks (stores.py
        # contract), so a reader holding the committed snapshot record
        # always sees a complete mask — the atomicity the old single-row
        # write had. Chunk 0 also supersedes any legacy single-row mask.
        snap = str(snapshot)
        doc = json.dumps([e.to_obj() for e in encryptions])
        with self.db.immediate():
            if index == 0:
                self.db.conn.execute(
                    "DELETE FROM snapshot_masks WHERE snapshot = ?", (snap,))
            self.db.conn.execute(
                "INSERT INTO snapshot_mask_chunks (snapshot, chunk_ix, doc) "
                "VALUES (?, ?, ?) ON CONFLICT (snapshot, chunk_ix) "
                "DO UPDATE SET doc = excluded.doc",
                (snap, int(index), doc),
            )

    def trim_snapshot_mask_chunks(self, snapshot, count):
        self._exec(
            "DELETE FROM snapshot_mask_chunks WHERE snapshot = ? "
            "AND chunk_ix >= ?", (str(snapshot), int(count)),
        )

    def get_snapshot_mask(self, snapshot):
        rows = self._all(
            "SELECT doc FROM snapshot_mask_chunks WHERE snapshot = ? "
            "ORDER BY chunk_ix", (str(snapshot),)
        )
        if not rows:
            # pre-chunking database: fall back to the legacy single row
            row = self._one(
                "SELECT doc FROM snapshot_masks WHERE snapshot = ?",
                (str(snapshot),)
            )
            if row is None:
                return None
            return [Encryption.from_obj(e) for e in json.loads(row[0])]
        return [
            Encryption.from_obj(e)
            for (doc,) in rows
            for e in json.loads(doc)
        ]


class SqliteClerkingJobsStore(_SqliteStore, ClerkingJobsStore):
    def enqueue_clerking_job(self, job):
        chaos.fail("store.enqueue_clerking_job")
        # upsert keyed by (clerk, id); the conflict clause deliberately
        # leaves done/leased_until alone — and refuses to touch a DONE
        # job's payload at all — so a snapshot retry can't resurrect,
        # un-lease, or rewrite completed work
        self._exec(
            "INSERT INTO clerking_jobs (id, clerk, snapshot, done, doc) "
            "VALUES (?, ?, ?, 0, ?) "
            "ON CONFLICT (clerk, id) DO UPDATE SET doc = excluded.doc "
            "WHERE clerking_jobs.done = 0",
            (
                str(job.id),
                str(job.clerk),
                str(job.snapshot),
                json.dumps(job.to_obj()),
            ),
        )

    def enqueue_clerking_jobs(self, jobs):
        # the snapshot fan-out: C jobs (each a whole clerk column) in ONE
        # transaction instead of C commits. Same upsert clause as the
        # per-item path, so done jobs are never resurrected; failpoints
        # fire per job so chaos drills keep their trigger budget
        jobs = list(jobs)
        if not jobs:
            return
        for _ in jobs:
            chaos.fail("store.enqueue_clerking_job")
        with self.db.immediate():
            self.db.conn.executemany(
                "INSERT INTO clerking_jobs (id, clerk, snapshot, done, doc) "
                "VALUES (?, ?, ?, 0, ?) "
                "ON CONFLICT (clerk, id) DO UPDATE SET doc = excluded.doc "
                "WHERE clerking_jobs.done = 0",
                [
                    (
                        str(job.id),
                        str(job.clerk),
                        str(job.snapshot),
                        json.dumps(job.to_obj()),
                    )
                    for job in jobs
                ],
            )

    def poll_clerking_job(self, clerk):
        chaos.fail("store.poll_clerking_job")
        row = self._one(
            "SELECT doc FROM clerking_jobs WHERE clerk = ? AND done = 0 "
            "ORDER BY id LIMIT 1",
            (str(clerk),),
        )
        return None if row is None else ClerkingJob.from_obj(json.loads(row[0]))

    def lease_clerking_job(self, clerk, lease_seconds, now=None, owner=None):
        chaos.fail("store.poll_clerking_job")
        now = time.time() if now is None else now
        # select + stamp in ONE immediate transaction: two processes
        # polling the same clerk identity cannot both stamp one job
        with self.db.immediate():
            row = self.db.conn.execute(
                "SELECT id, doc, leased_until FROM clerking_jobs "
                "WHERE clerk = ? AND done = 0 AND leased_until <= ? "
                "ORDER BY id LIMIT 1",
                (str(clerk), now),
            ).fetchone()
            if row is None:
                return None
            job_id, doc, previous = row
            if previous > 0:
                metrics.count("server.job.reissued")
            expires = now + lease_seconds
            self.db.conn.execute(
                "UPDATE clerking_jobs SET leased_until = ?, leased_by = ? "
                "WHERE clerk = ? AND id = ?",
                (expires, owner or "", str(clerk), job_id),
            )
            return ClerkingJob.from_obj(json.loads(doc)), expires

    def release_clerking_job_lease(self, clerk, job, expires=None):
        # graceful drain: hand a still-undone job straight back to the
        # fleet (leased_until 0 == immediately pollable by any process).
        # Compare-and-release: with `expires` the UPDATE only matches the
        # exact lease this caller was granted — a lapsed lease re-granted
        # to a peer has a new leased_until and stays the peer's
        sql = ("UPDATE clerking_jobs SET leased_until = 0, leased_by = '' "
               "WHERE clerk = ? AND id = ? AND done = 0 AND leased_until > 0")
        args = [str(clerk), str(job)]
        if expires is not None:
            sql += " AND leased_until = ?"
            args.append(expires)
        cursor = self._exec(sql, tuple(args))
        return cursor.rowcount > 0

    def recall_clerking_job_leases(self, node_id):
        # the dead-node recovery step: ONE conditional UPDATE drops every
        # active lease the dead worker granted — any process's next poll
        # reissues them immediately (autocommit: its own transaction)
        cursor = self._exec(
            "UPDATE clerking_jobs SET leased_until = 0, leased_by = '' "
            "WHERE leased_by = ? AND done = 0 AND leased_until > 0",
            (str(node_id),),
        )
        return cursor.rowcount

    def hedge_clerking_job(self, clerk, suspect_nodes, lease_seconds,
                           now=None, owner=None):
        # hedged execution: re-grant a SUSPECT holder's ACTIVE lease to
        # this caller inside one immediate transaction (two hedgers race,
        # one wins); the original holder may still finish — result commit
        # stays single-winner on the done flag
        suspects = [str(n) for n in suspect_nodes]
        if not suspects:
            return None
        now = time.time() if now is None else now
        with self.db.immediate():
            row = self.db.conn.execute(
                "SELECT id, doc FROM clerking_jobs "
                "WHERE clerk = ? AND done = 0 AND leased_until > ? "
                f"AND leased_by IN ({','.join('?' * len(suspects))}) "
                "ORDER BY id LIMIT 1",
                (str(clerk), now, *suspects),
            ).fetchone()
            if row is None:
                return None
            job_id, doc = row
            expires = now + lease_seconds
            self.db.conn.execute(
                "UPDATE clerking_jobs SET leased_until = ?, leased_by = ? "
                "WHERE clerk = ? AND id = ?",
                (expires, owner or "", str(clerk), job_id),
            )
            return ClerkingJob.from_obj(json.loads(doc)), expires

    # -- fleet heartbeats ---------------------------------------------------
    def put_worker_heartbeat(self, doc):
        self._exec(
            "INSERT INTO worker_heartbeats (node, state, doc) "
            "VALUES (?, ?, ?) "
            "ON CONFLICT (node) DO UPDATE SET "
            "state = excluded.state, doc = excluded.doc",
            (doc["node"], doc["state"], json.dumps(doc)),
        )

    def get_worker_heartbeat(self, node):
        row = self._one(
            "SELECT doc FROM worker_heartbeats WHERE node = ?", (str(node),)
        )
        return None if row is None else json.loads(row[0])

    def list_worker_heartbeats(self):
        rows = self._all("SELECT doc FROM worker_heartbeats ORDER BY node")
        return [json.loads(r[0]) for r in rows]

    def transition_worker_state(self, node, from_states, doc):
        # single-winner CAS across OS processes: one conditional UPDATE,
        # rowcount says whether THIS sweeper's declaration won (same
        # shape as transition_round_state)
        from_states = tuple(str(s) for s in from_states)
        cursor = self._exec(
            "UPDATE worker_heartbeats SET state = ?, doc = ? "
            f"WHERE node = ? AND state IN ({','.join('?' * len(from_states))})",
            (doc["state"], json.dumps(doc), str(node), *from_states),
        )
        return cursor.rowcount > 0

    def list_snapshot_jobs(self, snapshot):
        # the sweeper's dead-clerk census: one indexed-column read, no
        # payload decode (the doc column never leaves the database)
        rows = self._all(
            "SELECT id, clerk, done, leased_until FROM clerking_jobs "
            "WHERE snapshot = ? ORDER BY id",
            (str(snapshot),),
        )
        return [
            (ClerkingJobId(r[0]), AgentId(r[1]), bool(r[2]), float(r[3]))
            for r in rows
        ]

    def get_clerking_job(self, clerk, job):
        row = self._one(
            "SELECT doc FROM clerking_jobs WHERE clerk = ? AND id = ?",
            (str(clerk), str(job)),
        )
        return None if row is None else ClerkingJob.from_obj(json.loads(row[0]))

    def create_clerking_result(self, result):
        chaos.fail("store.create_clerking_result")
        # result write + done-flag flip, atomically (the Mongo store's
        # done-flag queue semantics, clerking_jobs.rs:32-75)
        with self.db.immediate():
            row = self.db.conn.execute(
                "SELECT snapshot, done FROM clerking_jobs WHERE clerk = ? AND id = ?",
                (str(result.clerk), str(result.job)),
            ).fetchone()
            if row is None:
                raise NotFound("job not found for clerk")
            snapshot, done = row
            if done:
                return  # duplicate result upload: idempotent
            self.db.conn.execute(
                "INSERT INTO clerking_results (job, snapshot, doc) VALUES (?, ?, ?) "
                "ON CONFLICT (snapshot, job) DO UPDATE SET doc = excluded.doc",
                (str(result.job), snapshot, json.dumps(result.to_obj())),
            )
            self.db.conn.execute(
                "UPDATE clerking_jobs SET done = 1 WHERE clerk = ? AND id = ?",
                (str(result.clerk), str(result.job)),
            )

    def purge_snapshot_jobs(self, snapshot):
        # the retention/delete cascade's job-store half: jobs (queued and
        # done, leases riding the rows) and results of the snapshot leave
        # in one transaction
        with self.db.immediate():
            jobs = self.db.conn.execute(
                "DELETE FROM clerking_jobs WHERE snapshot = ?",
                (str(snapshot),),
            ).rowcount
            results = self.db.conn.execute(
                "DELETE FROM clerking_results WHERE snapshot = ?",
                (str(snapshot),),
            ).rowcount
        return max(0, jobs) + max(0, results)

    def list_results(self, snapshot):
        rows = self._all(
            "SELECT job FROM clerking_results WHERE snapshot = ? ORDER BY job",
            (str(snapshot),),
        )
        return [ClerkingJobId(r[0]) for r in rows]

    def get_result(self, snapshot, job):
        row = self._one(
            "SELECT doc FROM clerking_results WHERE snapshot = ? AND job = ?",
            (str(snapshot), str(job)),
        )
        return None if row is None else ClerkingResult.from_obj(json.loads(row[0]))
