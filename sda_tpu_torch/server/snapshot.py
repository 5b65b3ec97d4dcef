"""The snapshot scheduler — the server-side "compute".

Reference: server/src/snapshot.rs:4-47. Creating a snapshot (1) freezes the
current participation set, (2) transposes participations x clerks into one
ClerkingJob per committee member, (3) records the snapshot, and (4) collects
the recipient-mask encryptions if the aggregation masks. All heavy lifting
is data movement; the field math happens at the clerks — EXCEPT under
Paillier premixing (below), where the broker also multiplies ciphertexts.

Premixing: when the committee encryption scheme is PackedPaillier and the
server opts in (``SdaServer.premix_paillier``), each clerk's column of
participation ciphertext batches is homomorphically combined *on the
server* before enqueueing — the untrusted broker compresses every clerk's
download from N batches to ceil(N / additive_capacity) without learning
anything (ciphertext products reveal nothing new), and the clerk-side flow
is unchanged: it decrypts integer share sums and its modular combine
reduces them. This is the payoff the reference's commented-out
PackedPaillier declaration (protocol/src/crypto.rs:164-174) was pointing
at; Sodium aggregations are untouched since sealed boxes don't compose.
"""

from __future__ import annotations

import logging
import uuid

from ..protocol import (
    ClerkingJob,
    ClerkingJobId,
    NotFound,
    PackedPaillierEncryption,
    Snapshot,
)
from .. import obs
from ..utils import metrics, timed_phase
from . import lifecycle

log = logging.getLogger(__name__)

#: Namespace for deterministic clerking-job ids (uuid5 over snapshot:clerk).
_JOB_NAMESPACE = uuid.UUID("6ad33932-6a4c-4745-a2b4-11e89e7206ad")


def clerking_job_id(snapshot_id, clerk_id) -> ClerkingJobId:
    """Deterministic job id for (snapshot, clerk) — re-running the snapshot
    pipeline (a retried POST after a lost response, a crash-resume replay)
    upserts the SAME jobs instead of enqueueing duplicates, which is what
    makes snapshot creation safe for the retrying transport."""
    return ClerkingJobId(uuid.uuid5(_JOB_NAMESPACE, f"{snapshot_id}:{clerk_id}"))


def _premix_columns(server, aggregation, committee, columns):
    """Per-clerk homomorphic combine of participation ciphertext columns."""
    from ..crypto.encryption import paillier_combine

    scheme = aggregation.committee_encryption_scheme
    cap = scheme.additive_capacity
    mixed = []
    for (clerk_id, key_id), column in zip(committee.clerks_and_keys, columns):
        signed_key = server.get_encryption_key(key_id)
        if signed_key is None:
            raise NotFound("lost clerk encryption key")
        ek = signed_key.body.body
        try:
            combined = [
                paillier_combine(ek, scheme, column[i : i + cap])
                for i in range(0, len(column), cap)
            ]
        except ValueError as e:
            # participant uploads are untrusted: a forged/malformed batch
            # must not wedge snapshot creation for everyone — enqueue the
            # column unmixed and let the clerk hit the bad batch itself,
            # exactly as it would without premixing
            log.warning(
                "premix skipped for clerk %s (malformed participation "
                "ciphertext: %s); enqueueing column unmixed", clerk_id, e
            )
            metrics.count("server.premix.skipped_malformed")
            mixed.append(column)
            continue
        metrics.count("server.premix.inputs", len(column))
        metrics.count("server.premix.outputs", len(combined))
        mixed.append(combined)
    return mixed


#: Upper bound on mask-ciphertext chunks materialized in pipeline memory
#: at once (override via SDA_SNAPSHOT_MASK_BATCH). Tree-scale leaf counts
#: make the mask column the largest per-round allocation on the broker;
#: chunking keeps snapshot memory O(batch) regardless of population size.
#: FLEET-UNIFORM, like every per-worker protocol knob: concurrent
#: pipelines chunking ONE snapshot at different boundaries cannot
#: converge (stores.py mask-chunk contract) — never vary this across
#: workers of one fleet mid-flight; the trim step only reconciles
#: SEQUENTIAL config changes (a replay after restart).
DEFAULT_MASK_BATCH = 1024


def _mask_batch_size() -> int:
    import os

    raw = os.environ.get("SDA_SNAPSHOT_MASK_BATCH", "")
    try:
        return max(1, int(raw)) if raw.strip() else DEFAULT_MASK_BATCH
    except ValueError:
        return DEFAULT_MASK_BATCH


def _collect_masks_streamed(server, aggregation, snap) -> None:
    """Stream the recipient-mask column into bounded store chunks.

    The column read stays a per-participation iterator and each full
    batch is flushed with ``put_snapshot_mask_chunk`` — pipeline memory
    is O(batch), not O(participants). Chunk writes are pure upserts: a
    crash-replay (or a contended fleet peer re-running the pipeline over
    the SAME frozen set) rewrites an identical chunk sequence, so any
    interleaving converges bit-exactly AND a reader holding the
    committed snapshot record always sees a complete mask (stores.py
    contended-idempotency contract); the final trim drops excess chunks
    left by an attempt that used a different batch size.

    Tree parents additionally append the frozen set's FORWARDED mask
    ciphertexts (``Participation.forwarded_masks`` — each relay's leaf
    masks, sealed to the root recipient), so the root's reveal sees one
    flat mask list: relay masks first (participation order), then the
    forwarded leaf masks.
    """
    batch = _mask_batch_size()
    store = server.aggregation_store
    chunk, index, total = [], 0, 0

    def flush():
        nonlocal chunk, index
        store.put_snapshot_mask_chunk(snap.id, index, chunk)
        metrics.observe("server.snapshot.mask_chunk", len(chunk))
        index += 1
        chunk = []

    for encryption in store.iter_snapped_recipient_encryptions(
        snap.aggregation, snap.id
    ):
        if encryption is None:
            raise NotFound("participation should have had a recipient encryption")
        chunk.append(encryption)
        total += 1
        if len(chunk) >= batch:
            flush()
    tree = getattr(aggregation, "tree", None)
    if tree is not None and tree.children:
        # forwarded leaf masks ride the SAME chunked stream upward
        for encryption in store.iter_snapped_forwarded_masks(
            snap.aggregation, snap.id
        ):
            chunk.append(encryption)
            total += 1
            if len(chunk) >= batch:
                flush()
    # always write the final (possibly empty) chunk: chunk 0 must exist so
    # get_snapshot_mask distinguishes "masked round, zero participations"
    # from "never collected"
    if chunk or index == 0:
        flush()
    store.trim_snapshot_mask_chunks(snap.id, index)
    metrics.count("server.snapshot.masks_collected", total)


def snapshot(server, snap: Snapshot) -> bool:
    # the whole pipeline is serialized: a timed-out client retry arriving
    # while the original is still running must wait and then hit the
    # existence check, not race the freeze/enqueue (snapshot creation is
    # a rare control-plane operation; the lock costs nothing that matters)
    with server._snapshot_lock:
        return _snapshot_locked(server, snap)


def _snapshot_locked(server, snap: Snapshot) -> bool:
    aggregation = server.aggregation_store.get_aggregation(snap.aggregation)
    if aggregation is None:
        raise NotFound("lost aggregation")
    if server.aggregation_store.get_snapshot(snap.aggregation, snap.id) is not None:
        # create-once: the snapshot record is written last (below), so its
        # presence proves the whole pipeline already ran — a retry is a no-op
        log.debug("snapshot %s: already exists, skipping", snap.id)
        metrics.count("server.snapshot.duplicate")
        return False
    log.debug("snapshot %s: freezing participations", snap.id)
    with timed_phase("server.snapshot_freeze"):
        # first-write-wins, now store-arbitrated: snapshot_participations
        # is single-winner even across competing server processes, so a
        # crash-replay (record not yet committed, jobs possibly enqueued
        # and even clerked) AND a concurrent peer's pipeline both re-use
        # the ORIGINAL frozen set — re-freezing after a late participation
        # would mix share generations across clerk columns
        if not server.aggregation_store.snapshot_participations(
            snap.aggregation, snap.id
        ):
            log.debug("snapshot %s: freeze already installed (replay or "
                      "competing worker); converging on it", snap.id)
            metrics.count("server.snapshot.freeze_converged")
    # lifecycle: the round leaves collecting the moment its participation
    # set is frozen (CAS — contended pipelines note it exactly once)
    lifecycle.note_frozen(server, aggregation, snap.id)

    committee = server.get_committee(snap.aggregation)
    if committee is None:
        raise NotFound("lost committee")

    log.debug("snapshot %s: transposing encryptions", snap.id)
    with timed_phase("server.transpose"):
        columns = server.aggregation_store.iter_snapshot_clerk_jobs_data(
            snap.aggregation, snap.id, len(committee.clerks_and_keys)
        )

    if (
        getattr(server, "premix_paillier", False)
        and isinstance(
            aggregation.committee_encryption_scheme, PackedPaillierEncryption
        )
        and any(columns)
    ):
        log.debug("snapshot %s: premixing clerk columns homomorphically", snap.id)
        with timed_phase("server.premix"):
            columns = _premix_columns(server, aggregation, committee, columns)

    log.debug("snapshot %s: enqueueing %d clerking jobs", snap.id, len(columns))
    with timed_phase("server.enqueue_jobs"):
        enqueue_ctx = obs.current_context()
        jobs = []
        for (clerk_id, _), encryptions in zip(committee.clerks_and_keys, columns):
            job = ClerkingJob(
                id=clerking_job_id(snap.id, clerk_id),
                clerk=clerk_id,
                aggregation=snap.aggregation,
                snapshot=snap.id,
                encryptions=encryptions,
            )
            # remember which trace enqueued each job: clerk-side processing
            # (including a lease-reissued retry of the same deterministic
            # job id) re-parents to this round instead of its own poll
            obs.link_job(str(job.id), enqueue_ctx)
            jobs.append(job)
        # ONE bulk store write for the whole committee fan-out (a single
        # transaction on sqlite, one lock hold on memory/jsonfs, batched
        # round trips on mongo) instead of C commits of C full columns
        server.clerking_job_store.enqueue_clerking_jobs(jobs)
        # long-poll push plane: stamp enqueue time (server.job.pickup
        # histogram) and wake exactly the clerks that now have work, so a
        # parked GET /v1/clerking-jobs?wait=S answers immediately instead
        # of riding out its re-check tick (server/wakeup.py)
        server.note_jobs_enqueued(job.id for job in jobs)
        server.job_wakeup.notify(job.clerk for job in jobs)
    # lifecycle: jobs are durable, the committee can work — the round is
    # clerking and its deadline clock starts (lifecycle.py)
    lifecycle.note_clerking(server, snap.aggregation, snap.id)

    if aggregation.masking_scheme.has_mask:
        log.debug("snapshot %s: collecting recipient mask encryptions", snap.id)
        with timed_phase("server.collect_masks"):
            _collect_masks_streamed(server, aggregation, snap)

    # the snapshot record is the commit point and therefore goes LAST:
    # its presence proves jobs and masks are durable, so the existence
    # check above can safely short-circuit a retried create. A crash
    # mid-pipeline leaves no record and the retry re-runs everything —
    # job ids are deterministic, so the re-run upserts instead of
    # duplicating. The insert is single-winner across competing server
    # processes (store-level conditional insert): when a peer's pipeline
    # commits first, OUR pipeline has already upserted the exact same
    # uuid5(snapshot, clerk) job set, so losing is convergence — report
    # not-created and leave the winner's record untouched.
    if not server.aggregation_store.create_snapshot(snap):
        log.debug("snapshot %s: lost the record race to a competing "
                  "worker (identical job set already enqueued)", snap.id)
        metrics.count("server.snapshot.contended")
        return False

    log.debug("snapshot %s: done", snap.id)
    return True
