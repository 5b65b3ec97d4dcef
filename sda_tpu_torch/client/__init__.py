"""L2: the SDA client — participant / clerk / recipient workflows.

``SdaClient`` (reference: client/src/lib.rs:39-56) binds an agent identity,
a keystore-backed CryptoModule, and any ``SdaService`` implementation —
in-process server, HTTP proxy, or the simulated-pod seam — and exposes the
role workflows as methods (the reference splits them across the
Participating/Clerking/Receiving/Maintenance traits).

Port of ``sda_tpu/client/__init__.py``: a client takes ``device=None``
(CUDA, raising without it) or ``device="cpu"``, and its crypto module runs
the scheme algebra there, the device-tile clerk fold
(``SDA_CLERK_DEVICE_TILES=1``) included.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from .. import obs
from ..crypto import CryptoModule, Keystore, signature_is_valid
from ..crypto import batch as crypto_batch
from ..crypto import signing
from ..utils import metrics, timed_phase
from ..protocol import (
    Agent,
    AgentId,
    Aggregation,
    AggregationId,
    ClerkingJob,
    ClerkingResult,
    Committee,
    EncryptionKeyId,
    NotFound,
    PackedPaillierEncryption,
    Participation,
    ParticipationConflict,
    ParticipationId,
    Profile,
    RoundExpired,
    RoundFailed,
    SdaService,
    ServerError,
    Snapshot,
    SnapshotId,
)

log = logging.getLogger(__name__)


#: Largest modulus whose residues are exactly representable in int64 —
#: below this the reveal path stays in numpy end-to-end (no Python-int
#: materialization); above it the arbitrary-precision object lane engages.
_INT64_MAX = (1 << 63) - 1


class RecipientOutput:
    """Revealed aggregate (receive.rs:7-21).

    ``participations`` is the number of summands in THIS revealed
    snapshot (SnapshotResult.number_of_participations) — not the
    aggregation-wide count, which can be larger when participations
    arrive after the snapshot froze the set or when rounds are
    pipelined. Fixed-point mean decoding must divide by this.
    """

    __slots__ = ("modulus", "values", "participations")

    def __init__(self, modulus: int, values, participations=None):
        self.modulus = int(modulus)
        if self.modulus <= _INT64_MAX:
            # int64 lane: every residue fits, stay vectorized end-to-end
            self.values = np.asarray(values, dtype=np.int64)
        else:
            # arbitrary-precision lane: object dtype instead of a silent
            # int64 wrap (np.mod stays elementwise-correct on object arrays)
            self.values = np.asarray(
                [int(v) for v in np.asarray(values, dtype=object).ravel()],
                dtype=object,
            )
        self.participations = (None if participations is None
                               else int(participations))

    def positive(self) -> "RecipientOutput":
        """Lift representatives into [0, modulus) (receive.rs:14-21).
        ``np.mod`` serves both lanes: one vectorized pass for int64
        moduli, elementwise bigint arithmetic on the object lane — no
        intermediate Python list either way."""
        return RecipientOutput(self.modulus, np.mod(self.values, self.modulus),
                               self.participations)

    def __repr__(self):
        return (f"RecipientOutput(modulus={self.modulus}, "
                f"values={self.values!r}, "
                f"participations={self.participations})")


#: Above this many elements the reveal-span digest is skipped: hashing a
#: dim-1e8 output would add seconds to the reveal for a forensics nicety.
OUTPUT_DIGEST_MAX_ELEMENTS = 1 << 22


def output_digest(output: "RecipientOutput") -> Optional[str]:
    """Canonical sha256 of a revealed output: positive representatives in
    ``[0, modulus)``, int64 little-endian bytes on the vectorized lane,
    decimal-string join on the bigint lane. The reveal span records this
    and loadgen recomputes it from its oracle, so a spool-only forensics
    pass (``sda-trace explain``) can assert bit-exactness."""
    values = output.positive().values
    if values.size > OUTPUT_DIGEST_MAX_ELEMENTS:
        return None
    if values.dtype == object:
        payload = ",".join(str(int(v)) for v in values.ravel()).encode()
    else:
        payload = np.ascontiguousarray(
            values, dtype="<i8").tobytes()
    return hashlib.sha256(payload).hexdigest()


def _committee_key_variant(aggregation: Aggregation) -> str:
    """The key variant clerks must hold for this aggregation's committee
    encryption scheme."""
    return (
        "PackedPaillier"
        if isinstance(aggregation.committee_encryption_scheme,
                      PackedPaillierEncryption)
        else "Sodium"
    )


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return int(raw)
    except ValueError:
        return default


class SdaClient:
    def __init__(self, agent: Agent, keystore: Keystore, service: SdaService,
                 device=None):
        self.agent = agent
        self.crypto = CryptoModule(keystore, device)
        self.service = service
        # immutable-document cache, keyed by aggregation id: the
        # aggregation resource, its committee, and signature-VERIFIED
        # encryption keys. All three are write-once per aggregation in the
        # protocol (the committee is elected exactly once, keys are
        # content-addressed by id), so a polling clerk must not re-fetch —
        # and re-verify — them on every job. Invalidated on the round
        # boundaries this client drives (upload/begin/end/snapshot);
        # SDA_CLIENT_CACHE=0 disables caching entirely.
        self._doc_cache: dict = {}
        self._doc_cache_lock = threading.Lock()
        # permanent-death latch for the chaos drills: once the
        # clerk.dies / participant.dies failpoint kills this agent, its
        # loop stays dead for the rest of the drill (chaos/drill.py)
        self._dead = False

    # -- immutable-document cache --------------------------------------
    @staticmethod
    def _cache_enabled() -> bool:
        return os.environ.get("SDA_CLIENT_CACHE", "1") != "0"

    def _cache_entry(self, aggregation_id: AggregationId) -> dict:
        # locked: the clerk pipeline touches the cache from pool threads
        # (fetch_committee/fetch_recipient_key) concurrently with the main
        # thread, and eviction must not race entry creation
        with self._doc_cache_lock:
            entry = self._doc_cache.get(aggregation_id)
            if entry is None:
                # bounded: a long-lived clerk serves many aggregations but
                # only the recipient path ever invalidates, so evict the
                # least-recently-created entries past SDA_CLIENT_CACHE_MAX
                # (aggregations are short-lived relative to a polling clerk)
                limit = max(1, _env_int("SDA_CLIENT_CACHE_MAX", 64))
                while len(self._doc_cache) >= limit:
                    self._doc_cache.pop(next(iter(self._doc_cache)))
                entry = self._doc_cache[aggregation_id] = {"keys": {}}
            return entry

    def _invalidate(self, aggregation_id: AggregationId) -> None:
        with self._doc_cache_lock:
            self._doc_cache.pop(aggregation_id, None)

    def _cached_aggregation(self, aggregation_id) -> Optional[Aggregation]:
        if not self._cache_enabled():
            return self.service.get_aggregation(self.agent, aggregation_id)
        entry = self._cache_entry(aggregation_id)
        aggregation = entry.get("aggregation")
        if aggregation is None:
            aggregation = self.service.get_aggregation(self.agent, aggregation_id)
            if aggregation is not None:
                entry["aggregation"] = aggregation
        return aggregation

    def _cached_committee(self, aggregation_id) -> Optional[Committee]:
        if not self._cache_enabled():
            return self.service.get_committee(self.agent, aggregation_id)
        entry = self._cache_entry(aggregation_id)
        committee = entry.get("committee")
        if committee is None:
            committee = self.service.get_committee(self.agent, aggregation_id)
            if committee is not None:
                entry["committee"] = committee
        return committee

    def _cached_verified_key(self, aggregation_id, owner_id: AgentId,
                             key_id: EncryptionKeyId):
        """``_fetch_verified_key`` behind the per-aggregation cache: the
        fetch AND the signature verification happen once per (owner, key)
        pair — keying on the owner too preserves the owner binding the
        signature check enforces (a key id listed under a different agent
        must still fail verification, cached or not)."""
        if not self._cache_enabled():
            return self._fetch_verified_key(owner_id, key_id)
        keys = self._cache_entry(aggregation_id)["keys"]
        key = keys.get((owner_id, key_id))
        if key is None:
            key = self._fetch_verified_key(owner_id, key_id)
            keys[(owner_id, key_id)] = key
        return key

    @classmethod
    def new_agent(cls, keystore: Keystore) -> Agent:
        """Fresh agent with a signature keypair in the keystore
        (profile.rs:10-18). Key generation is host work: no device is
        resolved."""
        return Agent(id=AgentId.random(),
                     verification_key=signing.new_labelled_verification_key(
                         keystore))

    # ------------------------------------------------------------------
    # Maintenance (profile.rs:21-51)

    def upload_agent(self) -> None:
        self.service.create_agent(self.agent, self.agent)

    def new_encryption_key(self, scheme=None) -> EncryptionKeyId:
        """Fresh keypair in the keystore; ``scheme`` picks the key type
        (None/Sodium -> Curve25519, PackedPaillierEncryption -> Paillier)."""
        return self.crypto.new_encryption_key(scheme)

    def upload_encryption_key(self, key: EncryptionKeyId) -> None:
        signed = self.crypto.sign_export(self.agent, key)
        if signed is None:
            raise NotFound("could not sign encryption key")
        self.service.create_encryption_key(self.agent, signed)

    def upsert_profile(self, profile: Profile) -> None:
        """Publish this agent's trust-building profile — the reference's
        'link their profile to some external authenticating system'
        (README.md 'Doing more'; resource: resources.rs:24-35). The service
        enforces owner == caller; this is the client-side convenience the
        reference's Maintenance trait never grew."""
        if profile.owner != self.agent.id:
            raise ValueError("profile.owner must be this client's agent id")
        self.service.upsert_profile(self.agent, profile)

    def get_profile(self, owner: AgentId) -> Optional[Profile]:
        return self.service.get_profile(self.agent, owner)

    # ------------------------------------------------------------------
    # Participating (participate.rs)

    def participate(self, input: Sequence[int], aggregation: AggregationId,
                    *, journal=None) -> None:
        """new_participation + upload in one go (participate.rs:31-35).

        With ``journal`` (a :class:`~sda_tpu_torch.client.journal.\
ParticipationJournal`), the fully sealed bundle is persisted BEFORE the
        first upload attempt and reaped after the confirmed upload — the
        durable half of exactly-once participation: a crash anywhere in
        between leaves the sealed bytes on disk for
        :meth:`resume` to re-upload verbatim (same randomness, same id,
        so the server dedupes instead of double-counting;
        docs/client.md)."""
        # permanent-death failpoint (chaos drills): a participant that
        # dies never contributes — the round's expected sum must exclude
        # it (PAPER.md's sporadic phones, made injectable)
        from .. import chaos

        if self._dead or chaos.evaluate(
                "participant.dies", kinds=("kill",)) is not None:
            self._dead = True
            metrics.count("participant.died")
            return
        with obs.span("participant.participate",
                      attributes={"aggregation": str(aggregation)}):
            if journal is not None:
                pending = journal.load(self.agent.id, aggregation)
                if pending is not None:
                    # a previous attempt crashed between seal and confirm:
                    # re-upload ITS bytes — recomputing would mint fresh
                    # randomness and a new id, the exact double-count (or
                    # conflict) the journal exists to prevent, and would
                    # overwrite the only bytes that can replay idempotently
                    metrics.count("participant.journal.recovered")
                    self.upload_participation(pending)
                    journal.reap(self.agent.id, aggregation)
                    return
            participation = self.new_participation(input, aggregation)
            if journal is not None:
                journal.record(participation)
                metrics.count("participant.journaled")
            self.upload_participation(participation)
            if journal is not None:
                journal.reap(self.agent.id, aggregation)

    def resume(self, journal) -> int:
        """Re-upload every journaled participation of THIS agent — the
        crash-recovery path of :meth:`participate`.

        The journal holds fully sealed bundles, so resume never
        recomputes: the SAME bytes go back out, and the server's
        exactly-once ingestion either inserts them (the crash hit before
        the upload) or recognizes the byte-identical replay (the crash
        ate the ack) — in neither case can the device double-count.
        Entries are reaped on success and on the terminal outcomes where
        re-uploading is moot: ``NotFound`` (the aggregation is gone) and
        ``ParticipationConflict`` (the server already holds a DIFFERENT
        bundle under our key — possible only if something else uploaded
        for this agent; counted, surfaced in logs, not raised, so one
        poisoned entry cannot wedge the resume loop). Transient transport
        errors leave the entry journaled for the next resume.

        Returns how many entries were re-uploaded successfully
        (``participant.resumed``)."""
        resumed = 0
        for participation in journal.pending(self.agent.id):
            with obs.span("participant.resume",
                          attributes={
                              "aggregation": str(participation.aggregation),
                              "participation": str(participation.id)}):
                try:
                    self.upload_participation(participation)
                except NotFound:
                    # the aggregation is gone (deleted / expired server
                    # side): the entry can never land — reap it
                    metrics.count("participant.resume.orphaned")
                    journal.reap(self.agent.id, participation.aggregation)
                    continue
                except ParticipationConflict as e:
                    log.warning(
                        "resume %s: server already holds a different "
                        "bundle for this agent (%s); reaping the journal "
                        "entry", participation.aggregation, e)
                    metrics.count("participant.resume.conflict")
                    journal.reap(self.agent.id, participation.aggregation)
                    continue
            journal.reap(self.agent.id, participation.aggregation)
            metrics.count("participant.resumed")
            resumed += 1
        return resumed

    def new_participation(
        self, input: Sequence[int], aggregation_id: AggregationId
    ) -> Participation:
        """Mask -> share -> encrypt per clerk (participate.rs:37-113).

        Separated from upload so a network failure can be retried without
        recomputation or double participation (participate.rs:16-19).

        ``input`` may be any integer sequence OR an int ndarray — the
        ndarray path is the hot one (a model-scale FL delta arrives as
        the codec's int64 residue vector and is normalized in one
        vectorized pass, no per-element conversion). Float arrays are
        rejected rather than silently truncated: quantization is the
        codec's job (``FixedPointCodec.encode``), and ``np.asarray(x,
        int64)`` on raw floats would floor-toward-zero without the
        clip/round/headroom contract.
        """
        arr = input if isinstance(input, np.ndarray) else np.asarray(input)
        if arr.size and np.issubdtype(arr.dtype, np.floating):
            raise ValueError(
                "participation input must be integers in [0, modulus); "
                "encode float vectors through FixedPointCodec.encode "
                "first (a raw float->int64 cast would truncate)")
        secrets = np.asarray(arr, dtype=np.int64)

        aggregation = self._cached_aggregation(aggregation_id)
        if aggregation is None:
            raise NotFound("could not find aggregation")
        if secrets.shape != (aggregation.vector_dimension,):
            raise ValueError("the input length does not match the aggregation")

        committee = self._cached_committee(aggregation_id)
        if committee is None:
            raise NotFound("could not find committee")

        # mask the secrets
        masker = self.crypto.new_secret_masker(aggregation.masking_scheme)
        with timed_phase("participant.mask"):
            recipient_mask, masked_secrets = masker.mask(secrets)

        recipient_encryption = None
        if len(recipient_mask) > 0:
            # flat rounds: the aggregation's recipient; tree rounds: the
            # ROOT recipient, sealing the mask past the leaf's relay
            # (the single rule lives on the resource — docs/scaling.md)
            mask_owner, mask_key_id = aggregation.mask_seal_target()
            recipient_key = self._cached_verified_key(
                aggregation_id, mask_owner, mask_key_id
            )
            encryptor = self.crypto.new_share_encryptor(
                recipient_key, aggregation.recipient_encryption_scheme
            )
            recipient_encryption = encryptor.encrypt(recipient_mask)

        # share the masked secrets; row i -> clerk i
        generator = self.crypto.new_share_generator(aggregation.committee_sharing_scheme)
        with timed_phase("participant.share"):
            shares_per_clerk = generator.generate(masked_secrets)

        # adversarial-input chaos (kind "taint"): an armed participant
        # lifts every share coordinate OUT of the field by adding the
        # sharing modulus — the combined sum mod m is unchanged (the
        # reveal stays bit-exact; mod_combine canonicalizes), but every
        # clerk that looks sees values >= m, the detectable fingerprint
        # ``clerk.share.out_of_range`` counts. The drill's model of a
        # protocol-compliant-but-malicious device (docs/robustness.md).
        from .. import chaos

        if chaos.registry.active() and chaos.evaluate(
                "participant.taint_shares", kinds=("taint",),
                ctx={"agent": str(self.agent.id)}) is not None:
            scheme = aggregation.committee_sharing_scheme
            field = int(getattr(scheme, "prime_modulus", None)
                        or scheme.modulus)
            shares_per_clerk = [
                np.asarray(s, dtype=np.int64) + field
                for s in shares_per_clerk]
            metrics.count("participant.shares_tainted")

        with timed_phase("participant.encrypt"):
            # one fetch-verify-seal task per clerk, fanned out on the
            # bounded crypto pool (libsodium drops the GIL; HTTP key
            # fetches overlap too). ``parent`` pins worker-thread spans to
            # this round's trace — pool threads have no ambient context.
            ctx = obs.current_context()

            def seal_for_clerk(pair):
                (clerk_id, clerk_key_id), clerk_shares = pair
                with obs.span("participant.seal", parent=ctx,
                              attributes={"clerk": str(clerk_id)}):
                    clerk_key = self._cached_verified_key(
                        aggregation_id, clerk_id, clerk_key_id)
                    encryptor = self.crypto.new_share_encryptor(
                        clerk_key, aggregation.committee_encryption_scheme
                    )
                    return (clerk_id, encryptor.encrypt(clerk_shares))

            clerk_encryptions = crypto_batch.pmap(
                seal_for_clerk,
                list(zip(committee.clerks_and_keys, shares_per_clerk)),
            )

        return Participation(
            id=ParticipationId.random(),
            participant=self.agent.id,
            aggregation=aggregation.id,
            recipient_encryption=recipient_encryption,
            clerk_encryptions=clerk_encryptions,
        )

    def upload_participation(self, participation: Participation) -> None:
        self.service.create_participation(self.agent, participation)

    def _fetch_verified_key(self, owner_id: AgentId, key_id: EncryptionKeyId):
        """Fetch an agent's signed encryption key and verify the signature
        (participate.rs:58-71, 87-97)."""
        signed_key = self.service.get_encryption_key(self.agent, key_id)
        if signed_key is None:
            raise NotFound("unknown encryption key")
        owner = self.service.get_agent(self.agent, owner_id)
        if owner is None:
            raise NotFound("unknown agent")
        if not signature_is_valid(owner, signed_key):
            raise ValueError("signature verification failed for key")
        return signed_key.body.body

    def _first_verified_key(self, owner_id: AgentId, key_ids,
                            want: str) -> Optional[EncryptionKeyId]:
        """First of ``key_ids`` that verifies and matches the ``want``
        variant — the single key-acceptance rule for BOTH automatic
        election and recipient-chosen committees."""
        for key_id in key_ids:
            try:
                key = self._fetch_verified_key(owner_id, key_id)
            except (NotFound, ValueError):
                continue
            if key.variant == want:
                return key_id
        return None

    # ------------------------------------------------------------------
    # Clerking (clerk.rs)

    def clerk_once(self) -> bool:
        """Poll-process-upload one job; False when the queue is dry
        (clerk.rs:25-37)."""
        # permanent-death failpoint: unlike clerk.abandon_job (transient —
        # the job was pulled, the lease reissues it), a dead clerk never
        # polls again, so its jobs are only ever finished by a sibling
        # worker of the same identity — or diagnosed dead by the round
        # sweeper (server/lifecycle.py). Checked BEFORE the poll so a
        # dying clerk cannot take a lease to its grave.
        from .. import chaos

        if self._dead or chaos.evaluate(
                "clerk.dies", kinds=("kill",)) is not None:
            self._dead = True
            return False
        job = self.service.get_clerking_job(self.agent, self.agent.id)
        if job is None:
            return False
        return self._clerk_job(job)

    def _clerk_job(self, job: ClerkingJob) -> bool:
        """Process one pulled job and upload its result (the shared tail
        of :meth:`clerk_once` and :meth:`run_clerk`); False when the
        abandon failpoint ate the job."""
        from .. import chaos

        # parent the processing to the trace that ENQUEUED the job (the
        # round's snapshot), recorded server-side at enqueue time and
        # propagated here via the X-Trace-Context poll header or the
        # in-process link registry. A lease-reissued job carries the same
        # deterministic id, so reissued work re-joins the original trace.
        link = obs.job_link(str(job.id))
        with obs.span(
            "clerk.job", parent=link,
            attributes={"job": str(job.id),
                        "aggregation": str(job.aggregation)},
        ) as job_span:
            # failpoint: the clerk dies AFTER pulling work — the job is
            # pulled (and, with leasing, invisible to its siblings) but no
            # result ever lands; lease expiry is what brings it back
            if chaos.evaluate("clerk.abandon_job", kinds=("drop",)) is not None:
                job_span.set_attribute("abandoned", True)
                return False
            t0 = time.perf_counter()
            result = self.process_clerking_job(job)
            self.service.create_clerking_result(self.agent, result)
            # job wall time (process + result upload): the loadgen capacity
            # report surfaces this histogram as ``clerk_job_ms``
            metrics.observe("clerk.job.seconds", time.perf_counter() - t0)
        return True

    def run_chores(self, max_iterations: int = -1) -> None:
        """Process jobs until dry (negative) or up to a bound (clerk.rs:39-57)."""
        iterations = 0
        while max_iterations < 0 or iterations < max_iterations:
            if not self.clerk_once():
                break
            iterations += 1

    def clerk_poll(self, wait_s: float = 0.0) -> Optional[ClerkingJob]:
        """One job poll, long-poll flavored when the service supports it:
        ``await_clerking_job`` (the HTTP proxy's
        ``GET /v1/clerking-jobs?wait=S``, or the in-process seam's
        wakeup-parked wait) blocks up to ``wait_s`` for work; a seam
        without the method (old peers, third-party services) answers
        immediately and :meth:`run_clerk` supplies the sleep."""
        waiter = getattr(self.service, "await_clerking_job", None)
        if wait_s > 0 and waiter is not None:
            return waiter(self.agent, self.agent.id, wait_s)
        return self.service.get_clerking_job(self.agent, self.agent.id)

    def run_clerk(
        self,
        *,
        wait_s: float = 30.0,
        poll_interval: float = 0.5,
        max_jobs: Optional[int] = None,
        deadline: Optional[float] = None,
        stop=None,
        idle_exit: bool = False,
    ) -> int:
        """The long-running clerk loop (``SdaClerk.run_clerk``): pull and
        process jobs forever, discovering work by LONG-POLL instead of a
        sleep loop — job-pickup latency collapses from the polling
        interval to the server's wakeup hop (docs/http.md).

        Against a long-poll-capable service each empty iteration is one
        parked request of up to ``wait_s``; against an old peer the loop
        degrades to immediate polls spaced ``poll_interval`` apart
        (jittered per agent — no fleet-wide stampede). Transient server
        trouble (a draining worker's 503, a browning-out store) is
        absorbed: the loop backs off honoring the ``Retry-After`` hint
        when the error carries one and keeps going.

        Exits when ``max_jobs`` are processed, the ``deadline`` (seconds)
        passes, ``stop`` (an ``Event``-like with ``is_set``) fires, the
        permanent-death failpoint kills this clerk, or — with
        ``idle_exit`` — the first empty poll after at least one processed
        job. Returns how many jobs were processed."""
        import random as _random

        from .. import chaos

        give_up = (None if deadline is None
                   else time.monotonic() + float(deadline))
        jitter_rng = _random.Random(f"{self.agent.id}:clerk")
        processed = 0
        while True:
            if stop is not None and stop.is_set():
                return processed
            if max_jobs is not None and processed >= max_jobs:
                return processed
            if give_up is not None and time.monotonic() >= give_up:
                return processed
            if self._dead or chaos.evaluate(
                    "clerk.dies", kinds=("kill",)) is not None:
                self._dead = True
                return processed
            budget = (wait_s if give_up is None
                      else min(wait_s, max(0.0, give_up - time.monotonic())))
            retry_after = None
            errored = False
            poll_t0 = time.monotonic()
            try:
                job = self.clerk_poll(wait_s=budget)
            except (ServerError, OSError) as e:
                # a drain 503 or brownout past the transport's retry
                # budget: the fleet is recovering, not gone — back off on
                # the server's schedule and re-poll. OSError covers the
                # transport's raw connection/timeout errors once ITS
                # retry budget exhausts (requests exceptions are
                # IOErrors): a restarting worker must not kill the clerk
                # daemon permanently
                metrics.count("clerk.poll.transient")
                errored = True
                retry_after = getattr(e, "retry_after", None)
                job = None
            if job is not None:
                if self._clerk_job(job):
                    processed += 1
                continue
            # idle_exit fires on an EMPTY poll only — a failed poll says
            # nothing about the queue, so it backs off and retries
            if not errored and idle_exit and processed:
                return processed
            # a long-poll-capable service already slept server-side; an
            # old peer (detected by the transport's first bare 404)
            # returns immediately, so WE must supply the cadence or the
            # loop busy-spins at the server. The elapsed check catches a
            # server that CLAIMS long-poll but didn't actually park (its
            # SDA_LONGPOLL_MAX clamped our wait toward zero): an empty
            # answer that came back in well under the asked-for budget
            # earns a client-side sleep, or every clerk hammers the
            # store in a tight loop
            supports = getattr(self.service, "longpoll_supported", None)
            long_polled = (budget > 0 and getattr(
                self.service, "await_clerking_job", None) is not None
                and (supports is None or supports())
                and not errored
                and (time.monotonic() - poll_t0)
                >= 0.5 * min(budget, poll_interval))
            if not long_polled:
                # old peer (or backoff hint): the classic sleep, jittered
                base_sleep = retry_after if retry_after else poll_interval
                sleep = base_sleep * (0.5 + jitter_rng.random())
                if give_up is not None:
                    sleep = min(sleep, max(0.0, give_up - time.monotonic()))
                if sleep > 0:
                    time.sleep(sleep)

    def process_clerking_job(self, job: ClerkingJob) -> ClerkingResult:
        """Decrypt shares -> modular sum -> re-encrypt to recipient
        (clerk.rs:63-107) — the clerk hot path.

        Pipelined: encryptions are decrypted in ``SDA_CLERK_BATCH``-sized
        bundles on the bounded crypto pool (libsodium releases the GIL)
        and each decrypted bundle feeds ONE stacked ``[B, dim]`` combine
        call; the pool keeps the next bundle's decryption in flight while
        the current bundle is being combined on the device
        (double-buffered — ``crypto.batch.prefetch_map``). Partial sums
        fold modularly, so the result is bit-exact with the scalar path.
        """
        # the committee fetch rides the pool so its round trip overlaps
        # the aggregation fetch (both immutable-doc-cached, independent)
        ctx = obs.current_context()

        def fetch_committee():
            with obs.span("clerk.fetch_committee", parent=ctx):
                return self._cached_committee(job.aggregation)

        committee_handle = crypto_batch.submit(fetch_committee)
        aggregation = self._cached_aggregation(job.aggregation)
        if aggregation is None:
            raise NotFound("unknown aggregation")
        committee = committee_handle.result()
        if committee is None:
            raise NotFound("unknown committee")

        own_key_id = next(
            (key for (cid, key) in committee.clerks_and_keys if cid == self.agent.id),
            None,
        )
        if own_key_id is None:
            raise NotFound("could not find own encryption key in committee")

        decryptor = self.crypto.new_share_decryptor(
            own_key_id, aggregation.committee_encryption_scheme
        )
        combiner = self.crypto.new_share_combiner(aggregation.committee_sharing_scheme)
        # SDA_CLERK_DEVICE_TILES=1: fold decrypted bundles into a
        # DEVICE-resident tiled accumulator on the role's device
        # (mesh/devscale.py) instead of the share combiner — each
        # [B, tile] tile is copied to the device and folded there, while
        # the decrypt pipeline below decrypts the next bundles. Bit-exact
        # with mod_combine; a failure raises, there is no fallback
        dev_combiner = None
        if os.environ.get("SDA_CLERK_DEVICE_TILES") == "1":
            from ..mesh.devscale import DeviceTileCombiner

            dev_combiner = DeviceTileCombiner(combiner.modulus,
                                              device=self.crypto.device)

        # the recipient key is only needed AFTER the last combine: fetch
        # and signature-verify it on the pool while the pipeline decrypts
        def fetch_recipient_key():
            with obs.span("clerk.fetch_recipient_key", parent=ctx):
                return self._cached_verified_key(
                    job.aggregation, aggregation.recipient,
                    aggregation.recipient_key)

        recipient_key_handle = crypto_batch.submit(fetch_recipient_key)

        batch_size = max(1, _env_int("SDA_CLERK_BATCH", 256))
        combined = None
        with obs.span("clerk.pipeline", attributes={
            "participations": len(job.encryptions),
            "batch_size": batch_size,
            "workers": crypto_batch.worker_count(),
        }):
            batches = crypto_batch.prefetch_map(
                decryptor.decrypt, job.encryptions, batch_size)
            while True:
                # clerk.decrypt now measures the WAIT for the bundle (the
                # pool decrypts ahead), clerk.combine the stacked fold —
                # their overlap is visible in the round timeline
                with timed_phase("clerk.decrypt"):
                    share_vectors = next(batches, None)
                if share_vectors is None:
                    break
                # server-side input sanity: shares this clerk is about to
                # fold must be canonical field residues. An out-of-field
                # value cannot corrupt the sum (mod_combine canonicalizes
                # anyway) but it IS a protocol deviation only a clerk can
                # see — the server proper never holds plaintext shares —
                # so it is counted per offending participation, surfaced
                # in /statusz and the drill report, and the vector is
                # canonicalized here so every downstream fold (the
                # device-tile path included) sees residues in [0, m).
                bad = 0
                for ix, v in enumerate(share_vectors):
                    arr = np.asarray(v, dtype=np.int64)
                    if arr.size and (int(arr.min()) < 0
                                     or int(arr.max()) >= combiner.modulus):
                        bad += 1
                        share_vectors[ix] = np.mod(arr, combiner.modulus)
                if bad:
                    metrics.count("clerk.share.out_of_range", bad)
                with timed_phase("clerk.combine"):
                    if dev_combiner is not None:
                        dev_combiner.fold(
                            np.asarray(share_vectors, dtype=np.int64))
                        metrics.count("clerk.device_tiles.bundle")
                    else:
                        partial = combiner.combine(share_vectors)
                        combined = (partial if combined is None
                                    else combiner.combine([combined, partial]))
        if dev_combiner is not None and dev_combiner.folded:
            # fold() blocks on each tile's copy and queues its sum; the
            # fetch here waits for the queued sums, so it is timed in the
            # same phase
            with timed_phase("clerk.combine"):
                combined = dev_combiner.result()
        if combined is None:  # empty job: keep the scalar path's shape
            combined = combiner.combine([])

        recipient_key = recipient_key_handle.result()
        encryptor = self.crypto.new_share_encryptor(
            recipient_key, aggregation.recipient_encryption_scheme
        )
        with timed_phase("clerk.encrypt"):
            result_encryption = encryptor.encrypt(combined)
        return ClerkingResult(
            job=job.id, clerk=job.clerk, encryption=result_encryption
        )

    # ------------------------------------------------------------------
    # Receiving (receive.rs)

    def upload_aggregation(self, aggregation: Aggregation) -> None:
        self._invalidate(aggregation.id)
        self.service.create_aggregation(self.agent, aggregation)

    def begin_aggregation(self, aggregation_id: AggregationId) -> None:
        """Elect a committee from service suggestions (receive.rs:48-62).

        Candidates are filtered to keys of the variant the aggregation's
        committee encryption scheme needs (the reference has a single
        scheme so never faces this; with Paillier in the lattice, electing
        a Sodium-keyed clerk would only fail later at participate time).
        """
        self._invalidate(aggregation_id)
        aggregation = self.service.get_aggregation(self.agent, aggregation_id)
        if aggregation is None:
            raise NotFound(f"unknown aggregation {aggregation_id}")
        candidates = self.service.suggest_committee(self.agent, aggregation_id)
        needed = aggregation.committee_sharing_scheme.output_size
        want = _committee_key_variant(aggregation)
        # filtered CLIENT-side on purpose: committee election is the
        # recipient's judgment call in the reference protocol
        # (receive.rs:48-62), and the recipient should not trust the broker
        # to pre-filter; the extra key fetches are bounded by the
        # suggestion-list size. Signature verification uses the same path
        # participate does, so an unverifiable key can't be elected only to
        # fail every participant later.
        selected = []
        for c in candidates:
            if len(selected) == needed:
                break
            key_id = self._first_verified_key(c.id, c.keys, want)
            if key_id is not None:
                selected.append((c.id, key_id))
        if len(selected) < needed:
            raise NotFound(
                f"only {len(selected)} of {needed} committee candidates "
                f"have a verified {want} encryption key"
            )
        self.service.create_committee(
            self.agent, Committee(aggregation=aggregation_id, clerks_and_keys=selected)
        )

    def begin_aggregation_with(
        self, aggregation_id: AggregationId, clerks: Sequence[AgentId]
    ) -> None:
        """Recipient-CHOSEN committee — the reference's 'allow recipient to
        actually chose the clerks that should get in the committee'
        (README.md 'Doing more', never implemented there).

        ``clerks`` must name exactly ``output_size`` candidates from the
        service's suggestion list, in the committee order the recipient
        wants (order fixes each clerk's share index). Every chosen clerk
        goes through the same key verification election uses — an
        unverifiable or wrong-variant key fails here, not at participate
        time.
        """
        self._invalidate(aggregation_id)
        aggregation = self.service.get_aggregation(self.agent, aggregation_id)
        if aggregation is None:
            raise NotFound(f"unknown aggregation {aggregation_id}")
        needed = aggregation.committee_sharing_scheme.output_size
        if len(clerks) != needed:
            raise ValueError(
                f"chose {len(clerks)} clerks; the sharing scheme needs "
                f"exactly {needed}")
        if len(set(clerks)) != len(clerks):
            raise ValueError("chosen clerks must be distinct")
        candidates = {
            c.id: c
            for c in self.service.suggest_committee(self.agent, aggregation_id)
        }
        want = _committee_key_variant(aggregation)
        selected = []
        for clerk_id in clerks:
            candidate = candidates.get(clerk_id)
            if candidate is None:
                raise NotFound(
                    f"chosen clerk {clerk_id} is not a committee candidate "
                    f"(no registered encryption key)")
            chosen_key = self._first_verified_key(clerk_id, candidate.keys, want)
            if chosen_key is None:
                raise NotFound(
                    f"chosen clerk {clerk_id} has no verified {want} "
                    f"encryption key")
            selected.append((clerk_id, chosen_key))
        self.service.create_committee(
            self.agent, Committee(aggregation=aggregation_id, clerks_and_keys=selected)
        )

    def end_aggregation(self, aggregation_id: AggregationId) -> None:
        """Close the round by creating a snapshot (receive.rs:64-78)."""
        self._invalidate(aggregation_id)
        with obs.span("recipient.snapshot",
                      attributes={"aggregation": str(aggregation_id)}):
            status = self.service.get_aggregation_status(self.agent, aggregation_id)
            if status is None:
                raise NotFound("unknown aggregation")
            if len(status.snapshots) >= 1:
                return
            self.service.create_snapshot(
                self.agent, Snapshot(id=SnapshotId.random(), aggregation=aggregation_id)
            )

    def snapshot_aggregation(self, aggregation_id: AggregationId) -> SnapshotId:
        """Freeze the current participation set as a NEW snapshot even if
        earlier ones exist — round pipelining: several snapshots of one
        aggregation proceed through clerking independently (SURVEY §2.4;
        the reference server supports this, its client never drives it)."""
        self._invalidate(aggregation_id)
        snapshot = Snapshot(id=SnapshotId.random(), aggregation=aggregation_id)
        with obs.span("recipient.snapshot",
                      attributes={"aggregation": str(aggregation_id),
                                  "snapshot": str(snapshot.id)}):
            self.service.create_snapshot(self.agent, snapshot)
        return snapshot.id

    def await_result(
        self,
        aggregation_id: AggregationId,
        *,
        deadline: Optional[float] = None,
        poll_interval: float = 0.1,
        snapshot_id: Optional[SnapshotId] = None,
    ) -> RecipientOutput:
        """Block until the round completes, then reveal and return the
        output — the lifecycle-aware replacement for hand-rolled
        ``result_ready`` polling.

        Polls the server's round state (``GET /v1/aggregations/{id}/round``,
        ``server/lifecycle.py``) alongside the snapshot status. A round
        the supervisor declared terminally ``failed`` raises
        :class:`~sda_tpu_torch.protocol.RoundFailed` and ``expired`` raises
        :class:`~sda_tpu_torch.protocol.RoundExpired`, each carrying the
        server's machine-readable diagnosis (``reason``, ``dead_clerks``,
        ``state``) — a dead clerk under additive sharing fails fast here
        instead of hanging forever. Against a pre-supervisor server (no
        round route) this degrades to plain result-ready polling.

        ``deadline`` bounds the wait in seconds client-side (``None`` =
        wait for a server verdict indefinitely); exceeding it raises
        ``RoundExpired`` too, tagged as the client's deadline.

        Herd hygiene: each iteration sleeps ``poll_interval`` scaled by a
        jitter factor in [0.5, 1.5) drawn from an RNG seeded on (agent,
        aggregation) — thousands of recipients waiting on one round
        decorrelate deterministically instead of stampeding a recovering
        server in lockstep. Transient server trouble during a poll (a
        browning-out store shedding 503s, ``StoreUnavailable`` in
        process) does not abort the wait: the loop backs off — honoring
        the server's ``Retry-After`` hint when the error carries one —
        and keeps polling until the deadline.
        """
        import random as _random

        give_up = (None if deadline is None
                   else time.monotonic() + float(deadline))
        # seeded per-(agent, aggregation): deterministic for drills,
        # distinct across the recipient population
        jitter_rng = _random.Random(f"{self.agent.id}:{aggregation_id}")
        round_status = None
        last_transient = None
        transient_streak = 0
        with obs.span("recipient.await_result",
                      attributes={"aggregation": str(aggregation_id)}):
            while True:
                retry_after = None
                try:
                    round_status = self.service.get_round_status(
                        self.agent, aggregation_id)
                    if round_status is not None and round_status.state in (
                            "failed", "expired"):
                        exc = (RoundExpired if round_status.state == "expired"
                               else RoundFailed)
                        raise exc(
                            f"round {aggregation_id} is {round_status.state}: "
                            f"{round_status.reason or 'no reason recorded'}",
                            state=round_status.state,
                            reason=round_status.reason,
                            dead_clerks=round_status.dead_clerks,
                        )
                    status = self.service.get_aggregation_status(
                        self.agent, aggregation_id)
                    if status is not None:
                        if snapshot_id is not None:
                            snap = next((s for s in status.snapshots
                                         if s.id == snapshot_id), None)
                        else:
                            snap = next((s for s in status.snapshots
                                         if s.result_ready), None)
                        if snap is not None and snap.result_ready:
                            return self.reveal_aggregation(aggregation_id,
                                                           snap.id)
                    transient_streak = 0  # a poll got through
                except ServerError as e:
                    # transient server trouble (injected 500s past the
                    # transport's retry budget, breaker-open 503 sheds):
                    # the round may well be fine — keep waiting, on the
                    # server's schedule when it gave one. With NO client
                    # deadline, a long unbroken failure streak is a dead
                    # server, not a brownout: propagate rather than spin
                    # forever (each streak element already survived the
                    # transport's full retry budget)
                    last_transient = e
                    transient_streak += 1
                    if give_up is None and transient_streak >= 8:
                        raise
                    retry_after = getattr(e, "retry_after", None)
                    metrics.count("recipient.await.transient")
                    log.debug("await_result poll failed transiently "
                              "(%s); backing off", e)
                if give_up is not None and time.monotonic() >= give_up:
                    raise RoundExpired(
                        f"await_result deadline exceeded client-side for "
                        f"{aggregation_id}" + (
                            f" (server round state: {round_status.state})"
                            if round_status is not None else "") + (
                            f" (last transient poll error: {last_transient})"
                            if last_transient is not None
                            and round_status is None else ""),
                        state=(round_status.state
                               if round_status is not None else None),
                        reason="client await_result deadline exceeded",
                    )
                # Retry-After beats the cadence; both get the seeded
                # jitter factor so recovering servers see a spread-out
                # herd, not a synchronized one
                base = retry_after if retry_after else poll_interval
                sleep = base * (0.5 + jitter_rng.random())
                if give_up is not None:
                    sleep = min(sleep, max(0.0, give_up - time.monotonic()))
                time.sleep(sleep)

    def reveal_aggregation(
        self, aggregation_id: AggregationId, snapshot_id: Optional[SnapshotId] = None
    ) -> RecipientOutput:
        """Decrypt clerk results, reconstruct, combine+subtract masks
        (receive.rs:80-157). ``snapshot_id`` selects a specific pipelined
        round; default is the first result-ready snapshot (receive.rs:91-94)."""
        with obs.span("recipient.reveal",
                      attributes={"aggregation": str(aggregation_id)}):
            output = self._reveal_aggregation(aggregation_id, snapshot_id)
            # stamp the canonical output digest on the span: the flight
            # recorder spools it, so a forensics pass can assert the
            # revealed round was bit-exact after every process has exited
            digest = output_digest(output)
            if digest is not None:
                obs.set_attribute("output.sha256", digest)
                obs.set_attribute("output.dim", int(output.values.size))
            return output

    def _reveal_aggregation(
        self, aggregation_id: AggregationId, snapshot_id: Optional[SnapshotId]
    ) -> RecipientOutput:
        aggregation = self._cached_aggregation(aggregation_id)
        if aggregation is None:
            raise NotFound(f"unknown aggregation {aggregation_id}")
        committee = self._cached_committee(aggregation_id)
        if committee is None:
            raise NotFound(f"unknown committee {aggregation_id}")

        status = self.service.get_aggregation_status(self.agent, aggregation_id)
        if status is None:
            raise NotFound("unknown aggregation")
        if snapshot_id is not None:
            snapshot = next(
                (s for s in status.snapshots
                 if s.id == snapshot_id and s.result_ready), None
            )
        else:
            snapshot = next((s for s in status.snapshots if s.result_ready), None)
        if snapshot is None:
            raise NotFound("aggregation not ready")
        result = self.service.get_snapshot_result(self.agent, aggregation_id, snapshot.id)
        if result is None:
            raise NotFound("missing aggregation result")

        decryptor = self.crypto.new_share_decryptor(
            aggregation.recipient_key, aggregation.recipient_encryption_scheme
        )

        # combine masks (expanding seeds for ChaCha); the per-participant
        # sealed-box opens fan out on the crypto pool
        with timed_phase("recipient.combine_masks"):
            if result.recipient_encryptions is None:
                mask = np.zeros(0, dtype=np.int64)
            else:
                decrypted = crypto_batch.pmap(
                    decryptor.decrypt, result.recipient_encryptions)
                mask = self.crypto.new_mask_combiner(aggregation.masking_scheme).combine(decrypted)

        # decrypt clerk results, map clerk id -> committee index
        clerk_positions = {cid: ix for ix, (cid, _) in enumerate(committee.clerks_and_keys)}
        with timed_phase("recipient.decrypt_results"):
            def decrypt_result(clerking_result):
                ix = clerk_positions.get(clerking_result.clerk)
                if ix is None:
                    # an unknown-clerk result (stale data, a buggy or
                    # hostile peer) must not abort the whole reveal from
                    # inside the crypto pool: skip it with a counted
                    # warning and reconstruct from the remaining quorum —
                    # the reconstructor below still enforces the
                    # reconstruction threshold on what survives
                    log.warning(
                        "reveal %s: skipping result from unknown clerk %s "
                        "(not in the committee)",
                        aggregation_id, clerking_result.clerk,
                    )
                    metrics.count("recipient.result.unknown_clerk")
                    return None
                return (ix, decryptor.decrypt(clerking_result.encryption))

            indexed_shares = [
                pair for pair in crypto_batch.pmap(
                    decrypt_result, result.clerk_encryptions)
                if pair is not None
            ]

        reconstructor = self.crypto.new_secret_reconstructor(
            aggregation.committee_sharing_scheme, aggregation.vector_dimension
        )
        with timed_phase("recipient.reconstruct"):
            masked_output = reconstructor.reconstruct(indexed_shares)

        unmasker = self.crypto.new_secret_unmasker(aggregation.masking_scheme)
        with timed_phase("recipient.unmask"):
            output = unmasker.unmask(mask, masked_output)
        return RecipientOutput(modulus=aggregation.modulus, values=output,
                               participations=result.number_of_participations)


#: Role alias for the participant-side workflow: the reference splits the
#: client across Participating/Clerking/Receiving traits; here one class
#: carries all three, and ``SdaParticipant`` names the participating view
#: where only ``participate(..., journal=...)`` / ``resume(journal)``
#: matter — the durable sporadic-device entry points (docs/client.md).
SdaParticipant = SdaClient

#: Role alias for the clerking view: a committee-member process that
#: lives in :meth:`SdaClient.run_clerk` — long-poll job discovery, lease
#: handback on drain, lifecycle-diagnosed death (docs/http.md).
SdaClerk = SdaClient

from .journal import ParticipationJournal  # noqa: E402  (re-export)
from . import relay  # noqa: E402  (the tree-round relay role; docs/scaling.md)
