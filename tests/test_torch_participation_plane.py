"""The recipes of ``tests/test_participation_plane.py`` against the port:
exactly-once participation, the duplicate/equivocation matrix on the
memory, sqlite, jsonfs and fake-mongo stores, the durable participation
journal and its resume, the HTTP seam, and churn rounds, every role an
``SdaClient(..., device="cpu")``.

``create_participation`` is a single-winner conditional insert keyed by
``(aggregation, participant)`` with a canonical content digest alongside:
fresh inserts win, byte-identical replays succeed idempotently, any
same-key-different-content upload raises ``ParticipationConflict`` (HTTP
409, terminal for the retrying transport). The journal persists the
sealed bundle before the first upload and re-uploads it verbatim on
resume. The port's canonical digests and journal files are held byte for
byte to the reference's for the same participation.
"""

import threading

import numpy as np
import pytest

from sda_tpu_torch import chaos
from sda_tpu_torch.client import SdaClient, SdaParticipant
from sda_tpu_torch.client.journal import ParticipationJournal
from sda_tpu_torch.crypto import MemoryKeystore
from sda_tpu_torch.protocol import (
    AdditiveSharing,
    Aggregation,
    AggregationId,
    FullMasking,
    NoMasking,
    NotFound,
    Participation,
    ParticipationConflict,
    ParticipationId,
    Snapshot,
    SnapshotId,
    SodiumEncryption,
)
from sda_tpu_torch.server import (
    SdaServerService,
    new_jsonfs_server,
    new_memory_server,
    new_mongo_server,
    new_sqlite_server,
)
from sda_tpu_torch.http import SdaHttpServer
from sda_tpu_torch.server.core import SdaServer
from sda_tpu_torch.utils import metrics
from sda_tpu.client.journal import ParticipationJournal as RefJournal

from torch_util import (mock_encryption, new_agent, new_full_agent,
                        open_service, to_reference)

BACKENDS = ["memory", "sqlite", "jsonfs", "fakemongo"]


@pytest.fixture(autouse=True)
def _clean_slate():
    chaos.reset()
    metrics.reset_counters()
    yield
    chaos.reset()


def _two_handles(backend, tmp_path):
    """Two INDEPENDENT service handles over one shared backend — the
    sharing shape of two fleet worker processes (test_fleet.py)."""
    if backend == "memory":
        from sda_tpu_torch.server.memory import (
            MemoryAggregationsStore,
            MemoryAgentsStore,
            MemoryAuthTokensStore,
            MemoryClerkingJobsStore,
        )

        stores = dict(
            agents_store=MemoryAgentsStore(),
            auth_tokens_store=MemoryAuthTokensStore(),
            aggregation_store=MemoryAggregationsStore(),
            clerking_job_store=MemoryClerkingJobsStore(),
        )
        return SdaServerService(SdaServer(**stores)), \
            SdaServerService(SdaServer(**stores))
    if backend == "sqlite":
        path = tmp_path / "shared.db"
        return new_sqlite_server(path), new_sqlite_server(path)
    if backend == "jsonfs":
        root = tmp_path / "shared-jfs"
        return new_jsonfs_server(root), new_jsonfs_server(root)
    from fake_mongo import FakeDatabase

    db = FakeDatabase()
    return new_mongo_server(db), new_mongo_server(db)


def _world(service, clerks=2):
    recipient, rkey = new_full_agent(service)
    committee = [new_full_agent(service) for _ in range(clerks)]
    agg = Aggregation(
        id=AggregationId.random(), title="plane", vector_dimension=4,
        modulus=433, recipient=recipient.id,
        recipient_key=rkey.body.id,
        masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(share_count=clerks,
                                                 modulus=433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    service.create_aggregation(recipient, agg)
    return recipient, committee, agg


def _participation(agent, agg, committee, payload=b"x", pid=None):
    return Participation(
        id=pid or ParticipationId.random(), participant=agent.id,
        aggregation=agg.id, recipient_encryption=None,
        clerk_encryptions=[(a.id, mock_encryption(payload))
                           for (a, _) in committee],
    )


# ---------------------------------------------------------------------------
# the duplicate/equivocation matrix, all four backends


@pytest.mark.parametrize("backend", BACKENDS)
def test_fresh_insert_then_byte_identical_replay(backend, tmp_path):
    service = open_service(backend, tmp_path)
    recipient, committee, agg = _world(service)
    agent = new_agent()
    service.create_agent(agent, agent)
    participation = _participation(agent, agg, committee)

    service.create_participation(agent, participation)
    # the lost-ack retry: the SAME bytes again — idempotent success
    service.create_participation(agent, participation)
    service.create_participation(agent, participation)

    status = service.get_aggregation_status(recipient, agg.id)
    assert status.number_of_participations == 1  # deduped, never doubled
    counters = metrics.counter_report()
    assert counters["server.participation.created"] == 1
    assert counters["server.participation.replayed"] == 2
    assert "server.participation.equivocation" not in counters
    # the replay really served the original bytes back into the round
    stored = service.server.aggregation_store
    snap = SnapshotId.random()
    stored.snapshot_participations(agg.id, snap)
    [frozen] = stored.iter_snapped_participations(agg.id, snap)
    assert frozen.canonical_digest() == participation.canonical_digest()


@pytest.mark.parametrize("backend", BACKENDS)
def test_same_id_different_content_is_rejected(backend, tmp_path):
    """The blind-overwrite hole (seed: sqlite ``DO UPDATE``, jsonfs
    ``_write_json``, memory dict assign silently replaced): re-uploading
    an existing participation id with different bytes must conflict."""
    service = open_service(backend, tmp_path)
    recipient, committee, agg = _world(service)
    agent = new_agent()
    service.create_agent(agent, agent)
    original = _participation(agent, agg, committee, payload=b"honest")
    service.create_participation(agent, original)

    forged = _participation(agent, agg, committee, payload=b"forged",
                            pid=original.id)
    with pytest.raises(ParticipationConflict):
        service.create_participation(agent, forged)
    # the original bytes survived untouched
    snap = SnapshotId.random()
    store = service.server.aggregation_store
    store.snapshot_participations(agg.id, snap)
    [frozen] = store.iter_snapped_participations(agg.id, snap)
    assert frozen.canonical_digest() == original.canonical_digest()
    assert metrics.counter_report()[
        "server.participation.equivocation"] == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_same_agent_new_id_is_rejected(backend, tmp_path):
    """The double-count hole: a device that recomputes with fresh
    randomness (new id, new bytes) after a crash must NOT land twice."""
    service = open_service(backend, tmp_path)
    recipient, committee, agg = _world(service)
    agent = new_agent()
    service.create_agent(agent, agent)
    service.create_participation(
        agent, _participation(agent, agg, committee, payload=b"first"))
    with pytest.raises(ParticipationConflict):
        service.create_participation(
            agent, _participation(agent, agg, committee, payload=b"second"))
    status = service.get_aggregation_status(recipient, agg.id)
    assert status.number_of_participations == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_foreign_agent_reusing_an_id_is_rejected(backend, tmp_path):
    """A different agent claiming an EXISTING participation id must not
    replace (or alias) the original owner's bundle."""
    service = open_service(backend, tmp_path)
    recipient, committee, agg = _world(service)
    victim, thief = new_agent(), new_agent()
    service.create_agent(victim, victim)
    service.create_agent(thief, thief)
    original = _participation(victim, agg, committee, payload=b"victim")
    service.create_participation(victim, original)
    with pytest.raises(ParticipationConflict):
        service.create_participation(
            thief, _participation(thief, agg, committee, payload=b"thief",
                                  pid=original.id))


@pytest.mark.parametrize("backend", BACKENDS)
def test_post_freeze_arrival_gets_late_treatment(backend, tmp_path):
    """Exactly-once ingestion must not change the late-arrival contract:
    a post-freeze participation is ACCEPTED (counted aggregation-wide)
    but stays out of the frozen round."""
    service = open_service(backend, tmp_path)
    recipient, committee, agg = _world(service)
    early = new_agent()
    service.create_agent(early, early)
    service.create_participation(
        early, _participation(early, agg, committee))
    store = service.server.aggregation_store
    snap = SnapshotId.random()
    assert store.snapshot_participations(agg.id, snap) is True

    late = new_agent()
    service.create_agent(late, late)
    service.create_participation(late, _participation(late, agg, committee))
    assert store.count_participations_snapshot(agg.id, snap) == 1
    status = service.get_aggregation_status(recipient, agg.id)
    assert status.number_of_participations == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_raced_two_uploaders_same_key_single_winner(backend, tmp_path):
    """Two handles (the two-process sharing shape) racing DIFFERENT
    bundles under one (aggregation, participant) key: exactly one winner
    per backend, the loser typed-rejected, never both stored."""
    a, b = _two_handles(backend, tmp_path)
    recipient, committee, agg = _world(a)
    agent = new_agent()
    a.create_agent(agent, agent)
    uploads = [
        (a, _participation(agent, agg, committee, payload=b"via-a")),
        (b, _participation(agent, agg, committee, payload=b"via-b")),
    ]
    outcomes = [None, None]

    def upload(ix):
        service, participation = uploads[ix]
        try:
            service.create_participation(agent, participation)
            outcomes[ix] = "won"
        except ParticipationConflict:
            outcomes[ix] = "conflict"

    threads = [threading.Thread(target=upload, args=(ix,))
               for ix in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(outcomes) == ["conflict", "won"]
    status = a.get_aggregation_status(recipient, agg.id)
    assert status.number_of_participations == 1
    # the stored bundle is the winner's, intact
    snap = SnapshotId.random()
    store = b.server.aggregation_store
    store.snapshot_participations(agg.id, snap)
    [frozen] = store.iter_snapped_participations(agg.id, snap)
    winner_ix = outcomes.index("won")
    assert frozen.canonical_digest() == \
        uploads[winner_ix][1].canonical_digest()


@pytest.mark.parametrize("backend", BACKENDS)
def test_raced_identical_replay_is_idempotent(backend, tmp_path):
    """Two handles racing the SAME bytes (a resumed device retrying via a
    second server): both succeed, exactly one row exists."""
    a, b = _two_handles(backend, tmp_path)
    recipient, committee, agg = _world(a)
    agent = new_agent()
    a.create_agent(agent, agent)
    participation = _participation(agent, agg, committee)
    errors = []

    def upload(service):
        try:
            service.create_participation(agent, participation)
        except Exception as e:  # pragma: no cover - the failure under test
            errors.append(e)

    threads = [threading.Thread(target=upload, args=(s,)) for s in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    status = a.get_aggregation_status(recipient, agg.id)
    assert status.number_of_participations == 1


def test_conflict_is_semantic_for_the_store_breaker():
    """A rejected equivocation is detection WORKING: it must pass through
    a breaker-wrapped store uncounted (a flood of equivocating devices
    must never trip the breaker open)."""
    from sda_tpu_torch.server.breaker import CircuitBreaker, wrap_server_stores

    service = new_memory_server()
    breaker = wrap_server_stores(service.server,
                                 CircuitBreaker(threshold=2, recovery_s=9.0))
    recipient, committee, agg = _world(service)
    agent = new_agent()
    service.create_agent(agent, agent)
    service.create_participation(
        agent, _participation(agent, agg, committee, payload=b"first"))
    for _ in range(5):  # well past the trip threshold
        with pytest.raises(ParticipationConflict):
            service.create_participation(
                agent, _participation(agent, agg, committee,
                                      payload=b"equiv"))
    assert breaker.report()["state"] == "closed"
    assert breaker.report()["times_opened"] == 0


# ---------------------------------------------------------------------------
# the durable journal


def test_journal_record_load_reap(tmp_path):
    journal = ParticipationJournal(tmp_path / "journal")
    agent = new_agent()
    agg_id = AggregationId.random()
    participation = Participation(
        id=ParticipationId.random(), participant=agent.id,
        aggregation=agg_id, recipient_encryption=None,
        clerk_encryptions=[(new_agent().id, mock_encryption(b"j"))],
    )
    assert journal.load(agent.id, agg_id) is None
    journal.record(participation)
    loaded = journal.load(agent.id, agg_id)
    assert loaded.canonical_digest() == participation.canonical_digest()
    # the reference journals the same participation to the same bytes,
    # under the same name, with the same digest
    ref = to_reference(participation)
    assert ref.canonical_digest() == participation.canonical_digest()
    RefJournal(tmp_path / "ref-journal").record(ref)
    [port_file] = (tmp_path / "journal").glob("*.json")
    [ref_file] = (tmp_path / "ref-journal").glob("*.json")
    assert port_file.name == ref_file.name
    assert port_file.read_bytes() == ref_file.read_bytes()
    assert len(journal) == 1
    assert journal.keys() == [(str(agent.id), str(agg_id))]
    # keyed by (agent, aggregation): a re-record REPLACES, never appends
    journal.record(participation)
    assert len(journal) == 1
    # pending() filters by agent
    assert journal.pending(new_agent().id) == []
    [pending] = journal.pending(agent.id)
    assert pending.id == participation.id
    assert journal.reap(agent.id, agg_id) is True
    assert journal.reap(agent.id, agg_id) is False
    assert journal.load(agent.id, agg_id) is None


def test_crash_resume_reuploads_same_bytes(tmp_path):
    """The tentpole flow: seal + journal, crash before the upload, rejoin
    as a fresh client, resume — the server receives the ORIGINAL bytes
    exactly once; a second resume finds nothing pending."""
    service = new_memory_server()
    recipient, agg, clerks = _crypto_world(service)
    journal = ParticipationJournal(tmp_path / "journal")

    keystore = MemoryKeystore()
    device = SdaClient(SdaClient.new_agent(keystore), keystore, service, device="cpu")
    device.upload_agent()
    participation = device.new_participation([1, 2, 3, 4], agg.id)
    journal.record(participation)
    # CRASH: the process dies before upload_participation ever runs

    rejoined = SdaParticipant(device.agent, MemoryKeystore(), service, device="cpu")
    assert rejoined.resume(journal) == 1
    assert len(journal) == 0  # reaped on confirmed upload
    status = service.get_aggregation_status(recipient.agent, agg.id)
    assert status.number_of_participations == 1
    assert rejoined.resume(journal) == 0  # nothing pending: no-op
    counters = metrics.counter_report()
    assert counters["participant.resumed"] == 1
    assert counters["server.participation.created"] == 1

    # the crash-AFTER-upload flavor: journaled, uploaded, ack lost before
    # the reap — resume replays byte-identically, the server dedupes
    keystore2 = MemoryKeystore()
    device2 = SdaClient(SdaClient.new_agent(keystore2), keystore2, service, device="cpu")
    device2.upload_agent()
    p2 = device2.new_participation([5, 6, 7, 8], agg.id)
    journal.record(p2)
    device2.upload_participation(p2)
    # CRASH before the reap; rejoin:
    assert SdaParticipant(device2.agent, MemoryKeystore(),
                          service, device="cpu").resume(journal) == 1
    status = service.get_aggregation_status(recipient.agent, agg.id)
    assert status.number_of_participations == 2
    assert metrics.counter_report()["server.participation.replayed"] == 1


def test_journaled_participate_retry_resumes_not_recomputes(tmp_path):
    """Re-running participate(journal=...) after a crash must re-upload
    the JOURNALED bytes (the only ones that replay idempotently), never
    overwrite the entry with a fresh-randomness bundle that would
    conflict against the already-landed upload."""
    service = new_memory_server()
    recipient, agg, clerks = _crypto_world(service)
    journal = ParticipationJournal(tmp_path / "journal")
    ks = MemoryKeystore()
    device = SdaClient(SdaClient.new_agent(ks), ks, service, device="cpu")
    device.upload_agent()
    # mid-upload crash: server holds the bytes, the journal entry lives
    sealed = device.new_participation([1, 2, 3, 4], agg.id)
    journal.record(sealed)
    device.upload_participation(sealed)
    # the user's natural retry of the SAME command converges to success
    device.participate([1, 2, 3, 4], agg.id, journal=journal)
    assert len(journal) == 0
    status = service.get_aggregation_status(recipient.agent, agg.id)
    assert status.number_of_participations == 1
    counters = metrics.counter_report()
    assert counters["participant.journal.recovered"] == 1
    assert counters["server.participation.replayed"] == 1
    assert "server.participation.equivocation" not in counters


def test_http_resume_reaps_orphaned_entry(srv, tmp_path):
    """Over the WIRE, a journal entry for a deleted aggregation must take
    the orphan path (X-Resource-Not-Found 404 -> NotFound), not be
    miscounted as successfully resumed."""
    client = _fast_client(srv)
    recipient, committee, agg = _world(client)
    agent = new_agent()
    client.create_agent(agent, agent)
    journal = ParticipationJournal(tmp_path / "journal")
    journal.record(_participation(agent, agg, committee))
    client.delete_aggregation(recipient, agg.id)
    resumer = SdaClient(agent, MemoryKeystore(), client, device="cpu")
    assert resumer.resume(journal) == 0
    assert len(journal) == 0  # reaped as orphaned, not "resumed"
    counters = metrics.counter_report()
    assert counters["participant.resume.orphaned"] == 1
    assert "participant.resumed" not in counters


def test_resume_reaps_orphaned_and_conflicted_entries(tmp_path):
    service = new_memory_server()
    recipient, committee, agg = _world(service)
    journal = ParticipationJournal(tmp_path / "journal")
    agent = new_agent()
    service.create_agent(agent, agent)

    # orphaned: the journal names an aggregation that no longer exists
    gone = _participation(agent, agg, committee)
    gone.aggregation = AggregationId.random()
    journal.record(gone)
    # conflicted: the server already holds a DIFFERENT bundle for us
    service.create_participation(
        agent, _participation(agent, agg, committee, payload=b"server"))
    journal.record(_participation(agent, agg, committee, payload=b"local"))

    client = SdaClient(agent, MemoryKeystore(), service, device="cpu")
    assert client.resume(journal) == 0  # neither entry lands...
    assert len(journal) == 0            # ...but both are reaped (moot)
    counters = metrics.counter_report()
    assert counters["participant.resume.orphaned"] == 1
    assert counters["participant.resume.conflict"] == 1


# ---------------------------------------------------------------------------
# the full client flow + HTTP seam


def _crypto_world(service, clerks=3):
    """A real-crypto additive world for SdaClient-driven tests; returns
    the recipient CLIENT (its keystore holds the reveal keys), the
    aggregation, and the clerk clients."""
    def _client():
        ks = MemoryKeystore()
        c = SdaClient(SdaClient.new_agent(ks), ks, service, device="cpu")
        c.upload_agent()
        return c

    recipient = _client()
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    clerk_clients = [_client() for _ in range(clerks)]
    for c in clerk_clients:
        c.upload_encryption_key(c.new_encryption_key())
    agg = Aggregation(
        id=AggregationId.random(), title="journal", vector_dimension=4,
        modulus=433, recipient=recipient.agent.id, recipient_key=rkey,
        masking_scheme=FullMasking(433),
        committee_sharing_scheme=AdditiveSharing(share_count=clerks,
                                                 modulus=433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    recipient.upload_aggregation(agg)
    recipient.begin_aggregation(agg.id)
    return recipient, agg, clerk_clients


@pytest.fixture()
def srv():
    service = new_memory_server()
    server = SdaHttpServer(service, bind="127.0.0.1:0")
    server.start_background()
    yield server
    server.shutdown()


def _fast_client(srv):
    from sda_tpu_torch.http import SdaHttpClient

    return SdaHttpClient(srv.address, token="plane-token",
                         max_retries=6, backoff_base=0.01, backoff_cap=0.05)


@pytest.mark.chaos
def test_http_identical_replay_after_lost_response(srv):
    """A lost ack + transport retry re-sends the SAME bytes: the server
    answers success via the replay path, one participation exists."""
    client = _fast_client(srv)
    recipient, committee, agg = _world(client)
    agent = new_agent()
    client.create_agent(agent, agent)
    participation = _participation(agent, agg, committee)
    chaos.configure("http.server.response", drop=True, times=1)
    client.create_participation(agent, participation)
    status = client.get_aggregation_status(recipient, agg.id)
    assert status.number_of_participations == 1
    counters = metrics.counter_report()
    assert counters["server.participation.replayed"] >= 1
    assert "http.participation.conflict" not in counters


def test_http_equivocation_is_409_terminal(srv):
    """Same agent, new bundle: HTTP 409, typed, counted, NEVER retried —
    and the server-side sum is untouched."""
    client = _fast_client(srv)
    recipient, committee, agg = _world(client)
    agent = new_agent()
    client.create_agent(agent, agent)
    client.create_participation(
        agent, _participation(agent, agg, committee, payload=b"first"))
    metrics.reset_counters()
    with pytest.raises(ParticipationConflict):
        client.create_participation(
            agent, _participation(agent, agg, committee, payload=b"equiv"))
    counters = metrics.counter_report()
    assert counters["http.participation.conflict"] == 1
    assert counters["server.participation.equivocation"] == 1
    # terminal: one attempt, zero transport retries spent on the 409
    assert "http.retry.attempt" not in counters
    status = client.get_aggregation_status(recipient, agg.id)
    assert status.number_of_participations == 1


@pytest.mark.chaos
def test_http_journal_resume_under_lost_response(srv, tmp_path):
    """Crash-resume over the real wire with the lost-ack failpoint armed:
    the journaled bytes land exactly once."""
    proxy = _fast_client(srv)
    recipient_ks = MemoryKeystore()
    recipient = SdaClient(SdaClient.new_agent(recipient_ks), recipient_ks,
                          proxy, device="cpu")
    recipient.upload_agent()
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    clerks = []
    for _ in range(3):
        ks = MemoryKeystore()
        c = SdaClient(SdaClient.new_agent(ks), ks, proxy, device="cpu")
        c.upload_agent()
        c.upload_encryption_key(c.new_encryption_key())
        clerks.append(c)
    agg = Aggregation(
        id=AggregationId.random(), title="wire-journal",
        vector_dimension=4, modulus=433,
        recipient=recipient.agent.id, recipient_key=rkey,
        masking_scheme=FullMasking(433),
        committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    recipient.upload_aggregation(agg)
    recipient.begin_aggregation(agg.id)

    journal = ParticipationJournal(tmp_path / "journal")
    ks = MemoryKeystore()
    device = SdaClient(SdaClient.new_agent(ks), ks, proxy, device="cpu")
    device.upload_agent()
    # the device uploads, the server stores, the ack is DROPPED; the
    # transport retries (byte-identical) and the journal entry survives
    # until the reap — then the device "crashes" before reaping anyway,
    # simulated by recording the entry back
    sealed = device.new_participation([1, 2, 3, 4], agg.id)
    journal.record(sealed)
    chaos.configure("http.server.response", drop=True, times=1)
    device.upload_participation(sealed)
    # rejoin from a cold process: replay is deduped server-side
    rejoined = SdaParticipant(device.agent, MemoryKeystore(), proxy, device="cpu")
    assert rejoined.resume(journal) == 1
    status = proxy.get_aggregation_status(recipient.agent, agg.id)
    assert status.number_of_participations == 1
    counters = metrics.counter_report()
    assert counters["server.participation.replayed"] >= 1

    # and the round still reveals bit-exactly with the resumed bundle in
    recipient.end_aggregation(agg.id)
    for c in clerks + [recipient]:  # the recipient may be elected
        c.run_chores(-1)
    out = recipient.reveal_aggregation(agg.id)
    np.testing.assert_array_equal(out.positive().values, [1, 2, 3, 4])


# ---------------------------------------------------------------------------
# churn schedule + the in-process churn round on every backend


def test_churn_schedule_is_seeded_and_alternates():
    a = chaos.churn_schedule(64, 0.4, seed=9)
    b = chaos.churn_schedule(64, 0.4, seed=9)
    assert a == b  # deterministic for a given (agents, rate, seed)
    assert a != chaos.churn_schedule(64, 0.4, seed=10)
    departures = [p for p in a if p["departs"]]
    assert departures, "40% of 64 must produce departures"
    # phases alternate by departure ordinal, starting mid-upload: every
    # plan with >= 1 departure exercises the lost-ack replay path
    phases = [p["phase"] for p in departures]
    assert phases[0] == "mid-upload"
    assert all(ph == ("mid-upload" if i % 2 == 0 else "pre-upload")
               for i, ph in enumerate(phases))
    assert all(p["rejoins"] for p in departures)
    assert all(p["phase"] is None for p in a if not p["departs"])
    assert chaos.churn_schedule(8, 0.0, seed=1) == [
        {"index": i, "departs": False, "phase": None, "rejoins": False}
        for i in range(8)
    ]
    with pytest.raises(ValueError):
        chaos.churn_schedule(8, 1.5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_churn_round_reveals_bit_exactly(backend, tmp_path):
    """A ≥20%-churn round on EVERY backend (fake mongo included): each
    departure journals, crashes at its scheduled point, rejoins, resumes;
    the reveal is bit-exact with zero double counts."""
    service = open_service(backend, tmp_path)
    recipient, agg, clerk_clients = _crypto_world(service)
    journal = ParticipationJournal(tmp_path / "journal")
    participants, dim, modulus = 10, 4, 433
    plan = chaos.churn_schedule(participants, 0.5, seed=13)
    assert sum(p["departs"] for p in plan) >= 2  # >= 20% churn

    rng = np.random.default_rng(13)
    inputs = rng.integers(0, modulus, size=(participants, dim),
                          dtype=np.int64)
    departed = []
    for i, row in enumerate(inputs):
        ks = MemoryKeystore()
        device = SdaClient(SdaClient.new_agent(ks), ks, service, device="cpu")
        device.upload_agent()
        if plan[i]["departs"]:
            sealed = device.new_participation([int(x) for x in row], agg.id)
            journal.record(sealed)
            if plan[i]["phase"] == "mid-upload":
                device.upload_participation(sealed)
            departed.append(device.agent)
        else:
            device.participate([int(x) for x in row], agg.id,
                               journal=journal)
    assert len(journal) == len(departed)  # confirmed uploads were reaped
    for agent in departed:
        assert SdaParticipant(agent, MemoryKeystore(),
                              service, device="cpu").resume(journal) == 1

    # one equivocation probe: fresh randomness from a churned agent must
    # be rejected and must not perturb the sum
    probe = SdaClient(departed[0], MemoryKeystore(), service, device="cpu")
    with pytest.raises(ParticipationConflict):
        probe.participate([0] * dim, agg.id)

    status = service.get_aggregation_status(recipient.agent, agg.id)
    assert status.number_of_participations == participants  # zero doubles
    counters = metrics.counter_report()
    mid_uploads = sum(p["departs"] and p["phase"] == "mid-upload"
                      for p in plan)
    assert counters["server.participation.replayed"] == mid_uploads
    assert counters["server.participation.equivocation"] == 1
    assert counters["server.participation.created"] == participants

    # ...and the round reveals bit-exactly with every resumed bundle in
    recipient.end_aggregation(agg.id)
    for c in clerk_clients + [recipient]:  # the recipient may be elected
        c.run_chores(-1)
    out = recipient.reveal_aggregation(agg.id)
    np.testing.assert_array_equal(out.positive().values,
                                  inputs.sum(axis=0) % modulus)
