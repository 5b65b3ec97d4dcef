"""The twin of ``tests/test_chaos.py`` on the port: failpoints, the
retrying transport, leases, idempotent snapshots and the chaos drill
(``sda_tpu_torch/chaos``, clients on the CPU), with the same seeds and
sizes; then ``ci.sh``'s dead-clerk, brownout and churn drills through
the port's ``sda-sim --chaos``, and the drill held to the reference's
report on the same seed.
"""

import json
import os
import time

import pytest

from sda_tpu_torch import chaos
from sda_tpu_torch.chaos import FailpointRegistry, InjectedFault
from sda_tpu.crypto import sodium as ref_sodium
from sda_tpu_torch.http import SdaHttpClient, SdaHttpServer
from sda_tpu_torch.protocol import (
    AgentId,
    AggregationId,
    ClerkingJob,
    ClerkingJobId,
    ClerkingResult,
    ServerError,
    Snapshot,
    SnapshotId,
)
from sda_tpu_torch.server import new_memory_server
from sda_tpu_torch.utils import metrics


from torch_util import mock_encryption, new_agent, new_full_agent


@pytest.fixture(autouse=True)
def _clean_slate():
    chaos.reset()
    metrics.reset_counters()
    yield
    chaos.reset()


# ---------------------------------------------------------------------------
# registry semantics

def test_failpoint_unarmed_is_noop():
    assert chaos.fail("never.configured") is None


def test_failpoint_times_schedule_is_exact():
    chaos.configure("fp.times", error=True, times=2)
    for i in range(5):
        if i < 2:
            with pytest.raises(InjectedFault):
                chaos.fail("fp.times")
        else:
            assert chaos.fail("fp.times") is None
    assert chaos.report()["fp.times"] == {"hits": 5, "triggers": 2}
    assert metrics.counter_report()["chaos.fp.times"] == 2


def test_failpoint_after_and_every():
    chaos.configure("fp.sched", error=True, after=2, every=3)
    outcomes = []
    for _ in range(11):
        try:
            chaos.fail("fp.sched")
            outcomes.append(False)
        except InjectedFault:
            outcomes.append(True)
    # hits 0,1 skipped; then every 3rd starting at hit 2
    assert outcomes == [False, False, True, False, False,
                        True, False, False, True, False, False]


def test_failpoint_rate_is_deterministic_per_seed():
    def schedule(seed):
        registry = FailpointRegistry()
        registry.configure("fp.rate", error=True, rate=0.3, seed=seed)
        out = []
        for _ in range(50):
            try:
                registry.fail("fp.rate")
                out.append(0)
            except InjectedFault:
                out.append(1)
        return out

    assert schedule(7) == schedule(7)  # reproducible
    assert schedule(7) != schedule(8)  # and actually seed-dependent
    assert 0 < sum(schedule(7)) < 50  # neither never nor always


def test_failpoint_custom_exception_and_delay():
    chaos.configure("fp.exc", error=ValueError("boom"))
    with pytest.raises(ValueError, match="boom"):
        chaos.fail("fp.exc")
    chaos.configure("fp.delay", delay=0.05)
    t0 = time.perf_counter()
    assert chaos.fail("fp.delay").kind == "delay"
    assert time.perf_counter() - t0 >= 0.05


def test_evaluate_kinds_filter_does_not_consume():
    """A call site that can only express some kinds ignores other armed
    kinds WITHOUT burning the schedule (counters stay honest)."""
    chaos.configure("fp.kinds", error=True, times=1)
    assert chaos.evaluate("fp.kinds", kinds=("drop",)) is None
    assert chaos.report()["fp.kinds"] == {"hits": 0, "triggers": 0}
    assert "chaos.fp.kinds" not in metrics.counter_report()
    # the single budgeted trigger is still live for a capable site
    assert chaos.evaluate("fp.kinds", kinds=("error",)).kind == "error"


def test_configure_from_spec():
    chaos.configure_from_spec(
        "fp.a=error,times=1;fp.b=drop;fp.c=delay:0.01,rate=0.5", seed=3
    )
    with pytest.raises(InjectedFault):
        chaos.fail("fp.a")
    assert chaos.fail("fp.a") is None
    assert chaos.evaluate("fp.b").kind == "drop"
    with pytest.raises(ValueError):
        chaos.configure_from_spec("fp.bad=explode")


def test_taint_is_a_first_class_kind():
    """`taint` (adversarial share corruption) rides the same
    registry discipline as drop/kill: armable directly and via spec,
    expressible-kinds filtered, exactly-one-kind validated."""
    chaos.configure("fp.taint", taint=True, times=1)
    action = chaos.evaluate("fp.taint", kinds=("taint",))
    assert action is not None and action.kind == "taint"
    assert chaos.evaluate("fp.taint", kinds=("taint",)) is None  # budget
    # a site that cannot express taint ignores it without consuming
    chaos.configure("fp.taint2", taint=True)
    assert chaos.evaluate("fp.taint2", kinds=("error", "drop")) is None
    assert chaos.report()["fp.taint2"] == {"hits": 0, "triggers": 0}
    # spec syntax and the exactly-one-kind rule
    chaos.configure_from_spec("fp.taint3=taint,times=2", seed=1)
    assert chaos.evaluate("fp.taint3", kinds=("taint",)).kind == "taint"
    with pytest.raises(ValueError, match="taint"):
        chaos.configure("fp.both", taint=True, error=True)


# ---------------------------------------------------------------------------
# retrying transport

@pytest.fixture
def srv():
    server = SdaHttpServer(new_memory_server(), bind="127.0.0.1:0")
    server.start_background()
    yield server
    server.shutdown()


def _fast_client(srv, **kw):
    kw.setdefault("max_retries", 6)
    kw.setdefault("backoff_base", 0.005)
    kw.setdefault("backoff_cap", 0.02)
    return SdaHttpClient(srv.address, token="test-token", **kw)


def test_get_retries_through_injected_500s(srv):
    client = _fast_client(srv)
    chaos.configure("http.server.request", error=True, times=2)
    assert client.ping().running  # 2 failures absorbed, then success
    counters = metrics.counter_report()
    assert counters["chaos.http.server.request"] == 2
    assert counters["http.retry.attempt"] == 2
    assert counters["http.retry.status_5xx"] == 2
    assert counters["http.retry.recovered"] == 1
    assert counters["http.status.500"] == 2


def test_get_retries_through_connection_drops(srv):
    client = _fast_client(srv)
    chaos.configure("http.server.request", drop=True, times=2)
    assert client.ping().running
    counters = metrics.counter_report()
    assert counters["chaos.http.server.request"] == 2
    assert counters["http.retry.connection"] == 2
    assert counters["http.retry.recovered"] == 1


def test_retries_exhaust_to_server_error(srv):
    client = _fast_client(srv, max_retries=2)
    chaos.configure("http.server.request", error=True)  # always
    with pytest.raises(ServerError):
        client.ping()
    counters = metrics.counter_report()
    assert counters["http.retry.attempt"] == 2  # 3 tries, 2 retries
    assert counters["http.retry.exhausted"] == 1
    assert counters["chaos.http.server.request"] == 3
    assert "http.retry.recovered" not in counters


def test_per_operation_deadline_caps_retries(srv):
    # generous retry count but a tiny deadline: the clock must win
    client = _fast_client(srv, max_retries=50, backoff_base=0.05,
                          backoff_cap=0.05, deadline=0.12)
    chaos.configure("http.server.request", error=True)
    t0 = time.perf_counter()
    with pytest.raises(ServerError):
        client.ping()
    assert time.perf_counter() - t0 < 2.0
    assert metrics.counter_report()["http.retry.attempt"] < 50


def test_timeout_configurable_constructor_beats_env(srv, monkeypatch):
    assert SdaHttpClient(srv.address).timeout == 60.0  # historical default
    monkeypatch.setenv("SDA_HTTP_TIMEOUT", "7.5")
    assert SdaHttpClient(srv.address).timeout == 7.5
    assert SdaHttpClient(srv.address, timeout=3.0).timeout == 3.0
    monkeypatch.setenv("SDA_HTTP_TIMEOUT", "not-a-number")
    assert SdaHttpClient(srv.address).timeout == 60.0


def test_post_lost_response_retries_without_duplicate_side_effects(srv):
    """The create-once pillar: the server processes a POST but the response
    is dropped; the client retries; exactly ONE participation exists."""
    from sda_tpu_torch.protocol import (
        AdditiveSharing, Aggregation, EncryptionKeyId, NoMasking,
        Participation, ParticipationId, SodiumEncryption,
    )

    client = _fast_client(srv)
    agent, _ = new_full_agent(client)
    agg = Aggregation(
        id=AggregationId.random(), title="retry", vector_dimension=4,
        modulus=433, recipient=agent.id,
        recipient_key=EncryptionKeyId.random(),
        masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(share_count=8, modulus=433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    client.create_aggregation(agent, agg)

    participation = Participation(
        id=ParticipationId.random(), participant=agent.id,
        aggregation=agg.id, recipient_encryption=None,
        clerk_encryptions=[],
    )
    # drop exactly the next response AFTER the server has processed it
    chaos.configure("http.server.response", drop=True, times=1)
    client.create_participation(agent, participation)

    counters = metrics.counter_report()
    assert counters["chaos.http.server.response"] == 1
    assert counters["http.retry.connection"] == 1
    assert counters["http.retry.recovered"] == 1
    status = client.get_aggregation_status(agent, agg.id)
    assert status.number_of_participations == 1  # deduped, not doubled


def test_unclassified_post_route_is_rejected(srv):
    client = _fast_client(srv)
    agent = new_agent()
    with pytest.raises(AssertionError, match="not classified retry-safe"):
        client._post(agent, "/v1/definitely/new/route", {})


# ---------------------------------------------------------------------------
# clerking-job lease / reissue (store level, all backends)

def _job(clerk_id, snapshot_id, n):
    return ClerkingJob(
        id=ClerkingJobId(f"00000000-0000-4000-8000-00000000000{n}"),
        clerk=clerk_id,
        aggregation=AggregationId.random(),
        snapshot=snapshot_id,
        encryptions=[mock_encryption(b"x")],
    )


def _jobs_store(kind, tmp_path):
    if kind == "memory":
        from sda_tpu_torch.server.memory import MemoryClerkingJobsStore

        return MemoryClerkingJobsStore()
    if kind == "sqlite":
        from sda_tpu_torch.server.sqlite import SqliteClerkingJobsStore, SqliteDb

        return SqliteClerkingJobsStore(SqliteDb(tmp_path / "lease.db"))
    if kind == "mongo":
        from fake_mongo import FakeDatabase
        from sda_tpu_torch.server.mongo import MongoClerkingJobsStore

        return MongoClerkingJobsStore(FakeDatabase())
    from sda_tpu_torch.server.jsonfs import JsonClerkingJobsStore

    return JsonClerkingJobsStore(tmp_path / "jobs")


@pytest.mark.parametrize("kind", ["memory", "sqlite", "jsonfs", "mongo"])
def test_lease_hides_held_jobs_and_reissues_expired(kind, tmp_path):
    store = _jobs_store(kind, tmp_path)
    clerk = AgentId.random()
    snap = SnapshotId.random()
    job1, job2 = _job(clerk, snap, 1), _job(clerk, snap, 2)
    store.enqueue_clerking_job(job1)
    store.enqueue_clerking_job(job2)

    # first lease pulls job1; a concurrent worker must get job2, not a dup
    got1, exp1 = store.lease_clerking_job(clerk, 30.0, now=1000.0)
    assert got1.id == job1.id and exp1 == 1030.0
    got2, _ = store.lease_clerking_job(clerk, 30.0, now=1001.0)
    assert got2.id == job2.id
    # both held: nothing visible
    assert store.lease_clerking_job(clerk, 30.0, now=1002.0) is None

    # job1's lease expires without a result: REISSUED to the next poller
    before = metrics.counter_report().get("server.job.reissued", 0)
    got3, exp3 = store.lease_clerking_job(clerk, 30.0, now=1031.0)
    assert got3.id == job1.id and exp3 == 1061.0
    assert metrics.counter_report()["server.job.reissued"] == before + 1

    # a completed job never comes back, even after its lease expires
    store.create_clerking_result(
        ClerkingResult(job=job1.id, clerk=clerk, encryption=mock_encryption(b"s"))
    )
    got4, _ = store.lease_clerking_job(clerk, 30.0, now=5000.0)
    assert got4.id == job2.id
    assert store.lease_clerking_job(clerk, 30.0, now=5000.5) is None


@pytest.mark.parametrize("kind", ["memory", "sqlite", "jsonfs", "mongo"])
def test_enqueue_does_not_resurrect_completed_job(kind, tmp_path):
    """Snapshot retries re-enqueue deterministically-id'd jobs; a job whose
    result already landed must stay done."""
    store = _jobs_store(kind, tmp_path)
    clerk = AgentId.random()
    job = _job(clerk, SnapshotId.random(), 3)
    store.enqueue_clerking_job(job)
    store.create_clerking_result(
        ClerkingResult(job=job.id, clerk=clerk, encryption=mock_encryption(b"s"))
    )
    assert store.poll_clerking_job(clerk) is None
    store.enqueue_clerking_job(job)  # the retry
    assert store.poll_clerking_job(clerk) is None
    assert store.lease_clerking_job(clerk, 30.0) is None
    assert store.list_results(job.snapshot) == [job.id]


def test_service_poll_uses_lease_when_enabled():
    service = new_memory_server()
    service.server.clerking_lease_seconds = 30.0
    clerk_agent, _ = new_full_agent(service)
    job = _job(clerk_agent.id, SnapshotId.random(), 4)
    service.server.clerking_job_store.enqueue_clerking_job(job)

    first = service.get_clerking_job(clerk_agent, clerk_agent.id)
    assert first is not None and first.id == job.id
    # held lease: the job is invisible to this clerk's next worker
    assert service.get_clerking_job(clerk_agent, clerk_agent.id) is None
    counters = metrics.counter_report()
    assert counters["server.job.leased"] == 1
    assert counters["server.job.polled"] == 1


def test_snapshot_creation_is_idempotent():
    """A retried snapshot POST (same snapshot id) must not duplicate
    clerking jobs — deterministic job ids + the create-once existence
    check (what makes the snapshot route retry-safe)."""
    from sda_tpu_torch.protocol import (
        AdditiveSharing, Aggregation, Committee, NoMasking,
        Participation, ParticipationId, SodiumEncryption,
    )

    service = new_memory_server()
    recipient, rkey = new_full_agent(service)
    clerk_agents = [new_full_agent(service) for _ in range(2)]
    agg = Aggregation(
        id=AggregationId.random(), title="idem", vector_dimension=2,
        modulus=433, recipient=recipient.id, recipient_key=rkey.body.id,
        masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(share_count=2, modulus=433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    service.create_aggregation(recipient, agg)
    service.create_committee(recipient, Committee(
        aggregation=agg.id,
        clerks_and_keys=[(a.id, k.body.id) for a, k in clerk_agents],
    ))
    service.create_participation(recipient, Participation(
        id=ParticipationId.random(), participant=recipient.id,
        aggregation=agg.id, recipient_encryption=None,
        clerk_encryptions=[(a.id, mock_encryption(b"c")) for a, _ in clerk_agents],
    ))

    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    service.create_snapshot(recipient, snap)
    jobs_first = {
        str(service.get_clerking_job(a, a.id).id) for a, _ in clerk_agents
    }
    service.create_snapshot(recipient, snap)  # the retry
    jobs_second = {
        str(service.get_clerking_job(a, a.id).id) for a, _ in clerk_agents
    }
    assert jobs_first == jobs_second
    counters = metrics.counter_report()
    assert counters["server.snapshot.created"] == 1
    assert counters["server.snapshot.duplicate"] == 1
    # per-clerk queue depth is still exactly one job
    for a, _ in clerk_agents:
        store = service.server.clerking_job_store
        assert len(store._queues[a.id]) == 1

    # crash-replay flavor: the snapshot RECORD is lost (it commits last)
    # but the frozen set survives; a late participation arrives (from a
    # FRESH device — exactly-once ingestion forbids a second bundle from
    # the same agent); the replay must re-use the ORIGINAL frozen set,
    # not re-freeze with the newcomer (mixing share generations across
    # clerk columns)
    agg_store = service.server.aggregation_store
    del agg_store._snapshots[agg.id][snap.id]  # simulate the crash point
    late_agent, _ = new_full_agent(service)
    service.create_participation(late_agent, Participation(
        id=ParticipationId.random(), participant=late_agent.id,
        aggregation=agg.id, recipient_encryption=None,
        clerk_encryptions=[(a.id, mock_encryption(b"late")) for a, _ in clerk_agents],
    ))
    service.create_snapshot(recipient, snap)  # the replay
    assert agg_store.count_participations_snapshot(agg.id, snap.id) == 1


@pytest.mark.parametrize("kind", ["memory", "sqlite", "jsonfs", "mongo"])
def test_frozen_empty_set_reads_as_frozen(kind, tmp_path):
    """has_snapshot_freeze must distinguish frozen-EMPTY from unfrozen —
    otherwise a crash-replay after an empty freeze would re-freeze a
    late participation into the set."""
    if kind == "memory":
        from sda_tpu_torch.server.memory import MemoryAggregationsStore

        store = MemoryAggregationsStore()
    elif kind == "sqlite":
        from sda_tpu_torch.server.sqlite import SqliteAggregationsStore, SqliteDb

        store = SqliteAggregationsStore(SqliteDb(tmp_path / "f.db"))
    elif kind == "mongo":
        from fake_mongo import FakeDatabase
        from sda_tpu_torch.server.mongo import MongoAggregationsStore

        store = MongoAggregationsStore(FakeDatabase())
    else:
        from sda_tpu_torch.server.jsonfs import JsonAggregationsStore

        store = JsonAggregationsStore(tmp_path / "agg")
    agg, snap = AggregationId.random(), SnapshotId.random()
    assert not store.has_snapshot_freeze(agg, snap)
    store.snapshot_participations(agg, snap)  # zero participations exist
    assert store.has_snapshot_freeze(agg, snap)
    assert store.count_participations_snapshot(agg, snap) == 0


# ---------------------------------------------------------------------------
# shutdown leak detection (satellite)

def test_shutdown_leak_detection(monkeypatch):
    server = SdaHttpServer(new_memory_server(), bind="127.0.0.1:0")
    server.start_background()
    # make the worker thread look wedged: join "times out", thread "alive"
    monkeypatch.setattr(server._thread, "join", lambda timeout=None: None)
    monkeypatch.setattr(server._thread, "is_alive", lambda: True)
    server.shutdown()
    assert metrics.counter_report()["http.shutdown.leaked"] == 1


# ---------------------------------------------------------------------------
# end-to-end: the acceptance round

@pytest.mark.chaos
def test_chaos_round_completes_bit_exactly():
    """Full aggregation round over HTTP with >=10% injected request
    failures and one clerk abandoning a pulled job: lease reissue +
    retrying transport must still land the bit-exact sum."""
    from sda_tpu_torch.chaos.drill import run_chaos_drill

    seed = int(os.environ.get("SDA_CHAOS_SEED", "20260803"))
    report = run_chaos_drill(participants=5, dim=4, rate=0.2, seed=seed,
                             lease_seconds=0.5, device="cpu")
    assert report["ready"], report
    assert report["exact"], report
    assert report["injected_ratio"] >= 0.10, report
    counters = report["counters"]
    assert counters["chaos.clerk.abandon_job"] == 1
    assert counters["server.job.reissued"] >= 1
    assert counters["chaos.http.server.request"] > 0
    assert counters["http.retry.attempt"] > 0
    assert counters["http.retry.recovered"] > 0


@pytest.mark.chaos
def test_chaos_round_schedule_is_reproducible():
    """Same seed -> same injection schedule (trigger counts match across
    runs; hit counts may differ slightly with thread timing)."""
    from sda_tpu_torch.chaos.drill import run_chaos_drill

    a = run_chaos_drill(participants=3, dim=2, rate=0.2, seed=11,
                        lease_seconds=0.4, device="cpu")
    b = run_chaos_drill(participants=3, dim=2, rate=0.2, seed=11,
                        lease_seconds=0.4, device="cpu")
    assert a["exact"] and b["exact"]
    for name in ("clerk.abandon_job", "http.server.response",
                 "store.create_participation"):
        assert a["failpoints"][name]["triggers"] == b["failpoints"][name]["triggers"]


# ---------------------------------------------------------------------------
# the port's drill against the reference, and ci.sh's drills

needs_ref_sodium = pytest.mark.skipif(
    not ref_sodium.available(), reason="the reference's libsodium not present")


@needs_ref_sodium
def test_chaos_drill_matches_reference_on_the_same_seed():
    """``run_chaos_drill(participants=3, dim=4, rate=0.0)`` on the CPU: the
    same revealed sum and the same verdicts as the reference's drill."""
    from sda_tpu.chaos.drill import run_chaos_drill as ref_drill
    from sda_tpu_torch.chaos.drill import run_chaos_drill

    ref = ref_drill(participants=3, dim=4, rate=0.0)
    got = run_chaos_drill(participants=3, dim=4, rate=0.0, device="cpu")
    assert got["exact"] is True
    for key in ("exact", "ready", "round_state", "round_reason",
                "round_dead_clerks", "admitted_participations",
                "double_counted", "participants", "dim", "clerks",
                "sharing", "output_sha256", "equivocations_undetected"):
        assert got.get(key) == ref.get(key), key
    assert set(got["latency_ms"]) == set(ref["latency_ms"])


def _sim_chaos(capsys, *flags):
    from sda_tpu_torch.cli import sim

    rc = sim.main(["--chaos", *flags, "--chaos-seed", "20260803",
                   "--chaos-rate", "0.05", "--device", "cpu"])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_ci_dead_clerk_drill_packed_degrades_bit_exact(capsys):
    """``ci.sh``'s dead-clerk drill, packed Shamir: clerking -> degraded
    -> revealed, bit-exact from the surviving 7-of-8 quorum."""
    rc, shamir = _sim_chaos(capsys, "--dead-clerks", "1")
    assert rc == 0
    states = [s for s, _ in shamir["round_history"]]
    assert shamir["exact"] is True, shamir
    assert "degraded" in states and states[-1] == "revealed", states
    assert shamir["round_dead_clerks"], shamir
    assert shamir["time_to_degraded_s"] and shamir["time_to_degraded_s"] > 0


def test_ci_dead_clerk_drill_additive_fails_closed(capsys):
    """``ci.sh``'s dead-clerk drill, additive sharing: a terminal
    ``failed`` with a machine-readable reason, surfaced as a typed
    error, before the drill's deadline."""
    rc, additive = _sim_chaos(capsys, "--dead-clerks", "1",
                              "--chaos-sharing", "additive")
    assert rc == 0
    assert additive["round_state"] == "failed", additive
    assert additive["round_reason"], additive
    assert additive["failure"]["type"] == "RoundFailed", additive
    assert additive["time_to_failed_s"] and additive["time_to_failed_s"] > 0


def test_ci_brownout_drill_breaker_trips_and_recovers(capsys):
    """``ci.sh``'s brownout drill: the store browns out mid-clerking, the
    breaker trips, sheds 503 + Retry-After, closes again, and the round
    reveals bit-exactly."""
    rc, report = _sim_chaos(capsys, "--brownout", "1.0")
    assert rc == 0
    assert report["ready"] and report["exact"], report
    breaker = report["breaker"]
    assert breaker["times_opened"] >= 1, breaker
    assert breaker["state"] == "closed", breaker
    counters = report["counters"]
    assert counters.get("server.store.breaker.shed", 0) >= 1, counters
    assert counters.get("http.status.503", 0) >= 1, counters
    mttr = report["time_to_recover_s"]
    assert mttr and 0 < mttr < 10.0, report


def test_ci_churn_drill_exactly_once(capsys):
    """``ci.sh``'s churn drill over sqlite: departures resume from their
    journals, mid-upload crashes replay byte-identically, the
    equivocation probe is rejected, and nothing is counted twice."""
    rc, report = _sim_chaos(capsys, "--churn", "0.35",
                            "--chaos-store", "sqlite")
    assert rc == 0
    assert report["exact"] is True, report
    assert report["participants_churned"] >= 1, report
    assert report["participants_resumed"] == report["participants_churned"]
    assert report["participations_replayed"] >= 1, report
    assert report["equivocations_undetected"] == 0, report
    assert report["equivocations_detected"] >= 1, report
    assert report["double_counted"] == 0, report
