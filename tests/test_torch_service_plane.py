"""The recipes of ``tests/test_service_plane.py`` against the port's copies
of the service plane (``sda_tpu_torch/service``: the recurring-round
scheduler and retention), the delete cascade and tenant admission, on all
four store backends, and the soak drill (``service/soak.py``) at the
reference's smoke size, its clients on the CPU, held to the reference's
report on the same seed.
"""

import threading
import time

import pytest

from sda_tpu_torch import chaos, obs
from sda_tpu_torch.http.admission import AdmissionControl, TENANT_HEADER
from sda_tpu_torch.protocol import (
    AdditiveSharing,
    Aggregation,
    AggregationId,
    ClerkingResult,
    Committee,
    NoMasking,
    NotFound,
    Participation,
    ParticipationId,
    Snapshot,
    SnapshotId,
    SodiumEncryption,
)
from sda_tpu_torch.server import (
    new_jsonfs_server,
    new_memory_server,
    new_mongo_server,
    new_sqlite_server,
)
from sda_tpu_torch.server import lifecycle
from sda_tpu_torch.service import (
    RetentionPolicy,
    RoundScheduler,
    ScheduleSpec,
    epoch_aggregation_id,
    epoch_snapshot_id,
    schedules_report,
    sweep_retention,
)
from sda_tpu_torch.service.retention import (
    jsonfs_file_counts,
    memory_row_counts,
    sqlite_row_counts,
)
from sda_tpu_torch.utils import metrics


from torch_util import mock_encryption, new_agent, new_full_agent

BACKENDS = ["memory", "sqlite", "jsonfs", "fakemongo"]


@pytest.fixture(autouse=True)
def _clean_registries():
    obs.reset_all()
    chaos.reset()
    yield
    chaos.reset()
    obs.reset_all()


def _two_handles(backend, tmp_path):
    """Two independent service handles over ONE shared backend — the
    fleet-arbitration fixture (same shape as test_round_lifecycle)."""
    if backend == "memory":
        from sda_tpu_torch.server import SdaServerService
        from sda_tpu_torch.server.core import SdaServer
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


def _spec(recipient_id, key_id, committee_ids, name="sched-a",
          period_s=0.001, max_pipelined=2):
    template = Aggregation(
        id=AggregationId.random(), title="svc", vector_dimension=4,
        modulus=433, recipient=recipient_id, recipient_key=key_id,
        masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(3, 433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    ).to_obj()
    return ScheduleSpec(
        name=name, period_s=period_s, template=template,
        committee=[[str(a), str(k)] for a, k in committee_ids],
        max_pipelined=max_pipelined,
    )


def _service_world(service):
    """Recipient + 3-clerk committee policy on a live service handle."""
    recipient, rkey = new_full_agent(service)
    committee = [new_full_agent(service) for _ in range(3)]
    return recipient, rkey, [(a.id, k.body.id) for (a, k) in committee]


def _participate(service, agg_id, data=b"x"):
    agent = new_agent()
    service.create_agent(agent, agent)
    committee = service.get_committee(agent, agg_id)
    service.create_participation(agent, Participation(
        id=ParticipationId.random(), participant=agent.id,
        aggregation=agg_id, recipient_encryption=None,
        clerk_encryptions=[(a, mock_encryption(data))
                           for (a, _) in committee.clerks_and_keys],
    ))
    return agent


def _post_results(service, agg_id):
    committee = service.server.get_committee(agg_id)
    for clerk_id, _key in committee.clerks_and_keys:
        agent = service.server.get_agent(clerk_id)
        job = service.get_clerking_job(agent, clerk_id)
        if job is None:
            continue
        service.create_clerking_result(agent, ClerkingResult(
            job=job.id, clerk=clerk_id, encryption=mock_encryption(b"r")))


# ---------------------------------------------------------------------------
# ScheduleSpec + deterministic ids

def test_epoch_ids_deterministic_and_distinct():
    a0 = epoch_aggregation_id("s1", 0)
    assert a0 == epoch_aggregation_id("s1", 0)
    assert a0 != epoch_aggregation_id("s1", 1)
    assert a0 != epoch_aggregation_id("s2", 0)
    assert epoch_snapshot_id("s1", 0) == epoch_snapshot_id("s1", 0)
    assert str(epoch_snapshot_id("s1", 0)) != str(a0)


def test_schedule_spec_roundtrip_and_validation():
    service = new_memory_server()
    recipient, rkey, committee = _service_world(service)
    spec = _spec(recipient.id, rkey.body.id, committee)
    again = ScheduleSpec.from_obj(spec.to_obj())
    assert again.to_obj() == spec.to_obj()
    assert again.tenant == str(recipient.id)
    agg = again.aggregation_for_epoch(3)
    assert agg.id == epoch_aggregation_id(spec.name, 3)
    assert agg.title == f"{spec.name} epoch 3"
    with pytest.raises(ValueError):
        _spec(recipient.id, rkey.body.id, committee, name="bad name!")
    with pytest.raises(ValueError):
        _spec(recipient.id, rkey.body.id, committee, period_s=0)
    with pytest.raises(ValueError):
        ScheduleSpec(name="x", period_s=1.0, template=spec.template,
                     committee=[])


# ---------------------------------------------------------------------------
# scheduler: install, mint, close, pipeline gating

def test_first_tick_installs_epoch_zero():
    service = new_memory_server()
    recipient, rkey, committee = _service_world(service)
    spec = _spec(recipient.id, rkey.body.id, committee)
    scheduler = RoundScheduler(service.server, [spec])
    tick = scheduler.tick_once()
    kinds = [a["action"] for a in tick["actions"]]
    assert "installed" in kinds and "aggregation" in kinds
    agg0 = epoch_aggregation_id(spec.name, 0)
    assert service.server.get_aggregation(agg0) is not None
    assert service.server.get_committee(agg0) is not None
    assert service.server.get_round_status(agg0).state == "collecting"
    report = schedules_report(service.server)
    assert report["count"] == 1
    assert report["schedules"][0]["epoch"] == 0
    assert report["schedules"][0]["tenant"] == str(recipient.id)


def test_mint_closes_previous_epoch_and_pipelines():
    service = new_memory_server()
    recipient, rkey, committee = _service_world(service)
    spec = _spec(recipient.id, rkey.body.id, committee)
    scheduler = RoundScheduler(service.server, [spec])
    scheduler.tick_once()
    agg0 = epoch_aggregation_id(spec.name, 0)
    _participate(service, agg0)
    # past the period: the next tick mints epoch 1 AND closes epoch 0
    tick = scheduler.tick_once(now=time.time() + 10)
    kinds = [a["action"] for a in tick["actions"]]
    assert "minted" in kinds and "closed" in kinds
    agg1 = epoch_aggregation_id(spec.name, 1)
    # epoch 1 collects while epoch 0 clerks — pipelined by construction,
    # and the history stamps prove the order
    status0 = service.server.get_round_status(agg0)
    status1 = service.server.get_round_status(agg1)
    assert status0.state == "clerking"
    assert status0.snapshot == epoch_snapshot_id(spec.name, 0)
    assert status1.state == "collecting"
    stamps0 = dict(status0.history)
    stamps1 = dict(status1.history)
    assert stamps1["collecting"] <= stamps0["clerking"]
    # the frozen epoch-0 set has exactly its own participation
    assert service.server.aggregation_store.count_participations_snapshot(
        agg0, status0.snapshot) == 1


def test_max_pipelined_gates_minting():
    service = new_memory_server()
    recipient, rkey, committee = _service_world(service)
    spec = _spec(recipient.id, rkey.body.id, committee, max_pipelined=1)
    scheduler = RoundScheduler(service.server, [spec])
    scheduler.tick_once()
    before = metrics.counter_report().get(
        "service.schedule.pipeline_full", 0)
    tick = scheduler.tick_once(now=time.time() + 10)
    # epoch 0 is still live (collecting): with max_pipelined=1 nothing
    # may be minted — strictly sequential rounds
    assert "minted" not in [a["action"] for a in tick["actions"]]
    assert metrics.counter_report()["service.schedule.pipeline_full"] \
        == before + 1
    assert service.server.aggregation_store.get_schedule_state(
        spec.name)["epoch"] == 0


def test_crash_between_cas_and_mint_is_repaired_by_reconcile():
    service = new_memory_server()
    recipient, rkey, committee = _service_world(service)
    spec = _spec(recipient.id, rkey.body.id, committee)
    scheduler = RoundScheduler(service.server, [spec])
    scheduler.tick_once()
    # simulate the crash window: the CAS advanced but the winner died
    # before minting anything for epoch 1
    store = service.server.aggregation_store
    doc = store.get_schedule_state(spec.name)
    advanced = dict(doc, epoch=1, next_epoch_at=time.time() + 3600)
    assert store.transition_schedule_state(spec.name, 0, advanced)
    agg1 = epoch_aggregation_id(spec.name, 1)
    assert store.get_aggregation(agg1) is None
    # any peer's next tick reconciles: epoch 1 materializes, epoch 0 is
    # closed — without advancing the epoch again
    tick = scheduler.tick_once()
    kinds = [a["action"] for a in tick["actions"]]
    assert "aggregation" in kinds and "closed" in kinds
    assert "minted" not in kinds
    assert store.get_aggregation(agg1) is not None
    assert store.get_schedule_state(spec.name)["epoch"] == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_raced_mint_single_winner_identical_ids(backend, tmp_path):
    a, b = _two_handles(backend, tmp_path)
    recipient, rkey, committee = _service_world(a)
    # a long period: the install ticks must not themselves come due
    # before the RACED advance below (slow backends take real ms)
    spec = _spec(recipient.id, rkey.body.id, committee, period_s=3600.0)
    schedulers = [RoundScheduler(a.server, [spec]),
                  RoundScheduler(b.server, [spec])]
    # both handles install epoch 0 (single-winner create)
    for scheduler in schedulers:
        scheduler.tick_once()
    assert a.server.aggregation_store.get_schedule_state(
        spec.name)["epoch"] == 0
    # raced advance: exactly ONE handle mints epoch 1
    now = time.time() + 7200
    results = [None, None]

    def tick(ix):
        results[ix] = schedulers[ix].tick_once(now=now)

    threads = [threading.Thread(target=tick, args=(ix,)) for ix in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    minted = [action for r in results for action in r["actions"]
              if action["action"] == "minted"]
    assert len(minted) == 1, minted
    assert minted[0]["epoch"] == 1
    # both handles converge on the SAME deterministic aggregation id
    agg1 = epoch_aggregation_id(spec.name, 1)
    for handle in (a, b):
        assert handle.server.aggregation_store.get_schedule_state(
            spec.name)["epoch"] == 1
        assert handle.server.get_aggregation(agg1) is not None
        assert handle.server.get_aggregation(agg1).id == agg1
        status0 = handle.server.get_round_status(
            epoch_aggregation_id(spec.name, 0))
        assert status0.state == "clerking"


@pytest.mark.parametrize("backend", BACKENDS)
def test_schedule_install_cannot_reset_advanced_schedule(backend, tmp_path):
    a, b = _two_handles(backend, tmp_path)
    store_a = a.server.aggregation_store
    doc = {"schedule": "s", "tenant": "t", "epoch": 0,
           "next_epoch_at": 0.0, "updated_at": 0.0}
    assert store_a.create_schedule_state(doc) is True
    assert store_a.transition_schedule_state(
        "s", 0, dict(doc, epoch=5)) is True
    # a late booting scheduler's install loses: the advance survives
    assert b.server.aggregation_store.create_schedule_state(doc) is False
    assert b.server.aggregation_store.get_schedule_state("s")["epoch"] == 5
    # and a stale CAS (wrong FROM epoch) loses too
    assert b.server.aggregation_store.transition_schedule_state(
        "s", 0, dict(doc, epoch=1)) is False
    assert store_a.get_schedule_state("s")["epoch"] == 5


# ---------------------------------------------------------------------------
# delete_aggregation cascade: leak-count per backend

def _row_counts(backend, service, tmp_path):
    if backend == "memory":
        return memory_row_counts(service.server)
    if backend == "sqlite":
        return sqlite_row_counts(tmp_path / "shared.db")
    if backend == "jsonfs":
        return jsonfs_file_counts(tmp_path / "shared-jfs")
    db = service.server.aggregation_store.db
    return {name: len(collection._docs)
            for name, collection in db._collections.items()}


def _full_round(service, spec_name="cascade"):
    """One complete mock round: aggregation, committee, participations,
    snapshot (jobs + freeze), results, round doc."""
    recipient, rkey, committee = _service_world(service)
    agg = Aggregation(
        id=AggregationId.random(), title=spec_name, vector_dimension=4,
        modulus=433, recipient=recipient.id, recipient_key=rkey.body.id,
        masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(3, 433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    service.create_aggregation(recipient, agg)
    service.create_committee(recipient, Committee(
        aggregation=agg.id, clerks_and_keys=committee))
    for i in range(3):
        _participate(service, agg.id, data=bytes([i]))
    snapshot = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    service.create_snapshot(recipient, snapshot)
    _post_results(service, agg.id)
    return recipient, agg, snapshot


@pytest.mark.parametrize("backend", BACKENDS)
def test_delete_aggregation_cascades_every_artifact(backend, tmp_path):
    a, _b = _two_handles(backend, tmp_path)
    # baseline BEFORE the round exists (agents/keys/tokens persist across
    # rounds by design — they are not round artifacts)
    recipient, agg, snapshot = _full_round(a)
    baseline = _row_counts(backend, a, tmp_path)
    # a second, unrelated round that must SURVIVE the delete untouched
    _other_recipient, other_agg, other_snapshot = _full_round(a, "other")
    a.delete_aggregation(recipient, agg.id)
    after = _row_counts(backend, a, tmp_path)
    store = a.server.aggregation_store
    jobs = a.server.clerking_job_store
    assert store.get_aggregation(agg.id) is None
    assert store.get_committee(agg.id) is None
    assert store.get_round_state(agg.id) is None
    assert store.list_snapshots(agg.id) == []
    assert store.count_participations(agg.id) == 0
    assert store.get_snapshot_mask(snapshot.id) in (None, [])
    assert jobs.list_snapshot_jobs(snapshot.id) == []
    assert jobs.list_results(snapshot.id) == []
    # the unrelated round is intact
    assert store.get_aggregation(other_agg.id) is not None
    assert len(jobs.list_results(other_snapshot.id)) == 3
    # leak count: both stores held exactly one full round's artifacts at
    # baseline and after the delete (round 1 then, round 2 now), so the
    # per-table totals must MATCH — any surplus is a leak. Agent/key/
    # token registrations are not round artifacts and survive deletes.
    agent_tables = {"agents", "auth_tokens", "enc_keys", "profiles",
                    "keys", "auths", "."}
    for table in set(baseline) | set(after):
        if any(key in str(table) for key in agent_tables):
            continue
        assert after.get(table, 0) == baseline.get(table, 0), (
            f"{table}: {baseline.get(table, 0)} -> {after.get(table, 0)} "
            f"(leak after delete_aggregation)")


@pytest.mark.parametrize("backend", BACKENDS)
def test_purge_snapshot_jobs_store_level(backend, tmp_path):
    a, b = _two_handles(backend, tmp_path)
    _recipient, agg, snapshot = _full_round(a)
    jobs = a.server.clerking_job_store
    assert len(jobs.list_snapshot_jobs(snapshot.id)) == 3
    removed = jobs.purge_snapshot_jobs(snapshot.id)
    assert removed >= 3
    assert jobs.list_snapshot_jobs(snapshot.id) == []
    assert jobs.list_results(snapshot.id) == []
    # idempotent, and visible through the peer handle
    assert jobs.purge_snapshot_jobs(snapshot.id) == 0
    assert b.server.clerking_job_store.list_results(snapshot.id) == []


# ---------------------------------------------------------------------------
# retention: TTL expiry + cascade purge, raced sweeps, no resurrection

def _revealed_round(service):
    recipient, agg, snapshot = _full_round(service)
    # the recipient-grade fetch flips the round to revealed
    result = service.get_snapshot_result(recipient, agg.id, snapshot.id)
    assert result is not None
    assert service.server.get_round_status(agg.id).state == "revealed"
    return recipient, agg, snapshot


def test_retention_expires_and_purges_revealed_round():
    service = new_memory_server()
    service.server.retention_policy = RetentionPolicy(revealed_ttl_s=60.0)
    _recipient, agg, snapshot = _revealed_round(service)
    # inside the TTL: nothing happens
    assert sweep_retention(service.server) == []
    assert service.server.get_round_status(agg.id).state == "revealed"
    # past the TTL: expire (CAS) + cascade purge
    actions = sweep_retention(service.server, now=time.time() + 61)
    assert [a["to"] for a in actions] == ["expired", "purged"]
    assert service.server.get_round_status(agg.id) is None
    assert service.server.get_aggregation(agg.id) is None
    assert service.server.clerking_job_store.list_results(snapshot.id) == []
    counters = metrics.counter_report()
    assert counters.get("server.round.retention_expired") == 1
    assert counters.get("server.round.purged") == 1


def test_retention_rides_the_sweeper():
    service = new_memory_server()
    service.server.retention_policy = RetentionPolicy(revealed_ttl_s=0.0)
    _recipient, agg, _snapshot = _revealed_round(service)
    sweeper = lifecycle.RoundSweeper(service.server)
    swept = sweeper.sweep_once()
    assert any(a.get("to") == "purged" for a in swept["actions"])
    assert service.server.get_round_status(agg.id) is None


def test_retention_failed_ttl_covers_failed_and_expired():
    service = new_memory_server()
    service.server.retention_policy = RetentionPolicy(failed_ttl_s=0.0)
    recipient, rkey, committee = _service_world(service)
    spec = _spec(recipient.id, rkey.body.id, committee)
    agg = spec.aggregation_for_epoch(0)
    service.server.create_aggregation(agg)
    assert lifecycle.transition(
        service.server.aggregation_store, agg.id, ("collecting",),
        "failed", reason="test")
    actions = sweep_retention(service.server, now=time.time() + 1)
    assert [a["to"] for a in actions] == ["expired", "purged"]
    assert service.server.aggregation_store.get_round_state(agg.id) is None
    # revealed rounds are NOT covered by failed_ttl_s
    _recipient2, agg2, _snap2 = _revealed_round(service)
    assert sweep_retention(service.server, now=time.time() + 1) == []
    assert service.server.get_round_status(agg2.id).state == "revealed"


def test_retention_never_purges_a_schedules_current_epoch():
    """Purging the CURRENT epoch would make the scheduler's reconcile
    re-mint its deterministic id as an empty zombie round (and a later
    close would fabricate an empty result under the original epoch id):
    retention must defer until the schedule advances past the epoch."""
    service = new_memory_server()
    service.server.retention_policy = RetentionPolicy(revealed_ttl_s=0.0)
    recipient, rkey, committee = _service_world(service)
    spec = _spec(recipient.id, rkey.body.id, committee, period_s=3600.0)
    scheduler = RoundScheduler(service.server, [spec])
    scheduler.tick_once()
    agg0 = epoch_aggregation_id(spec.name, 0)
    # drive epoch 0 terminal (revealed) while it is still the CURRENT
    # epoch — the long period means no advance has happened
    _participate(service, agg0)
    service.create_snapshot(recipient, Snapshot(
        id=epoch_snapshot_id(spec.name, 0), aggregation=agg0))
    _post_results(service, agg0)
    assert service.get_snapshot_result(
        recipient, agg0, epoch_snapshot_id(spec.name, 0)) is not None
    assert service.server.get_round_status(agg0).state == "revealed"
    # retention DEFERS: the round is terminal and past its 0s TTL, but
    # it is the schedule's current epoch
    assert sweep_retention(service.server, now=time.time() + 9999) == []
    assert service.server.get_aggregation(agg0) is not None
    assert metrics.counter_report()["server.round.retention_deferred"] >= 1
    # reconcile does NOT re-mint anything (the aggregation still exists)
    tick = scheduler.tick_once()
    assert "aggregation" not in [a["action"] for a in tick["actions"]]
    # once the schedule advances, epoch 0 becomes purgeable
    tick = scheduler.tick_once(now=time.time() + 7200)
    assert "minted" in [a["action"] for a in tick["actions"]]
    actions = sweep_retention(service.server, now=time.time() + 9999)
    assert [a["to"] for a in actions if a["aggregation"] == str(agg0)] \
        == ["expired", "purged"]
    assert service.server.get_aggregation(agg0) is None
    # and the scheduler never resurrects the purged past epoch
    tick = scheduler.tick_once()
    assert str(agg0) not in [a.get("aggregation") for a in tick["actions"]]
    assert service.server.get_aggregation(agg0) is None


@pytest.mark.parametrize("backend", BACKENDS)
def test_raced_retention_single_expiry_winner(backend, tmp_path):
    a, b = _two_handles(backend, tmp_path)
    for handle in (a, b):
        handle.server.retention_policy = RetentionPolicy(revealed_ttl_s=0.0)
    _recipient, agg, _snapshot = _revealed_round(a)
    now = time.time() + 1
    results = [None, None]

    def sweep(ix, handle):
        results[ix] = sweep_retention(handle.server, now=now)

    threads = [threading.Thread(target=sweep, args=(ix, handle))
               for ix, handle in enumerate((a, b))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    expired = [action for r in results for action in r
               if action["to"] == "expired"]
    assert len(expired) == 1, expired  # the CAS admits one winner
    for handle in (a, b):
        assert handle.server.aggregation_store.get_round_state(
            agg.id) is None
        assert handle.server.get_aggregation(agg.id) is None


def test_late_clerk_result_cannot_resurrect_expired_round():
    """The raced-expiry hazard: retention expires a round between a
    clerk's poll and its result post. The result may land in the job
    store (pre-purge) or 404 (post-purge) — the ROUND's terminal verdict
    must survive either way."""
    service2 = new_memory_server()
    recipient2, rkey2, committee2 = _service_world(service2)
    agg2 = Aggregation(
        id=AggregationId.random(), title="late", vector_dimension=4,
        modulus=433, recipient=recipient2.id, recipient_key=rkey2.body.id,
        masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(3, 433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    service2.create_aggregation(recipient2, agg2)
    service2.create_committee(recipient2, Committee(
        aggregation=agg2.id, clerks_and_keys=committee2))
    _participate(service2, agg2.id)
    snap2 = Snapshot(id=SnapshotId.random(), aggregation=agg2.id)
    service2.create_snapshot(recipient2, snap2)
    # the round is clerking; the sweep expires it (deadline semantics)
    assert lifecycle.transition(
        service2.server.aggregation_store, agg2.id, ("clerking",),
        "expired", reason="test expiry")
    # phase 1: expired but not yet purged — the late result is accepted
    # by the job store, but the round verdict is NOT resurrected
    clerk_id, _ = committee2[0]
    clerk_agent = service2.server.get_agent(clerk_id)
    job = service2.get_clerking_job(clerk_agent, clerk_id)
    assert job is not None
    service2.create_clerking_result(clerk_agent, ClerkingResult(
        job=job.id, clerk=clerk_id, encryption=mock_encryption(b"late")))
    assert service2.server.get_round_status(agg2.id).state == "expired"
    # phase 2: purged — a later clerk's post gets a clean NotFound
    service2.server.purge_aggregation(agg2.id)
    clerk_id2, _ = committee2[1]
    clerk_agent2 = service2.server.get_agent(clerk_id2)
    assert service2.get_clerking_job(clerk_agent2, clerk_id2) is None
    with pytest.raises(NotFound):
        service2.server.create_clerking_result(ClerkingResult(
            job=job.id, clerk=clerk_id2,
            encryption=mock_encryption(b"later")))
    assert service2.server.get_round_status(agg2.id) is None


# ---------------------------------------------------------------------------
# tenant fairness (http/admission.py)

def test_tenant_budget_sheds_before_shared_caps():
    admission = AdmissionControl(max_inflight=100, tenant_rate=1.0,
                                 tenant_burst=2.0)
    assert admission.enabled
    # burst of 2 admits twice, then sheds 429 against the TENANT budget
    assert admission.admit("agent-1", tenant_key="tenant-a") is None
    assert admission.admit("agent-2", tenant_key="tenant-a") is None
    shed = admission.admit("agent-3", tenant_key="tenant-a")
    assert shed is not None and shed.status == 429
    assert shed.reason == "per-tenant budget"
    assert shed.retry_after > 0
    # ANOTHER tenant is untouched by tenant-a's exhaustion
    assert admission.admit("agent-4", tenant_key="tenant-b") is None
    # and a request with no tenant header skips the tenant guard
    assert admission.admit("agent-5") is None
    report = admission.tenants_report()
    assert report["tenants"]["tenant-a"]["shed"] == 1
    assert report["tenants"]["tenant-a"]["admitted"] == 2
    assert report["tenants"]["tenant-b"]["shed"] == 0
    assert metrics.counter_report()["http.throttled.tenant"] == 1


def test_tenant_shed_does_not_consume_inflight():
    admission = AdmissionControl(max_inflight=1, tenant_rate=0.5,
                                 tenant_burst=1.0)
    assert admission.admit("a", tenant_key="t1") is None  # takes the slot
    # a hot tenant's overflow sheds 429 on ITS budget, not 503 on the
    # shared in-flight cap — the fairness ordering under test
    shed = admission.admit("b", tenant_key="t1")
    assert shed.status == 429 and shed.reason == "per-tenant budget"
    admission.release()


def test_tenant_header_flows_over_http():
    from sda_tpu_torch.http import SdaHttpClient, SdaHttpServer

    service = new_memory_server()
    server = SdaHttpServer(service, bind="127.0.0.1:0",
                           tenant_rate=1.0, tenant_burst=1.0)
    server.start_background()
    try:
        proxy = SdaHttpClient(server.address, token="t",
                              max_retries=0, deadline=5.0)
        proxy.tenant = "11111111-2222-3333-4444-555555555555"
        assert proxy.ping().running  # burst of 1: admitted
        from sda_tpu_torch.protocol import ServerError

        with pytest.raises(ServerError) as err:
            proxy.ping()  # same tenant, bucket empty: shed 429
        assert "429" in str(err.value)
        report = server.admission.tenants_report()
        assert report["tenants"][proxy.tenant]["shed"] >= 1
        # the statusz page surfaces the tenant table
        statusz = server.statusz()
        assert statusz["admission"]["tenants"][proxy.tenant]["shed"] >= 1
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# /statusz rounds table: live-priority, per-tenant rollup, O(limit)

def test_rounds_report_prefers_live_and_rolls_up_tenants():
    service = new_memory_server()
    store = service.server.aggregation_store
    now = time.time()
    # 40 terminal rounds (fresher updated_at!) + 3 live ones
    for i in range(40):
        store.put_round_state({
            "aggregation": str(AggregationId.random()),
            "tenant": f"tenant-{i % 4}", "state": "revealed",
            "updated_at": now + 100 + i,
        })
    live_ids = []
    for i in range(3):
        aggregation = str(AggregationId.random())
        live_ids.append(aggregation)
        store.put_round_state({
            "aggregation": aggregation, "tenant": "tenant-live",
            "state": "clerking", "updated_at": now + i,
        })
    report = lifecycle.rounds_report(service.server, limit=8)
    assert report["count"] == 43
    assert report["live"] == 3
    assert len(report["recent"]) == 8  # O(limit), not O(rounds)
    # every live round leads the table despite older updated_at stamps
    assert [r["aggregation"] for r in report["recent"][:3]] \
        == list(reversed(live_ids))
    assert all(r["state"] == "revealed" for r in report["recent"][3:])
    # per-tenant rollup with state counts
    assert report["by_tenant"]["tenant-live"] == {"clerking": 3}
    assert report["by_tenant"]["tenant-0"] == {"revealed": 10}
    assert report["tenants_omitted"] == 0
    # a tenant flood stays bounded
    tight = lifecycle.rounds_report(service.server, limit=2)
    assert len(tight["by_tenant"]) == 2
    assert tight["tenants_omitted"] == 3
    # round docs written by the service plane carry their tenant
    recipient, rkey, committee = _service_world(service)
    spec = _spec(recipient.id, rkey.body.id, committee, name="tenants")
    RoundScheduler(service.server, [spec]).tick_once()
    report = lifecycle.rounds_report(service.server, limit=50)
    assert str(recipient.id) in report["by_tenant"]


# ---------------------------------------------------------------------------
# the soak drill, smoke-sized (real crypto end to end)

def test_soak_smoke_memory():
    from sda_tpu_torch.service import SoakProfile, run_soak

    report = run_soak(SoakProfile(
        tenants=2, epochs=2, participants=4, dim=4, seed=11, churn=0.5,
        device="cpu"))
    assert report["exact"] is True
    assert report["rounds_exact"] == 4
    # epoch e entered collecting before epoch e-1 revealed, per tenant
    assert report["pipelined"] is True
    assert report["pipelined_pairs"] == "2/2"
    # zero cross-epoch/cross-tenant contamination
    assert report["leaks"] == 0
    assert sum(report["replay_probes"].values()) == 2
    # retention kept the store flat: every revealed round purged
    assert report["retention"]["purged_rounds"] == 4
    assert report["retention"]["store_rows_flat"] is True
    # churned devices all resumed via their journals
    assert report["churn"]["participants_resumed"] \
        == report["churn"]["participants_churned"]
    assert report["value"] > 0  # rounds_per_hour headline
    assert report["unit"] == "rounds/hour"


def test_soak_matches_reference_on_the_same_seed():
    """The soak smoke through both packages on the same seed: the same
    rounds, verdicts, churn plan, replay probes and retention counts."""
    from sda_tpu.crypto import sodium as ref_sodium

    if not ref_sodium.available():
        pytest.skip("the reference's libsodium not present")
    from sda_tpu.service import SoakProfile as RefProfile
    from sda_tpu.service import run_soak as ref_run_soak
    from sda_tpu_torch.service import SoakProfile, run_soak

    kw = dict(tenants=2, epochs=2, participants=4, dim=4, seed=11,
              churn=0.5)
    ref = ref_run_soak(RefProfile(**kw))
    got = run_soak(SoakProfile(**kw, device="cpu"))
    for key in ("exact", "rounds", "rounds_exact", "pipelined",
                "pipelined_pairs", "leaks", "replay_probes", "churn",
                "client_failures", "unit"):
        assert got[key] == ref[key], key
    for key in ("purged_rounds", "store_rows_flat"):
        assert got["retention"][key] == ref["retention"][key], key
