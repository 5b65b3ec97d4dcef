"""The fleet plane on the port, the recipes of ``tests/test_fleet.py``:
contended-idempotent snapshots over two handles of one shared backend,
consistent-hash routing, early lease release, node identity on the HTTP
plane, the multi-process launcher (``sda_tpu_torch/server/fleet.py``,
which spawns the port's ``sdad``, ``-m sda_tpu_torch.cli.serverd``) and
the ``sda-fleet`` flag mapping (``sda_tpu_torch/cli/fleetd.py``).
"""


import threading

import pytest

from sda_tpu_torch.protocol import (
    AdditiveSharing,
    Aggregation,
    AggregationId,
    ClerkingResult,
    Committee,
    NoMasking,
    Participation,
    ParticipationId,
    Snapshot,
    SnapshotId,
    SodiumEncryption,
)
from sda_tpu_torch.server import (
    SdaServerService,
    new_jsonfs_server,
    new_mongo_server,
    new_sqlite_server,
)
from sda_tpu_torch.server.core import SdaServer
from sda_tpu_torch.server.routing import NODE_HEADER, HashRing


from torch_util import mock_encryption, new_agent, new_full_agent

BACKENDS = ["memory", "sqlite", "jsonfs", "fakemongo"]


def _two_handles(backend, tmp_path):
    """Two INDEPENDENT service handles over one shared backend — the
    sharing shape of two fleet worker processes."""
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


@pytest.fixture(params=BACKENDS)
def handles(request, tmp_path):
    return _two_handles(request.param, tmp_path)


def _world(service, clerks=4, participants=6):
    recipient, recipient_key = new_full_agent(service)
    committee = [new_full_agent(service) for _ in range(clerks)]
    agg = Aggregation(
        id=AggregationId.random(), title="fleet", vector_dimension=4,
        modulus=433, recipient=recipient.id,
        recipient_key=recipient_key.body.id,
        masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(share_count=clerks,
                                                 modulus=433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    service.create_aggregation(recipient, agg)
    service.create_committee(recipient, Committee(
        aggregation=agg.id,
        clerks_and_keys=[(a.id, k.body.id) for (a, k) in committee],
    ))
    for i in range(participants):
        agent = new_agent()
        service.create_agent(agent, agent)
        service.create_participation(agent, Participation(
            id=ParticipationId.random(), participant=agent.id,
            aggregation=agg.id, recipient_encryption=None,
            clerk_encryptions=[(a.id, mock_encryption(bytes([i])))
                               for (a, _) in committee],
        ))
    return recipient, committee, agg


# ---------------------------------------------------------------------------
# contended-idempotent snapshot creation


def test_contended_create_snapshot_single_winner(handles):
    """Two handles race the FULL snapshot pipeline on the same snapshot
    id: exactly one store-level winner, one snapshot record, exactly one
    job per clerk (zero duplicates, zero lost), identical frozen set."""
    a, b = handles
    recipient, committee, agg = _world(a, clerks=4, participants=6)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)

    barrier = threading.Barrier(2)
    errors = []

    def race(service):
        try:
            barrier.wait()
            service.create_snapshot(recipient, snap)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=race, args=(s,)) for s in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors

    # one snapshot record, visible through BOTH handles
    for service in (a, b):
        store = service.server.aggregation_store
        assert store.list_snapshots(agg.id) == [snap.id]
        assert store.get_snapshot(agg.id, snap.id) is not None
        assert store.has_snapshot_freeze(agg.id, snap.id)
        assert store.count_participations_snapshot(agg.id, snap.id) == 6

    # exactly one job per clerk, same deterministic id through both
    # handles, full frozen column each — convergence, not duplication
    from sda_tpu_torch.server.snapshot import clerking_job_id

    for clerk, _ in committee:
        expected_id = clerking_job_id(snap.id, clerk.id)
        for service in (a, b):
            job = service.server.clerking_job_store.get_clerking_job(
                clerk.id, expected_id)
            assert job is not None, "clerk lost its job"
            assert job.id == expected_id
            assert len(job.encryptions) == 6
        # the queue holds ONLY that one job: polling it away empties it
        store = a.server.clerking_job_store
        first = store.poll_clerking_job(clerk.id)
        assert first is not None and first.id == expected_id
        store.create_clerking_result(ClerkingResult(
            job=first.id, clerk=clerk.id,
            encryption=mock_encryption(b"done")))
        assert store.poll_clerking_job(clerk.id) is None, "duplicate job"


def test_store_level_conditional_inserts(handles):
    """The two store primitives under the contract: ``create_snapshot``
    and ``snapshot_participations`` each return True exactly once when
    raced from two handles, and never overwrite the winner."""
    a, b = handles
    recipient, committee, agg = _world(a, clerks=2, participants=3)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)

    for op in ("snapshot_participations", "create_snapshot"):
        barrier = threading.Barrier(2)
        outcomes = []
        lock = threading.Lock()

        def race(store, op=op):
            barrier.wait()
            if op == "create_snapshot":
                won = store.create_snapshot(snap)
            else:
                won = store.snapshot_participations(agg.id, snap.id)
            with lock:
                outcomes.append(bool(won))

        threads = [
            threading.Thread(target=race,
                             args=(s.server.aggregation_store,))
            for s in (a, b)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(outcomes) == [False, True], \
            f"{op}: want exactly one winner, got {outcomes}"

    # and a replay AFTER the race is a clean loss on both handles
    for service in (a, b):
        store = service.server.aggregation_store
        assert store.create_snapshot(snap) is False
        assert store.snapshot_participations(agg.id, snap.id) is False
        assert store.count_participations_snapshot(agg.id, snap.id) == 3


def test_late_participation_does_not_widen_frozen_set(handles):
    """A participation landing between the winner's freeze and the
    loser's converge must NOT enter the frozen set (mixing share
    generations across clerk columns is the failure mode)."""
    a, b = handles
    recipient, committee, agg = _world(a, clerks=2, participants=4)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)

    assert a.server.aggregation_store.snapshot_participations(
        agg.id, snap.id) is True
    # late arrival through the OTHER handle
    agent = new_agent()
    b.create_agent(agent, agent)
    b.create_participation(agent, Participation(
        id=ParticipationId.random(), participant=agent.id,
        aggregation=agg.id, recipient_encryption=None,
        clerk_encryptions=[(c.id, mock_encryption(b"late"))
                           for (c, _) in committee],
    ))
    assert b.server.aggregation_store.snapshot_participations(
        agg.id, snap.id) is False
    for service in (a, b):
        assert service.server.aggregation_store \
            .count_participations_snapshot(agg.id, snap.id) == 4


# ---------------------------------------------------------------------------
# early lease release (graceful drain)


@pytest.mark.parametrize("backend", BACKENDS)
def test_release_clerking_job_lease(backend, tmp_path):
    """A released lease makes the job immediately pollable by the peer
    handle; done or never-leased jobs release as False."""
    a, b = _two_handles(backend, tmp_path)
    recipient, committee, agg = _world(a, clerks=1, participants=2)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    a.create_snapshot(recipient, snap)
    clerk = committee[0][0]
    store_a = a.server.clerking_job_store
    store_b = b.server.clerking_job_store

    lease = store_a.lease_clerking_job(clerk.id, lease_seconds=300.0)
    assert lease is not None
    job, _expires = lease
    # leased: invisible to the peer until the visibility timeout
    assert store_b.lease_clerking_job(clerk.id, lease_seconds=300.0) is None

    assert store_a.release_clerking_job_lease(clerk.id, job.id) is True
    # released: the peer's next poll gets it immediately
    release = store_b.lease_clerking_job(clerk.id, lease_seconds=300.0)
    assert release is not None and release[0].id == job.id

    # releasing an already-released lease is a no-op
    assert store_a.release_clerking_job_lease(clerk.id, job.id) in (
        True, False)  # b holds it now; a's release hands it back again
    store_b.create_clerking_result(ClerkingResult(
        job=job.id, clerk=clerk.id, encryption=mock_encryption(b"done")))
    # done: nothing to release, nothing to poll
    assert store_b.release_clerking_job_lease(clerk.id, job.id) is False
    assert store_a.lease_clerking_job(clerk.id, lease_seconds=1.0) is None


@pytest.mark.parametrize("backend", BACKENDS)
def test_release_is_compare_and_release(backend, tmp_path):
    """A drain must not release a lease that lapsed and was re-granted to
    a peer: releasing with the ORIGINAL expiry instant is a no-op, so a
    third worker cannot be handed the peer's in-flight job."""
    a, b = _two_handles(backend, tmp_path)
    recipient, committee, agg = _world(a, clerks=1, participants=1)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    a.create_snapshot(recipient, snap)
    clerk = committee[0][0]
    store_a = a.server.clerking_job_store
    store_b = b.server.clerking_job_store

    job, old_expires = store_a.lease_clerking_job(
        clerk.id, lease_seconds=5.0, now=1000.0)
    # the lease lapses unanswered; peer b re-leases (reissue)
    job2, new_expires = store_b.lease_clerking_job(
        clerk.id, lease_seconds=5.0, now=2000.0)
    assert job2.id == job.id and new_expires != old_expires
    # a's drain, arriving late with its stale expiry, must not touch it
    assert store_a.release_clerking_job_lease(
        clerk.id, job.id, expires=old_expires) is False
    assert store_a.lease_clerking_job(
        clerk.id, lease_seconds=5.0, now=2001.0) is None, \
        "stale release exposed the peer's active lease"
    # the current holder's release (matching expiry) works
    assert store_b.release_clerking_job_lease(
        clerk.id, job.id, expires=new_expires) is True
    assert store_a.lease_clerking_job(
        clerk.id, lease_seconds=5.0, now=2002.0) is not None


@pytest.mark.parametrize("backend", BACKENDS)
def test_contended_lease_grant_single_winner(backend, tmp_path):
    """Two handles racing ``lease_clerking_job`` for the same clerk must
    grant the one queued job exactly once — the jsonfs read-check-write
    is flock-arbitrated across processes, sqlite by the conditional
    UPDATE, memory/mongo by their store locks."""
    a, b = _two_handles(backend, tmp_path)
    recipient, committee, agg = _world(a, clerks=1, participants=1)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    a.create_snapshot(recipient, snap)
    clerk = committee[0][0]

    barrier = threading.Barrier(2)
    grants = []
    lock = threading.Lock()

    def race(store):
        barrier.wait()
        got = store.lease_clerking_job(clerk.id, lease_seconds=300.0)
        with lock:
            grants.append(got)

    threads = [
        threading.Thread(target=race, args=(s.server.clerking_job_store,))
        for s in (a, b)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(g is not None for g in grants) == 1, \
        f"want exactly one lease grant, got {grants}"


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_release_held_leases_on_drain(backend, tmp_path):
    """``SdaServer.release_held_leases`` (the drain step) returns every
    lease this server granted, and a peer handle reissues instantly."""
    a, b = _two_handles(backend, tmp_path)
    a.server.clerking_lease_seconds = 300.0
    b.server.clerking_lease_seconds = 300.0
    recipient, committee, agg = _world(a, clerks=3, participants=2)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    a.create_snapshot(recipient, snap)

    leased = [a.server.poll_clerking_job(c.id) for (c, _) in committee]
    assert all(j is not None for j in leased)
    # all three held by server a: peer polls come back empty
    assert all(b.server.poll_clerking_job(c.id) is None
               for (c, _) in committee)

    assert a.server.release_held_leases() == 3
    assert a.server.release_held_leases() == 0  # drained is drained
    reissued = [b.server.poll_clerking_job(c.id) for (c, _) in committee]
    assert sorted(str(j.id) for j in reissued) == \
        sorted(str(j.id) for j in leased)


# ---------------------------------------------------------------------------
# consistent-hash routing


def test_ring_deterministic_and_complete():
    nodes = [f"w{i}" for i in range(4)]
    r1, r2 = HashRing(nodes), HashRing(list(nodes))
    keys = [f"agg-{i}" for i in range(500)]
    assert [r1.node_for(k) for k in keys] == [r2.node_for(k) for k in keys]
    spread = r1.spread(keys)
    assert set(spread) == set(nodes)
    assert all(count > 0 for count in spread.values()), spread
    # 64 vnodes per worker keeps the imbalance bounded
    assert max(spread.values()) <= 4 * min(spread.values()), spread


def test_ring_minimal_movement_on_node_loss():
    """Draining one of four workers moves ONLY the drained worker's keys:
    every key owned by a survivor keeps its owner (cache affinity is why
    the ring exists)."""
    nodes = [f"w{i}" for i in range(4)]
    before = HashRing(nodes)
    after = HashRing([n for n in nodes if n != "w2"])
    keys = [f"agg-{i}" for i in range(500)]
    for key in keys:
        owner = before.node_for(key)
        if owner != "w2":
            assert after.node_for(key) == owner
        else:
            assert after.node_for(key) in after.nodes


def test_ring_preferred_failover_order():
    ring = HashRing(["a", "b", "c"])
    pref = ring.preferred("some-aggregation", count=3)
    assert pref[0] == ring.node_for("some-aggregation")
    assert sorted(pref) == ["a", "b", "c"]  # distinct, all nodes
    assert ring.preferred("some-aggregation", count=99) == pref


def test_ring_rejects_degenerate_input():
    with pytest.raises(ValueError):
        HashRing([])
    with pytest.raises(ValueError):
        HashRing(["a"], replicas=0)
    assert HashRing(["a", "a", "b"]).nodes == ["a", "b"]  # deduped


# ---------------------------------------------------------------------------
# node identity on the HTTP plane


def test_node_id_on_responses_statusz_metrics():
    """A node-tagged server stamps X-SDA-Node on every response, labels
    /metrics samples with node_id, and reports fleet.peers in /statusz."""
    import requests

    from sda_tpu_torch.http import SdaHttpServer
    from sda_tpu_torch.server import new_memory_server
    from sda_tpu_torch import obs

    obs.reset_all()
    srv = SdaHttpServer(
        new_memory_server(), bind="127.0.0.1:0",
        metrics_endpoint=True, statusz_endpoint=True,
        node_id="wX", fleet_peers=3,
    ).start_background()
    try:
        ping = requests.get(srv.address + "/v1/ping")
        assert ping.headers.get(NODE_HEADER) == "wX"
        statusz = requests.get(srv.address + "/statusz").json()
        assert statusz["node_id"] == "wX"
        assert statusz["fleet"]["peers"] == 3
        metrics_text = requests.get(srv.address + "/metrics").text
        assert 'node_id="wX"' in metrics_text
    finally:
        srv.shutdown()
        obs.reset_all()


def test_no_node_header_when_solo():
    import requests

    from sda_tpu_torch.http import SdaHttpServer
    from sda_tpu_torch.server import new_memory_server

    srv = SdaHttpServer(
        new_memory_server(), bind="127.0.0.1:0").start_background()
    try:
        assert NODE_HEADER not in requests.get(srv.address + "/v1/ping").headers
    finally:
        srv.shutdown()


def test_node_id_lands_on_server_spans():
    """Round timelines attribute hops to workers: the server-side span of
    a traced request carries the node_id attribute."""
    import requests

    from sda_tpu_torch.http import SdaHttpServer
    from sda_tpu_torch.server import new_memory_server
    from sda_tpu_torch import obs

    obs.reset_all()
    srv = SdaHttpServer(
        new_memory_server(), bind="127.0.0.1:0", node_id="w7",
    ).start_background()
    try:
        requests.get(srv.address + "/v1/ping")
        spans = [s for s in obs.finished_spans()
                 if s.name.startswith("http.server")]
        assert spans, "expected a server span"
        assert all(s.attributes.get("node_id") == "w7" for s in spans)
    finally:
        srv.shutdown()
        obs.reset_all()


# ---------------------------------------------------------------------------
# the launcher: real worker processes over one shared store


def test_fleet_launcher_two_workers_shared_sqlite(tmp_path):
    """Spawn 2 real `sdad` processes over one WAL sqlite file: distinct
    addresses and node ids, X-SDA-Node names the serving worker, both see
    the SAME store, and SIGTERM drains both with zero leaked requests."""
    import requests

    from sda_tpu_torch.server.fleet import Fleet

    fleet = Fleet(2, ["--sqlite", str(tmp_path / "shared.db")],
                  extra_args=["--statusz", "--job-lease", "5"])
    assert all(w.command[1:3] == ["-m", "sda_tpu_torch.cli.serverd"]
               for w in fleet.workers)
    try:
        fleet.start(timeout_s=120.0)
        addresses = fleet.addresses
        assert sorted(addresses) == ["w0", "w1"]
        assert len(set(addresses.values())) == 2
        for node, address in addresses.items():
            ping = requests.get(address + "/v1/ping", timeout=10)
            assert ping.headers.get(NODE_HEADER) == node
            statusz = requests.get(address + "/statusz", timeout=10).json()
            assert statusz["node_id"] == node
            assert statusz["fleet"]["peers"] == 2
            assert statusz["store"] == "sqlite"
        # shared store: an agent registered via w0 is readable via w1
        agent = new_agent()
        w0, w1 = addresses["w0"], addresses["w1"]
        created = requests.post(
            w0 + "/v1/agents/me", json=agent.to_obj(),
            auth=(str(agent.id), "fleet-test-token"), timeout=10)
        assert created.status_code in (200, 201)
        fetched = requests.get(
            w1 + f"/v1/agents/{agent.id}",
            auth=(str(agent.id), "fleet-test-token"), timeout=10)
        assert fetched.status_code == 200
        assert fetched.json()["id"] == str(agent.id)
    finally:
        summaries = fleet.stop()
    assert len(summaries) == 2
    for summary in summaries:
        assert not summary.get("killed"), summaries
        assert summary["leaked"] == 0
    assert all(w.returncode == 0 for w in fleet.workers)


def test_fleet_rejects_memory_backend(tmp_path):
    from sda_tpu_torch.server.fleet import Fleet

    with pytest.raises(ValueError, match="memory"):
        Fleet(2, ["--memory"])
    with pytest.raises(ValueError):
        Fleet(0, ["--sqlite", str(tmp_path / "x.db")])


def test_fleetd_flag_mapping():
    """The `sda-fleet` CLI maps its flags onto per-worker `sdad` flags
    without spawning anything."""
    from sda_tpu_torch.cli.fleetd import build_parser, worker_extra_args

    args = build_parser().parse_args(
        ["-n", "3", "--sqlite", "db", "--job-lease", "7", "--metrics",
         "--statusz", "--rate-limit", "50", "--drain-grace", "2"])
    extra = worker_extra_args(args)
    assert extra[:2] == ["--drain-grace", "2.0"]
    assert ["--job-lease", "7.0"] == extra[2:4]
    assert "--metrics" in extra and "--statusz" in extra
    assert ["--rate-limit", "50.0"] == \
        [extra[extra.index("--rate-limit")], extra[extra.index("--rate-limit") + 1]]
    assert "--rate-burst" not in extra
