"""The recipes of ``tests/test_gray_failure.py`` against the port's copies:
gray failpoint kinds (``chaos``), fleet health (``server/health.py``:
heartbeats, the suspect/dead CAS, lease recall, hedging), the store
circuit breaker (``server/breaker.py``), the clerk's result wait, and the
fleet drills (``server/fleet.py`` spawning the port's ``sdad``: the
graceful drain's heartbeat and a SIGKILLed worker's lease recall, the
clients on the CPU). ``sda-sim``'s ``--chaos-spec`` recipe is in
``tests/test_torch_sim.py``.
"""

import threading
import time

import numpy as np
import pytest

from sda_tpu_torch import chaos
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
    RoundExpired,
    RoundFailed,
    ServerError,
    Snapshot,
    SnapshotId,
    SodiumEncryption,
    StoreUnavailable,
)
from sda_tpu_torch.server import (
    SdaServerService,
    new_jsonfs_server,
    new_mongo_server,
    new_sqlite_server,
)
from sda_tpu_torch.server import health
from sda_tpu_torch.server.breaker import (
    BreakerStore,
    CircuitBreaker,
    wrap_server_stores,
)
from sda_tpu_torch.server.core import SdaServer


from torch_util import mock_encryption, new_agent, new_full_agent

BACKENDS = ["memory", "sqlite", "jsonfs", "fakemongo"]


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.reset()
    chaos.set_identity(None)
    yield
    chaos.reset()
    chaos.set_identity(None)


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


def _world(service, clerks=2, participants=2):
    recipient, _ = new_full_agent(service)
    committee = [new_full_agent(service) for _ in range(clerks)]
    agg = Aggregation(
        id=AggregationId.random(), title="gray", vector_dimension=4,
        modulus=433, recipient=recipient.id,
        recipient_key=committee[0][1].body.id,
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
# chaos: gray failpoint kinds


def test_brownout_mixes_errors_and_delays_deterministically():
    """Inside the window a brownout hit errors with probability `rate`
    and delays otherwise; the same seed replays the same split."""
    def schedule(seed):
        chaos.reset()
        chaos.configure("fp.brown", brownout=0.0, rate=0.5, window=60.0,
                        seed=seed)
        kinds = []
        for _ in range(32):
            action = chaos.evaluate("fp.brown", kinds=("error", "delay"))
            kinds.append(action.kind)
        return kinds

    a, b = schedule(7), schedule(7)
    assert a == b, "same (seed, name) must replay the same schedule"
    assert set(a) == {"error", "delay"}, a
    assert schedule(8) != a, "different seed must change the schedule"


def test_brownout_heals_after_window():
    chaos.configure("fp.heal", brownout=0.0, rate=1.0, window=30.0, seed=0)
    assert chaos.evaluate("fp.heal", kinds=("error", "delay")) is not None
    point = chaos.registry._points["fp.heal"]
    point.armed_at -= 31.0  # wind the clock: the window has elapsed
    assert chaos.evaluate("fp.heal", kinds=("error", "delay")) is None
    # a healed hit consumed nothing: the schedule only describes the
    # degraded phase
    assert point.hits == 1 and point.triggers == 1


def test_flap_cycles_down_and_up():
    chaos.configure("fp.flap", flap=0.0, rate=1.0, window=10.0, up=10.0,
                    seed=0)
    point = chaos.registry._points["fp.flap"]
    assert chaos.evaluate("fp.flap", kinds=("error", "delay")) is not None
    point.armed_at -= 10.0  # now inside the healthy (up) phase
    assert chaos.evaluate("fp.flap", kinds=("error", "delay")) is None
    point.armed_at -= 10.0  # next down phase of the cycle
    assert chaos.evaluate("fp.flap", kinds=("error", "delay")) is not None


def test_brownout_honors_every():
    chaos.configure("fp.every", brownout=0.0, rate=1.0, window=60.0,
                    every=3, seed=0)
    fired = [chaos.evaluate("fp.every", kinds=("error", "delay"))
             is not None for _ in range(9)]
    assert fired == [True, False, False] * 3


def test_flap_requires_window_and_up():
    with pytest.raises(ValueError, match="flap"):
        chaos.configure("fp.bad", flap=0.01)
    with pytest.raises(ValueError, match="brownout"):
        chaos.configure("fp.bad2", brownout=0.01)


def test_partition_scoped_to_node_identity():
    """A node-scoped partition severs exactly the named process: one
    fleet-wide spec, one partitioned worker."""
    chaos.configure("fp.part", partition=True, node="w0", window=None)
    chaos.set_identity("w1")
    assert chaos.evaluate("fp.part") is None
    chaos.set_identity("w0")
    action = chaos.evaluate("fp.part")
    assert action is not None and action.kind == "error"
    with pytest.raises(chaos.PartitionedFault):
        chaos.fail("fp.part")
    # heals after the window
    chaos.configure("fp.part2", partition=True, node="w0", window=30.0)
    chaos.registry._points["fp.part2"].armed_at -= 31.0
    assert chaos.evaluate("fp.part2") is None


def test_partition_scoped_to_agent():
    chaos.configure("fp.agent", partition=True, agent="alice")
    assert chaos.evaluate("fp.agent", ctx={"agent": "bob"}) is None
    assert chaos.evaluate("fp.agent") is None  # no ctx: no match
    assert chaos.evaluate("fp.agent", ctx={"agent": "alice"}) is not None


def test_partition_returns_503_class_error_over_http():
    """An agent-scoped partition at the HTTP seam 500s exactly that
    agent's requests; everyone else sails through (and the retrying
    client of the partitioned agent eventually gives up with the
    Retry-After-free ServerError)."""
    from sda_tpu_torch.http import SdaHttpClient, SdaHttpServer
    from sda_tpu_torch.server import new_memory_server

    service = new_memory_server()
    server = SdaHttpServer(service, bind="127.0.0.1:0")
    server.start_background()
    try:
        alice, bob = new_agent(), new_agent()
        proxy = SdaHttpClient(server.address, token="gray-test",
                              max_retries=1, backoff_base=0.0,
                              backoff_cap=0.0, deadline=5.0)
        for agent in (alice, bob):
            proxy.create_agent(agent, agent)
        chaos.configure("http.server.request", partition=True,
                        agent=str(alice.id))
        assert proxy.get_agent(bob, bob.id) is not None
        with pytest.raises(ServerError):
            proxy.get_agent(alice, alice.id)
    finally:
        chaos.reset()
        server.shutdown()


# ---------------------------------------------------------------------------
# chaos: composable spec syntax


def test_spec_multi_target_and_gray_kinds():
    specs = chaos.parse_spec(
        "a.x,a.y=brownout:0.02,rate=0.7,for=5;"
        "b=partition,node=w0,agent=alice,for=3;"
        "c=flap:0.01,for=1,up=2,times=4")
    assert set(specs) == {"a.x", "a.y", "b", "c"}
    assert specs["a.x"]["brownout"] == 0.02
    assert specs["a.x"]["window"] == 5.0 and specs["a.x"]["rate"] == 0.7
    assert specs["b"]["partition"] is True and specs["b"]["node"] == "w0"
    assert specs["b"]["agent"] == "alice"
    assert specs["c"]["flap"] == 0.01 and specs["c"]["up"] == 2.0
    chaos.configure_from_spec("a.x,a.y=brownout:0.02,rate=1.0,for=60", seed=3)
    assert chaos.evaluate("a.y", kinds=("error", "delay")) is not None


def test_spec_conflicts_rejected_with_clear_error():
    with pytest.raises(ValueError, match="conflict.*'a'"):
        chaos.parse_spec("a=error;a=kill")
    with pytest.raises(ValueError, match="conflict.*'dup'"):
        chaos.configure_from_specs(["dup=error", "x=kill;dup=drop"])
    # a rejected merge arms NOTHING (no half-applied drill)
    assert chaos.evaluate("x") is None
    with pytest.raises(ValueError, match="unknown key"):
        chaos.parse_spec("a=error,bogus=1")


# ---------------------------------------------------------------------------
# fleet health: heartbeats, the suspect/dead CAS, lease recall


@pytest.mark.parametrize("backend", BACKENDS)
def test_heartbeat_roundtrip_and_cas(backend, tmp_path):
    a, b = _two_handles(backend, tmp_path)
    store_a = a.server.clerking_job_store
    store_b = b.server.clerking_job_store
    writer = health.HeartbeatWriter(store_a, "w0")
    writer.beat(now=100.0)
    doc = store_b.get_worker_heartbeat("w0")  # peer sees it (shared store)
    assert doc["state"] == "alive" and doc["ts"] == 100.0
    assert [d["node"] for d in store_b.list_worker_heartbeats()] == ["w0"]
    # CAS: only the matching FROM state transitions
    suspect = dict(doc, state="suspect")
    assert store_b.transition_worker_state("w0", ("dead",), suspect) is False
    assert store_b.transition_worker_state("w0", ("alive",), suspect) is True
    assert store_a.get_worker_heartbeat("w0")["state"] == "suspect"
    # the worker's next beat revives it (plain upsert beats the verdict)
    writer.beat(now=101.0)
    assert store_b.get_worker_heartbeat("w0")["state"] == "alive"
    # a clean stop leaves the terminal 'drained' state
    writer.stop(drained=True)
    assert store_b.get_worker_heartbeat("w0")["state"] == "drained"


@pytest.mark.parametrize("backend", BACKENDS)
def test_raced_dead_declaration_recalls_leases_exactly_once(backend,
                                                            tmp_path):
    """Two competing sweepers over one shared store: the dead CAS is
    single-winner, the dead node's lease is recalled exactly once, and
    the job is reissued to exactly one subsequent poller — no
    double-reissue, no orphaned job."""
    a, b = _two_handles(backend, tmp_path)
    a.server.node_id, b.server.node_id = "w1", "w2"
    recipient, committee, agg = _world(a, clerks=1, participants=1)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    a.create_snapshot(recipient, snap)
    clerk = committee[0][0]
    store_a = a.server.clerking_job_store
    store_b = b.server.clerking_job_store

    # the doomed worker w0 beats once, leases the job, then goes silent
    health.HeartbeatWriter(store_a, "w0").beat(now=1000.0)
    leased = store_a.lease_clerking_job(clerk.id, lease_seconds=300.0,
                                        now=1000.0, owner="w0")
    assert leased is not None
    job = leased[0]
    assert store_b.lease_clerking_job(clerk.id, lease_seconds=300.0,
                                      now=1001.0) is None  # held

    barrier = threading.Barrier(2)
    results = []
    lock = threading.Lock()

    def sweep(handle):
        barrier.wait()
        actions = health.sweep_worker_health(
            handle.server, now=1010.0, suspect_after_s=2.0,
            dead_after_s=5.0)
        with lock:
            results.append(actions)

    threads = [threading.Thread(target=sweep, args=(s,)) for s in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    winners = [acts for acts in results if acts]
    assert len(winners) == 1, f"dead CAS must be single-winner: {results}"
    assert winners[0][0]["to"] == "dead"
    assert winners[0][0]["recalled_leases"] == 1
    assert store_a.get_worker_heartbeat("w0")["state"] == "dead"

    # recalled: exactly one poller gets the job back, immediately
    grants = []

    def poll(store, owner):
        barrier.wait()
        grants.append(store.lease_clerking_job(
            clerk.id, lease_seconds=300.0, now=1011.0, owner=owner))

    barrier.reset()
    threads = [threading.Thread(target=poll, args=(store_a, "w1")),
               threading.Thread(target=poll, args=(store_b, "w2"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    granted = [g for g in grants if g is not None]
    assert len(granted) == 1, f"recall must not double-reissue: {grants}"
    assert granted[0][0].id == job.id
    # the round still completes: the new holder's result lands
    b.server.clerking_job_store.create_clerking_result(ClerkingResult(
        job=job.id, clerk=clerk.id, encryption=mock_encryption(b"done")))
    assert store_a.list_results(snap.id) == [job.id]
    # a second sweep finds nothing left to do
    assert health.sweep_worker_health(a.server, now=1012.0,
                                     suspect_after_s=2.0,
                                     dead_after_s=5.0) == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_recall_spares_other_owners_and_done_jobs(backend, tmp_path):
    a, b = _two_handles(backend, tmp_path)
    recipient, committee, agg = _world(a, clerks=2, participants=1)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    a.create_snapshot(recipient, snap)
    (c0, _), (c1, _) = committee
    store = a.server.clerking_job_store
    j0, _ = store.lease_clerking_job(c0.id, 300.0, now=100.0, owner="w0")
    j1, _ = store.lease_clerking_job(c1.id, 300.0, now=100.0, owner="w1")
    # w0's DONE job must not come back either
    store.create_clerking_result(ClerkingResult(
        job=j0.id, clerk=c0.id, encryption=mock_encryption(b"r")))
    assert store.recall_clerking_job_leases("w0") == 0  # done: no lease left
    assert store.recall_clerking_job_leases("w1") == 1
    assert store.recall_clerking_job_leases("w1") == 0  # idempotent
    # w1's job is pollable again; w0's stays done
    regrant = b.server.clerking_job_store.lease_clerking_job(
        c1.id, 300.0, now=101.0)
    assert regrant is not None and regrant[0].id == j1.id
    assert b.server.clerking_job_store.lease_clerking_job(
        c0.id, 300.0, now=101.0) is None


# ---------------------------------------------------------------------------
# straggler hedging


@pytest.mark.parametrize("backend", BACKENDS)
def test_hedge_targets_only_suspect_holders(backend, tmp_path):
    a, b = _two_handles(backend, tmp_path)
    recipient, committee, agg = _world(a, clerks=1, participants=1)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    a.create_snapshot(recipient, snap)
    clerk = committee[0][0]
    store_a = a.server.clerking_job_store
    store_b = b.server.clerking_job_store
    job, _ = store_a.lease_clerking_job(clerk.id, 300.0, now=100.0,
                                        owner="w0")
    # holder healthy: no hedge
    assert store_b.hedge_clerking_job(clerk.id, ["w9"], 300.0,
                                      now=101.0, owner="w1") is None
    assert store_b.hedge_clerking_job(clerk.id, [], 300.0,
                                      now=101.0, owner="w1") is None
    # holder suspect: hedged exactly once — the second hedger sees the
    # lease now owned by w1 (not suspect) and backs off
    hedged = store_b.hedge_clerking_job(clerk.id, ["w0"], 300.0,
                                        now=101.0, owner="w1")
    assert hedged is not None and hedged[0].id == job.id
    assert store_a.hedge_clerking_job(clerk.id, ["w0"], 300.0,
                                      now=102.0, owner="w2") is None
    # a lapsed lease is NOT hedged (the plain reissue path owns it)
    assert store_b.hedge_clerking_job(clerk.id, ["w1"], 300.0,
                                      now=500.0, owner="w2") is None


@pytest.mark.parametrize("backend", BACKENDS)
def test_hedged_commit_is_single_winner(backend, tmp_path):
    """Original holder and hedged copy both upload: one result row, no
    duplicate, no error — duplicate partial sums are impossible."""
    a, b = _two_handles(backend, tmp_path)
    recipient, committee, agg = _world(a, clerks=1, participants=1)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    a.create_snapshot(recipient, snap)
    clerk = committee[0][0]
    job, _ = a.server.clerking_job_store.lease_clerking_job(
        clerk.id, 300.0, now=100.0, owner="w0")
    hedged = b.server.clerking_job_store.hedge_clerking_job(
        clerk.id, ["w0"], 300.0, now=101.0, owner="w1")
    assert hedged is not None
    result = ClerkingResult(job=job.id, clerk=clerk.id,
                            encryption=mock_encryption(b"sum"))
    b.server.clerking_job_store.create_clerking_result(result)
    # the straggler wakes up and uploads too: idempotent no-op
    a.server.clerking_job_store.create_clerking_result(result)
    assert a.server.clerking_job_store.list_results(snap.id) == [job.id]
    # and the job never comes back
    assert a.server.clerking_job_store.lease_clerking_job(
        clerk.id, 300.0, now=102.0) is None


def test_server_poll_hedges_via_heartbeat_table(tmp_path):
    """The server-level wiring: an empty lease poll consults the
    heartbeat table and hedges a stale holder's job."""
    a, b = _two_handles("sqlite", tmp_path)
    a.server.node_id, b.server.node_id = "w0", "w1"
    a.server.clerking_lease_seconds = 300.0
    b.server.clerking_lease_seconds = 300.0
    b.server.hedge_suspect_after_s = 1.0
    recipient, committee, agg = _world(a, clerks=1, participants=1)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    a.create_snapshot(recipient, snap)
    clerk = committee[0][0]
    # w0 heartbeats, leases the job through the SERVER path, goes silent
    health.HeartbeatWriter(a.server.clerking_job_store, "w0").beat(
        now=time.time() - 30.0)
    job = a.server.poll_clerking_job(clerk.id)
    assert job is not None
    # w1's poll: nothing unleased, but w0 is stale -> hedged
    hedged = b.server.poll_clerking_job(clerk.id)
    assert hedged is not None and hedged.id == job.id
    from sda_tpu_torch.utils import metrics

    assert metrics.counter_report("server.job.").get("server.job.hedged")


# ---------------------------------------------------------------------------
# store circuit breaker


class _FlakyStore:
    def __init__(self):
        self.failing = False
        self.calls = 0

    def ping(self):
        self.calls += 1
        if self.failing:
            raise OSError("store down")
        return None

    def lookup(self):
        self.calls += 1
        if self.failing:
            raise OSError("store down")
        raise NotFound("no such thing")


def test_breaker_opens_sheds_and_recovers():
    breaker = CircuitBreaker(threshold=3, recovery_s=30.0,
                             failure_window_s=60.0, budget_rate=0.0,
                             budget_cap=0.0)
    store = BreakerStore(_FlakyStore(), breaker)
    store._inner.failing = True
    for _ in range(3):
        with pytest.raises(OSError):
            store.ping()
    assert breaker.state == "open"
    # open: shed WITHOUT touching the store, with a Retry-After hint
    calls = store._inner.calls
    with pytest.raises(StoreUnavailable) as exc:
        store.ping()
    assert store._inner.calls == calls
    assert 0 < exc.value.retry_after <= 30.0
    # recovery elapses -> half-open: exactly one probe goes through
    breaker._opened_at -= 31.0
    store._inner.failing = False
    assert store.ping() is None
    assert breaker.state == "closed"
    report = breaker.report()
    assert report["times_opened"] == 1
    assert report["time_to_recover_s"] > 0


def test_breaker_windowed_failures_survive_interleaved_successes():
    """A browning-out store fails GRAY: successes between the failures
    must not reset the verdict (the consecutive-counter trap)."""
    breaker = CircuitBreaker(threshold=3, recovery_s=30.0,
                             failure_window_s=60.0, budget_rate=0.0,
                             budget_cap=0.0)
    store = BreakerStore(_FlakyStore(), breaker)
    for _ in range(2):
        store._inner.failing = True
        with pytest.raises(OSError):
            store.ping()
        store._inner.failing = False
        store.ping()  # interleaved success
    store._inner.failing = True
    with pytest.raises(OSError):
        store.ping()
    assert breaker.state == "open", \
        "3 failures in the window must trip regardless of successes"


def test_breaker_failed_probe_reopens():
    breaker = CircuitBreaker(threshold=1, recovery_s=30.0,
                             budget_rate=0.0, budget_cap=0.0)
    store = BreakerStore(_FlakyStore(), breaker)
    store._inner.failing = True
    with pytest.raises(OSError):
        store.ping()
    assert breaker.state == "open"
    breaker._opened_at -= 31.0
    with pytest.raises(OSError):
        store.ping()  # the probe itself fails
    assert breaker.state == "open" and breaker.times_opened == 2


def test_breaker_retry_budget_absorbs_blips():
    """With budget, a one-shot failure is retried immediately and never
    counts toward the verdict; without tokens it does."""
    breaker = CircuitBreaker(threshold=1, recovery_s=1.0,
                             budget_rate=0.0, budget_cap=1.0)

    class OneShot:
        def __init__(self):
            self.fails_left = 1

        def op(self):
            if self.fails_left:
                self.fails_left -= 1
                raise OSError("blip")
            return "ok"

    store = BreakerStore(OneShot(), breaker)
    assert store.op() == "ok"  # retried on the budget token
    assert breaker.state == "closed"
    # budget exhausted (cap 1, refill 0): the next blip trips threshold=1
    store._inner.fails_left = 1
    with pytest.raises(OSError):
        store.op()
    assert breaker.state == "open"


def test_breaker_semantic_errors_pass_through_uncounted():
    breaker = CircuitBreaker(threshold=1, recovery_s=1.0,
                             budget_rate=0.0, budget_cap=0.0)
    store = BreakerStore(_FlakyStore(), breaker)
    for _ in range(5):
        with pytest.raises(NotFound):
            store.lookup()
    assert breaker.state == "closed", \
        "a NotFound is an answer, not an infrastructure failure"


def test_breaker_open_maps_to_503_retry_after_over_http():
    """The HTTP seam: an open breaker sheds with 503 + Retry-After and
    zero store touches; the retrying client converges once it closes."""
    import requests

    from sda_tpu_torch.http import SdaHttpServer
    from sda_tpu_torch.server import new_memory_server

    service = new_memory_server()
    breaker = wrap_server_stores(service.server, CircuitBreaker(
        threshold=1, recovery_s=30.0, budget_rate=0.0, budget_cap=0.0))
    server = SdaHttpServer(service, bind="127.0.0.1:0")
    server.start_background()
    try:
        agent = new_agent()
        created = requests.post(
            server.address + "/v1/agents/me", json=agent.to_obj(),
            auth=(str(agent.id), "token"), timeout=10)
        assert created.status_code == 201
        # trip the breaker through the store seam
        chaos.configure("store.poll_clerking_job", error=True, times=1)
        with pytest.raises(Exception):
            service.server.clerking_job_store.poll_clerking_job(agent.id)
        assert breaker.state == "open"
        shed = requests.get(
            server.address + f"/v1/agents/{agent.id}",
            auth=(str(agent.id), "token"), timeout=10)
        assert shed.status_code == 503
        assert float(shed.headers["Retry-After"]) > 0
        # recovery: the probe closes it and the route answers again
        breaker._opened_at -= 31.0
        ok = requests.get(
            server.address + f"/v1/agents/{agent.id}",
            auth=(str(agent.id), "token"), timeout=10)
        assert ok.status_code == 200
        assert breaker.state == "closed"
    finally:
        chaos.reset()
        server.shutdown()


# ---------------------------------------------------------------------------
# await_result herd hygiene (satellite: jitter + Retry-After)


class _ScriptedService:
    """get_round_status raises scripted transients, then reports a
    terminal verdict; tracks how often it was polled."""

    def __init__(self, transients, final_state="failed"):
        self.transients = list(transients)
        self.final_state = final_state
        self.polls = 0

    def get_round_status(self, caller, aggregation):
        self.polls += 1
        if self.transients:
            raise self.transients.pop(0)
        from sda_tpu_torch.protocol import RoundStatus

        return RoundStatus(
            aggregation=aggregation, state=self.final_state, snapshot=None,
            scheme="additive", committee_size=1,
            reconstruction_threshold=1, results=0, dead_clerks=[],
            reason="scripted", deadline_at=None, updated_at=None,
            history=[])

    def get_aggregation_status(self, caller, aggregation):
        return None


def _client_with(service):
    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.crypto import MemoryKeystore

    return SdaClient(new_agent(), MemoryKeystore(), service, device="cpu")


def test_await_result_survives_transients_and_honors_retry_after():
    shed = StoreUnavailable("browning out", retry_after=0.05)
    service = _ScriptedService([shed, shed])
    client = _client_with(service)
    t0 = time.monotonic()
    with pytest.raises(RoundFailed):
        client.await_result(AggregationId.random(), deadline=10.0,
                            poll_interval=0.01)
    elapsed = time.monotonic() - t0
    assert service.polls == 3, "both transients absorbed, verdict on #3"
    # two Retry-After-hinted sleeps, each jittered in [0.5, 1.5) x 0.05
    assert elapsed >= 2 * 0.05 * 0.5


def test_await_result_deadline_survives_endless_transients():
    service = _ScriptedService([ServerError("boom")] * 10_000)
    client = _client_with(service)
    with pytest.raises(RoundExpired, match="deadline"):
        client.await_result(AggregationId.random(), deadline=0.2,
                            poll_interval=0.01)
    assert service.polls > 1


def test_await_result_unbounded_wait_propagates_dead_server():
    """deadline=None tolerates a brownout but must NOT spin forever on a
    permanently dead server: a long unbroken transient streak (each
    element already past the transport's own retry budget) propagates."""
    service = _ScriptedService([ServerError("connection refused")] * 10_000)
    client = _client_with(service)
    with pytest.raises(ServerError, match="connection refused"):
        client.await_result(AggregationId.random(), deadline=None,
                            poll_interval=0.001)
    assert service.polls == 8, "streak bound: 8 consecutive, then raise"


def test_await_result_jitter_is_seeded_per_agent():
    """The jitter RNG is deterministic per (agent, aggregation): the
    same client replays the same schedule, two clients differ."""
    import random

    agg = AggregationId.random()
    client_a = _client_with(_ScriptedService([]))
    client_b = _client_with(_ScriptedService([]))
    draws = {
        name: [random.Random(f"{c.agent.id}:{agg}").random()
               for _ in range(4)]
        for name, c in (("a", client_a), ("b", client_b))
    }
    assert draws["a"] == [random.Random(
        f"{client_a.agent.id}:{agg}").random() for _ in range(4)]
    assert draws["a"] != draws["b"]


# ---------------------------------------------------------------------------
# the fleet: a graceful drain's heartbeat, then SIGKILL a worker holding
# leases mid-round


def test_drained_heartbeat_lands_after_graceful_drain(tmp_path):
    """A SIGTERM'd worker's terminal 'drained' row is written AFTER the
    drain hands leases back (a worker killed mid-drain must look
    stale-alive — diagnosable — never prematurely 'drained')."""
    from sda_tpu_torch.server.fleet import Fleet

    fleet = Fleet(1, ["--sqlite", str(tmp_path / "one.db")],
                  extra_args=["--heartbeat", "0.25", "--job-lease", "5"])
    try:
        fleet.start(timeout_s=120.0)
    finally:
        summaries = fleet.stop()
    assert summaries and summaries[0].get("leaked") == 0
    store = new_sqlite_server(tmp_path / "one.db").server.clerking_job_store
    assert store.get_worker_heartbeat("w0")["state"] == "drained"


# ---------------------------------------------------------------------------
# the capstone: SIGKILL a fleet worker holding leases mid-round


def _run_sigkill_drill(tmp_path, backend_args, lease_seconds=30.0):
    """Two real `sdad` workers over one shared store; w0 grants itself
    every clerking-job lease and is SIGKILLed (no drain); w1's heartbeat
    detector must recall the leases and the round must complete
    bit-exactly well inside the lease-expiry fallback."""
    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.crypto import MemoryKeystore
    from sda_tpu_torch.http import SdaHttpClient
    from sda_tpu_torch.protocol import FullMasking
    from sda_tpu_torch.server.fleet import Fleet

    scheme = AdditiveSharing(share_count=3, modulus=433)
    fleet = Fleet(2, backend_args, extra_args=[
        "--job-lease", str(lease_seconds),
        "--heartbeat", "0.25", "--suspect-after", "0.5",
        "--dead-after", "1.0", "--round-sweep", "0.2",
        "--statusz",
    ])
    kill_to_done_s = None
    try:
        fleet.start(timeout_s=120.0)
        w0, w1 = fleet.addresses["w0"], fleet.addresses["w1"]

        proxy_w1 = SdaHttpClient(w1, token="gray-drill",
                                 max_retries=8, backoff_base=0.01,
                                 backoff_cap=0.1)
        proxy_w0 = SdaHttpClient(w0, token="gray-drill",
                                 max_retries=2, backoff_base=0.01,
                                 backoff_cap=0.05, deadline=10.0)

        def new_client():
            keystore = MemoryKeystore()
            agent = SdaClient.new_agent(keystore)
            return SdaClient(agent, keystore, proxy_w1, device="cpu")

        recipient = new_client()
        recipient.upload_agent()
        recipient_key = recipient.new_encryption_key()
        recipient.upload_encryption_key(recipient_key)
        candidates = {recipient.agent.id: recipient}
        for _ in range(scheme.share_count):
            clerk = new_client()
            clerk.upload_agent()
            clerk.upload_encryption_key(clerk.new_encryption_key())
            candidates[clerk.agent.id] = clerk
        agg = Aggregation(
            id=AggregationId.random(), title="sigkill-drill",
            vector_dimension=4, modulus=scheme.modulus,
            recipient=recipient.agent.id, recipient_key=recipient_key,
            masking_scheme=FullMasking(scheme.modulus),
            committee_sharing_scheme=scheme,
            recipient_encryption_scheme=SodiumEncryption(),
            committee_encryption_scheme=SodiumEncryption(),
        )
        recipient.upload_aggregation(agg)
        recipient.begin_aggregation(agg.id)
        committee = recipient.service.get_committee(recipient.agent, agg.id)
        clerks = [candidates[cid] for cid, _ in committee.clerks_and_keys]

        inputs = np.arange(4 * 4, dtype=np.int64).reshape(4, 4) % 433
        for row in inputs:
            participant = new_client()
            participant.upload_agent()
            participant.participate([int(x) for x in row], agg.id)
        recipient.end_aggregation(agg.id)  # snapshot + job fan-out

        # every clerking job is leased THROUGH w0 — and every poll
        # response is "lost" with the worker, the gray-failure shape:
        # leases live in the shared store, the work never happens
        for clerk in clerks:
            doomed = proxy_w0.get_clerking_job(clerk.agent, clerk.agent.id)
            assert doomed is not None, "w0 must grant each clerk's lease"
        fleet.kill("w0")
        t_kill = time.monotonic()

        # the committee keeps polling via the surviving worker: nothing
        # is pollable until w1's detector declares w0 dead and recalls
        deadline = time.monotonic() + 20.0
        done = False
        while time.monotonic() < deadline and not done:
            for clerk in clerks:
                try:
                    clerk.run_chores(-1)
                except ServerError:
                    pass  # transient while the fleet re-converges
            status = recipient.service.get_aggregation_status(
                recipient.agent, agg.id)
            done = bool(
                status is not None and status.snapshots
                and status.snapshots[0].number_of_clerking_results
                >= scheme.share_count)
            if not done:
                time.sleep(0.05)
        assert done, "round stalled: heartbeat recall never freed the leases"
        kill_to_done_s = time.monotonic() - t_kill

        output = recipient.await_result(agg.id, deadline=10.0)
        expected = inputs.sum(axis=0) % 433
        assert (output.positive().values == expected).all(), \
            "zero lost participations, bit-exact reveal"
        # MTTR: well under the lease-expiry fallback (the pre-heartbeat
        # recovery path would idle ~lease_seconds)
        assert kill_to_done_s < lease_seconds / 2, (
            f"recovered in {kill_to_done_s:.1f}s — not meaningfully "
            f"faster than the {lease_seconds}s lease-expiry fallback")

        # the surviving worker's statusz names the dead peer
        import requests

        statusz = requests.get(w1 + "/statusz", timeout=10).json()
        assert statusz["fleet_health"]["w0"]["state"] == "dead"
        assert statusz["fleet_health"]["w1"]["state"] == "alive"
    finally:
        summaries = fleet.stop()
    # w1 drains clean; w0 was SIGKILLed so it reports killed-or-dead
    by_node = {s.get("node_id"): s for s in summaries if s.get("node_id")}
    assert by_node.get("w1", {}).get("leaked") == 0
    return kill_to_done_s


@pytest.mark.chaos
def test_sigkill_worker_midround_recovers_via_heartbeats_sqlite(tmp_path):
    _run_sigkill_drill(tmp_path, ["--sqlite", str(tmp_path / "shared.db")])


@pytest.mark.chaos
def test_sigkill_worker_midround_recovers_via_heartbeats_jsonfs(tmp_path):
    _run_sigkill_drill(tmp_path, ["--jfs", str(tmp_path / "shared-jfs")])
