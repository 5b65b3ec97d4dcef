"""The server planes that ``sdad``'s flags arm, on the port and on the
reference over the same store: the round sweeper with heartbeats
(``--round-sweep --dead-after``), straggler hedging (``--hedge``),
retention (``--retain-*``) and ``/statusz`` (``--statusz``).

Both packages open one sqlite file. The port builds a world in it, the
file is copied, and each package runs the same call at the same clock on
its own copy: the results must be equal. These are the paths whose lazy
imports (``server.health``, ``service.retention``, ``service.scheduler``,
``obs.devprof.compile_totals``) the port lacked before it copied them.
"""

import json
import shutil
import time
import urllib.request

import pytest

from sda_tpu.http import SdaHttpServer as RefHttpServer
from sda_tpu.server import lifecycle as ref_lifecycle
from sda_tpu.server import new_memory_server as ref_memory
from sda_tpu.server import new_sqlite_server as ref_sqlite
from sda_tpu.service.retention import RetentionPolicy as RefRetentionPolicy
from sda_tpu.service.retention import sqlite_row_counts as ref_row_counts

from sda_tpu_torch.http import SdaHttpServer
from sda_tpu_torch.protocol import Snapshot, SnapshotId
from sda_tpu_torch.server import health, lifecycle
from sda_tpu_torch.server import new_memory_server, new_sqlite_server
from sda_tpu_torch.service.retention import RetentionPolicy, sqlite_row_counts

from test_torch_gray_failure import _world


def _with_reference(tmp_path, port):
    """A reference service over a copy of the port's sqlite store (with
    its write-ahead log)."""
    for suffix in ("", "-wal", "-shm"):
        src = tmp_path / f"port.db{suffix}"
        if src.exists():
            shutil.copy(src, tmp_path / f"ref.db{suffix}")
    return ref_sqlite(tmp_path / "ref.db")


def _stale_lease(tmp_path):
    """A port store where worker w0 leased the only clerking job and then
    went silent 30 s ago; returns the service, the clerk and the job."""
    port = new_sqlite_server(tmp_path / "port.db")
    port.server.node_id = "w0"
    port.server.clerking_lease_seconds = 300.0
    recipient, committee, agg = _world(port, clerks=1, participants=1)
    port.create_snapshot(recipient, Snapshot(id=SnapshotId.random(),
                                             aggregation=agg.id))
    health.HeartbeatWriter(port.server.clerking_job_store, "w0").beat(
        now=time.time() - 30.0)
    clerk = committee[0][0]
    job = port.server.poll_clerking_job(clerk.id)
    assert job is not None
    return port, clerk, job


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_roadmap_sweeper_call(pkg):
    """The call that raised ``ImportError`` in the port: a heartbeat-armed
    sweep of an empty store. On the service handle both packages raise the
    same ``AttributeError`` (the sweeper takes the server); on the server
    both report an empty sweep."""
    mod, make = ((lifecycle, new_memory_server) if pkg == "port"
                 else (ref_lifecycle, ref_memory))
    service = make()
    with pytest.raises(AttributeError, match="clerking_job_store"):
        mod.RoundSweeper(service, heartbeat_dead_s=1.0).sweep_once()
    assert mod.RoundSweeper(service.server, heartbeat_dead_s=1.0) \
        .sweep_once() == {"rounds": 0, "actions": []}


def test_heartbeat_sweep_matches_reference(tmp_path):
    port, clerk, job = _stale_lease(tmp_path)
    ref = _with_reference(tmp_path, port)
    port.server.node_id = ref.server.node_id = "w1"  # a peer sweeps
    now = time.time()
    got = lifecycle.RoundSweeper(port.server, heartbeat_dead_s=1.0) \
        .sweep_once(now=now)
    want = ref_lifecycle.RoundSweeper(ref.server, heartbeat_dead_s=1.0) \
        .sweep_once(now=now)
    assert got == want
    assert [(a["node"], a["to"], a["recalled_leases"])
            for a in got["actions"]] == [("w0", "dead", 1)]
    # the recalled job is pollable again in both stores
    assert port.server.poll_clerking_job(clerk.id).id == job.id
    assert str(ref.server.poll_clerking_job(clerk.id).id) == str(job.id)


def test_hedged_poll_matches_reference(tmp_path):
    port, clerk, job = _stale_lease(tmp_path)
    ref = _with_reference(tmp_path, port)
    for service in (port, ref):
        service.server.node_id = "w1"
        service.server.clerking_lease_seconds = 300.0
        service.server.hedge_suspect_after_s = 1.0
    hedged = port.server.poll_clerking_job(clerk.id)
    ref_hedged = ref.server.poll_clerking_job(clerk.id)
    assert hedged is not None and hedged.id == job.id
    assert hedged.to_obj() == ref_hedged.to_obj()


def test_retention_sweep_matches_reference(tmp_path):
    """A failed round past its TTL expires and is cascade-purged: the same
    actions, and the same rows left, in both packages."""
    port = new_sqlite_server(tmp_path / "port.db")
    recipient, committee, agg = _world(port, clerks=2, participants=2)
    assert lifecycle.transition(port.server.aggregation_store, agg.id,
                                ("collecting",), "failed", reason="test")
    ref = _with_reference(tmp_path, port)
    port.server.retention_policy = RetentionPolicy(failed_ttl_s=1.0)
    ref.server.retention_policy = RefRetentionPolicy(failed_ttl_s=1.0)
    later = time.time() + 60.0
    got = lifecycle.RoundSweeper(port.server).sweep_once(now=later)
    want = ref_lifecycle.RoundSweeper(ref.server).sweep_once(now=later)
    assert got == want
    assert [a.get("to") for a in got["actions"]].count("expired") == 1, got
    assert sqlite_row_counts(tmp_path / "port.db") == \
        ref_row_counts(tmp_path / "ref.db")


def _statusz(url):
    with urllib.request.urlopen(f"{url}/statusz") as resp:
        return json.loads(resp.read())


def test_statusz_matches_reference(tmp_path):
    """``sdad --statusz`` on the port serves the reference's document: the
    same keys, the same rounds, fleet health and lease table, and
    ``devprof`` compile totals with the reference's keys. The port's
    registry counts its instrumented stages process-wide, so the test
    opens a fresh observation window: statusz itself runs none."""
    from sda_tpu_torch import obs

    obs.reset_all()
    port, _, _ = _stale_lease(tmp_path)
    ref = _with_reference(tmp_path, port)
    docs = []
    for cls, service in ((SdaHttpServer, port), (RefHttpServer, ref)):
        server = cls(service, bind="127.0.0.1:0", statusz_endpoint=True)
        server.start_background()
        try:
            docs.append(_statusz(server.address))
        finally:
            server.shutdown()
    got, want = docs
    assert got.keys() == want.keys()
    for key in ("store", "rounds", "schedules", "breaker"):
        assert got[key] == want[key], key
    for doc in (got, want):  # ages differ by the time between the calls
        for row in doc["fleet_health"].values():
            row.pop("age_s")
    assert got["fleet_health"] == want["fleet_health"] == {
        "w0": {"seq": 1, "state": "alive"}}
    assert got["lease"].keys() == want["lease"].keys()
    assert got["lease"]["held"] == 1  # granted by this (the port's) server
    assert got["devprof"].keys() == want["devprof"].keys()
    assert got["devprof"]["functions"] == {}
