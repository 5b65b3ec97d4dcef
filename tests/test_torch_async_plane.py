"""The twin of ``tests/test_async_plane.py`` on the port: the async
event-loop HTTP plane and long-poll clerk job delivery, parametrized over
both serving planes (wire parity, the long-poll contract, drain, the
shared ``/statusz`` document, the pickup histogram); then the port's
job-pickup A/B bench (``loadgen/pickup.py``, ``ci.sh``'s recipe at a
smaller size) and its connection storm (``loadgen/connstorm.py``, which
spawns the port's ``sdad``).
"""

from __future__ import annotations

import json
import threading
import time

import pytest
import requests

from sda_tpu_torch import obs
from sda_tpu_torch.client import SdaClient
from sda_tpu_torch.http import SdaHttpClient, server_class
from sda_tpu_torch.protocol import (
    AdditiveSharing,
    Aggregation,
    AggregationId,
    FullMasking,
    InvalidCredentials,
    NotFound,
    Participation,
    ParticipationId,
    ServerError,
    SodiumEncryption,
)
from sda_tpu_torch.protocol import bincodec
from sda_tpu_torch.server import new_memory_server
from sda_tpu_torch.utils import metrics


from torch_util import mock_encryption, new_agent, new_full_agent

PLANES = ("threaded", "async")

TOKEN = "async-plane-test-token"


@pytest.fixture(params=PLANES)
def plane(request):
    return request.param


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.reset_all()
    yield
    obs.reset_all()


def start_server(plane, service=None, **kwargs):
    service = service or new_memory_server()
    server = server_class(plane == "async")(
        service, bind="127.0.0.1:0", **kwargs)
    return server.start_background()


def proxied_world(server, n_clerks=3):
    """The fake-crypto world of test_service, built OVER the wire: a
    committee whose fanned-out jobs carry mock ciphertexts (the broker
    never opens them), so job-delivery mechanics test without libsodium."""
    proxy = SdaHttpClient(server.address, token=TOKEN)
    recipient, recipient_key = new_full_agent(proxy)
    clerks = [new_full_agent(proxy) for _ in range(n_clerks)]
    agg = Aggregation(
        id=AggregationId.random(),
        title="longpoll-test",
        vector_dimension=4,
        modulus=433,
        recipient=recipient.id,
        recipient_key=recipient_key.body.id,
        masking_scheme=FullMasking(433),
        committee_sharing_scheme=AdditiveSharing(share_count=n_clerks,
                                                 modulus=433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    proxy.create_aggregation(recipient, agg)
    from sda_tpu_torch.protocol import Committee

    proxy.create_committee(recipient, Committee(
        aggregation=agg.id,
        clerks_and_keys=[(a.id, k.body.id) for (a, k) in clerks],
    ))
    return proxy, recipient, clerks, agg


def participate_one(proxy, agg, n_clerks=3, tag="p0"):
    p_agent = new_agent()
    proxy.create_agent(p_agent, p_agent)
    participation = Participation(
        id=ParticipationId.random(),
        participant=p_agent.id,
        aggregation=agg.id,
        recipient_encryption=mock_encryption(f"mask-{tag}".encode()),
        clerk_encryptions=[(p_agent.id,
                            mock_encryption(f"{tag}-c{c}".encode()))
                           for c in range(n_clerks)],
    )
    proxy.create_participation(p_agent, participation)
    return p_agent, participation


def snapshot(proxy, recipient, agg):
    from sda_tpu_torch.protocol import Snapshot, SnapshotId

    sid = SnapshotId.random()
    proxy.create_snapshot(recipient, Snapshot(id=sid, aggregation=agg.id))
    return sid


# ---------------------------------------------------------------------------
# wire parity

def test_basic_wire_parity(plane):
    """CRUD + error-mapping smoke on each plane: 200/201, option-None via
    X-Resource-Not-Found, bare-404 NotFound, 401 on bad auth."""
    server = start_server(plane)
    try:
        proxy = SdaHttpClient(server.address, token=TOKEN)
        assert proxy.ping().running
        agent, _key = new_full_agent(proxy)
        assert proxy.get_agent(agent, agent.id).id == agent.id
        from sda_tpu_torch.protocol import AgentId

        assert proxy.get_agent(agent, AgentId.random()) is None
        response = requests.get(server.address + "/v1/nope",
                                auth=(str(agent.id), TOKEN))
        assert response.status_code == 404
        assert "X-Resource-Not-Found" not in response.headers
        bad = SdaHttpClient(server.address, token="wrong-token")
        with pytest.raises(InvalidCredentials):
            bad.get_agent(agent, agent.id)
        # request-id echoed, codec advertised — on both planes
        pong = requests.get(server.address + "/v1/ping")
        assert pong.headers.get("X-Request-Id")
        assert pong.headers.get(bincodec.CODECS_HEADER) == "bin"
    finally:
        server.shutdown()


def test_statusz_documents_match_across_planes():
    """The shared builder (http/base.py): identical key sets, correct
    plane tag, and the lease block's pickup/held fields present — the
    fields fleet-mode aggregation scrapes must not drift."""
    docs = {}
    for plane in PLANES:
        server = start_server(plane, statusz_endpoint=True)
        try:
            docs[plane] = requests.get(server.address + "/statusz").json()
        finally:
            server.shutdown()
    assert set(docs["threaded"]) == set(docs["async"])
    assert docs["threaded"]["plane"] == "threaded"
    assert docs["async"]["plane"] == "async"
    for doc in docs.values():
        assert doc["lease"]["held"] == 0
        assert "pickup_ms" in doc["lease"]
        assert doc["longpoll"]["parked"] == 0


def test_streamed_bin_participation_upload(plane):
    """A binary participation body decodes through the incremental
    FeedDecoder on both planes — same 201, same stored resource."""
    server = start_server(plane)
    try:
        proxy, recipient, clerks, agg = proxied_world(server)
        p_agent = new_agent()
        proxy.create_agent(p_agent, p_agent)
        participation = Participation(
            id=ParticipationId.random(),
            participant=p_agent.id,
            aggregation=agg.id,
            recipient_encryption=mock_encryption(b"m" * 100_000),
            clerk_encryptions=[(p_agent.id, mock_encryption(b"c" * 50_000))
                               for _ in range(3)],
        )
        raw = bincodec.encode_participation(participation)
        response = requests.post(
            server.address + "/v1/aggregations/participations", data=raw,
            headers={"Content-Type": bincodec.CONTENT_TYPE},
            auth=(str(p_agent.id), TOKEN))
        assert response.status_code == 201, response.text
        status = proxy.get_aggregation_status(recipient, agg.id)
        assert status.number_of_participations == 1
        # malformed frame (bad magic, fails on the FIRST fed chunk with
        # most of the body still unread) -> 400, connection stays usable
        session = requests.Session()
        response = session.post(
            server.address + "/v1/aggregations/participations",
            data=b"XXXX" + raw[4:],
            headers={"Content-Type": bincodec.CONTENT_TYPE},
            auth=(str(p_agent.id), TOKEN))
        assert response.status_code == 400
        # keep-alive framing survived the mid-stream error
        assert session.get(server.address + "/v1/ping").status_code == 200
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# long-poll contract

def test_longpoll_empty_wait_expires_with_resource_not_found(plane):
    server = start_server(plane)
    try:
        proxy = SdaHttpClient(server.address, token=TOKEN)
        agent, _ = new_full_agent(proxy)
        t0 = time.monotonic()
        assert proxy.await_clerking_job(agent, agent.id, wait_s=0.5) is None
        elapsed = time.monotonic() - t0
        assert 0.4 <= elapsed < 5.0
        # wait=0 degenerates to the immediate-return path
        t0 = time.monotonic()
        assert proxy.await_clerking_job(agent, agent.id, wait_s=0.0) is None
        assert time.monotonic() - t0 < 0.5
        # a garbled wait is a 400, not a parked request
        response = requests.get(
            server.address + "/v1/clerking-jobs", params={"wait": "bogus"},
            auth=(str(agent.id), TOKEN))
        assert response.status_code == 400
    finally:
        server.shutdown()


def test_longpoll_delivers_job_fanned_out_while_parked(plane):
    """The headline behavior: a clerk parked BEFORE the snapshot exists
    receives its job as soon as fan-out fires the wakeup — far faster
    than any polling interval — and the pickup histogram records it."""
    server = start_server(plane)
    server.sda_service.server.clerking_lease_seconds = 30.0
    try:
        proxy, recipient, clerks, agg = proxied_world(server)
        participate_one(proxy, agg)
        clerk_agent = clerks[0][0]
        got = {}

        def parked_poll():
            got["job"] = proxy.await_clerking_job(clerk_agent,
                                                  clerk_agent.id,
                                                  wait_s=20.0)
            got["at"] = time.monotonic()

        t = threading.Thread(target=parked_poll, daemon=True)
        t.start()
        time.sleep(0.4)  # let the request park server-side
        t0 = time.monotonic()
        snapshot(proxy, recipient, agg)
        t.join(timeout=10)
        assert not t.is_alive()
        assert got["job"] is not None
        assert got["job"].clerk == clerk_agent.id
        # delivered on the wakeup hop, not a polling cadence
        assert got["at"] - t0 < 2.0
        pickup = metrics.histogram_report("server.job.pickup").get(
            "server.job.pickup")
        assert pickup and pickup["count"] >= 1
    finally:
        server.shutdown()


def test_parked_longpoll_holds_admission_slot(plane):
    """``max_inflight`` bounds parked long-polls identically on both
    planes: the admission slot covers the parked time (a parked clerk IS
    in-flight work), so with the cap filled by a parked poll every other
    request sheds 503 until the park resolves — and the slot comes back
    once it does."""
    server = start_server(plane, max_inflight=1)
    try:
        proxy = SdaHttpClient(server.address, token=TOKEN)
        agent, _ = new_full_agent(proxy)
        done = {}

        def park():
            done["job"] = proxy.await_clerking_job(agent, agent.id,
                                                   wait_s=2.0)

        t = threading.Thread(target=park, daemon=True)
        t.start()
        time.sleep(0.5)  # let the long-poll reach its server-side park
        response = requests.get(server.address + "/v1/ping",
                                auth=(str(agent.id), TOKEN))
        assert response.status_code == 503
        assert "Retry-After" in response.headers
        t.join(timeout=10)
        assert not t.is_alive()
        assert done["job"] is None
        response = requests.get(server.address + "/v1/ping",
                                auth=(str(agent.id), TOKEN))
        assert response.status_code == 200
    finally:
        server.shutdown()


def test_longpoll_old_peer_fallback():
    """Against a server without the long-poll route (bare 404) the
    client degrades to the immediate-return poll — transparently and
    permanently for that proxy."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class OldHandler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/v1/clerking-jobs"):
                body = b'{"error": "no such route"}'
            elif self.path.startswith("/v1/aggregations/any/jobs"):
                self.send_response(404)
                self.send_header("X-Resource-Not-Found", "true")
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")
                return
            else:
                body = b"{}"
            self.send_response(404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), OldHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        host, port = httpd.server_address[:2]
        proxy = SdaHttpClient(f"http://{host}:{port}", token=TOKEN)
        agent = new_agent()
        assert proxy.await_clerking_job(agent, agent.id, wait_s=5.0) is None
        assert proxy._peer_longpoll is False
        counters = metrics.counter_report("http.longpoll.")
        assert counters.get("http.longpoll.unsupported") == 1
        # subsequent calls skip the dead route entirely
        assert proxy.await_clerking_job(agent, agent.id, wait_s=5.0) is None
        assert metrics.counter_report("http.longpoll.")[
            "http.longpoll.unsupported"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_inprocess_seam_longpoll_and_clerk_poll():
    """The in-process mirror: SdaServerService.await_clerking_job parks
    on the job wakeup; SdaClient.clerk_poll(wait_s=...) rides it."""
    service = new_memory_server()
    recipient, recipient_key = new_full_agent(service)
    clerks = [new_full_agent(service) for _ in range(3)]
    agg = Aggregation(
        id=AggregationId.random(), title="seam", vector_dimension=4,
        modulus=433, recipient=recipient.id,
        recipient_key=recipient_key.body.id,
        masking_scheme=FullMasking(433),
        committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    service.create_aggregation(recipient, agg)
    from sda_tpu_torch.protocol import Committee, Snapshot, SnapshotId

    service.create_committee(recipient, Committee(
        aggregation=agg.id,
        clerks_and_keys=[(a.id, k.body.id) for (a, k) in clerks]))
    p_agent = new_agent()
    service.create_agent(p_agent, p_agent)
    service.create_participation(p_agent, Participation(
        id=ParticipationId.random(), participant=p_agent.id,
        aggregation=agg.id,
        recipient_encryption=mock_encryption(b"m"),
        clerk_encryptions=[(p_agent.id, mock_encryption(f"c{c}".encode()))
                           for c in range(3)]))

    clerk_agent = clerks[0][0]
    from sda_tpu_torch.crypto import Keystore

    class _NullKeystore(Keystore):
        def put(self, *a, **k):
            raise NotImplementedError

        def get(self, *a, **k):
            return None

    client = SdaClient.__new__(SdaClient)  # no crypto needed for polling
    client.agent = clerk_agent
    client.service = service
    client._dead = False
    got = {}

    def parked():
        got["job"] = client.clerk_poll(wait_s=10.0)
        got["at"] = time.monotonic()

    t = threading.Thread(target=parked, daemon=True)
    t.start()
    time.sleep(0.2)
    t0 = time.monotonic()
    service.create_snapshot(recipient, Snapshot(id=SnapshotId.random(),
                                                aggregation=agg.id))
    t.join(timeout=5)
    assert not t.is_alive()
    assert got["job"] is not None and got["job"].clerk == clerk_agent.id
    assert got["at"] - t0 < 1.0  # wakeup hop, not the 10s budget


# ---------------------------------------------------------------------------
# drain under parked long-polls (satellite): a draining worker must wake
# parked clerks with 503 + Connection: close — not hold them to timeout —
# and still drain with leaked == 0. Raced on both planes.

def test_drain_wakes_parked_longpolls(plane):
    server = start_server(plane)
    try:
        proxy = SdaHttpClient(server.address, token=TOKEN)
        agents = [new_full_agent(proxy)[0] for _ in range(3)]
        results = {}

        def parked(ix, agent):
            # raw request (no retries): the 503 itself is the assertion
            response = requests.get(
                server.address + "/v1/clerking-jobs",
                params={"wait": "30"}, auth=(str(agent.id), TOKEN),
                timeout=20)
            results[ix] = (response.status_code,
                           response.headers.get("Connection"),
                           response.headers.get("Retry-After"))

        threads = [threading.Thread(target=parked, args=(ix, agent),
                                    daemon=True)
                   for ix, agent in enumerate(agents)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if server.statusz()["longpoll"]["parked"] >= 3:
                break
            time.sleep(0.02)
        assert server.statusz()["longpoll"]["parked"] >= 3
        t0 = time.monotonic()
        summary = server.drain(grace_s=10.0)
        drain_wall = time.monotonic() - t0
        for t in threads:
            t.join(timeout=10)
        assert all(not t.is_alive() for t in threads)
        # woken immediately — nowhere near the 30s park budget
        assert drain_wall < 8.0
        assert summary["leaked"] == 0
        assert len(results) == 3
        for status, connection, retry_after in results.values():
            assert status == 503
            assert (connection or "").lower() == "close"
            assert retry_after is not None
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# run_clerk loop + relay Retry-After satellite

class _FlakyService:
    """await_clerking_job-less service whose poll alternates transient
    ServerError (with a Retry-After hint) and empty."""

    def __init__(self):
        self.polls = 0

    def get_clerking_job(self, caller, clerk):
        self.polls += 1
        if self.polls == 1:
            error = ServerError("brownout")
            error.retry_after = 0.05
            raise error
        return None


def test_run_clerk_absorbs_transients_and_deadline():
    service = _FlakyService()
    client = SdaClient.__new__(SdaClient)
    client.agent = new_agent()
    client.service = service
    client._dead = False
    t0 = time.monotonic()
    processed = client.run_clerk(wait_s=0.0, poll_interval=0.05,
                                 deadline=0.6)
    assert processed == 0
    assert 0.5 <= time.monotonic() - t0 < 5.0
    assert service.polls >= 3  # kept polling through the transient
    assert metrics.counter_report("clerk.").get("clerk.poll.transient") == 1


class _DeadTransportService:
    """Transport whose retry budget keeps exhausting on a refused
    connection: polls raise the raw OSError family (what requests'
    ConnectionError is) until the 'worker' comes back."""

    def __init__(self, outage_polls):
        self.polls = 0
        self.outage_polls = outage_polls

    def get_clerking_job(self, caller, clerk):
        self.polls += 1
        if self.polls <= self.outage_polls:
            raise ConnectionRefusedError("connection refused")
        return None


def test_run_clerk_survives_transport_outage():
    """A restarting worker's refused connections (raw OSError out of the
    transport once ITS retries exhaust) must not kill the clerk daemon —
    the loop backs off and resumes polling when the worker returns."""
    service = _DeadTransportService(outage_polls=2)
    client = SdaClient.__new__(SdaClient)
    client.agent = new_agent()
    client.service = service
    client._dead = False
    processed = client.run_clerk(wait_s=0.0, poll_interval=0.02,
                                 deadline=0.5)
    assert processed == 0
    assert service.polls > 2  # polled THROUGH the outage and beyond it


class _OldPeerService:
    """Transport whose long-poll fallback already tripped: the waiter
    exists but returns immediately (no server-side park)."""

    def __init__(self):
        self.polls = 0

    def longpoll_supported(self):
        return False

    def await_clerking_job(self, caller, clerk, wait_s=0.0):
        return self.get_clerking_job(caller, clerk)

    def get_clerking_job(self, caller, clerk):
        self.polls += 1
        return None


def test_run_clerk_paces_against_old_peer():
    """Once the transport's old-peer fallback trips, empty polls return
    instantly — run_clerk must supply the polling cadence itself, not
    busy-spin at the server."""
    service = _OldPeerService()
    client = SdaClient.__new__(SdaClient)
    client.agent = new_agent()
    client.service = service
    client._dead = False
    processed = client.run_clerk(wait_s=30.0, poll_interval=0.1,
                                 deadline=0.8)
    assert processed == 0
    # jittered ~0.1s cadence inside a 0.8s deadline: a handful of polls,
    # not an unthrottled storm
    assert 2 <= service.polls <= 30


class _ClampedLongpollService:
    """Claims long-poll (waiter present, fallback never tripped) but the
    server clamped the wait to zero: every 'park' returns instantly."""

    def __init__(self):
        self.polls = 0

    def await_clerking_job(self, caller, clerk, wait_s=0.0):
        self.polls += 1
        return None

    def get_clerking_job(self, caller, clerk):
        return self.await_clerking_job(caller, clerk)


def test_run_clerk_paces_when_longpoll_wait_clamped_to_zero():
    """A server with SDA_LONGPOLL_MAX=0 answers empty immediately while
    still looking long-poll-capable — run_clerk must notice the poll
    did not actually park and supply the cadence itself."""
    service = _ClampedLongpollService()
    client = SdaClient.__new__(SdaClient)
    client.agent = new_agent()
    client.service = service
    client._dead = False
    processed = client.run_clerk(wait_s=30.0, poll_interval=0.1,
                                 deadline=0.8)
    assert processed == 0
    # jittered ~0.1s cadence inside 0.8s: a handful of polls, not a storm
    assert 2 <= service.polls <= 30


def test_await_masked_honors_retry_after_and_deadline():
    """Relay satellite: the await_masked poll loop must back off on the
    server's Retry-After hint (not its own fixed cadence) and never
    sleep past the remaining deadline."""
    from sda_tpu_torch.client import relay
    from sda_tpu_torch.protocol import RoundExpired

    class _BrownoutService:
        def __init__(self):
            self.polls = 0

        def get_round_status(self, caller, aggregation):
            self.polls += 1
            error = ServerError("shedding")
            error.retry_after = 0.1
            raise error

    client = SdaClient.__new__(SdaClient)
    client.agent = new_agent()
    client.service = _BrownoutService()
    t0 = time.monotonic()
    with pytest.raises(RoundExpired):
        # poll_interval is huge: only the Retry-After hint can explain
        # multiple polls inside the 0.7s deadline
        relay.await_masked(client, AggregationId.random(),
                           deadline=0.7, poll_interval=30.0)
    wall = time.monotonic() - t0
    assert wall < 5.0  # capped at the remaining deadline, not 30s
    assert client.service.polls >= 3
    assert metrics.counter_report("relay.").get(
        "relay.await.transient", 0) >= 3


# ---------------------------------------------------------------------------
# shared granted-lease sweep (satellite): one implementation, both planes

def test_granted_lease_sweep_shared_and_statusz_held(plane):
    server = start_server(plane, statusz_endpoint=True)
    core = server.sda_service.server if plane == "async" \
        else server.httpd.sda_service.server
    core.clerking_lease_seconds = 0.2
    try:
        proxy, recipient, clerks, agg = proxied_world(server)
        participate_one(proxy, agg)
        snapshot(proxy, recipient, agg)
        clerk_agent = clerks[0][0]
        job = proxy.get_clerking_job(clerk_agent, clerk_agent.id)
        assert job is not None
        assert core.held_lease_count() == 1
        time.sleep(0.3)  # lease lapses
        assert core.held_lease_count() == 0  # sweep dropped it
        assert requests.get(server.address + "/statusz").json()[
            "lease"]["held"] == 0
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# W3C context over the async seam + observability-endpoint exemptions
# (flight-recorder plane satellites: the cross-process joins that let
# sda-trace explain stitch a round from many processes' spools)

def test_traceparent_joins_parked_longpoll_pickup(plane):
    """A clerk's long-poll carries its traceparent across the wire; the
    server span joins the clerk's trace even when the request PARKS and
    resolves on a wakeup hop — and the recorded server-span duration
    covers the parked time (the async plane amends the span after its
    deferred completion), so a forensics timeline shows the real wait."""
    server = start_server(plane)
    server.sda_service.server.clerking_lease_seconds = 30.0
    try:
        proxy, recipient, clerks, agg = proxied_world(server)
        participate_one(proxy, agg)
        clerk_agent = clerks[0][0]
        got = {}

        def parked_poll():
            with obs.span("clerk.pickup-root") as root:
                got["trace"] = root.trace_id
                got["job"] = proxy.await_clerking_job(
                    clerk_agent, clerk_agent.id, wait_s=20.0)

        t = threading.Thread(target=parked_poll, daemon=True)
        t.start()
        time.sleep(0.4)  # let the request park server-side
        snapshot(proxy, recipient, agg)  # fan-out fires the wakeup
        t.join(timeout=10)
        assert not t.is_alive()
        assert got["job"] is not None
        joined = [s for s in obs.finished_spans()
                  if s.name.startswith("http.server")
                  and s.trace_id == got["trace"]]
        assert joined, "server spans must join the clerk's trace"
        parked = max(joined, key=lambda s: s.duration_s or 0.0)
        assert parked.attributes["http.route"].startswith("GET:")
        assert (parked.duration_s or 0.0) >= 0.3
    finally:
        server.shutdown()


def test_metrics_statusz_admission_and_tracing_exempt_under_load(plane):
    """/metrics and /statusz must answer during the exact overload they
    diagnose: with the rate limiter drained so ordinary requests shed
    429, every scrape still lands 200 — and none of them mint a server
    span (a scrape loop must not churn the ring buffer or the spools)."""
    server = start_server(plane, metrics_endpoint=True,
                          statusz_endpoint=True,
                          rate_limit=0.001, rate_burst=1.0)
    try:
        # burn the single admission token, then prove the limiter bites
        statuses = [requests.get(server.address + "/v1/ping").status_code
                    for _ in range(4)]
        assert 429 in statuses
        for _ in range(20):
            m = requests.get(server.address + "/metrics")
            assert m.status_code == 200
            assert "sda_events_total" in m.text
            z = requests.get(server.address + "/statusz")
            assert z.status_code == 200
            assert "admission" in z.json()
        scraped = [s for s in obs.finished_spans()
                   if "/metrics" in s.name or "statusz" in s.name]
        assert scraped == [], "observability endpoints must not be traced"
    finally:
        server.shutdown()


# -- the pickup bench and the connection storm of the port -------------------

def test_pickup_bench_longpoll_beats_polling():
    """``ci.sh``'s job-pickup A/B at 2 snapshots a mode: both modes reveal
    bit-exactly and the long-poll enqueue->lease p99 sits well below the
    polling baseline's on the same fixed-seed round."""
    from sda_tpu_torch.loadgen import PickupProfile, run_pickup_bench

    record = run_pickup_bench(PickupProfile(
        snapshots=2, poll_interval=0.25, wait_s=10, seed=20260803,
        device="cpu"))
    assert record["exact"] is True, record
    assert record["samples"] >= 16, record
    assert record["value"] is not None and record["value"] > 0, record
    assert record["speedup_p99"] and record["speedup_p99"] >= 2.0, record


def test_connstorm_holds_connections_on_the_ports_sdad():
    """``ci.sh``'s connection storm at 200 connections: the port's
    ``sdad`` worker serves every connection on the async plane, no 5xx,
    bounded RSS and a clean drain."""
    from sda_tpu_torch.loadgen import ConnstormProfile, run_connstorm

    record = run_connstorm(ConnstormProfile(connections=200, waves=1))
    assert record["ok"] is True, record
    assert record["errors_5xx"] == 0, record["statuses"]
    assert record["transport_failures"] == 0, record
    assert record["connect_failures"] == 0, record
    assert record["leaked"] == 0, record["drain"]
    assert record["value"] == 200, record
    assert record["rss_bounded"] is True, record
