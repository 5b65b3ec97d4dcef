"""The twin of ``tests/test_load_admission.py`` on the port: histograms
under contention, the token-bucket/in-flight shedding path, Retry-After
in the client, the /metrics endpoint and the loadgen drills
(``sda_tpu_torch/loadgen``, clients on the CPU), with the same seeds and
sizes; then the port held to the reference: ``latency_report_ms`` on the
same histograms, one closed-loop ``run_load`` against the reference's
on the same seed, and ``ci.sh``'s loadgen smoke through the port's
``sda-sim --load``.
"""

import threading
import time

import pytest
import requests

from sda_tpu_torch import chaos
from sda_tpu.crypto import sodium as ref_sodium
from sda_tpu_torch.http import SdaHttpClient, SdaHttpServer
from sda_tpu_torch.http.admission import AdmissionControl, TokenBucket
from sda_tpu_torch.http.server import route_label
from sda_tpu_torch.protocol import ServerError
from sda_tpu_torch.server import new_memory_server
from sda_tpu_torch.utils import metrics


@pytest.fixture(autouse=True)
def _fresh_metrics():
    metrics.reset_all()
    yield
    metrics.reset_all()


# -- metrics: histograms, gauges, contention --------------------------------

def test_histogram_report_percentiles_ordered_and_bounded():
    for ms in range(1, 1001):  # 1ms .. 1s uniform
        metrics.observe("unit.lat", ms / 1e3)
    s = metrics.histogram_report("unit.")["unit.lat"]
    assert s["count"] == 1000
    assert abs(s["sum"] - sum(range(1, 1001)) / 1e3) < 1e-6
    assert s["min"] == 1e-3 and s["max"] == 1.0
    assert s["p50"] <= s["p95"] <= s["p99"] <= s["max"]
    # log-bucketed quantiles overestimate by at most one bucket (~19%)
    assert 0.5 <= s["p50"] <= 0.5 * 1.2
    assert 0.99 <= s["p99"] <= 0.99 * 1.2


def test_histogram_tiny_and_huge_values_do_not_blow_up():
    metrics.observe("unit.wide", 0.0)
    metrics.observe("unit.wide", 1e-9)
    metrics.observe("unit.wide", 3600.0)
    s = metrics.histogram_report()["unit.wide"]
    assert s["count"] == 3
    assert s["max"] == 3600.0
    assert s["p99"] <= 3600.0 * 1.2


def test_multithreaded_count_and_observe_totals_are_exact():
    """The satellite contract: totals under contention are EXACT — the
    registry takes a real lock, not a racy read-modify-write."""
    threads, per_thread = 8, 2000

    def hammer():
        for i in range(per_thread):
            metrics.count("unit.contended")
            metrics.observe("unit.contended.lat", (i % 100 + 1) / 1e4)

    workers = [threading.Thread(target=hammer) for _ in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    assert metrics.counter_report()["unit.contended"] == threads * per_thread
    hist = metrics.histogram_report()["unit.contended.lat"]
    assert hist["count"] == threads * per_thread
    expected_sum = threads * sum((i % 100 + 1) / 1e4 for i in range(per_thread))
    assert abs(hist["sum"] - expected_sum) < 1e-6


def test_gauges_set_and_max():
    metrics.gauge_set("unit.depth", 3)
    metrics.gauge_set("unit.depth", 1)
    metrics.gauge_max("unit.peak", 5)
    metrics.gauge_max("unit.peak", 2)
    assert metrics.gauge_report("unit.") == {"unit.depth": 1, "unit.peak": 5}


def test_prometheus_text_exposition_format():
    metrics.count("unit.requests", 3)
    metrics.gauge_set("unit.depth", 2)
    metrics.observe("unit.lat", 0.005)
    text = metrics.prometheus_text()
    assert 'sda_events_total{name="unit.requests"} 3' in text
    assert 'sda_gauge{name="unit.depth"} 2' in text
    assert 'sda_histogram_bucket{name="unit.lat",le="+Inf"} 1' in text
    assert 'sda_histogram_count{name="unit.lat"} 1' in text
    # cumulative bucket for a 5ms observation exists with a finite bound
    assert 'sda_histogram_bucket{name="unit.lat",le="0.005' in text


# -- admission primitives ---------------------------------------------------

def test_token_bucket_refill_schedule():
    b = TokenBucket(rate=10.0, burst=2.0, now=100.0)
    assert b.try_take(100.0) == 0.0
    assert b.try_take(100.0) == 0.0
    wait = b.try_take(100.0)  # empty: exactly one token away
    assert wait == pytest.approx(0.1)
    assert b.try_take(100.0 + wait) == 0.0  # honoring the hint succeeds
    assert b.try_take(1000.0) == 0.0  # long idle refills to burst, not more
    assert b.try_take(1000.0) == 0.0
    assert b.try_take(1000.0) > 0.0


def test_admission_control_inflight_and_release():
    ac = AdmissionControl(max_inflight=2)
    assert ac.admit("a") is None
    assert ac.admit("b") is None
    shed = ac.admit("c")
    assert shed is not None and shed.status == 503 and shed.retry_after > 0
    ac.release()
    assert ac.admit("c") is None
    assert metrics.counter_report()["http.throttled.inflight"] == 1
    assert metrics.gauge_report()["http.inflight.peak"] == 2


def test_token_bucket_clamps_sub_token_burst():
    # burst < 1 could never admit yet would promise finite Retry-After
    # hints forever — the clamp keeps the config meaningful
    b = TokenBucket(rate=10.0, burst=0.5, now=0.0)
    assert b.try_take(0.0) == 0.0
    assert b.try_take(0.0) > 0.0


def test_sheds_do_not_pollute_route_latency_histograms():
    srv = _server(rate_limit=5.0, rate_burst=1)
    try:
        codes = [requests.get(srv.address + "/v1/ping").status_code
                 for _ in range(4)]
        assert codes.count(429) == 3
    finally:
        srv.shutdown()
    report = metrics.histogram_report("http.latency.")
    assert report["http.latency.GET:/v1/ping"]["count"] == 1  # served only
    assert report["http.latency.shed"]["count"] == 3


def test_admission_zero_rate_blocks_without_crashing():
    ac = AdmissionControl(rate=0.0)
    shed = ac.admit("a")
    assert shed is not None and shed.status == 429 and shed.retry_after > 0


def test_inflight_shed_does_not_burn_the_rate_token():
    ac = AdmissionControl(max_inflight=1, rate=10.0, burst=2.0)
    assert ac.admit("a") is None          # one token spent, slot taken
    shed = ac.admit("a")
    assert shed is not None and shed.status == 503  # concurrency, not rate
    ac.release()
    # the 503 must not have cost a token: the second token is still there
    assert ac.admit("a") is None


def test_route_templates_cover_every_dispatched_route():
    """Drift tripwire: ROUTE_TEMPLATES is maintained next to the shared
    dispatch table (http/base.py, serving BOTH planes) — a route added to
    dispatch without a template would silently fold its latency into the
    'unmatched' bucket."""
    import inspect
    import re as _re

    from sda_tpu_torch.http import base as base_mod

    src = inspect.getsource(base_mod._dispatch_inner)
    routes = set(_re.findall(r'path == "([^"]+)"', src))
    routes |= {
        pattern.replace("({_ID})", "{id}")
        for pattern in _re.findall(r'm\(rf"([^"]+)"\)', src)
    }
    assert len(routes) >= 15, "dispatch-table parse went stale"
    missing = routes - base_mod.ROUTE_TEMPLATES
    assert not missing, f"routes without a latency template: {missing}"


def test_route_label_collapses_ids_and_bounds_cardinality():
    uid = "3f2a0000-0000-4000-8000-00000000abcd"
    assert route_label("GET", f"/v1/agents/{uid}") == "GET:/v1/agents/{id}"
    assert (route_label("GET", f"/v1/aggregations/{uid}/snapshots/{uid}/result")
            == "GET:/v1/aggregations/{id}/snapshots/{id}/result")
    assert route_label("GET", "/v1/ping") == "GET:/v1/ping"
    assert route_label("GET", "/../../etc/passwd") == "GET:unmatched"
    assert route_label("POST", "/v1/agents/not-an-id") == "POST:unmatched"


# -- server-side shedding over real HTTP ------------------------------------

def _server(**kwargs) -> SdaHttpServer:
    return SdaHttpServer(
        new_memory_server(), bind="127.0.0.1:0", **kwargs
    ).start_background()


def test_rate_limit_sheds_429_with_retry_after_before_store_work():
    srv = _server(rate_limit=5.0, rate_burst=2)
    try:
        codes = [requests.get(srv.address + "/v1/ping").status_code
                 for _ in range(5)]
        assert codes[:2] == [200, 200]
        assert 429 in codes
        shed = requests.get(srv.address + "/v1/ping")
        assert shed.status_code == 429
        assert float(shed.headers["Retry-After"]) > 0.0
        counters = metrics.counter_report()
        assert counters["http.throttled.rate"] >= 3
        # the shed happened BEFORE any service/store work: no server.*
        # counters moved for throttled hits, only http ones
        assert metrics.counter_report("server.") == {}
    finally:
        srv.shutdown()


def test_rate_limit_is_per_agent():
    srv = _server(rate_limit=5.0, rate_burst=1)
    try:
        # distinct agent ids (valid uuids — garbled usernames fall back to
        # the per-address bucket) get distinct buckets: nobody sheds
        agents = [f"00000000-0000-4000-8000-00000000000{i}" for i in range(3)]
        for agent in agents:
            r = requests.get(srv.address + "/v1/ping", auth=(agent, "t"))
            assert r.status_code == 200, agent
        # the same agent again inside the refill window does shed
        r = requests.get(srv.address + "/v1/ping", auth=(agents[0], "t"))
        assert r.status_code == 429
    finally:
        srv.shutdown()


@pytest.mark.chaos
def test_inflight_cap_sheds_503_while_handler_is_busy():
    chaos.reset()
    srv = _server(max_inflight=1)
    try:
        # park one request inside the handler via an injected delay, then
        # probe from a second connection: the cap must shed it with 503
        chaos.configure("http.server.request", delay=0.6, times=1)
        slow = threading.Thread(
            target=lambda: requests.get(srv.address + "/v1/ping")
        )
        slow.start()
        time.sleep(0.2)  # let the slow request take its in-flight slot
        probe = requests.get(srv.address + "/v1/ping")
        slow.join()
        assert probe.status_code == 503
        assert float(probe.headers["Retry-After"]) > 0.0
        assert metrics.counter_report()["http.throttled.inflight"] >= 1
    finally:
        chaos.reset()
        srv.shutdown()


def test_latency_histograms_per_route():
    srv = _server()
    try:
        requests.get(srv.address + "/v1/ping")
        requests.get(srv.address + "/v1/ping")
        requests.get(srv.address + "/v1/definitely-not-a-route")
    finally:
        srv.shutdown()
    report = metrics.histogram_report("http.latency.")
    assert report["http.latency.GET:/v1/ping"]["count"] == 2
    assert report["http.latency.GET:unmatched"]["count"] == 1
    assert report["http.latency.GET:/v1/ping"]["p99"] > 0.0


def test_metrics_endpoint_off_by_default_on_when_enabled():
    srv = _server()
    try:
        assert requests.get(srv.address + "/metrics").status_code == 404
    finally:
        srv.shutdown()
    srv = _server(metrics_endpoint=True)
    try:
        requests.get(srv.address + "/v1/ping")
        r = requests.get(srv.address + "/metrics")
        assert r.status_code == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        assert 'sda_events_total{name="http.request"}' in r.text
        assert 'sda_histogram_bucket{name="http.latency.GET:/v1/ping"' in r.text
    finally:
        srv.shutdown()


# -- client honors Retry-After ----------------------------------------------

def test_client_honors_retry_after_and_converges():
    srv = _server(rate_limit=10.0, rate_burst=1)
    try:
        with SdaHttpClient(srv.address, token="t", max_retries=8,
                           backoff_base=0.01, backoff_cap=0.05) as client:
            for _ in range(4):
                client.ping()  # throttled pings must converge via the hint
        counters = metrics.counter_report()
        assert counters["http.retry.after_hint"] >= 2
        assert counters["http.retry.status_429"] >= 2
        assert counters["http.retry.after_hint"] == counters["http.retry.status_429"]
        assert "http.status.500" not in counters
    finally:
        srv.shutdown()


def test_client_caps_retry_after_at_the_op_deadline():
    srv = _server(rate_limit=0.01, rate_burst=1)  # next token: ~100s away
    try:
        client = SdaHttpClient(srv.address, token="t", max_retries=8,
                               backoff_base=0.01, deadline=0.5)
        client.ping()  # burst token
        t0 = time.monotonic()
        with pytest.raises(ServerError, match="429"):
            client.ping()
        # a naive implementation would sleep the full 100s hint; the
        # deadline must cap it
        assert time.monotonic() - t0 < 5.0
        assert metrics.counter_report()["http.retry.exhausted"] == 1
        client.close()
    finally:
        srv.shutdown()


# -- loadgen smoke (tier-1: tiny N, deterministic seed) ---------------------

def test_loadgen_closed_loop_smoke():
    from sda_tpu_torch.loadgen import LoadProfile, run_load

    report = run_load(LoadProfile(
        participants=6, dim=4, arrivals="closed", concurrency=3, seed=0,
        device="cpu",
        timeout_s=60,
    ))
    assert report["completed"] == 6
    assert report["client_failures"] == 0
    assert report["ready"] and report["exact"], report
    assert report["errors_5xx"] == 0
    assert report["admitted_participations"] == 6
    # non-empty per-route histogram report with sane tails
    lat = report["latency_ms"]
    assert lat, "empty latency report"
    post = lat["POST:/v1/aggregations/participations"]
    assert post["count"] == 6
    assert 0 < post["p50_ms"] <= post["p99_ms"] <= post["max_ms"]
    assert set(report["phases_ms"]) == {"register", "participate"}


def test_loadgen_overload_sheds_429_and_still_exact():
    """The acceptance property at smoke scale: under a forced overload
    profile the server sheds with 429/Retry-After — zero 5xx, zero lost
    participations among admitted requests — and clients converge."""
    from sda_tpu_torch.loadgen import LoadProfile, run_load

    report = run_load(LoadProfile(
        participants=5, dim=4, arrivals="open", target_rps=100.0,
        concurrency=3, seed=1, rate_limit=15.0, rate_burst=2, timeout_s=90,
        device="cpu",
    ))
    assert report["shed_429"] > 0, report
    assert report["errors_5xx"] == 0
    assert report["client_failures"] == 0
    assert report["ready"] and report["exact"], report
    assert report["retries"]["http.retry.after_hint"] > 0
    assert report["throttled"]["http.throttled.rate"] == report["shed_429"]
    assert report["admitted_participations"] == 5


# -- the port held to the reference ------------------------------------------

def test_latency_report_ms_matches_reference():
    """The per-route latency table the load and chaos reports share: the
    same observations in both packages' registries give the same table."""
    from sda_tpu.loadgen import latency_report_ms as ref_report
    from sda_tpu.utils import metrics as ref_metrics
    from sda_tpu_torch.loadgen import latency_report_ms

    ref_metrics.reset_all()
    try:
        for i in range(1, 301):
            for registry in (metrics, ref_metrics):
                registry.observe("http.latency.GET:/v1/ping", i / 1e4)
                if i % 3 == 0:
                    registry.observe("http.latency.POST:/v1/x", i / 1e3)
                registry.observe("other.latency", 1.0)
        table = latency_report_ms()
        assert set(table) == {"GET:/v1/ping", "POST:/v1/x"}
        assert table["POST:/v1/x"]["count"] == 100
        assert table == ref_report()
        assert latency_report_ms("other.") == ref_report("other.")
    finally:
        ref_metrics.reset_all()


@pytest.mark.skipif(not ref_sodium.available(),
                    reason="the reference's libsodium not present")
def test_run_load_matches_reference_on_the_same_seed(monkeypatch):
    """One closed-loop round through both packages on the same seed: the
    same revealed sum (its digest), admissions, request mix by route and
    status, and server counters, exactly; only times differ.

    The request mix depends on the agents' ids, which are random: the
    recipient is a clerk candidate too, and the committee takes the first
    8 of the 9 candidates by id. When the recipient is elected, a
    participant's fetch of the recipient's key also serves its clerk key
    from the client's cache; when its id sorts last and it is left out,
    every participant fetches that key (its agent and its key) apart, and
    the round makes 14 more reads, 12 of them in the load window. So the
    ids are made in order here, rising or falling, and both cases are
    held."""
    import itertools
    import uuid

    from sda_tpu.loadgen import LoadProfile as RefProfile
    from sda_tpu.loadgen import run_load as ref_run_load
    from sda_tpu_torch.loadgen import LoadProfile, run_load

    def routes(report):
        return {route: s["count"] for route, s in report["latency_ms"].items()}

    kw = dict(participants=6, dim=4, arrivals="closed", concurrency=3,
              seed=0, timeout_s=60)
    load_requests = {}
    for case, step in (("elected", 1), ("left out", -1)):
        # the recipient's agent is made first: the lowest id, or the highest
        counter = itertools.count()
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(
            int=(1 << 120) + step * next(counter)))
        ref = ref_run_load(RefProfile(**kw))
        got = run_load(LoadProfile(**kw, device="cpu"))
        assert got["exact"] and ref["exact"], case
        for key in ("output_sha256", "completed", "admitted_participations",
                    "load_requests", "requests", "status_counts", "counters",
                    "codec", "codec_counters", "errors_5xx", "shed_429"):
            assert got[key] == ref[key], (case, key)
        assert routes(got) == routes(ref), case
        assert sum(routes(got).values()) == got["requests"], case
        load_requests[case] = got["load_requests"]
    assert load_requests["left out"] - load_requests["elected"] \
        == 2 * kw["participants"]


def test_ci_loadgen_smoke_through_the_ports_sim(capsys):
    """``ci.sh``'s loadgen smoke (fixed seed, closed loop, zero 5xx, a
    histogram report) through the port's ``sda-sim --load``."""
    import json

    from sda_tpu_torch.cli import sim

    rc = sim.main(["--load", "--participants", "24", "--dim", "4",
                   "--load-arrivals", "closed", "--load-concurrency", "8",
                   "--load-seed", "20260803", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert report["ready"] and report["exact"], report
    assert report["client_failures"] == 0, report
    assert report["errors_5xx"] == 0, report["status_counts"]
    assert report["latency_ms"], "empty per-route histogram report"
    assert report["phases_ms"], "empty phase histogram report"
    assert report["rounds_degraded"] == 0, report
    assert report["rounds_failed"] == 0, report

