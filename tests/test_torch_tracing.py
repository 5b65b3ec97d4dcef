"""Twin of ``tests/test_tracing.py`` on the port: span layer semantics, W3C
context propagation across the HTTP seam, trace integrity under adversity
(throttle retries, chaos 500s/drops, lease-reissued clerking jobs), the
Chrome-trace export tree, X-Request-Id correlation, JSON logs joined to
traces, the unified observability reset, and the Prometheus exposition
golden consistency check.

The reference file's recipes run against ``sda_tpu_torch`` with the same
seeds and sizes, the rounds' clients on ``device="cpu"``. Wherever both
packages produce a result from the same input, the two are held equal:
seeded ids, ``traceparent`` headers, merged and exported Chrome traces,
round timelines, JSON log records and the Prometheus exposition.
"""

import json
import logging
import time

import pytest

from sda_tpu import obs as ref_obs
from sda_tpu.utils import metrics as ref_metrics
from sda_tpu.utils.logsetup import JsonFormatter as RefJsonFormatter
from sda_tpu_torch import chaos, obs
from sda_tpu_torch.http import SdaHttpClient, SdaHttpServer
from sda_tpu_torch.server import new_memory_server
from sda_tpu_torch.utils import metrics
from sda_tpu_torch.utils.logsetup import JsonFormatter


@pytest.fixture(autouse=True)
def _clean_slate():
    chaos.reset()
    obs.reset_all()
    ref_obs.reset_all()
    yield
    chaos.reset()
    obs.reset_all()
    obs.seed_ids(None)
    ref_obs.reset_all()
    ref_obs.seed_ids(None)


# ---------------------------------------------------------------------------
# span layer semantics

def test_span_nesting_parents_and_buffer():
    with obs.span("outer", attributes={"k": 1}) as outer:
        assert obs.current_span() is outer
        with obs.span("inner") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
            obs.add_event("tick", n=3)
            obs.set_attribute("marked", True)
        assert obs.current_span() is outer
    assert obs.current_span() is None
    spans = obs.finished_spans()
    assert [s.name for s in spans] == ["inner", "outer"]  # finish order
    inner_, outer_ = spans
    assert outer_.parent_id is None
    assert outer_.attributes["k"] == 1
    assert inner_.attributes["marked"] is True
    assert inner_.events[0]["name"] == "tick"
    assert inner_.events[0]["attributes"] == {"n": 3}
    assert inner_.duration_s is not None and inner_.duration_s >= 0.0


def test_span_error_status_on_exception():
    with pytest.raises(RuntimeError):
        with obs.span("boom"):
            raise RuntimeError("kapow")
    span = obs.finished_spans()[-1]
    assert span.status == "error"
    assert "kapow" in span.attributes["error"]


def test_explicit_remote_parent_adopts_trace():
    remote = obs.SpanContext("ab" * 16, "cd" * 8)
    with obs.span("local-root"):
        with obs.span("adopted", parent=remote) as adopted:
            assert adopted.trace_id == remote.trace_id
            assert adopted.parent_id == remote.span_id


def test_deterministic_ids_under_seed():
    def run(o=obs):
        o.reset_spans()
        with o.span("a"):
            with o.span("b"):
                pass
        return [(s.trace_id, s.span_id) for s in o.finished_spans()]

    obs.seed_ids(1234)
    first = run()
    obs.seed_ids(1234)
    second = run()
    assert first == second
    # the reference draws the same ids from the same seed
    ref_obs.seed_ids(1234)
    assert run(ref_obs) == first
    obs.seed_ids(None)
    assert run() != first  # cryptographically random again


def test_traceparent_roundtrip_and_garbage():
    ctx = obs.SpanContext("0123456789abcdef" * 2, "fedcba9876543210")
    header = obs.format_traceparent(ctx)
    assert header == f"00-{ctx.trace_id}-{ctx.span_id}-01"
    parsed = obs.parse_traceparent(header)
    assert parsed == ctx
    assert ref_obs.format_traceparent(ref_obs.SpanContext(
        ctx.trace_id, ctx.span_id)) == header
    ref_parsed = ref_obs.parse_traceparent(header)
    assert (ref_parsed.trace_id, ref_parsed.span_id) == \
        (parsed.trace_id, parsed.span_id)
    for garbage in (None, "", "nonsense", "00-short-short-01",
                    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",  # zero trace
                    "00-" + "1" * 32 + "-" + "0" * 16 + "-01",  # zero span
                    "zz-" + "1" * 32 + "-" + "2" * 16 + "-01"):
        assert obs.parse_traceparent(garbage) is None, garbage
        assert ref_obs.parse_traceparent(garbage) is None, garbage


def test_job_links_bounded_and_lookup():
    ctx = obs.SpanContext("11" * 16, "22" * 8)
    obs.link_job("job-1", ctx)
    obs.link_job("job-none", None)  # ignored
    assert obs.job_link("job-1") == ctx
    assert obs.job_link("job-none") is None
    assert obs.job_link("never") is None


def test_chrome_trace_export_structure():
    with obs.span("participant.mask"):
        obs.add_event("chaos.fake", kind="error")
    trace = obs.chrome_trace()
    events = trace["traceEvents"]
    metas = [e for e in events if e["ph"] == "M"]
    xs = [e for e in events if e["ph"] == "X"]
    instants = [e for e in events if e["ph"] == "i"]
    assert any(m["args"]["name"] == "participant" for m in metas)
    assert len(xs) == 1 and len(instants) == 1
    x = xs[0]
    assert x["name"] == "participant.mask"
    assert x["dur"] >= 0 and x["ts"] > 0
    assert set(x["args"]) >= {"trace_id", "span_id"}
    assert instants[0]["name"] == "chaos.fake"
    assert instants[0]["args"]["span_id"] == x["args"]["span_id"]
    # the reference exports the same events, but for their times and ids
    with ref_obs.span("participant.mask"):
        ref_obs.add_event("chaos.fake", kind="error")

    def shape(events):
        return sorted((e["ph"], e["name"], json.dumps(
            {k: v for k, v in e.get("args", {}).items()
             if k not in ("trace_id", "span_id")}, sort_keys=True))
            for e in events)

    assert shape(ref_obs.chrome_trace()["traceEvents"]) == shape(events)


def test_merge_chrome_traces_remaps_pids():
    a = {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "ts": 0, "dur": 1}]}
    b = {"traceEvents": [{"name": "y", "ph": "X", "pid": 1, "ts": 0, "dur": 1}]}
    merged = obs.merge_chrome_traces(a, b)
    pids = [e["pid"] for e in merged["traceEvents"]]
    assert len(set(pids)) == 2  # no collision after merge
    assert ref_obs.merge_chrome_traces(a, b) == merged


def test_merge_puts_a_profiler_trace_on_the_span_clock(tmp_path):
    """A ``torch.profiler`` trace counts ``ts`` from its own
    ``baseTimeNanoseconds``; merged, a span and a profiler range opened
    back to back start within 2 ms, and no base is carried over."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("clock.span"):
            with torch.profiler.record_function("clock.range"):
                torch.arange(4096).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    device = json.loads(path.read_text())
    assert "baseTimeNanoseconds" in device
    merged = obs.merge_chrome_traces(obs.chrome_trace(), device)
    assert "baseTimeNanoseconds" not in merged

    def start(name):
        (ts,) = [e["ts"] for e in merged["traceEvents"]
                 if e.get("ph") == "X" and e.get("name") == name]
        return ts

    assert abs(start("clock.range") - start("clock.span")) < 2000.0


def test_merge_leaves_a_trace_without_a_base_unshifted():
    a = {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "ts": 5.5,
                          "dur": 1}]}
    merged = obs.merge_chrome_traces(a)
    assert [e["ts"] for e in merged["traceEvents"]] == [5.5]
    assert ref_obs.merge_chrome_traces(a) == merged


def test_timeline_critical_path_and_slowest():
    def fake(name, span_id, parent_id, start, dur, trace="t1" * 16):
        s = obs.Span(name, trace, span_id, parent_id, "internal", None)
        s.start_s = start
        s.duration_s = dur
        return s

    root = fake("round", "a" * 16, None, 0.0, 10.0)
    fast = fake("load.participant", "b" * 16, "a" * 16, 1.0, 2.0)
    slow = fake("load.participant", "c" * 16, "a" * 16, 2.0, 7.0)
    leaf = fake("http.client GET /x", "d" * 16, "c" * 16, 8.0, 0.9)
    spans = [root, fast, slow, leaf]
    timelines = obs.round_timelines(spans)
    assert len(timelines) == 1
    t = timelines[0]
    assert t["root"] == "round" and t["spans"] == 4
    # critical path follows the child that ENDED last at each level
    assert [p["name"] for p in t["critical_path"]] == [
        "round", "load.participant", "http.client GET /x"]
    exemplars = obs.slowest_spans("load.participant", n=1, spans=spans)
    assert exemplars[0]["span_id"] == "c" * 16
    assert exemplars[0]["critical_path"][0]["duration_ms"] == 7000.0

    # the reference reads the same spans the same way
    def ref_span(s):
        r = ref_obs.Span(s.name, s.trace_id, s.span_id, s.parent_id,
                         "internal", None)
        r.start_s, r.duration_s = s.start_s, s.duration_s
        return r

    ref_spans = [ref_span(s) for s in spans]
    assert ref_obs.round_timelines(ref_spans) == timelines
    assert ref_obs.slowest_spans("load.participant", n=1,
                                 spans=ref_spans) == exemplars


def test_reset_all_clears_every_registry():
    from sda_tpu_torch.utils import phase_report, timed_phase

    metrics.count("reset.test")
    metrics.gauge_set("reset.gauge", 1.0)
    metrics.observe("reset.hist", 0.5)
    with timed_phase("reset.phase"):
        pass
    obs.link_job("reset-job", obs.SpanContext("33" * 16, "44" * 8))
    assert obs.finished_spans() and phase_report()
    obs.reset_all()
    assert obs.finished_spans() == []
    assert phase_report() == {}
    assert metrics.counter_report() == {}
    assert metrics.gauge_report() == {}
    assert metrics.histogram_report() == {}
    assert obs.job_link("reset-job") is None


# ---------------------------------------------------------------------------
# propagation across the HTTP seam

def _server_client(**server_kwargs):
    server = SdaHttpServer(new_memory_server(), bind="127.0.0.1:0",
                           **server_kwargs).start_background()
    client = SdaHttpClient(server.address, token="trace-test-token",
                           max_retries=8, backoff_base=0.01, backoff_cap=0.1)
    return server, client


def _spans_by_name(prefix):
    return [s for s in obs.finished_spans() if s.name.startswith(prefix)]


def test_traceparent_joins_server_to_client_trace():
    server, client = _server_client()
    try:
        with obs.span("op-root") as root:
            assert client.ping().running
    finally:
        server.shutdown()
    attempts = _spans_by_name("http.attempt")
    servers = _spans_by_name("http.server")
    assert attempts and servers
    assert all(s.trace_id == root.trace_id for s in attempts + servers)
    # the server span's parent is the exact attempt that carried the header
    assert servers[0].parent_id in {a.span_id for a in attempts}
    assert servers[0].attributes["http.status"] == 200
    assert servers[0].attributes["http.route"] == "GET:/v1/ping"


def test_trace_survives_429_retry_after_convergence():
    # burst 1 @ 2/s: the second immediate ping is shed with Retry-After
    # and must converge through the hint — in the SAME trace
    server, client = _server_client(rate_limit=2.0, rate_burst=1.0)
    try:
        with obs.span("op-root") as root:
            assert client.ping().running
            assert client.ping().running
    finally:
        server.shutdown()
    assert metrics.counter_report()["http.retry.status_429"] >= 1
    retried = [s for s in _spans_by_name("http.attempt")
               if s.attributes["attempt"] >= 1]
    assert retried, "expected at least one retry attempt span"
    hinted = [s for s in _spans_by_name("http.attempt")
              if "retry_after_s" in s.attributes]
    assert hinted and all(s.attributes["retry_after_s"] >= 0 for s in hinted)
    shed = [s for s in _spans_by_name("http.server")
            if s.attributes.get("http.status") == 429]
    assert shed and all(s.attributes.get("shed") for s in shed)
    for s in _spans_by_name("http.attempt") + _spans_by_name("http.server"):
        assert s.trace_id == root.trace_id


def test_trace_survives_chaos_500_and_drop():
    server, client = _server_client()
    try:
        chaos.configure("http.server.request", error=True, times=1)
        chaos.configure("http.server.response", drop=True, times=1)
        with obs.span("op-root") as root:
            assert client.ping().running
    finally:
        chaos.reset()
        server.shutdown()
    assert metrics.counter_report()["http.retry.recovered"] >= 1
    servers = _spans_by_name("http.server")
    assert all(s.trace_id == root.trace_id for s in servers)
    injected = [ev for s in servers for ev in s.events
                if ev["name"].startswith("chaos.")]
    kinds = {ev["attributes"]["kind"] for ev in injected}
    assert kinds == {"error", "drop"}  # both injections visible in the trace
    # the 500'd attempt and the successful one are siblings under one op
    ops = _spans_by_name("http.client GET /v1/ping")
    assert ops and ops[-1].attributes.get("retries", 0) >= 1


def test_x_request_id_echoed_and_logged():
    import io
    import urllib.request

    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    http_log = logging.getLogger("sda_tpu_torch.http.server")
    http_log.addHandler(handler)
    old_level = http_log.level
    http_log.setLevel(logging.INFO)
    server = SdaHttpServer(new_memory_server(), bind="127.0.0.1:0",
                           trace_log=True).start_background()
    try:
        # minted when absent
        with urllib.request.urlopen(server.address + "/v1/ping") as resp:
            minted = resp.headers.get("X-Request-Id")
            assert minted and len(minted) == 16
        # reused when present
        req = urllib.request.Request(server.address + "/v1/ping",
                                     headers={"X-Request-Id": "my-correlation"})
        with urllib.request.urlopen(req) as resp:
            assert resp.headers.get("X-Request-Id") == "my-correlation"
        # 4xx replies carry the id in the log line
        try:
            urllib.request.urlopen(server.address + "/v1/nonexistent")
        except urllib.error.HTTPError as e:
            assert e.headers.get("X-Request-Id")
    finally:
        server.shutdown()
        http_log.removeHandler(handler)
        http_log.setLevel(old_level)
    lines = buf.getvalue().splitlines()
    assert any("-> 401" in l and "request_id=" in l for l in lines)
    assert any(l.startswith("trace ") for l in lines)  # --trace span lines
    # the request id is recorded on the server span too
    assert any(s.attributes.get("request_id") == "my-correlation"
               for s in _spans_by_name("http.server"))


def test_json_log_format_carries_trace_ids(monkeypatch):
    from sda_tpu_torch.utils.logsetup import configure_logging, log_format

    monkeypatch.setenv("SDA_LOG_FORMAT", "json")
    assert log_format() == "json"
    configure_logging(1)  # must not raise even when already configured
    formatter = JsonFormatter()
    record = logging.LogRecord("sda_tpu_torch.test", logging.INFO, __file__, 1,
                               "hello %s", ("world",), None)
    with obs.span("logged-op") as span:
        obj = json.loads(formatter.format(record))
        assert obj["message"] == "hello world"
        assert obj["level"] == "INFO"
        assert obj["logger"] == "sda_tpu_torch.test"
        assert obj["trace_id"] == span.trace_id
        assert obj["span_id"] == span.span_id
    outside = json.loads(formatter.format(record))
    assert "trace_id" not in outside  # no active span, no stamp
    # the reference's formatter writes the same record with the same keys
    ref_outside = json.loads(RefJsonFormatter().format(record))
    assert set(ref_outside) == set(outside)
    assert {k: v for k, v in ref_outside.items() if k != "ts"} == \
        {k: v for k, v in outside.items() if k != "ts"}


# ---------------------------------------------------------------------------
# full-round trace integrity (real crypto over real HTTP)

def _run_http_round(lease_seconds=None, abandon_once=False):
    """One full additive round over HTTP under a ``round`` root span;
    returns (root_span, revealed_output, expected)."""
    import numpy as np

    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.crypto import MemoryKeystore
    from sda_tpu_torch.protocol import (
        AdditiveSharing,
        Aggregation,
        AggregationId,
        FullMasking,
        SodiumEncryption,
    )

    service = new_memory_server()
    if lease_seconds is not None:
        service.server.clerking_lease_seconds = lease_seconds
    server = SdaHttpServer(service, bind="127.0.0.1:0").start_background()
    try:
        proxy = SdaHttpClient(server.address, token="round-test-token",
                              max_retries=8, backoff_base=0.01,
                              backoff_cap=0.1)

        def new_client():
            keystore = MemoryKeystore()
            agent = SdaClient.new_agent(keystore)
            client = SdaClient(agent, keystore, proxy, device="cpu")
            client.upload_agent()
            return client

        with obs.span("round") as root:
            recipient = new_client()
            recipient_key = recipient.new_encryption_key()
            recipient.upload_encryption_key(recipient_key)
            clerks = []
            for _ in range(3):
                clerk = new_client()
                clerk.upload_encryption_key(clerk.new_encryption_key())
                clerks.append(clerk)
            agg = Aggregation(
                id=AggregationId.random(), title="trace-round",
                vector_dimension=4, modulus=433,
                recipient=recipient.agent.id, recipient_key=recipient_key,
                masking_scheme=FullMasking(433),
                committee_sharing_scheme=AdditiveSharing(share_count=3,
                                                         modulus=433),
                recipient_encryption_scheme=SodiumEncryption(),
                committee_encryption_scheme=SodiumEncryption(),
            )
            recipient.upload_aggregation(agg)
            recipient.begin_aggregation(agg.id)
            inputs = [[1, 2, 3, 4], [10, 20, 30, 40]]
            for row in inputs:
                new_client().participate(row, agg.id)
            recipient.end_aggregation(agg.id)
            if abandon_once:
                chaos.configure("clerk.abandon_job", drop=True, times=1)
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                # the recipient holds a key too, so the election may have
                # put it on the committee — run its chores as well
                for clerk in clerks + [recipient]:
                    clerk.run_chores(-1)
                status = recipient.service.get_aggregation_status(
                    recipient.agent, agg.id)
                if (status and status.snapshots
                        and status.snapshots[0].result_ready
                        and status.snapshots[0].number_of_clerking_results
                        >= 3):
                    break
                time.sleep(0.05)
            output = recipient.reveal_aggregation(agg.id)
        expected = (np.array(inputs).sum(axis=0) % 433).tolist()
        return root, output, expected
    finally:
        chaos.reset()
        server.shutdown()


def _sodium_or_skip():
    from sda_tpu_torch.crypto import sodium

    if not sodium.available():
        pytest.skip("libsodium not present")


def test_round_exports_one_connected_trace(tmp_path):
    """The exported Chrome trace holds participant,
    server, clerk, and recipient spans under ONE trace id with correct
    parent links, and tracing changes no protocol bytes (bit-exact)."""
    _sodium_or_skip()
    root, output, expected = _run_http_round()
    assert output.positive().values.tolist() == expected  # bit-exact

    trace = obs.export_chrome_trace(str(tmp_path / "round.trace.json"))
    reloaded = json.loads((tmp_path / "round.trace.json").read_text())
    assert reloaded == trace
    xs = [e for e in reloaded["traceEvents"] if e["ph"] == "X"]
    by_id = {e["args"]["span_id"]: e for e in xs}
    in_round = [e for e in xs if e["args"]["trace_id"] == root.trace_id]
    roles = {e["name"].split(" ")[0].split(".")[0] for e in in_round}
    assert {"participant", "clerk", "recipient", "server", "http",
            "round"} <= roles
    # every parent link resolves, and walking up from ANY span in the
    # round trace reaches the root
    root_event = next(e for e in in_round
                      if "parent_id" not in e["args"])
    assert root_event["name"] == "round"
    for e in in_round:
        seen = set()
        node = e
        while "parent_id" in node["args"]:
            assert node["args"]["parent_id"] in by_id, node["name"]
            assert node["args"]["span_id"] not in seen  # no cycles
            seen.add(node["args"]["span_id"])
            node = by_id[node["args"]["parent_id"]]
        assert node["args"]["span_id"] == root_event["args"]["span_id"]
    # cross-process link: server spans are children of client attempts
    crossed = [e for e in in_round if e["name"].startswith("http.server")
               and by_id[e["args"]["parent_id"]]["name"] == "http.attempt"]
    assert crossed, "no server span parented to a client attempt"


def test_reissued_clerk_job_parents_to_original_trace():
    """A lease-reissued clerking job (first pull abandoned) must re-join
    the round trace that enqueued it — not start a trace of its own."""
    _sodium_or_skip()
    root, output, expected = _run_http_round(lease_seconds=0.3,
                                             abandon_once=True)
    assert output.positive().values.tolist() == expected
    jobs = [s for s in obs.finished_spans() if s.name == "clerk.job"]
    abandoned = [s for s in jobs if s.attributes.get("abandoned")]
    assert len(abandoned) == 1
    # the reissue: the same job id processed again, successfully
    job_id = abandoned[0].attributes["job"]
    reissues = [s for s in jobs
                if s.attributes["job"] == job_id
                and not s.attributes.get("abandoned")]
    assert reissues, "abandoned job was never reissued"
    assert all(s.trace_id == root.trace_id for s in jobs)
    counters = metrics.counter_report()
    assert counters["server.job.reissued"] >= 1


# ---------------------------------------------------------------------------
# Prometheus exposition golden consistency (satellite)

def test_prometheus_histogram_lines_are_mutually_consistent():
    """_bucket lines must be cumulative and non-decreasing, the +Inf
    bucket must equal _count, and _sum must match the observed total —
    for every histogram, including multi-decade ones."""
    values = {
        "golden.fast": [2e-6, 5e-6, 5e-6, 1e-4],
        "golden.slow": [0.001, 0.5, 0.5, 3.0, 30.0],
    }
    for name, vs in values.items():
        for v in vs:
            metrics.observe(name, v)
            ref_metrics.observe(name, v)
    metrics.count("golden.counter", 7)
    metrics.gauge_set("golden.gauge", 2.5)
    ref_metrics.count("golden.counter", 7)
    ref_metrics.gauge_set("golden.gauge", 2.5)
    text = metrics.prometheus_text()
    # the same observations expose the same text in both packages
    assert ref_metrics.prometheus_text() == text
    assert 'sda_events_total{name="golden.counter"} 7' in text
    assert 'sda_gauge{name="golden.gauge"} 2.5' in text
    import re

    for name, vs in values.items():
        buckets = re.findall(
            rf'sda_histogram_bucket{{name="{name}",le="([^"]+)"}} (\d+)',
            text)
        assert buckets[-1][0] == "+Inf"
        bounds = [float(b) for b, _ in buckets[:-1]]
        counts = [int(c) for _, c in buckets]
        assert bounds == sorted(bounds)
        assert counts == sorted(counts)  # cumulative => non-decreasing
        assert counts[-2] == counts[-1] == len(vs)  # last finite == +Inf
        # every observation is <= some finite bound it was counted under
        assert all(v <= bounds[-1] for v in vs)
        m = re.search(rf'sda_histogram_sum{{name="{name}"}} ([0-9.e+-]+)',
                      text)
        assert m and abs(float(m.group(1)) - sum(vs)) < 1e-9 * max(1, sum(vs))
        m = re.search(rf'sda_histogram_count{{name="{name}"}} (\d+)', text)
        assert m and int(m.group(1)) == len(vs)
        # the report view agrees with the exposition view
        summary = metrics.histogram_report(name)[name]
        assert summary["count"] == len(vs)
        assert abs(summary["sum"] - sum(vs)) < 1e-9 * max(1, sum(vs))
