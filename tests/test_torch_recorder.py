"""The twin of ``tests/test_recorder.py`` on the port: the flight
recorder's spools (rotation, eviction, torn-line tolerance, proc clock
anchors), the multi-process clock-offset merge, round forensics
(``obs/forensics.py``), per-tenant SLO burn rates (``obs/slo.py``), chaos
fault marks and the shared histogram-bucket format, with the same inputs;
then the port's ``sda-trace`` (``cli/tracecli.py``) held to the
reference's over one spool.
"""

import json
import os
import time

import pytest

from sda_tpu_torch import chaos, obs
from sda_tpu_torch.obs import forensics, recorder, slo, timeline, trace
from sda_tpu_torch.utils import metrics


@pytest.fixture(autouse=True)
def _clean_slate():
    recorder.uninstall()
    chaos.reset()
    obs.reset_all()
    yield
    recorder.uninstall()
    chaos.reset()
    obs.reset_all()


# ---------------------------------------------------------------------------
# recorder: segments, rotation, eviction, crash tolerance

def _sealed(root):
    return [s for s in recorder.list_segments(str(root)) if s["sealed"]]


def test_spool_opens_every_segment_with_proc_anchor(tmp_path):
    rec = recorder.install(str(tmp_path), node_id="w0", snapshot_s=0.0)
    with obs.span("outer", attributes={"k": 1}):
        with obs.span("inner"):
            obs.add_event("tick", n=3)
    recorder.uninstall()
    sealed = _sealed(tmp_path)
    assert sealed, "close() must seal the active segment"
    for seg in sealed:
        with open(seg["path"], encoding="utf-8") as f:
            first = json.loads(f.readline())
        assert first["t"] == "proc"
        assert first["pid"] == rec.pid
        assert first["node"] == "w0"
        assert first["wall_s"] > 0 and first["mono_s"] > 0
    records, torn = recorder.read_spool(str(tmp_path))
    assert torn == 0
    spans = [r for r in records if r["t"] == "span"]
    assert {s["name"] for s in spans} == {"outer", "inner"}
    inner = next(s for s in spans if s["name"] == "inner")
    outer = next(s for s in spans if s["name"] == "outer")
    assert inner["trace"] == outer["trace"]
    assert inner["parent"] == outer["span"]
    assert inner["events"][0]["name"] == "tick"
    assert inner["events"][0]["attrs"] == {"n": 3}
    assert outer["attrs"]["k"] == 1
    assert outer["duration_s"] >= inner["duration_s"] >= 0.0


def test_rotation_by_size_and_oldest_sealed_eviction(tmp_path):
    rec = recorder.FlightRecorder(
        str(tmp_path), node_id="w0",
        segment_bytes=4096, max_bytes=8192, snapshot_s=0.0)
    payload = "x" * 120
    for i in range(300):  # ~36 KB >> the 8 KiB directory cap
        rec.record({"t": "span", "name": "s", "i": i, "pad": payload})
    rec.close()
    assert rec.report()["segments_written"] >= 4
    segs = recorder.list_segments(str(tmp_path))
    assert segs and all(s["sealed"] for s in segs)
    # eviction ran: the earliest segments are gone and what remains is
    # bounded by the cap plus at most one freshly-sealed segment of slack
    names = [s["segment"] for s in segs]
    assert f"spool-w0-{rec.pid}-000001.jsonl" not in names
    assert sum(s["bytes"] for s in segs) <= 8192 + 4096 + 1024
    # records survive in the surviving segments, newest kept
    records, torn = recorder.read_spool(str(tmp_path))
    assert torn == 0
    kept = [r["i"] for r in records if r["t"] == "span"]
    assert kept and kept[-1] == 299


def test_rotation_by_age(tmp_path):
    rec = recorder.FlightRecorder(
        str(tmp_path), node_id="w0", segment_age_s=0.05, snapshot_s=0.0)
    rec.record({"t": "span", "name": "a"})
    time.sleep(0.12)
    rec.record({"t": "span", "name": "b"})
    rec.close()
    assert rec.report()["segments_written"] >= 2
    assert len(_sealed(tmp_path)) >= 2


def test_torn_trailing_line_is_skipped_and_tallied(tmp_path):
    rec = recorder.FlightRecorder(str(tmp_path), node_id="w0",
                                  snapshot_s=0.0)
    rec.record({"t": "span", "name": "whole"})
    rec.close()
    seg = _sealed(tmp_path)[0]
    with open(seg["path"], "a", encoding="utf-8") as f:
        f.write('{"t":"span","name":"torn-by-sigkill')  # no newline
    records, torn = recorder.read_spool(str(tmp_path))
    assert torn == 1
    assert [r["name"] for r in records if r["t"] == "span"] == ["whole"]


def test_install_is_idempotent_and_uninstall_detaches_sink(tmp_path):
    rec = recorder.install(str(tmp_path), node_id="w0", snapshot_s=0.0)
    assert recorder.install(str(tmp_path / "elsewhere")) is rec
    assert recorder.installed() is rec
    assert trace.span_sink() == rec.record_span
    recorder.uninstall()
    assert recorder.installed() is None
    assert trace.span_sink() is None
    # spans after uninstall are not spooled
    with obs.span("after"):
        pass
    records, _ = recorder.read_spool(str(tmp_path))
    assert "after" not in {r.get("name") for r in records}


def test_record_is_a_noop_without_recorder(tmp_path):
    recorder.record({"t": "round", "state": "collecting"})  # must not raise
    assert recorder.read_spool(str(tmp_path)) == ([], 0)


def test_record_metrics_spools_full_snapshot(tmp_path):
    rec = recorder.FlightRecorder(str(tmp_path), node_id="w0",
                                  snapshot_s=0.0)
    metrics.count("spool.test.count", 3)
    metrics.observe("spool.test.latency", 0.01)
    metrics.observe("spool.test.latency", 0.02)
    rec.record_metrics(reason="test")
    rec.close()
    records, _ = recorder.read_spool(str(tmp_path))
    snap = next(r for r in records if r["t"] == "metrics")
    assert snap["reason"] == "test"
    assert snap["node"] == "w0" and snap["pid"] == rec.pid
    assert snap["counters"]["spool.test.count"] == 3
    hist = snap["histograms"]["spool.test.latency"]
    assert hist["count"] == 2
    assert hist["buckets"][-1] == ["+Inf", 2]
    assert sum(1 for _ in hist["buckets"]) >= 2


def test_maybe_install_from_env_honors_knobs(tmp_path, monkeypatch):
    monkeypatch.delenv(recorder.RECORDER_DIR_ENV, raising=False)
    assert recorder.maybe_install_from_env() is None
    spool = tmp_path / "spool"
    monkeypatch.setenv(recorder.RECORDER_DIR_ENV, str(spool))
    monkeypatch.setenv(recorder.SEGMENT_BYTES_ENV, "65536")
    monkeypatch.setenv(recorder.SNAPSHOT_ENV, "0")
    rec = recorder.maybe_install_from_env(node_id="env-w")
    assert rec is not None and recorder.installed() is rec
    assert rec.segment_bytes == 65536
    assert rec.node_id == "env-w"
    assert os.path.isdir(str(spool))


# ---------------------------------------------------------------------------
# clock-offset merge (the multi-process timeline satellite)

def test_clock_offsets_keeps_earliest_anchor_per_process():
    anchors = [
        {"t": "proc", "node": "w0", "pid": 1, "wall_s": 1000.0,
         "mono_s": 100.0, "seq": 1},
        # later segment of the SAME process after a wall-clock step:
        # must not shear the timeline — the earliest anchor wins
        {"t": "proc", "node": "w0", "pid": 1, "wall_s": 1500.0,
         "mono_s": 200.0, "seq": 2},
        {"t": "proc", "node": "w1", "pid": 2, "wall_s": 1000.5,
         "mono_s": 5000.0, "seq": 1},
        {"t": "span", "name": "not-an-anchor"},
    ]
    offsets = timeline.clock_offsets(anchors)
    assert offsets == {("w0", 1): 900.0, ("w1", 2): -3999.5}


def test_normalize_span_records_merges_skewed_processes_causally():
    # w0's perf_counter epoch starts near 100, w1's near 5000; raw
    # mono_s order is w0-first even though w1's span happened first
    records = [
        {"t": "proc", "node": "w0", "pid": 1, "wall_s": 1000.0,
         "mono_s": 100.0},
        {"t": "proc", "node": "w1", "pid": 2, "wall_s": 1000.0,
         "mono_s": 5000.0},
        {"t": "span", "name": "w0.later", "node": "w0", "pid": 1,
         "mono_s": 102.0, "duration_s": 0.1, "trace": "t1", "span": "a"},
        {"t": "span", "name": "w1.earlier", "node": "w1", "pid": 2,
         "mono_s": 5001.0, "duration_s": 0.1, "trace": "t1", "span": "b"},
        {"t": "span", "name": "anchorless", "node": "w9", "pid": 9,
         "start_s": 1001.5, "trace": "t1", "span": "c"},
    ]
    normed = timeline.normalize_span_records(records)
    assert [r["name"] for r in normed] == [
        "w1.earlier", "anchorless", "w0.later"]
    assert normed[0]["norm_s"] == pytest.approx(1001.0)
    assert normed[2]["norm_s"] == pytest.approx(1002.0)
    assert normed[1]["norm_s"] == pytest.approx(1001.5)  # wall fallback
    chrome = timeline.chrome_trace_from_records(records)
    lanes = [ev for ev in chrome["traceEvents"]
             if ev.get("ph") == "M" and ev["name"] == "process_name"]
    assert {m["args"]["name"] for m in lanes} == {
        "w0[1]", "w1[2]", "w9[9]"}
    xs = [ev for ev in chrome["traceEvents"] if ev.get("ph") == "X"]
    assert len({ev["pid"] for ev in xs}) == 3
    assert xs[0]["ts"] <= xs[1]["ts"] <= xs[2]["ts"]


# ---------------------------------------------------------------------------
# forensics: spool indexing + explain

def _seg(segment, *records):
    return [dict(r, _segment=segment) for r in records]


def _anchor(segment, node, pid, wall=1000.0, mono=0.0):
    return dict(_segment=segment, t="proc", node=node, pid=pid,
                wall_s=wall, mono_s=mono, seq=1)


def test_spool_dedupes_amended_spans_keeping_longest():
    records = [
        _anchor("seg-a", "w0", 1),
        *_seg("seg-a",
              {"t": "span", "name": "http.server", "trace": "t1",
               "span": "s1", "mono_s": 1.0, "duration_s": 0.001},
              # the amended parked long-poll re-spool: same id, real wait
              {"t": "span", "name": "http.server", "trace": "t1",
               "span": "s1", "mono_s": 1.0, "duration_s": 4.2}),
    ]
    spool = forensics.Spool(records)
    assert len(spool.spans) == 1
    assert spool.spans[0]["duration_s"] == 4.2
    assert spool.spans[0]["node"] == "w0"  # inherited from its segment


def test_resolve_prefix_unique_ambiguous_missing():
    records = [
        _anchor("seg-a", "w0", 1),
        *_seg("seg-a",
              {"t": "round", "aggregation": "aaaa1111", "state": "revealed",
               "mono_s": 1.0},
              {"t": "round", "aggregation": "aaab2222", "state": "failed",
               "mono_s": 2.0}),
    ]
    spool = forensics.Spool(records)
    assert spool.resolve("aaaa") == "aaaa1111"
    assert spool.resolve("aaab2222") == "aaab2222"
    with pytest.raises(KeyError, match="ambiguous"):
        spool.resolve("aa")
    with pytest.raises(KeyError, match="no aggregation"):
        spool.resolve("zz")


def _synthetic_round_spool():
    """Two dead processes' segments narrating one chaotic round."""
    agg = "feedc0de0001"
    server = [
        _anchor("seg-w0", "w0", 11, wall=2000.0, mono=0.0),
        *_seg(
            "seg-w0",
            # ledger
            {"t": "round", "aggregation": agg, "state": "collecting",
             "previous": None, "tenant": "tenant-a", "mono_s": 0.1},
            {"t": "round", "aggregation": agg, "state": "frozen",
             "previous": "collecting", "mono_s": 0.5},
            {"t": "round", "aggregation": agg, "state": "revealed",
             "previous": "frozen", "reason": "reveal", "mono_s": 0.9},
            {"t": "epoch", "action": "minted", "schedule": "hourly",
             "tenant": "tenant-a", "epoch": 3, "aggregation": agg,
             "mono_s": 0.05},
            # three distinct admissions, one replay, one conflict
            {"t": "span", "name": "server.create_participation",
             "trace": "t1", "span": "sp1", "mono_s": 0.2,
             "duration_s": 0.01, "attrs": {"aggregation": agg}},
            {"t": "span", "name": "server.create_participation",
             "trace": "t1", "span": "sp2", "mono_s": 0.21,
             "duration_s": 0.01, "attrs": {"aggregation": agg}},
            {"t": "span", "name": "server.create_participation",
             "trace": "t2", "span": "sp3", "mono_s": 0.22,
             "duration_s": 0.01, "attrs": {"aggregation": agg}},
            {"t": "span", "name": "server.create_participation",
             "trace": "t2", "span": "sp4", "mono_s": 0.23,
             "duration_s": 0.01,
             "attrs": {"aggregation": agg, "replayed": True}},
            {"t": "span", "name": "server.create_participation",
             "trace": "t2", "span": "sp5", "mono_s": 0.24,
             "duration_s": 0.01,
             "attrs": {"aggregation": agg, "conflict": True}},
            # a shed request and a chaos injection inside an open span:
            # fault record AND chaos.* event — must count ONCE
            {"t": "span", "name": "http.server", "trace": "t1",
             "span": "sp6", "mono_s": 0.3, "duration_s": 0.002,
             "attrs": {"shed": "rate"}},
            {"t": "span", "name": "http.server", "trace": "t1",
             "span": "sp7", "mono_s": 0.35, "duration_s": 0.004,
             "attrs": {},
             "events": [{"name": "chaos.store.put", "time_s": 0.001,
                         "attrs": {"kind": "error",
                                   "fault.kind": "error",
                                   "fault.site": "store.put"}}]},
            {"t": "fault", "site": "store.put", "kind": "error",
             "node": "w0", "trace": "t1", "span": "sp7", "mono_s": 0.35},
            # an evicted-record fault surviving only as a span event
            {"t": "span", "name": "http.server", "trace": "t2",
             "span": "sp8", "mono_s": 0.4, "duration_s": 0.004,
             "events": [{"name": "chaos.http.server.request",
                         "time_s": 0.001,
                         "attrs": {"fault.kind": "delay",
                                   "fault.site": "http.server.request"}}]},
            {"t": "span", "name": "clerk.job", "trace": "t1", "span": "sp9",
             "mono_s": 0.6, "duration_s": 0.05,
             "attrs": {"job": "j1", "abandoned": False}},
            {"t": "span", "name": "clerk.job", "trace": "t2",
             "span": "sp10", "mono_s": 0.6, "duration_s": 0.08,
             "attrs": {"job": "j2"}},
            {"t": "metrics", "mono_s": 0.95, "reason": "close",
             "counters": {"http.retry.attempt": 5,
                          "http.retry.status_500": 2,
                          "server.job.reissued": 1}},
        ),
    ]
    client = [
        # skewed client clock: mono epoch 7000, wall 2000.05
        _anchor("seg-sim", "sim", 22, wall=2000.05, mono=7000.0),
        *_seg(
            "seg-sim",
            {"t": "span", "name": "participant.participate", "trace": "t1",
             "span": "sc1", "mono_s": 7000.1, "duration_s": 0.05,
             "attrs": {"aggregation": agg, "retries": 2}},
            {"t": "span", "name": "participant.participate", "trace": "t2",
             "span": "sc2", "mono_s": 7000.1, "duration_s": 0.05,
             "attrs": {"aggregation": agg}},
            {"t": "span", "name": "participant.resume", "trace": "t2",
             "span": "sc3", "mono_s": 7000.2, "duration_s": 0.02,
             "attrs": {"aggregation": agg}},
            {"t": "span", "name": "recipient.reveal", "trace": "t1",
             "span": "sc4", "mono_s": 7000.8, "duration_s": 0.03,
             "status": "ok",
             "attrs": {"aggregation": agg, "output.sha256": "ab" * 32,
                       "output.dim": 4}},
            # noise from a DIFFERENT round: must not leak into the story
            {"t": "span", "name": "participant.participate",
             "trace": "t-other", "span": "sc5", "mono_s": 7000.3,
             "duration_s": 0.01, "attrs": {"aggregation": "other999"}},
            {"t": "metrics", "mono_s": 7000.9, "reason": "close",
             "counters": {"http.retry.attempt": 3}},
        ),
    ]
    return forensics.Spool(server + client, torn=1), agg


def test_explain_reconstructs_round_from_dead_processes():
    spool, agg = _synthetic_round_spool()
    report = forensics.explain(spool, agg[:6])  # prefix resolve
    assert report["aggregation"] == agg
    assert report["tenant"] == "tenant-a"
    assert report["epoch"] == {"schedule": "hourly", "epoch": 3,
                               "action": "minted"}
    assert report["traces"] == ["t1", "t2"]
    assert report["processes"] == ["sim[22]", "w0[11]"]
    assert report["final_state"] == "revealed"
    assert [s["state"] for s in report["states"]] == [
        "collecting", "frozen", "revealed"]
    assert report["states"][-1]["reason"] == "reveal"
    p = report["participations"]
    assert p == {"created": 3, "replayed": 1, "conflicts": 1,
                 "participant_spans": 2, "resumed": 1}
    assert report["retries"]["total"] == 2  # from span attrs
    # by_cause sums the LAST snapshot of each process fleet-wide
    assert report["retries"]["by_cause"]["attempt"] == 8
    assert report["retries"]["by_cause"]["status_500"] == 2
    assert report["sheds"] == 1
    assert report["lease_reissues"] == 1
    # fault record + matching event deduped; event-only fault still counts
    assert len(report["faults"]) == 2
    sites = {f["site"]: f["kind"] for f in report["faults"]}
    assert sites == {"store.put": "error", "http.server.request": "delay"}
    assert [j["job"] for j in report["clerk_jobs"]] == ["j2", "j1"]
    assert report["reveal"]["status"] == "ok"
    assert report["reveal"]["output_sha256"] == "ab" * 32
    assert report["reveal"]["dim"] == 4
    assert report["spans"] == 14  # the other round's span excluded
    assert report["torn_lines"] == 1
    # clock merge places the client reveal INSIDE the server's ledger
    # window despite the 7000s monotonic skew
    states = {s["state"]: s["time_s"] for s in report["states"]}
    reveal_t = spool.norm_time(
        next(s for s in spool.spans if s["name"] == "recipient.reveal"))
    assert states["frozen"] < reveal_t < states["revealed"] + 0.2
    text = forensics.format_explain(report)
    assert f"round {agg}" in text
    assert "collecting -> frozen -> revealed[reveal]" in text
    assert "3 created (1 replayed, 1 conflicts, 1 resumed)" in text
    assert "sha256=" + "ab" * 32 in text
    assert "1 torn spool line(s) skipped" in text


def test_chrome_trace_filters_to_one_round():
    spool, agg = _synthetic_round_spool()
    whole = forensics.chrome_trace(spool)
    one = forensics.chrome_trace(spool, agg[:6])
    count = lambda tr: sum(
        1 for ev in tr["traceEvents"] if ev.get("ph") == "X")
    assert count(whole) == 15
    assert count(one) == 14


def test_explain_over_a_live_spool_end_to_end(tmp_path):
    agg = "live00aggid"
    recorder.install(str(tmp_path), node_id="t0", snapshot_s=0.0)
    recorder.record({"t": "round", "aggregation": agg,
                     "state": "collecting", "previous": None,
                     "tenant": "tenant-live"})
    with obs.span("load.round", attributes={"aggregation": agg}):
        with obs.span("server.create_participation",
                      attributes={"aggregation": agg}):
            pass
    recorder.record({"t": "round", "aggregation": agg,
                     "state": "revealed", "previous": "collecting"})
    recorder.uninstall()  # every process is now "dead"
    spool = forensics.load_spool(str(tmp_path))
    report = forensics.explain(spool, "live0")
    assert report["final_state"] == "revealed"
    assert report["tenant"] == "tenant-live"
    assert report["participations"]["created"] == 1
    assert report["spans"] == 2
    assert report["processes"] == [f"t0[{os.getpid()}]"]


# ---------------------------------------------------------------------------
# SLOs and burn rates

def test_rounds_from_spool_outcomes_and_inflight():
    records = [
        _anchor("seg-a", "w0", 1),
        *_seg("seg-a",
              {"t": "round", "aggregation": "A", "state": "collecting",
               "tenant": "t1", "mono_s": 1.0},
              {"t": "round", "aggregation": "A", "state": "revealed",
               "mono_s": 3.0},
              {"t": "round", "aggregation": "B", "state": "collecting",
               "tenant": "t1", "mono_s": 2.0},
              {"t": "round", "aggregation": "B", "state": "failed",
               "mono_s": 4.0},
              {"t": "round", "aggregation": "C", "state": "collecting",
               "tenant": "t2", "mono_s": 5.0}),
    ]
    rounds = slo.rounds_from_spool(forensics.Spool(records))
    by_agg = {r["aggregation"]: r for r in rounds}
    assert by_agg["A"]["good"] is True
    assert by_agg["A"]["duration_s"] == pytest.approx(2.0)
    assert by_agg["A"]["tenant"] == "t1"
    assert by_agg["B"]["good"] is False
    assert by_agg["B"]["final_state"] == "failed"
    assert by_agg["C"]["good"] is None  # in flight when the fleet died
    report = slo.evaluate(rounds)
    t1 = report["tenants"]["t1"]
    assert (t1["settled"], t1["good"], t1["in_flight"]) == (2, 1, 0)
    assert t1["availability"] == 0.5
    t2 = report["tenants"]["t2"]
    assert t2["settled"] == 0 and t2["in_flight"] == 1
    assert t2["availability"] is None and t2["met"] is None


def _round(tenant, end_s, good, duration_s=0.5):
    return {"aggregation": f"{tenant}-{end_s}", "tenant": tenant,
            "end_s": end_s, "duration_s": duration_s,
            "final_state": "revealed" if good else "failed",
            "good": good, "states": []}


def test_burn_page_requires_both_windows():
    policy = slo.SloPolicy(availability_target=0.9,
                           windows=((10.0, 100.0, 2.0),))
    # recent blip: every round in the last 10 s is bad, but the long
    # window is dominated by older good rounds -> burn high/low -> NO page
    blip = ([_round("t1", 910.0 + i, True) for i in range(20)]
            + [_round("t1", 995.0, False), _round("t1", 999.0, False)])
    report = slo.evaluate(blip, policy, now_s=1000.0)
    (win,) = report["tenants"]["t1"]["windows"]
    assert win["short"]["burn"] >= 2.0
    assert win["long"]["burn"] < 2.0
    assert not win["page"] and report["alerts"] == []
    # sustained burn: both windows hot -> page
    sustained = [_round("t1", 905.0 + 5 * i, False) for i in range(20)]
    report = slo.evaluate(sustained, policy, now_s=1000.0)
    (win,) = report["tenants"]["t1"]["windows"]
    assert win["page"]
    assert report["alerts"] and "t1" in report["alerts"][0]


def test_latency_target_makes_slow_reveals_bad():
    policy = slo.SloPolicy(availability_target=0.9, latency_target_s=1.0,
                           windows=((300.0, 3600.0, 1.0),))
    rounds = [_round("t1", 999.0, True, duration_s=5.0),
              _round("t1", 998.0, True, duration_s=0.2)]
    report = slo.evaluate(rounds, policy, now_s=1000.0)
    (win,) = report["tenants"]["t1"]["windows"]
    assert win["short"]["bad"] == 1 and win["short"]["total"] == 2
    # availability itself is untouched — latency shares only the budget
    assert report["tenants"]["t1"]["availability"] == 1.0
    text = slo.format_slo(report)
    assert "reveal latency <= 1s" in text
    assert "t1:" in text


def test_slo_now_defaults_to_end_of_recorded_history():
    # a spool written yesterday must not read as "no recent errors"
    policy = slo.SloPolicy(availability_target=0.9,
                           windows=((10.0, 100.0, 2.0),))
    rounds = [_round("t1", 50.0, False), _round("t1", 55.0, False)]
    report = slo.evaluate(rounds, policy)
    assert report["now_s"] == 55.0
    (win,) = report["tenants"]["t1"]["windows"]
    assert win["page"]


# ---------------------------------------------------------------------------
# chaos fault marks (the structured-failpoint satellite)

@pytest.mark.chaos
def test_chaos_injection_tags_span_event_and_spools_fault(tmp_path):
    recorder.install(str(tmp_path), node_id="w0", snapshot_s=0.0)
    chaos.set_identity("w0")
    chaos.configure("obs.test.site", delay=0.001, times=1)
    with obs.span("victim") as victim:
        assert chaos.fail("obs.test.site") is not None
    recorder.uninstall()
    chaos.set_identity(None)
    (event,) = [ev for s in obs.finished_spans() for ev in s.events
                if ev["name"] == "chaos.obs.test.site"]
    assert event["attributes"]["fault.kind"] == "delay"
    assert event["attributes"]["fault.site"] == "obs.test.site"
    assert event["attributes"]["kind"] == "delay"  # legacy tag stays
    records, _ = recorder.read_spool(str(tmp_path))
    (fault,) = [r for r in records if r["t"] == "fault"]
    assert fault["site"] == "obs.test.site"
    assert fault["kind"] == "delay"
    assert fault["node"] == "w0"
    assert fault["trace"] == victim.trace_id
    assert fault["span"] == victim.span_id


# ---------------------------------------------------------------------------
# one bucket format: /metrics exposition vs spooled snapshots

def test_label_escape_round_trips():
    tricky = [
        'plain', 'with "quotes"', 'back\\slash', 'new\nline',
        'GET:/v1/agents/{id}', 'mix \\"n\\" match\n\\', 'a\\nb',
        'trailing backslash\\',
    ]
    for s in tricky:
        assert metrics.unescape_label(metrics._escape_label(s)) == s


def test_snapshot_buckets_match_prometheus_le_lines():
    metrics.reset_all()
    for v in (1e-5, 3e-4, 3e-4, 0.002, 0.1, 7.0):
        metrics.observe("bucket.parity", v)
    snap = metrics.snapshot()["histograms"]["bucket.parity"]
    text_rows = []
    for line in metrics.prometheus_text().splitlines():
        if line.startswith('sda_histogram_bucket{name="bucket.parity"'):
            le = line.split('le="', 1)[1].split('"', 1)[0]
            text_rows.append([metrics.unescape_label(le),
                              int(line.rsplit(" ", 1)[1])])
    assert text_rows == snap["buckets"]
    assert snap["buckets"][-1] == ["+Inf", 6]
    assert snap["count"] == 6
    assert snap["sum"] == pytest.approx(sum((1e-5, 3e-4, 3e-4,
                                             0.002, 0.1, 7.0)))


# ---------------------------------------------------------------------------
# sda-trace of the port against the reference's, over one spool

def _live_spool(root, agg):
    """Two recorded processes' worth of one round: a tenant, a
    participation, a chaos mark and the reveal."""
    recorder.install(str(root), node_id="t0", snapshot_s=0.0)
    recorder.record({"t": "round", "aggregation": agg,
                     "state": "collecting", "previous": None,
                     "tenant": "tenant-live"})
    with obs.span("load.round", attributes={"aggregation": agg}):
        with obs.span("server.create_participation",
                      attributes={"aggregation": agg}):
            pass
    recorder.record({"t": "round", "aggregation": agg,
                     "state": "revealed", "previous": "collecting"})
    recorder.uninstall()


@pytest.mark.parametrize("command", [
    ["segments"], ["explain", "live0"], ["timeline", "live0"], ["slo"],
    ["slo", "--availability", "0.5", "--latency", "0.001"]])
def test_trace_cli_matches_reference(tmp_path, capsys, command):
    from sda_tpu.cli import tracecli as ref_cli
    from sda_tpu_torch.cli import tracecli

    _live_spool(tmp_path, "live00aggid")
    argv = ["--spool", str(tmp_path), "--json", *command]
    rc = tracecli.main(argv)
    got = capsys.readouterr()
    ref_rc = ref_cli.main(argv)
    want = capsys.readouterr()
    assert rc == ref_rc == 0
    assert json.loads(got.out) == json.loads(want.out)
    assert got.err == want.err


def test_trace_cli_text_report_and_unknown_round(tmp_path, capsys):
    from sda_tpu.cli import tracecli as ref_cli
    from sda_tpu_torch.cli import tracecli

    _live_spool(tmp_path, "live00aggid")
    for argv in (["--spool", str(tmp_path), "explain", "live0"],
                 ["--spool", str(tmp_path), "explain", "nope"]):
        rc = tracecli.main(argv)
        got = capsys.readouterr()
        assert rc == ref_cli.main(argv)
        want = capsys.readouterr()
        assert (got.out, got.err) == (want.out, want.err)
