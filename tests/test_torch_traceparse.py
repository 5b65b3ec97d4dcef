"""utils.traceparse of the port: torch.profiler Chrome traces (synthetic
ones in the profiler's shape, and a real CPU capture with no device
lane)."""

import gzip
import json
import os

import pytest
import torch

from sda_tpu_torch.utils import traceparse


def synthetic_trace():
    """A Chrome trace shaped like a torch.profiler CUDA capture: host ops
    and runtime calls on the process's pid, kernels and copies on the
    device's (pid 0, one tid a stream)."""
    host = 4242
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": host, "tid": 0,
         "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "GPU 0"}},
        # the profiler's own session event spans more than the work
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
         "pid": "Spans", "tid": "PyTorch Profiler", "ts": -5000,
         "dur": 99999},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sum", "pid": host,
         "tid": 1, "ts": 0, "dur": 4000.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": host, "tid": 1, "ts": 10, "dur": 5.0},
        # device lane: 3 launches of K1 + a copy + a memset
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "void fused_round_columns<3, 4, true>(...)",
         "ts": 100, "dur": 900.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "void fused_round_columns<3, 4, true>(...)",
         "ts": 1100, "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "void fused_round_columns<3, 4, true>(...)",
         "ts": 2200, "dur": 1100.0},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7,
         "name": "Memcpy DtoH (Device -> Pageable)", "ts": 3300,
         "dur": 50.0},
        # overlaps the copy on another stream: counted once in the union
        {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 8,
         "name": "Memset (Device)", "ts": 3320, "dur": 80.0},
        # a GPU-side annotation range is not device work
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 9,
         "name": "round", "ts": 0, "dur": 4000.0},
    ]}


def test_device_lane_detection_and_stats():
    tr = synthetic_trace()
    assert traceparse.device_lane_pids(tr) == {0: "GPU 0"}
    stats = traceparse.device_module_stats(tr)
    k1 = "void fused_round_columns<3, 4, true>(...)"
    assert set(stats) == {k1, "Memcpy DtoH (Device -> Pageable)",
                          "Memset (Device)"}
    assert stats[k1] == {"count": 3, "total_us": 3000.0, "median_us": 1000.0}
    assert traceparse.dominant_module(stats) == k1
    assert set(traceparse.device_module_stats(tr, "fused_round")) == {k1}

    # even-length lists take the midpoint average
    tr["traceEvents"].append({"ph": "X", "cat": "kernel", "pid": 0,
                              "tid": 7, "name": k1, "ts": 3500,
                              "dur": 100.0})
    stats = traceparse.device_module_stats(tr)
    assert stats[k1]["count"] == 4
    assert stats[k1]["median_us"] == 950.0  # (900+1000)/2


def test_busy_share_is_the_union_over_the_window():
    # device busy: 900 + 1000 + 1100 + (3300..3400) = 3100 us of the host
    # window 0..4000 (the profiler's session event does not stretch it)
    assert traceparse.busy_share(synthetic_trace()) == pytest.approx(
        3100 / 4000)


def test_lane_without_metadata_is_named_by_pid():
    tr = {"traceEvents": [{"ph": "X", "cat": "kernel", "pid": 3, "tid": 1,
                           "name": "k", "ts": 0, "dur": 1.0}]}
    assert traceparse.device_lane_pids(tr) == {3: "device 3"}
    assert traceparse.busy_share(tr) == 1.0


def test_no_device_lane_is_empty_not_error():
    tr = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "python"}},
        {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1, "name": "aten::mm",
         "ts": 0, "dur": 1.0},
    ]}
    assert traceparse.device_lane_pids(tr) == {}
    assert traceparse.device_module_stats(tr) == {}
    assert traceparse.dominant_module({}) is None
    assert traceparse.busy_share(tr) is None


@pytest.mark.parametrize("suffix", [".json", ".json.gz"])
def test_load_latest_trace_roundtrip(tmp_path, suffix):
    d = tmp_path / "plugins" / "profile"
    d.mkdir(parents=True)
    old = {"traceEvents": []}
    (d / "old.pt.trace.json").write_text(json.dumps(old))
    os.utime(d / "old.pt.trace.json", (1, 1))
    tr = synthetic_trace()
    path = d / f"worker.1.pt.trace{suffix}"
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(tr, f)
    assert traceparse.load_latest_trace(str(tmp_path)) == tr
    assert traceparse.load_latest_trace(str(tmp_path / "empty")) is None


def test_real_cpu_capture_has_no_device_lane(tmp_path):
    """A real torch.profiler capture of CPU work (the CPU activity alone:
    the CUDA one hangs in a CPU-only torch) parses cleanly and reports no
    device lane."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones((64, 64))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (x @ x).sum()
    prof.export_chrome_trace(str(tmp_path / "cpu.json"))
    tr = traceparse.load_latest_trace(str(tmp_path))
    assert tr is not None and "traceEvents" in tr
    assert any(e.get("cat") == "cpu_op" for e in tr["traceEvents"])
    stats = traceparse.device_module_stats(tr)
    assert stats == {}
    assert traceparse.dominant_module(stats) is None
    assert traceparse.busy_share(tr) is None


def test_device_split_by_kernel_name_and_launching_range():
    """Device time by part: kernels by a substring of their name, the rest
    by the host range (a ``record_function``) enclosing the runtime call
    that launched them, matched by correlation id; the device lane's
    mirror of a range (``gpu_user_annotation``) is not a host range."""
    host = 4242
    tr = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "stream.feed",
         "pid": host, "tid": 1, "ts": 0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "stream.feed",
         "pid": 0, "tid": 9, "ts": 300, "dur": 1000.0},
        *({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "pid": host, "tid": 1, "ts": ts, "dur": 5.0,
           "args": {"correlation": c}}
          for c, ts in ((1, 10), (2, 150), (3, 160), (4, 170))),
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "void at::elementwise_kernel<128, 2>(...)", "ts": 300,
         "dur": 40.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "void at::elementwise_kernel<128, 2>(...)", "ts": 400,
         "dur": 7.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "void (anonymous namespace)::chacha_mask_kernel<true, "
                 "true>(...)", "ts": 500, "dur": 600.0,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
         "name": "void fused_round_columns<3, 4, false>(...)", "ts": 1200,
         "dur": 250.0, "args": {"correlation": 4}},
        {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 7,
         "name": "Memset (Device)", "ts": 1500, "dur": 3.0},
    ]}
    assert traceparse.device_split(
        tr, {"K3": "chacha_", "K1": "fused_round"},
        {"block provider": "stream.feed"}) == {
            "K3": 600.0, "K1": 250.0, "block provider": 40.0, "rest": 10.0}
    assert traceparse.device_split(tr, {}, {}) == {"rest": 900.0}
