"""The launch matcher and the three readers of the finale's and the
padding's ranges, on a synthetic Chrome trace: a device event counts for
the host range its launching call started in (matched by
``correlation``), overlapping events count once, and each reader gives
None where the trace holds none of its ranges."""

import pytest

from aggbench.cell import metric_reader
from aggbench.launches import launched_inside
from aggbench.traceparse import TraceView


def _x(name, cat, ts, dur, pid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": pid, "tid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(pad=True, finale_parts=True):
    """Two rounds of 200 us: a feed that pads (when ``pad``) and launches
    a fill and a copy, an unpadded feed's kernel, and a finale split in
    reveal, copy and store (when ``finale_parts``)."""
    ev = []
    for r, t in enumerate((1000, 1200)):
        c = 100 * r
        ev.append(_x("aggbench.round", "user_annotation", t, 200))
        ev.append(_x("stream.feed", "user_annotation", t, 60))
        if pad:
            ev.append(_x("stream.feed.pad", "user_annotation", t + 5, 20))
            # the mirror of the range on the device lane is no host range
            ev.append(_x("stream.feed.pad", "gpu_user_annotation", t + 5,
                         20, pid=0))
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", t + 6, 2,
                     corr=c + 1))
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", t + 10, 2,
                     corr=c + 2))
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", t + 40, 2,
                     corr=c + 3))
        ev.append(_x("void at::native::FillFunctor", "kernel", t + 30, 10,
                     pid=0, corr=c + 1))
        # overlaps the fill: [t + 35, t + 55) adds 15 us
        ev.append(_x("void at::native::elementwise_kernel", "kernel",
                     t + 35, 20, pid=0, corr=c + 2))
        # launched after the pad range closed
        ev.append(_x("fused_round_columns", "kernel", t + 60, 50, pid=0,
                     corr=c + 3))
        # its launching call is not in the trace
        ev.append(_x("void at::native::FillFunctor", "kernel", t + 115, 5,
                     pid=0, corr=c + 99))
        ev.append(_x("stream.finale", "user_annotation", t + 150, 40))
        if finale_parts:
            ev.append(_x("stream.finale.reveal", "user_annotation", t + 151,
                         2))
            ev.append(_x("stream.finale.copy", "user_annotation", t + 153,
                         10))
            ev.append(_x("stream.finale.store", "user_annotation", t + 163,
                         25))
    return {"traceEvents": ev}


def _view(trace):
    return TraceView(trace, "aggbench.round", {})


def test_matcher_counts_launches_inside_the_range_only():
    trace = _trace()
    inside = launched_inside(trace, "stream.feed.pad")
    names = [e["name"] for e in _view(trace).device if inside(e)]
    assert names == ["void at::native::FillFunctor",
                     "void at::native::elementwise_kernel"] * 2


def test_matcher_without_the_range_matches_nothing():
    trace = _trace(pad=False)
    inside = launched_inside(trace, "stream.feed.pad")
    assert not any(inside(e) for e in _view(trace).device)


def test_matcher_merges_overlapping_ranges():
    trace = {"traceEvents": [
        _x("r", "user_annotation", 0, 10),
        _x("r", "user_annotation", 5, 20),  # another thread's, overlapping
        _x("r", "user_annotation", 40, 5),
        _x("cudaLaunchKernel", "cuda_runtime", 22, 1, corr=1),
        _x("cudaLaunchKernel", "cuda_runtime", 30, 1, corr=2),
        _x("cudaMemcpyAsync", "cuda_runtime", 45, 1, corr=3),
        _x("k", "kernel", 50, 1, pid=0, corr=1),
        _x("k", "kernel", 51, 1, pid=0, corr=2),
        _x("Memcpy HtoD", "gpu_memcpy", 52, 1, pid=0, corr=3),
    ]}
    inside = launched_inside(trace, "r")
    device = [e for e in trace["traceEvents"] if e["pid"] == 0]
    assert [inside(e) for e in device] == [True, False, True]


def test_pad_device_pct_counts_overlapping_events_once():
    view = _view(_trace())
    # a round: fill [30, 40) and copy [35, 55) -> 25 us of 200
    assert metric_reader("pad_device_pct")(view) == pytest.approx(
        100.0 * 2 * 25 / 400)


def test_finale_parts_read_their_ranges():
    view = _view(_trace())
    assert metric_reader("finale_copy_pct")(view) == pytest.approx(
        100.0 * 2 * 10 / 400)
    assert metric_reader("finale_store_pct")(view) == pytest.approx(
        100.0 * 2 * 25 / 400)
    parts = sum(metric_reader(name)(view)
                for name in ("finale_copy_pct", "finale_store_pct"))
    assert parts <= metric_reader("finale_pct")(view)


@pytest.mark.parametrize("name, trace", [
    ("pad_device_pct", _trace(pad=False)),
    ("finale_copy_pct", _trace(finale_parts=False)),
    ("finale_store_pct", _trace(finale_parts=False)),
])
def test_readers_give_none_without_their_ranges(name, trace):
    assert metric_reader(name)(_view(trace)) is None


def test_pad_device_pct_is_none_without_device_launches():
    # a host-only trace (a CPU run): the ranges, but no device events
    trace = _trace()
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e["pid"] != 0]
    assert metric_reader("pad_device_pct")(_view(trace)) is None
