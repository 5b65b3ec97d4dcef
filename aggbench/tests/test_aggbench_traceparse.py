"""The trace reader on a synthetic Chrome trace: the busy union, the split
by kernel name, the union of host ranges, the rounds that lost events, and
what the host was doing in the longest idle gaps."""

import pytest

from aggbench.traceparse import TraceView, by_name, gaps, union_us


def _x(name, cat, ts, dur, pid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": 1}


def _trace(drop_first_round_k1=False):
    ev = [_x("ProfilerStep", "Trace", 0, 1000)]
    for r, start in enumerate((100, 300)):
        ev.append(_x("aggbench.round", "user_annotation", start, 150))
        ev.append(_x("stream.finale", "user_annotation", start + 120, 30))
        ev.append(_x("cudaMemcpyAsync", "cuda_runtime", start + 121, 28))
        if not (drop_first_round_k1 and r == 0):
            ev.append(_x("void fused_round_columns<3, 4, false>(unsigned "
                         "int const*, long long)", "kernel", start + 10, 20,
                         pid=0))
        ev.append(_x("void (anonymous namespace)::chacha_mask_kernel<1>"
                     "(Key)", "kernel", start + 40, 50, pid=0))
        ev.append(_x("void (anonymous namespace)::chacha_mask_kernel<1>"
                     "(Key)", "kernel", start + 80, 20, pid=0))  # overlaps
        ev.append(_x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
                     start + 125, 20, pid=0))
        # the profiler mirrors a host range on the device lane: not busy
        ev.append(_x("stream.finale", "gpu_user_annotation", start + 120,
                     30, pid=0))
    ev.append(_x("aten::empty", "cpu_op", 255, 35))  # between the rounds
    # a kernel of the warm-up, before the window: left out
    ev.append(_x("void fused_round_columns<3, 4, false>(x)", "kernel", 10, 5,
                 pid=0))
    return {"traceEvents": ev}


def test_union_and_gaps():
    spans = [(0, 10), (5, 20), (30, 40)]
    assert union_us(spans) == 30
    assert union_us(spans, 8, 35) == 17
    assert gaps(spans, -5, 50) == [(-5, 0), (20, 30), (40, 50)]


def test_window_busy_union_and_ranges():
    view = TraceView(_trace(), "aggbench.round", {})
    assert (view.lo, view.hi) == (100, 450)
    assert view.window_us == 350
    # a round: K1 10-30, K3 40-100 (two overlapping launches), copy 125-145
    assert view.busy_us() == pytest.approx(2 * (20 + 60 + 20))
    assert view.range_us("stream.finale") == pytest.approx(60)
    assert view.range_us("aggbench.round") == pytest.approx(300)


def test_split_by_kernel_name():
    view = TraceView(_trace(), "aggbench.round", {})
    split = by_name(view.device)
    assert split == {"fused_round_columns<3, 4, false>": 40,
                     "chacha_mask_kernel<1>": 140,
                     "gpu_memcpy: Memcpy DtoH (Device -> Pageable)": 40}
    assert view.kernel_us(("fused_round_",)) == (40, 2)
    assert view.kernel_us(("chacha_mask_kernel",)) == (140, 2)
    assert view.kernel_us(("residues_kernel",)) == (0, 0)
    top = view.top_device_ops()
    assert top[0] == ["chacha_mask_kernel<1>", pytest.approx(140e-6)]


def test_round_that_lost_events_is_left_out():
    view = TraceView(_trace(drop_first_round_k1=True), "aggbench.round", {})
    assert view.kernel_us(("fused_round_",)) == (20, 1)
    # K3's rounds are whole: both are read
    assert view.kernel_us(("chacha_mask_kernel",)) == (140, 2)


def test_idle_gaps_name_what_the_host_did():
    view = TraceView(_trace(), "aggbench.round", {})
    idle = view.idle_gaps(limit=2)
    # the longest gap lies between the rounds' device work (245 -> 310),
    # the next inside the first round (200 -> 225): the innermost host
    # event around each one's middle
    assert idle == [["aten::empty", pytest.approx(65e-6)],
                    ["aggbench.round", pytest.approx(25e-6)]]
