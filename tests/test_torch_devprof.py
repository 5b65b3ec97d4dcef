"""The port's device perf plane (``sda_tpu_torch.obs.devprof``): the
call/shape registry of eager stages (never a compile), counted costs and
the roofline against the card's peaks, nested device-memory peaks, the
watermark report, the ``/statusz`` block, and the streamed driver's "at
most two shapes per axis" — mirroring tests/test_devprof.py, with the
JAX package's roofline math as the reference."""

import numpy as np
import pytest
import requests
import torch

from sda_tpu.obs import devprof as ref_devprof

from sda_tpu_torch import obs
from sda_tpu_torch.benchmarks import bounds
from sda_tpu_torch.fields import numtheory
from sda_tpu_torch.http import SdaHttpServer
from sda_tpu_torch.mesh import StreamingAggregator
from sda_tpu_torch.obs import devprof
from sda_tpu_torch.protocol import FullMasking, PackedShamirSharing
from sda_tpu_torch.server import new_memory_server
from sda_tpu_torch.utils import metrics


@pytest.fixture(autouse=True)
def _fresh_obs(monkeypatch):
    monkeypatch.delenv("SDA_DEVPROF_COST", raising=False)
    obs.reset_all()
    yield
    obs.reset_all()
    devprof.enable_cost_analysis(False)


def _scheme():
    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    return PackedShamirSharing(3, 8, t, p, w2, w3), p


# -- the registry --------------------------------------------------------------

def test_reset_all_clears_devprof_state():
    devprof.profile("unit.fn").calls = 5
    metrics.count("xla.compile.retrace")
    obs.reset_all()
    assert devprof.report() == {}
    assert metrics.counter_report("xla.") == {}


def test_wrappers_built_before_reset_keep_reporting():
    # module-level instrumented functions (fields/sharing.py) are wrapped
    # at import, long before any obs.reset_all(); stats from calls AFTER
    # a reset must land in the fresh registry, not an orphaned profile
    from sda_tpu_torch.fields import sharing

    obs.reset_all()
    sharing.combine(torch.ones((3, 8), dtype=torch.int64), modulus=97)
    prof = devprof.profile("fields.combine")
    assert prof.calls == 1
    assert "fields.combine" in devprof.report()


def test_eager_function_never_counts_compiles():
    eager = devprof.instrument("unit.eager", lambda x: x * 2)
    assert eager(np.ones((2,))) is not None
    assert eager(torch.ones((4,))) is not None
    prof = devprof.profile("unit.eager")
    assert prof.calls == 2 and len(prof.shapes) == 2
    assert prof.compiles == 0 and prof.retraces == 0
    assert metrics.counter_report("xla.compile.retrace") == {}
    assert devprof.compile_totals()["functions"]["unit.eager"] == {
        "calls": 2, "compiles": 0, "retraces": 0, "compiled_shapes": 2,
        "block_shapes": [[2], [4]]}


def test_numbers_are_keyed_by_type_not_value():
    # a seed or an offset is a new value every call: the registry must
    # not grow a "shape" per call (flags and names still key by value)
    step = devprof.instrument("unit.step", lambda x, seed, flag: x)
    for seed in range(5):
        step(torch.ones(3), seed, True)
    step(torch.ones(3), 2.5, False)
    assert devprof.profile("unit.step").calls == 6
    assert len(devprof.profile("unit.step").shapes) == 2


def test_sharing_entry_points_use_the_reference_names():
    """The four entry points of fields/sharing.py register under the names
    the JAX package's do, called the same way in both packages."""
    import jax.numpy as jnp

    from sda_tpu import obs as ref_obs
    from sda_tpu.fields import sharing as ref_sharing
    from sda_tpu_torch.fields import sharing

    s, p = _scheme()
    m = numtheory.share_matrix_for(s)
    r = numtheory.reconstruct_matrix_for(s, tuple(range(8)))
    ref_obs.reset_all()
    try:
        for mod, tensor in ((sharing, lambda a: torch.from_numpy(a)),
                            (ref_sharing, jnp.asarray)):
            x = tensor(np.arange(12, dtype=np.int64))
            mod.packed_share_from_randomness(
                x, tensor(np.zeros((4, 4), np.int64)), m, prime=p,
                secret_count=3)
            mod.additive_share_from_randomness(
                x, tensor(np.zeros((2, 12), np.int64)), modulus=p)
            mod.packed_reconstruct(tensor(np.zeros((8, 4), np.int64)), r,
                                   prime=p, dimension=12)
            mod.combine(tensor(np.zeros((2, 8, 4), np.int64)), modulus=p)
        want = set(ref_devprof.report())
    finally:
        ref_obs.reset_all()
    assert want == {"fields.packed_share", "fields.additive_share",
                    "fields.packed_reconstruct", "fields.combine"}
    assert set(devprof.report()) == want
    assert all(v["calls"] == 1 for v in devprof.report().values())


def test_streaming_at_most_two_shapes_per_axis():
    scheme, p = _scheme()
    agg = StreamingAggregator(scheme, FullMasking(p), participants_chunk=4,
                              dim_chunk=24, device="cpu")
    rng = np.random.default_rng(1)
    # ragged on BOTH axes: 10 = 2x4 + 2 participants, 60 = 2x24 + 12 dims
    x = rng.integers(0, 1 << 10, size=(10, 60), dtype=np.int64)
    out = agg.aggregate(x, seed=3)
    assert (np.asarray(out).astype(object)
            == x.astype(object).sum(axis=0) % p).all()
    steps = devprof.profile("stream.step").block_shapes()
    assert steps, "stream.step never profiled"
    assert devprof.profile("stream.step").calls == 9
    assert len({s[0] for s in steps}) <= 2, steps
    assert len({s[1] for s in steps}) <= 2, steps
    finales = devprof.profile("stream.finale").block_shapes()
    assert devprof.profile("stream.finale").calls == 3
    assert len({s[-1] for s in finales}) <= 2


# -- counted costs and the roofline -------------------------------------------

def test_cost_analysis_off_by_default_records_no_costs():
    assert not devprof.cost_analysis_enabled()
    scheme, p = _scheme()
    agg = StreamingAggregator(scheme, FullMasking(p), participants_chunk=4,
                              dim_chunk=24, device="cpu")
    agg.aggregate(np.ones((8, 48), dtype=np.int64), seed=1)
    assert devprof.profile("stream.step").costs == {}
    assert devprof.roofline()["flops"] == 0


def test_cost_capture_feeds_roofline_block():
    devprof.enable_cost_analysis()
    scheme, p = _scheme()
    agg = StreamingAggregator(scheme, FullMasking(p), participants_chunk=4,
                              dim_chunk=48, device="cpu")
    agg.aggregate(np.ones((8, 48), dtype=np.int64), seed=1)
    step = devprof.profile("stream.step")
    (sig, cost), = step.costs.items()
    assert cost["flops"] == agg._step_ops(torch.zeros((4, 48)))
    # the block (int64), the accumulators in and out
    assert cost["bytes_accessed"] == 4 * 48 * 8 + 2 * (8 * 16 + 48) * 8
    assert cost["hbm_peak_bytes"] == 0      # no card: no memory peak
    block = devprof.roofline(seconds=0.25)
    assert block["flops"] == 2 * cost["flops"] + devprof.profile(
        "stream.finale").totals()["flops"]
    assert block["ops_unit"] == "int32/int64 pipe ops, counted"
    assert 0 < block["utilization"] < 1
    assert set(block["phases"]) == {"stream.step", "stream.finale"}
    assert devprof.hbm_peak_recorded() == 0


@pytest.mark.parametrize("flops,nbytes,seconds", [
    (1000.0, 100.0, 1.0), (5e9, 4e8, 3.2e-3), (1e6, 0.0, None),
    (7.0, 3e9, 0.5)])
def test_roofline_block_matches_reference(flops, nbytes, seconds):
    got = devprof.roofline_block(flops, nbytes, seconds=seconds,
                                 platform="cpu", hbm_peak_bytes=12)
    want = ref_devprof.roofline_block(flops, nbytes, seconds=seconds,
                                      platform="cpu", hbm_peak_bytes=12)
    assert got.pop("ops_unit") == devprof.OPS_UNIT
    assert got == want


def test_roofline_block_math():
    block = devprof.roofline_block(1000.0, 100.0, seconds=1.0,
                                   platform="cpu")
    peaks = block["peaks"]
    attainable = min(peaks["flops_per_s"], 10.0 * peaks["hbm_bytes_per_s"])
    assert block["arithmetic_intensity"] == 10.0
    assert block["attainable_flops_per_s"] == attainable
    assert block["utilization"] == pytest.approx(1000.0 / attainable)


def test_cuda_peaks_come_from_bounds():
    label, peaks = devprof._peaks("cuda")
    assert label == "cuda"
    assert peaks["flops_per_s"] == bounds.PIPE_OPS_PER_S
    assert peaks["hbm_bytes_per_s"] == bounds.HBM_BYTES_PER_S == 3.35e12
    assert "bounds.py" in peaks["source"]
    label, peaks = devprof._peaks("rocm")
    assert label == "rocm"
    assert peaks["flops_per_s"] == devprof.CHIP_PEAKS["cpu"]["flops_per_s"]
    assert "no pinned peaks" in peaks["source"]
    assert "tpu" not in devprof.CHIP_PEAKS


def test_flagship_round_counted_within_the_cuda_roofline():
    """The twin's counted cost of the flagship round (K1's pipe ops, the
    tensors' bytes) against the cuda peaks: at K1's own bound time the
    utilization is exactly 1 (the two counts agree), so any round that
    takes longer reads <= 1, and a reading above 1.05 is a counting bug."""
    from sda_tpu_torch.benchmarks.bench import _round_ops

    scheme, _ = _scheme()
    P, d = 100, 999_999
    B = -(-d // 3)
    ops = _round_ops(scheme)(torch.empty((P, d), device="meta"), None)
    assert ops == bounds.k1_pipe_ops(P, B, 3, 7, True)
    nbytes = P * d * 4 + d * 8
    bound_ms, bound_by, _ = bounds.k1_bound(P, B, 3, 7, True, 11)
    assert bound_by == "operations"
    at_bound = devprof.roofline_block(ops, nbytes, seconds=bound_ms / 1e3,
                                      platform="cuda")
    assert at_bound["utilization"] == pytest.approx(1.0, rel=1e-3)
    # PERF.md's flagship round: ~3.2 ms on the H100
    measured = devprof.roofline_block(ops, nbytes, seconds=3.2e-3,
                                      platform="cuda")
    assert 0 < measured["utilization"] <= 1.05


def test_instrumented_round_records_counted_cost():
    from sda_tpu_torch.benchmarks.bench import _round_ops
    from sda_tpu_torch.fields.fused_round import single_chip_round_pallas

    devprof.enable_cost_analysis()
    scheme, p = _scheme()
    fn = devprof.instrument(
        "bench.round", single_chip_round_pallas(scheme, FullMasking(p),
                                                device="cpu"),
        cost=_round_ops(scheme))
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1 << 20, size=(8, 3003), dtype=np.uint32))
    out = fn(x, torch.Generator().manual_seed(1))
    assert torch.equal(out, x.to(torch.int64).sum(0) % p)
    (cost,) = devprof.profile("bench.round").costs.values()
    assert cost["flops"] == bounds.k1_pipe_ops(8, 1001, 3, 7, True)
    assert cost["bytes_accessed"] == 8 * 3003 * 4 + 3003 * 8


class _FakeAllocator:
    """torch.cuda's one peak counter a device, modelled on the host."""

    def __init__(self):
        self.current = self.peak = 0

    def alloc(self, n):
        self.current += n
        self.peak = max(self.peak, self.current)

    def free(self, n):
        self.current -= n

    def reset(self, _dev=None):
        self.peak = self.current


def test_memory_peaks_of_nested_calls(monkeypatch):
    fake = _FakeAllocator()
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", fake.reset)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda _dev=None: fake.peak)
    dev = torch.device("cuda", 0)
    fake.alloc(1000)                        # before any call: not counted
    fake.free(1000)
    with devprof._MemoryFrame(dev) as outer:
        fake.alloc(300)
        fake.free(300)                      # the outer call's own high mark
        fake.alloc(100)
        with devprof._MemoryFrame(dev) as inner:
            fake.alloc(50)
            fake.free(50)
        fake.free(100)
        with devprof._MemoryFrame(dev) as second:
            fake.alloc(500)                 # above the outer's earlier 300
            fake.free(500)
    assert inner.peak == 150
    assert second.peak == 500
    assert outer.peak == 500
    with devprof._MemoryFrame(dev) as alone:
        fake.alloc(20)
    assert alone.peak == 20


def test_watermark_report():
    rep = devprof.watermark_report(peak_bytes=1 << 28, device="cpu")
    assert rep["watermark_bytes"] == devprof.hbm_watermark("cpu")
    assert rep["within_watermark"]
    assert rep["hbm_watermark_ratio"] == round((1 << 28) / rep[
        "watermark_bytes"], 4)
    empty = devprof.watermark_report(device="cpu")
    assert empty["hbm_peak_bytes"] == 0 and "note" in empty
    prof = devprof.profile("unit.peak")
    prof.shapes[("x",)] = 1
    prof.costs[("x",)] = {"flops": 1, "bytes_accessed": 1,
                          "hbm_peak_bytes": 4096}
    assert devprof.hbm_peak_recorded() == 4096
    assert devprof.watermark_report(device="cpu")["hbm_peak_bytes"] == 4096
    assert devprof.hbm_peak_recorded(names=("other",)) == 0


# -- /statusz ------------------------------------------------------------------

def test_statusz_off_by_default_and_reports_when_enabled():
    from sda_tpu_torch.fields import sharing

    sharing.combine(torch.ones((2, 4), dtype=torch.int64), modulus=97)
    srv = SdaHttpServer(new_memory_server(),
                        bind="127.0.0.1:0").start_background()
    try:
        assert requests.get(srv.address + "/statusz").status_code == 404
    finally:
        srv.shutdown()
    srv = SdaHttpServer(new_memory_server(), bind="127.0.0.1:0",
                        statusz_endpoint=True).start_background()
    try:
        requests.get(srv.address + "/v1/ping")
        r = requests.get(srv.address + "/statusz")
        assert r.status_code == 200
        payload = r.json()
        assert payload["store"] == "memory"
        block = payload["devprof"]
        assert block["functions"]["fields.combine"]["calls"] == 1
        assert block["functions"]["fields.combine"]["compiles"] == 0
        assert "cache" in block
    finally:
        srv.shutdown()
