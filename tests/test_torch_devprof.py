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


def _registry(profile):
    obj = profile.to_obj()
    return {key: obj[key] for key in ("calls", "compiled_shapes",
                                      "block_shapes", "retraces")}


def _ref_scheme(scheme):
    from sda_tpu import protocol as ref_protocol

    return ref_protocol.LinearSecretSharingScheme.from_obj(scheme.to_obj())


def test_pod_round_one_signature_a_shape_as_the_reference():
    """Two ``SimulatedPod`` rounds of one shape are one signature of
    ``mesh.simpod.round`` in both packages: the pod's collectives, a new
    object every round, key no signature of their own."""
    from sda_tpu import mesh as ref_mesh
    from sda_tpu import obs as ref_obs
    from sda_tpu.protocol import FullMasking as RefFull
    from sda_tpu_torch.mesh import SimulatedPod, make_mesh

    scheme, p = _scheme()
    x = np.random.default_rng(0).integers(0, 1 << 20, size=(8, 48),
                                          dtype=np.int64)
    pod = SimulatedPod(scheme, FullMasking(p),
                       mesh=make_mesh(4, 2, devices=["cpu"] * 8))
    ref_pod = ref_mesh.SimulatedPod(_ref_scheme(scheme), RefFull(p),
                                    mesh=ref_mesh.make_mesh(4, 2))
    ref_obs.reset_all()
    try:
        for seed in range(2):
            pod.aggregate(x, seed=seed)
            ref_pod.aggregate(x)
        want = _registry(ref_devprof.profile("mesh.simpod.round"))
    finally:
        ref_obs.reset_all()
    assert want["compiled_shapes"] == 1
    assert _registry(devprof.profile("mesh.simpod.round")) == want


def test_devscale_round_one_signature_a_shape_as_the_reference():
    """Three ``ModelScaleRound`` rounds of one shape are one signature of
    ``devscale.round`` in both packages."""
    import jax

    from sda_tpu import mesh as ref_mesh
    from sda_tpu import obs as ref_obs
    from sda_tpu.mesh import devscale as ref_devscale
    from sda_tpu.protocol import FullMasking as RefFull
    from sda_tpu_torch.mesh import ModelScaleRound, make_mesh

    scheme, p = _scheme()
    x = np.random.default_rng(1).integers(0, 1 << 20, size=(16, 288),
                                          dtype=np.int64)
    rnd = ModelScaleRound(scheme, FullMasking(p), dim_tile=96,
                          mesh=make_mesh(4, 2, devices=["cpu"] * 8))
    ref_rnd = ref_devscale.ModelScaleRound(
        _ref_scheme(scheme), RefFull(p), mesh=ref_mesh.make_mesh(4, 2),
        dim_tile=96)
    ref_obs.reset_all()
    try:
        for seed in range(3):
            rnd.aggregate(x, seed)
            ref_rnd.aggregate(x, jax.random.PRNGKey(seed))
        want = _registry(ref_devprof.profile("devscale.round"))
    finally:
        ref_obs.reset_all()
    assert want["compiled_shapes"] == 1
    assert _registry(devprof.profile("devscale.round")) == want


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


@pytest.mark.parametrize("lane", ["plain", "k1"])
def test_pod_round_counts_its_operations(lane):
    """With cost capture on, ``mesh.simpod.round`` records the operations
    ``_round_ops`` counts for its shapes (K1's from ``bounds.k1_pipe_ops``
    on the K1 lane) and its tensors' bytes, once a signature."""
    from sda_tpu_torch.mesh import SimulatedPod, make_mesh

    devprof.enable_cost_analysis()
    scheme, p = _scheme()
    pod = SimulatedPod(scheme, FullMasking(p), use_pallas=lane == "k1",
                       mesh=make_mesh(4, 2, devices=["cpu"] * 8))
    x = np.random.default_rng(2).integers(0, 1 << 20, size=(8, 48),
                                          dtype=np.int64)
    for seed in range(2):
        np.testing.assert_array_equal(pod.aggregate(x, seed=seed).numpy(),
                                      x.sum(axis=0) % p)
    (cost,) = devprof.profile("mesh.simpod.round").costs.values()
    # 4 x 2 shards of [2, 24] (B = 8 columns of k = 3), each folded, then
    # two d columns of 8 clerk rows gathered over 4 partials, reconstructed
    # by the [k, r] matrix and unmasked
    fold = 2 * 24 + (bounds.k1_pipe_ops(2, 8, 3, 3 + 4, True) if lane == "k1"
                     else 3 * 2 * 24 + 2 * 2 * 4 * 8 + 2 * 24
                     + 8 * (1 + 3 + 4) * 8)
    k, r = pod._L_host.shape
    reveal = 4 * (8 * 8 + 24) + 24 + k * r * 8
    assert cost["flops"] == 8 * fold + 2 * reveal
    assert cost["bytes_accessed"] == 8 * 48 * 8 + 48 * 8
    block = devprof.roofline(seconds=0.25)
    assert block["flops"] == 2 * cost["flops"]
    assert set(block["phases"]) == {"mesh.simpod.round"}
    assert 0 < block["utilization"] < 1


def test_sim_perf_plane_at_ci_argv(monkeypatch):
    """``ci.sh:688``'s run through the port's ``sda-sim`` on the CPU: a
    roofline of counted operations and bytes with a utilization in (0, 1),
    and ``mesh.simpod.round`` registered as the reference's sim registers
    it (two calls of one signature, the same block shape, no retrace)."""
    import contextlib
    import io
    import json

    from sda_tpu import obs as ref_obs
    from sda_tpu.cli import sim as ref_sim
    from sda_tpu_torch.cli import sim

    monkeypatch.setenv("SDA_SIM_PLATFORM", "cpu")   # as ci.sh runs it
    argv = ["--participants", "16", "--dim", "96", "--clerks", "8",
            "--verify"]
    reports = []
    try:
        for main, extra in ((sim.main, ["--device", "cpu"]),
                            (ref_sim.main, [])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert main([*argv, *extra]) == 0
            reports.append(json.loads(out.getvalue().splitlines()[-1]))
    finally:
        ref_obs.reset_all()
        ref_devprof.enable_cost_analysis(False)
    port, ref = reports
    assert port["exact"] and ref["exact"]
    roof = port["roofline"]
    assert roof["flops"] > 0 and roof["bytes"] > 0
    assert roof["arithmetic_intensity"] > 0
    assert 0 < roof["utilization"] < 1
    assert roof["ops_unit"] == devprof.OPS_UNIT
    assert roof["hbm_peak_bytes"] == 0      # no card: no memory peak
    assert set(roof["phases"]) == {"mesh.simpod.round"}
    fn = port["xla"]["functions"]["mesh.simpod.round"]
    ref_fn = ref["xla"]["functions"]["mesh.simpod.round"]
    assert fn["calls"] == ref_fn["calls"] == 2
    assert fn["compiled_shapes"] == ref_fn["compiled_shapes"] == 1
    assert fn["block_shapes"] == ref_fn["block_shapes"]
    assert fn["retraces"] == ref_fn["retraces"] == 0


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
