"""The port's devscale plane (``sda_tpu_torch.mesh.devscale``,
``sda_tpu_torch.loadgen.devscale``, ``sda_tpu_torch.obs.devprof``) against
the JAX package's: the stream schedule equals the reference's;
``DeviceTileCombiner`` equals ``mod_combine`` and the reference's combiner
bit for bit; the watermark's overrides; the sink feeding the streamed
round; a protocol round whose clerks fold on device tiles
(``SDA_CLERK_DEVICE_TILES=1``, on the CPU) reveals what the host fold
reveals; the watermark tile rule at 8-byte lanes (at budget 2W the
reference's tile at W) with the per-device share; ``ModelScaleRound`` on
both lanes, exact and equal to the reference's XLA lane; and
``run_devscale``'s record at drill dims."""

import numpy as np
import pytest
import torch

from sda_tpu import mesh as ref_mesh
from sda_tpu import protocol as ref_proto
from sda_tpu.crypto.sharing import mod_combine as ref_mod_combine
from sda_tpu.loadgen import devscale as ref_loadgen
from sda_tpu.mesh import devscale as ref_devscale

from sda_tpu_torch.crypto.sharing import mod_combine
from sda_tpu_torch.fields import fused_round, numtheory
from sda_tpu_torch.loadgen import DevScaleProfile, run_devscale
from sda_tpu_torch.loadgen import devscale as loadgen
from sda_tpu_torch.mesh import (
    DeviceTileCombiner,
    DeviceTileSink,
    ModelScaleRound,
    StreamingAggregator,
    bytes_per_dim_column,
    make_mesh,
    stream_schedule,
    synthetic_block_provider32,
    synthetic_device_block_provider32,
    watermark_dim_tile,
)
from sda_tpu_torch.obs import devprof
from sda_tpu_torch.protocol import (
    AdditiveSharing,
    ChaChaMasking,
    FullMasking,
    LinearMaskingScheme,
    LinearSecretSharingScheme,
    NoMasking,
    PackedShamirSharing,
)
from sda_tpu_torch.utils import metrics

T, P29, W2, W3 = numtheory.generate_packed_params(3, 8, 28)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many small tensor ops: with one intra-op thread
    they do not spin against the suite's other workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fast_scheme():
    return PackedShamirSharing(3, 8, T, P29, W2, W3)


def _ref(obj):
    """The reference package's twin of a port scheme (same wire object)."""
    if isinstance(obj, LinearMaskingScheme):
        return ref_proto.LinearMaskingScheme.from_obj(obj.to_obj())
    return ref_proto.LinearSecretSharingScheme.from_obj(obj.to_obj())


SCHEMES = {
    "flagship": fast_scheme(),
    "packed433": PackedShamirSharing(3, 8, 4, 433, 354, 150),
    "additive": AdditiveSharing(share_count=8, modulus=433),
}
MASKINGS = {
    "none": lambda m: NoMasking(),
    "full": FullMasking,
    "chacha": lambda m: ChaChaMasking(m, 4096, 128),
}


def _modulus(s):
    return getattr(s, "prime_modulus", None) or s.modulus


# -- the stream schedule --------------------------------------------------------

@pytest.mark.parametrize("args", [
    (10, 250, 8, 96, 48), (23, 100, 4, 24, 24), (7, 33, 3, 12, 3),
    (5, 12, 64, 3 << 20, 3), (10_000, 10_000_008, 250, 3 << 20, 24),
    (1, 1, 1, 1, 1), (9, 100, 4, 36, 3), (11, 100, 4, 48, 24),
])
def test_stream_schedule_equals_reference(args):
    """The port's schedule is the reference's without its uniform_tail."""
    sched = stream_schedule(*args)
    assert sched == ref_devscale.stream_schedule(*args, uniform_tail=False)
    P, d, pc, dc, grain = args
    assert len(sched) == -(-P // pc) * -(-d // dc)
    assert all(d_size % grain == 0 and d1 - d0 <= d_size < d1 - d0 + grain
               for _, _, d0, d1, d_size in sched)


def test_stream_schedule_drive_order():
    sched = stream_schedule(10, 250, 8, 96, 48)
    assert sched[0] == (0, 8, 0, 96, 96)
    assert sched[1] == (8, 10, 0, 96, 96)
    assert sched[-1] == (8, 10, 192, 250, 96)  # 58 columns -> grain 48


# -- hbm_watermark ---------------------------------------------------------------

def test_hbm_watermark_env_override(monkeypatch):
    monkeypatch.setenv("SDA_HBM_WATERMARK", str(123456789))
    assert devprof.hbm_watermark("cpu") == 123456789
    monkeypatch.setenv("SDA_HBM_WATERMARK", "not a number")
    assert devprof.hbm_watermark("cpu") == int(
        devprof.HBM_WATERMARK_DEFAULTS["cpu"] * 0.8)
    monkeypatch.delenv("SDA_HBM_WATERMARK")
    default = devprof.hbm_watermark("cpu")
    assert 0 < default <= devprof.HBM_WATERMARK_DEFAULTS["cpu"]


@pytest.mark.parametrize("fraction,want", [("0.5", 0.5), ("2", 1.0),
                                           ("0.01", 0.05), ("junk", 0.8)])
def test_hbm_watermark_fraction(monkeypatch, fraction, want):
    monkeypatch.delenv("SDA_HBM_WATERMARK", raising=False)
    monkeypatch.setenv("SDA_HBM_WATERMARK_FRACTION", fraction)
    assert devprof.hbm_watermark("cpu") == int((1 << 30) * want)


def test_hbm_watermark_resolves_the_device(monkeypatch):
    monkeypatch.delenv("SDA_HBM_WATERMARK", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        devprof.hbm_watermark()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceTileCombiner(433)


# -- the device tile combiner ----------------------------------------------------

def test_device_tile_combiner_matches_mod_combine():
    p = P29
    rng = np.random.default_rng(13)
    vecs = [rng.integers(0, p, size=1000).astype(np.int64)
            for _ in range(9)]
    c = DeviceTileCombiner(p, dim_tile=192, device="cpu")  # 5x192 + 40
    c.fold(np.stack(vecs[:4]))
    c.fold(np.stack(vecs[4:8]))
    c.fold(vecs[8])  # single-vector bundle
    assert c.folded == 3 and c._plan_t.n_tiles == 6
    np.testing.assert_array_equal(c.result(), mod_combine(vecs, p, "cpu"))
    ref = ref_devscale.DeviceTileCombiner(p, dim_tile=192)
    ref.fold(np.stack(vecs[:4]))
    ref.fold(np.stack(vecs[4:8]))
    ref.fold(vecs[8])
    np.testing.assert_array_equal(c.result(), ref.result())
    np.testing.assert_array_equal(c.result(), ref_mod_combine(vecs, p))


@pytest.mark.parametrize("modulus", [433, P29, (1 << 61) - 1])
def test_device_tile_combiner_unreduced_inputs(modulus):
    """Paillier-premixed clerk batches decrypt to UNREDUCED sums: the
    device fold canonicalizes exactly like mod_combine."""
    rng = np.random.default_rng(14)
    hi = min(10 * modulus, 1 << 62)
    vecs = [rng.integers(0, hi, size=50).astype(np.int64) for _ in range(3)]
    c = DeviceTileCombiner(modulus, dim_tile=32, device="cpu")
    for v in vecs:
        c.fold(v)
    np.testing.assert_array_equal(c.result(), mod_combine(vecs, modulus,
                                                          "cpu"))
    np.testing.assert_array_equal(c.result(), ref_mod_combine(vecs, modulus))


def test_device_tile_combiner_empty_and_dim_guard():
    c = DeviceTileCombiner(433, device="cpu")
    assert c.result().size == 0 and c.folded == 0
    c.fold(np.ones((2, 10), dtype=np.int64))
    with pytest.raises(ValueError, match="bundle dim"):
        c.fold(np.ones((2, 11), dtype=np.int64))


def test_device_tile_combiner_watermark_sized_tile(monkeypatch):
    monkeypatch.setenv("SDA_HBM_WATERMARK", str(1 << 20))
    c = DeviceTileCombiner(P29, device="cpu")
    c.fold(np.ones((4, 100_000), dtype=np.int64))
    # (2 * 4 + 2) int64 lanes a column, 25% slack
    assert c._dim_tile == (1 << 20) // 100
    assert c._plan_t.n_tiles == -(-100_000 // c._dim_tile)
    np.testing.assert_array_equal(
        c.result(), np.full(100_000, 4, dtype=np.int64))


# -- the host -> device sink -----------------------------------------------------

@pytest.mark.parametrize("masking", sorted(MASKINGS))
def test_sink_fed_streamed_round_bit_exact_and_prefetched(masking):
    s = fast_scheme()
    p = s.prime_modulus
    host = synthetic_block_provider32(p, seed=9)

    def make():
        return StreamingAggregator(s, MASKINGS[masking](p),
                                   participants_chunk=8, dim_chunk=96,
                                   device="cpu")

    agg = make()
    metrics.reset_counters()
    sink = DeviceTileSink(host, 20, 250, agg.participants_chunk,
                          agg.dim_chunk, dtype=np.int64, device="cpu")
    out_sink = agg.aggregate_blocks(sink.provider(), 20, 250, 11)
    out_direct = make().aggregate_blocks(host, 20, 250, 11)
    np.testing.assert_array_equal(out_sink, out_direct)
    np.testing.assert_array_equal(
        out_sink, host(0, 20, 0, 250).astype(np.int64).sum(axis=0) % p)
    counters = metrics.counter_report("devscale.sink.")
    assert counters.get("devscale.sink.hit", 0) == 9  # 3 p-chunks x 3 tiles
    assert counters.get("devscale.sink.miss", 0) == 0


def test_sink_out_of_order_request_degrades_to_direct_decode():
    host = synthetic_block_provider32(433, seed=1)
    metrics.reset_counters()
    sink = DeviceTileSink(host, 8, 96, 8, 48, device="cpu")
    get = sink.provider()
    blk = np.asarray(get(0, 8, 48, 96))
    np.testing.assert_array_equal(blk, np.asarray(host(0, 8, 48, 96)))
    assert metrics.counter_report("devscale.sink.").get(
        "devscale.sink.miss") == 1
    first = get(0, 8, 0, 48)  # the predicted first block: a device tile
    assert isinstance(first, torch.Tensor)
    np.testing.assert_array_equal(first.numpy(), host(0, 8, 0, 48))


# -- the clerk's device leg ------------------------------------------------------

def _protocol_round(aggregation, inputs):
    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.crypto import MemoryKeystore
    from sda_tpu_torch.server import new_memory_server

    service = new_memory_server()

    def client():
        keystore = MemoryKeystore()
        return SdaClient(SdaClient.new_agent(keystore), keystore, service,
                         device="cpu")

    recipient = client()
    key = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(key)
    aggregation = aggregation.replace(recipient=recipient.agent.id,
                                      recipient_key=key)
    recipient.upload_aggregation(aggregation)
    clerks = [client() for _ in range(
        aggregation.committee_sharing_scheme.output_size)]
    for clerk in clerks:
        clerk_key = clerk.new_encryption_key()
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk_key)
    recipient.begin_aggregation(aggregation.id)
    for x in inputs:
        participant = client()
        participant.upload_agent()
        participant.participate(x, aggregation.id)
    recipient.end_aggregation(aggregation.id)
    for worker in [recipient] + clerks:
        worker.run_chores(-1)
    return recipient.reveal_aggregation(aggregation.id).positive().values


@pytest.mark.parametrize("sharing_kind", ["packed", "additive"])
def test_clerk_device_tiles_equal_the_host_fold(monkeypatch, sharing_kind):
    from sda_tpu_torch.crypto import sharing
    from sda_tpu_torch.protocol import (Aggregation, AggregationId, AgentId,
                                        EncryptionKeyId, SodiumEncryption)

    d = 300
    scheme = (fast_scheme() if sharing_kind == "packed"
              else AdditiveSharing(share_count=3, modulus=P29))
    aggregation = Aggregation(
        id=AggregationId.random(), title="device tiles", vector_dimension=d,
        modulus=P29, recipient=AgentId.random(),
        recipient_key=EncryptionKeyId.random(),
        masking_scheme=FullMasking(P29), committee_sharing_scheme=scheme,
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption())
    inputs = np.random.default_rng(3).integers(0, 1 << 20, size=(4, d))
    monkeypatch.setattr(sharing, "HOST_PATH_MAX", 0)
    monkeypatch.delenv("SDA_CLERK_DEVICE_TILES", raising=False)
    host_fold = _protocol_round(aggregation, inputs)
    monkeypatch.setenv("SDA_CLERK_DEVICE_TILES", "1")
    metrics.reset_counters()
    folds = []
    real_fold = DeviceTileCombiner.fold

    def counted(self, rows):
        folds.append(np.asarray(rows).shape)
        return real_fold(self, rows)

    monkeypatch.setattr(DeviceTileCombiner, "fold", counted)
    tiles_fold = _protocol_round(aggregation.replace(
        id=AggregationId.random()), inputs)
    np.testing.assert_array_equal(tiles_fold, inputs.sum(axis=0) % P29)
    np.testing.assert_array_equal(tiles_fold, host_fold)
    assert len(folds) == scheme.output_size  # one bundle a clerk
    assert metrics.counter_report("clerk.device_tiles.").get(
        "clerk.device_tiles.bundle") == scheme.output_size


# -- the watermark tile rule -------------------------------------------------------

#: the reference's test grid of the tile rule (tests/test_devscale.py):
#: budgets, resident participants, mesh shapes, plus the dim clamp
BUDGETS = (1, 1 << 20, 1 << 26, 1 << 34)
CHUNKS = (8, 64)
SHAPES = ((4, 2), (8, 1), (2, 4))


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("masking", sorted(MASKINGS))
def test_bytes_per_dim_column_is_twice_the_reference(scheme, masking):
    """The port's residues are int64: a column costs exactly twice the
    reference's 4-byte-lane count."""
    s = SCHEMES[scheme]
    mask = MASKINGS[masking](_modulus(s))
    for rows in (1, 2, 3, 8, 64):
        assert bytes_per_dim_column(s, mask, rows) == \
            2 * ref_devscale.bytes_per_dim_column(_ref(s), _ref(mask), rows)
    assert bytes_per_dim_column(s, FullMasking(_modulus(s)), 8) > \
        bytes_per_dim_column(s, NoMasking(), 8) > 0


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("masking", sorted(MASKINGS))
def test_watermark_tile_at_2w_is_the_reference_tile_at_w(scheme, masking):
    s = SCHEMES[scheme]
    mask = MASKINGS[masking](_modulus(s))
    for budget in BUDGETS:
        for pc in CHUNKS:
            for p_shards, d_shards in SHAPES:
                for dim in (None, 1000, 10_000_008):
                    kw = dict(participants_chunk=pc, p_shards=p_shards,
                              d_shards=d_shards, dim=dim)
                    assert watermark_dim_tile(
                        s, mask, watermark_bytes=2 * budget, **kw) == \
                        ref_devscale.watermark_dim_tile(
                            _ref(s), _ref(mask), watermark_bytes=budget, **kw)


def test_watermark_tile_scales_with_budget_and_stays_on_grain():
    s = fast_scheme()
    mask = FullMasking(s.prime_modulus)
    kw = dict(participants_chunk=8, p_shards=4, d_shards=2)
    small = watermark_dim_tile(s, mask, watermark_bytes=1 << 20, **kw)
    big = watermark_dim_tile(s, mask, watermark_bytes=1 << 26, **kw)
    grain = 24 * 2  # lcm(k=3, 8 chacha words) x d_shards
    assert small % grain == 0 and big % grain == 0 and big > small
    crowded = watermark_dim_tile(s, mask, participants_chunk=64, p_shards=4,
                                 d_shards=2, watermark_bytes=1 << 20)
    assert crowded < small
    assert watermark_dim_tile(s, mask, watermark_bytes=1, **kw) == grain
    assert watermark_dim_tile(s, mask, watermark_bytes=1 << 34, dim=1000,
                              **kw) == -(-1000 // 48) * 48


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_watermark_tile_per_device_share(shards):
    """Shards placed on one device share its memory: each plans under the
    watermark divided by the shards on the device."""
    s = fast_scheme()
    mask = FullMasking(s.prime_modulus)
    kw = dict(participants_chunk=8, p_shards=4, d_shards=2)
    W = 68_000_000_000
    assert watermark_dim_tile(s, mask, watermark_bytes=W,
                              shards_per_device=shards, **kw) == \
        watermark_dim_tile(s, mask, watermark_bytes=W // shards, **kw)


def test_model_scale_round_default_tile_takes_the_device_share(monkeypatch):
    monkeypatch.setenv("SDA_HBM_WATERMARK", str(1 << 24))
    s = fast_scheme()
    mask = FullMasking(s.prime_modulus)
    shared = ModelScaleRound(s, mask, mesh=make_mesh(4, 2,
                                                     devices=["cpu"] * 8))
    assert shared.dim_tile == watermark_dim_tile(
        s, mask, participants_chunk=8, p_shards=4, d_shards=2,
        watermark_bytes=(1 << 24) // 8)
    split = ModelScaleRound(s, mask, mesh=make_mesh(
        4, 2, devices=["cpu"] * 4 + ["meta"] * 4))
    assert split.dim_tile == watermark_dim_tile(
        s, mask, participants_chunk=8, p_shards=4, d_shards=2,
        watermark_bytes=(1 << 24) // 4)
    assert split.dim_tile > shared.dim_tile
    assert shared.dim_tile % shared._grain == 0


# -- ModelScaleRound ------------------------------------------------------------------

def _msr(scheme, mask, shape, **kw):
    return ModelScaleRound(scheme, mask, mesh=make_mesh(
        *shape, devices=["cpu"] * 8), **kw)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (8, 1)])
@pytest.mark.parametrize("masking", sorted(MASKINGS))
@pytest.mark.parametrize("lane", ["plain", "k1"])
def test_model_scale_round_exact(mesh_shape, masking, lane):
    """Ragged: P off the p axis, dim off the tile grain AND the mesh
    grain; both lanes equal the column sum and (plain lane, no ChaCha:
    the reference's tier-1 cut) the JAX package's XLA lane."""
    import jax

    s = fast_scheme()
    p = s.prime_modulus
    mask = MASKINGS[masking](p)
    x = np.random.default_rng(1).integers(0, 1 << 20, size=(13, 250),
                                          dtype=np.int64)
    r = _msr(s, mask, mesh_shape, dim_tile=96, use_pallas=lane == "k1")
    out = r.aggregate(x, 2)
    assert out.dtype == torch.int64 and out.shape == (250,)
    np.testing.assert_array_equal(out.numpy(), x.sum(axis=0) % p)
    if lane == "plain" and masking != "chacha":
        ref = ref_devscale.ModelScaleRound(
            _ref(s), _ref(mask), mesh=ref_mesh.make_mesh(*mesh_shape),
            dim_tile=96)
        assert ref.dim_tile == r.dim_tile
        np.testing.assert_array_equal(
            np.asarray(ref.aggregate(x, jax.random.PRNGKey(2))), out.numpy())


@pytest.mark.parametrize("masking", sorted(MASKINGS))
@pytest.mark.parametrize("lane", ["plain", "k1"])
def test_model_scale_round_ragged_tile_without_a_copy(monkeypatch, masking,
                                                      lane):
    """A shard of 264 columns in tiles of 96 ends in a ragged 72-wide tile:
    on every lane the round gives the reference's aggregate (its XLA lane,
    which pads the input once) and the column sum. On the K1 lane the
    ragged tile reaches the kernel that first reads it at its own width,
    with the tile's width to pad to (K8's residues; K3's mask op for
    ChaCha masks)."""
    import jax

    from sda_tpu_torch.mesh import simpod

    s = fast_scheme()
    p = s.prime_modulus
    mask = MASKINGS[masking](p)
    seen = []
    real_k8, real_k3 = simpod.residues_int32, \
        simpod.chacha_device.mask_residues_derived

    def k8(x, sp, width=None):
        seen.append(("K8", x.shape[1], width))
        return real_k8(x, sp, width=width)

    def k3(*args, **kw):
        seen.append(("K3", args[4].shape[1], kw.get("width")))
        return real_k3(*args, **kw)

    monkeypatch.setattr(simpod, "residues_int32", k8)
    monkeypatch.setattr(simpod.chacha_device, "mask_residues_derived", k3)
    x = np.random.default_rng(12).integers(0, 1 << 20, size=(16, 528),
                                           dtype=np.int64)
    r = _msr(s, mask, (4, 2), dim_tile=192, use_pallas=lane == "k1")
    out = r.aggregate(x, 9).numpy()
    np.testing.assert_array_equal(out, x.sum(axis=0) % p)
    ref = ref_devscale.ModelScaleRound(
        _ref(s), _ref(mask), mesh=ref_mesh.make_mesh(4, 2), dim_tile=192)
    np.testing.assert_array_equal(
        np.asarray(ref.aggregate(x, jax.random.PRNGKey(9))), out)
    if lane == "k1":
        kernel = "K3" if masking == "chacha" else "K8"
        widths = [(cols, width) for name, cols, width in seen
                  if name == kernel]
        # 8 shards x 3 tiles; the last tile of each shard 72 wide
        assert sorted(widths) == sorted([(96, 96)] * 16 + [(72, 96)] * 8)


def test_model_scale_round_one_k1_call_a_shard_a_tile(monkeypatch):
    s = fast_scheme()
    p = s.prime_modulus
    calls = []
    real = fused_round.fused_mask_share_combine

    def k1(x_cols, *args, **kw):
        calls.append(tuple(x_cols.shape))
        return real(x_cols, *args, **kw)

    monkeypatch.setattr(fused_round, "fused_mask_share_combine", k1)
    r = _msr(s, FullMasking(p), (4, 2), dim_tile=96, use_pallas=True)
    x = np.random.default_rng(3).integers(0, 1 << 20, size=(16, 288))
    np.testing.assert_array_equal(r.aggregate(x, 5).numpy(),
                                  x.sum(axis=0) % p)
    # local shard 144 columns in tiles of 48: 3 tiles x 8 shards
    assert calls == [(4, 3, 16)] * 24


def test_model_scale_round_quorum_reveal():
    s = fast_scheme()
    p = s.prime_modulus
    survivors = tuple(range(s.reconstruction_threshold))
    x = np.random.default_rng(4).integers(0, 1 << 20, size=(8, 192))
    for pallas in (False, True):
        r = _msr(s, FullMasking(p), (4, 2), dim_tile=96,
                 surviving_clerks=survivors, use_pallas=pallas)
        np.testing.assert_array_equal(r.aggregate(x, 6).numpy(),
                                      x.sum(axis=0) % p)


def test_model_scale_round_validation():
    with pytest.raises(ValueError, match="model-scale step requires"):
        _msr(SCHEMES["packed433"], None, (4, 2), use_pallas=True)
    with pytest.raises(ValueError, match="must be divisible by the p axis"):
        _msr(fast_scheme(), None, (3, 2))


# -- run_devscale ---------------------------------------------------------------------

#: the reference's record keys (sda_tpu/loadgen/devscale.py::run_devscale)
REF_KEYS = {
    "metric", "value", "unit", "platform", "pallas", "dim", "participants",
    "p_shards", "d_shards", "dim_tile", "tiles", "participants_chunk",
    "tile_rule", "rounds", "round_seconds_marginal", "compile_seconds",
    "exact", "oracle", "retraces", "warm_program_reused", "compiled_shapes",
    "roofline", "roofline_utilization", "hbm", "hbm_watermark_ratio",
    "host_scaled", "seed", "xla", "ok",
}


def test_run_devscale_record_at_a_drill_dim():
    record = run_devscale(DevScaleProfile(
        dim=25_000, participants=8, participants_chunk=8, p_shards=4,
        d_shards=2, rounds=3, seed=20260804, device="cpu"))
    assert REF_KEYS | {"framework", "clerk_fed", "scan_lane"} <= set(record)
    assert record["framework"] == "torch" and record["platform"] == "cpu"
    assert record["ok"] and record["exact"] and record["host_scaled"]
    assert record["oracle"] == {"mode": "full", "windows": 1, "cols": 25_000}
    assert record["device_oracle"] == {"cols": 25_000, "outputs": 2}
    assert record["retraces"] == 0 and record["warm_program_reused"]
    assert record["tile_rule"] == "hbm_watermark"
    assert record["dim_tile"] % 48 == 0
    assert record["clerk_fed"]["exact"]
    assert record["clerk_fed"]["sink_misses"] == 0
    assert record["scan_lane"]["exact"]
    assert record["hbm"]["within_watermark"] and record["value"] > 0
    assert record["roofline_utilization"] is not None
    assert record["compiled_shapes"] == {"stream.pod.step": 1,
                                         "stream.pod.finale": 1}
    assert not devprof.cost_analysis_enabled()


def test_run_devscale_k1_lane_sampled_oracle():
    """K1's lane with ChaCha masks over two dim tiles, past 2^17 columns:
    the oracle samples seeded windows, as at model scale."""
    record = run_devscale(DevScaleProfile(
        dim=131_100, participants=8, participants_chunk=8, p_shards=4,
        d_shards=2, rounds=2, pallas=True, mask="chacha", clerk_fed=False,
        scan_lane=False, dim_tile=65_568, oracle_window_cols=512, seed=1,
        device="cpu"))
    assert record["ok"] and record["exact"] and record["pallas"]
    assert record["tiles"] == 2 and record["tile_rule"] == "explicit"
    assert record["oracle"] == {"mode": "sampled", "windows": 4,
                                "cols": 4 * 512}
    # every column, where the host oracle samples
    assert record["device_oracle"] == {"cols": 131_100, "outputs": 2}


@pytest.mark.parametrize("rows,tile", [(8, 4096), (3, 1000), (1, 30_000)])
def test_device_oracle_checks_every_column(rows, tile):
    """The device oracle sums the device provider's rows in int64 on the
    device, whatever its blocking, and finds a wrong column in any of the
    outputs it is given."""
    d, P = 30_000, 8
    dev = synthetic_device_block_provider32(P29, seed=4, device="cpu")
    host = synthetic_block_provider32(P29, seed=4)
    right = host(0, P, 0, d).astype(np.int64).sum(axis=0) % P29
    assert loadgen._device_oracle_check(
        (right, right), dev, P, d, P29, rows, tile) == (
            True, {"cols": d, "outputs": 2})
    wrong = right.copy()
    wrong[17_777] = (wrong[17_777] + 1) % P29
    ok, report = loadgen._device_oracle_check(
        (right, wrong), dev, P, d, P29, rows, tile)
    assert not ok
    d0, d1 = report["failed_window"]
    assert d0 <= 17_777 < d1 and report["cols"] == d0


def test_run_devscale_families():
    """The flagship dims pinned (``tests/test_devscale.py``'s recipe), and
    ``run_devscale(family="lora")`` on the CPU: the family sets the dim,
    the record carries both and is exact (one participant, no masks,
    quarter-million-column tiles: the drill's knobs, the family's
    width)."""
    from sda_tpu_torch.fl import FLAGSHIP_FAMILIES, flagship_dim, flagship_dims

    dims = flagship_dims()
    assert set(FLAGSHIP_FAMILIES) <= set(dims)
    assert dims["mobilelite"] == 3_731_890   # MobileLite default config
    assert dims["lora"] == 11_782_400        # LoRAMLP adapter sub-tree
    assert dims["devscale"] == 100_000_000   # the ROADMAP model-scale rung
    with pytest.raises(ValueError, match="unknown flagship family"):
        flagship_dim("resnet")
    record = run_devscale(DevScaleProfile(
        family="lora", dim=0, participants=1, participants_chunk=1,
        p_shards=1, d_shards=1, rounds=2, mask="none", dim_tile=262_144,
        clerk_fed=False, device="cpu"))
    assert record["family"] == "lora" and record["dim"] == 11_782_400
    assert record["ok"] and record["exact"]
    assert record["device_oracle"] == {"cols": 11_782_400, "outputs": 2}


@pytest.mark.parametrize("bad", [dict(dim=0), dict(participants=0),
                                 dict(rounds=1), dict(mask="bogus")])
def test_devscale_profile_validation_equals_reference(bad):
    with pytest.raises(ValueError) as ours:
        DevScaleProfile(**bad).validate()
    with pytest.raises(ValueError) as theirs:
        ref_loadgen.DevScaleProfile(**bad).validate()
    assert str(ours.value) == str(theirs.value)


def test_oracle_check_equals_reference():
    """The oracle itself is the reference's: the same windows, verdicts
    and report on the same (wrong and right) outputs."""
    host = synthetic_block_provider32(P29, seed=3)
    d = 300_000
    right = host(0, 4, 0, d).astype(np.int64).sum(axis=0) % P29
    wrong = right.copy()
    wrong[-1] ^= 1
    for out in (right, wrong):
        for profile in (DevScaleProfile(seed=5), DevScaleProfile(
                seed=9, oracle_windows=6, oracle_window_cols=1000)):
            ref_profile = ref_loadgen.DevScaleProfile(
                seed=profile.seed, oracle_windows=profile.oracle_windows,
                oracle_window_cols=profile.oracle_window_cols)
            assert loadgen._oracle_check(out, host, 4, d, P29, profile) == \
                ref_loadgen._oracle_check(out, host, 4, d, P29, ref_profile)
