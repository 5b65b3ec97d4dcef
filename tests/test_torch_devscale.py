"""The single-device part of the port's devscale plane
(``sda_tpu_torch.mesh.devscale``, ``sda_tpu_torch.obs.devprof``) against
the JAX package's: the stream schedule equals the reference's;
``DeviceTileCombiner`` equals
``mod_combine`` and the reference's combiner bit for bit; the watermark's
overrides; the sink feeding the streamed round; and a protocol round whose
clerks fold on device tiles (``SDA_CLERK_DEVICE_TILES=1``, on the CPU)
reveals what the host fold reveals."""

import numpy as np
import pytest
import torch

from sda_tpu import protocol as ref_proto
from sda_tpu.crypto.sharing import mod_combine as ref_mod_combine
from sda_tpu.mesh import devscale as ref_devscale

from sda_tpu_torch.crypto.sharing import mod_combine
from sda_tpu_torch.fields import numtheory
from sda_tpu_torch.mesh import (
    DeviceTileCombiner,
    DeviceTileSink,
    StreamingAggregator,
    stream_schedule,
    synthetic_block_provider32,
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
    from sda_tpu_torch.crypto import sharing, sodium
    from sda_tpu_torch.protocol import (Aggregation, AggregationId, AgentId,
                                        EncryptionKeyId, SodiumEncryption)

    if not sodium.available():
        pytest.skip("libsodium not present")
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
