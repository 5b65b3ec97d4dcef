"""The batched clerk pipeline of ``tests/test_clerk_pipeline.py`` through
the port (``sda_tpu_torch``), on the reference's seeds and sizes.

The clerk hot path decrypts in bundles on the crypto worker pool
(``crypto.batch.prefetch_map``) and feeds each bundle into one stacked
combine, folding partial sums modularly (``SDA_CLERK_BATCH``). The
contract: the revealed aggregate is bit-exact with the scalar path and
with the JAX package's round on the same inputs, under every batch size,
under chaos failpoints, with the device-tile fold, and with the
client-side document cache on or off. Every role is an
``SdaClient(..., device="cpu")``.
"""

import functools
import threading
import time

import numpy as np
import pytest

from sda_tpu_torch import chaos, obs
from sda_tpu_torch.client import RecipientOutput, SdaClient
from sda_tpu_torch.crypto import MemoryKeystore
from sda_tpu_torch.crypto import batch as crypto_batch
from sda_tpu_torch.protocol import (
    Aggregation,
    AggregationId,
    FullMasking,
    PackedShamirSharing,
    SodiumEncryption,
)
from sda_tpu_torch.server import new_memory_server

SCHEME = PackedShamirSharing(3, 8, 4, 433, 354, 150)
DIM = 6
PARTICIPANTS = 7


# -- pool primitives ---------------------------------------------------------

def test_pmap_preserves_order(monkeypatch):
    monkeypatch.setenv("SDA_CRYPTO_WORKERS", "4")
    crypto_batch.reset()
    try:
        def slow_identity(x):
            time.sleep(0.002 * (7 - x % 8))  # later items finish earlier
            return x * x
        assert crypto_batch.pmap(slow_identity, range(16)) == [
            x * x for x in range(16)]
    finally:
        crypto_batch.reset()


def test_pmap_propagates_exceptions(monkeypatch):
    monkeypatch.setenv("SDA_CRYPTO_WORKERS", "4")
    crypto_batch.reset()
    try:
        def boom(x):
            if x == 5:
                raise RuntimeError("item 5")
            return x
        with pytest.raises(RuntimeError, match="item 5"):
            crypto_batch.pmap(boom, range(8))
    finally:
        crypto_batch.reset()


@pytest.mark.parametrize("workers", ["0", "1", "4"])
def test_prefetch_map_yields_ordered_batches(monkeypatch, workers):
    monkeypatch.setenv("SDA_CRYPTO_WORKERS", workers)
    crypto_batch.reset()
    try:
        batches = list(crypto_batch.prefetch_map(
            lambda x: x + 100, list(range(10)), batch_size=3))
        assert batches == [[100, 101, 102], [103, 104, 105],
                           [106, 107, 108], [109]]
    finally:
        crypto_batch.reset()


def test_prefetch_map_bounds_staging(monkeypatch):
    # at most (prefetch + 1) batches may ever be in flight or staged
    monkeypatch.setenv("SDA_CRYPTO_WORKERS", "8")
    crypto_batch.reset()
    started = []
    lock = threading.Lock()
    try:
        def track(x):
            with lock:
                started.append(x)
            return x

        stream = crypto_batch.prefetch_map(track, list(range(100)),
                                           batch_size=10, prefetch=1)
        next(stream)
        time.sleep(0.05)  # let any runaway submissions surface
        with lock:
            assert len(started) <= 30  # batch 0 + at most 2 ahead
    finally:
        crypto_batch.reset()


# -- end-to-end bit-exactness ------------------------------------------------


def _inputs(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, SCHEME.prime_modulus, size=(PARTICIPANTS, DIM), dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _reference_reveal(seed: int) -> tuple:
    """The JAX package's round on the same inputs (its own test's flow)."""
    from sda_tpu.client import SdaClient as RefClient
    from sda_tpu.crypto import MemoryKeystore as RefKeystore
    from sda_tpu.crypto import sodium as ref_sodium
    from sda_tpu.protocol import (
        Aggregation as RefAggregation,
        AggregationId as RefAggregationId,
        FullMasking as RefFullMasking,
        PackedShamirSharing as RefPackedShamir,
        SodiumEncryption as RefSodium,
    )
    from sda_tpu.server import new_memory_server as ref_memory_server

    if not ref_sodium.available():
        pytest.skip("the reference's libsodium not present")
    scheme = RefPackedShamir(3, 8, 4, 433, 354, 150)
    service = ref_memory_server()

    def new_client():
        keystore = RefKeystore()
        return RefClient(RefClient.new_agent(keystore), keystore, service)

    recipient = new_client()
    key = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(key)
    clerks = [new_client() for _ in range(scheme.share_count)]
    for clerk in clerks:
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk.new_encryption_key())
    aggregation = RefAggregation(
        id=RefAggregationId.random(), title="pipeline-equivalence",
        vector_dimension=DIM, modulus=scheme.prime_modulus,
        recipient=recipient.agent.id, recipient_key=key,
        masking_scheme=RefFullMasking(scheme.prime_modulus),
        committee_sharing_scheme=scheme,
        recipient_encryption_scheme=RefSodium(),
        committee_encryption_scheme=RefSodium())
    recipient.upload_aggregation(aggregation)
    recipient.begin_aggregation(aggregation.id)
    for row in _inputs(seed):
        participant = new_client()
        participant.upload_agent()
        participant.participate([int(x) for x in row], aggregation.id)
    recipient.end_aggregation(aggregation.id)
    for worker in [recipient] + clerks:
        worker.run_chores(-1)
    return tuple(int(v) for v in
                 recipient.reveal_aggregation(aggregation.id)
                 .positive().values)


def _new_client(service):
    keystore = MemoryKeystore()
    agent = SdaClient.new_agent(keystore)
    return SdaClient(agent, keystore, service, device="cpu")


def _aggregation(recipient, recipient_key, title):
    return Aggregation(
        id=AggregationId.random(),
        title=title,
        vector_dimension=DIM,
        modulus=SCHEME.prime_modulus,
        recipient=recipient.agent.id,
        recipient_key=recipient_key,
        masking_scheme=FullMasking(SCHEME.prime_modulus),
        committee_sharing_scheme=SCHEME,
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )


def _run_round(seed: int) -> np.ndarray:
    """One full in-process round; returns the revealed positive values,
    checked against the plain sum and the JAX package's reveal."""
    obs.reset_all()
    service = new_memory_server()

    recipient = _new_client(service)
    recipient_key = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(recipient_key)

    clerks = [_new_client(service) for _ in range(SCHEME.share_count)]
    for clerk in clerks:
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk.new_encryption_key())

    aggregation = _aggregation(recipient, recipient_key,
                               "pipeline-equivalence")
    recipient.upload_aggregation(aggregation)
    recipient.begin_aggregation(aggregation.id)

    inputs = _inputs(seed)
    for row in inputs:
        participant = _new_client(service)
        participant.upload_agent()
        participant.participate([int(x) for x in row], aggregation.id)

    recipient.end_aggregation(aggregation.id)
    # several sweeps: under the chaos profile a worker may abandon a job
    # mid-sweep (clerk.abandon_job drop) — the job stays queued and a
    # later sweep picks it up, exactly like a re-polling clerk fleet
    for _ in range(4):
        for worker in [recipient] + clerks:
            worker.run_chores(-1)

    output = np.asarray(recipient.reveal_aggregation(aggregation.id)
                        .positive().values)
    np.testing.assert_array_equal(
        output, inputs.sum(axis=0) % SCHEME.prime_modulus)
    np.testing.assert_array_equal(output, _reference_reveal(seed))
    return output


@pytest.mark.parametrize("batch,workers", [
    ("1", "0"),    # scalar: one vector at a time, no threads
    ("2", "4"),    # tiny bundles, real overlap
    ("3", "2"),
    ("4096", "8"),  # one bundle for everything
])
def test_batched_clerk_is_bit_exact_with_scalar(monkeypatch, batch, workers):
    monkeypatch.setenv("SDA_CLERK_BATCH", batch)
    monkeypatch.setenv("SDA_CRYPTO_WORKERS", workers)
    crypto_batch.reset()
    try:
        out = _run_round(seed=20260803)
        assert out.shape == (DIM,)
    finally:
        crypto_batch.reset()


def test_batched_clerk_exact_under_chaos(monkeypatch):
    # failpoints abandon clerk jobs mid-round (lease reissue brings them
    # back): chaos changes who processes a job, never the partial sums
    monkeypatch.setenv("SDA_CLERK_BATCH", "2")
    monkeypatch.setenv("SDA_CRYPTO_WORKERS", "4")
    crypto_batch.reset()
    chaos.reset()
    try:
        chaos.configure("clerk.abandon_job", drop=True, after=1, every=3,
                        times=4)
        _run_round(seed=20260803)
    finally:
        chaos.reset()
        crypto_batch.reset()


def test_cache_disabled_round_still_exact(monkeypatch):
    monkeypatch.setenv("SDA_CLIENT_CACHE", "0")
    _run_round(seed=7)


@pytest.mark.parametrize("batch", ["1", "3"])
def test_device_tile_clerk_combine_bit_exact(monkeypatch, batch):
    # SDA_CLERK_DEVICE_TILES=1: decrypted bundles fold into the tiled
    # accumulator on the clerk's device (mesh/devscale.py
    # DeviceTileCombiner) instead of host numpy; the reveal must not change
    from sda_tpu_torch.utils import metrics as _metrics

    monkeypatch.setenv("SDA_CLERK_DEVICE_TILES", "1")
    monkeypatch.setenv("SDA_CLERK_BATCH", batch)
    monkeypatch.setenv("SDA_CRYPTO_WORKERS", "2")
    crypto_batch.reset()
    try:
        _run_round(seed=20260804)
        counters = _metrics.counter_report("clerk.device_tiles")
        assert counters.get("clerk.device_tiles.bundle", 0) > 0, \
            "device-tile path never engaged"
    finally:
        crypto_batch.reset()


# -- document cache ----------------------------------------------------------

class _CountingService:
    """Service wrapper counting the immutable-doc fetches."""

    def __init__(self, inner):
        self._inner = inner
        self.counts = {"get_aggregation": 0, "get_committee": 0,
                       "get_encryption_key": 0}

    def __getattr__(self, name):
        fn = getattr(self._inner, name)
        if name in self.counts:
            def counted(*args, **kwargs):
                self.counts[name] += 1
                return fn(*args, **kwargs)
            return counted
        return fn


def test_clerk_polling_uses_cached_documents():
    service = new_memory_server()
    counting = _CountingService(service)

    recipient = _new_client(service)
    recipient_key = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(recipient_key)

    clerks = [_new_client(service) for _ in range(SCHEME.share_count)]
    for clerk in clerks:
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk.new_encryption_key())

    aggregation = _aggregation(recipient, recipient_key, "cache")
    recipient.upload_aggregation(aggregation)
    recipient.begin_aggregation(aggregation.id)

    for _ in range(3):
        p = _new_client(service)
        p.upload_agent()
        p.participate([1] * DIM, aggregation.id)

    # three pipelined snapshots -> three jobs per committee member
    for _ in range(3):
        recipient.snapshot_aggregation(aggregation.id)

    committee = service.get_committee(recipient.agent, aggregation.id)
    committee_ids = {cid for cid, _ in committee.clerks_and_keys}
    worker = next(c for c in [recipient] + clerks
                  if c.agent.id in committee_ids)
    counted_clerk = SdaClient(worker.agent, worker.crypto.keystore, counting,
                              device="cpu")
    processed = 0
    while counted_clerk.clerk_once():
        processed += 1
    assert processed == 3
    # one fetch each despite three jobs: the cache held between polls
    assert counting.counts["get_aggregation"] == 1
    assert counting.counts["get_committee"] == 1
    # recipient key verified once, not once per job
    assert counting.counts["get_encryption_key"] == 1


# -- RecipientOutput lanes ---------------------------------------------------

def test_recipient_output_int64_lane_stays_numpy():
    out = RecipientOutput(433, [-5, 0, 432, 440])
    lifted = out.positive()
    assert lifted.values.dtype == np.int64
    np.testing.assert_array_equal(lifted.values, [428, 0, 432, 7])


def test_recipient_output_bigint_lane():
    modulus = (1 << 80) + 13  # beyond int64: object lane, no silent wrap
    values = [-(1 << 70), 1 << 79, 7]
    out = RecipientOutput(modulus, values)
    assert out.values.dtype == object
    lifted = out.positive()
    assert lifted.values.dtype == object
    assert list(lifted.values) == [v % modulus for v in values]
