"""The recipes of ``tests/test_embed.py`` against the port: a
participation built by the native C core (``sda_tpu_torch.client.embed``
over the port's ``native/``) joins rounds of the port's
``SdaClient(..., device="cpu")`` participants and reveals exactly, across
the none/full/chacha masking lattice and the Shamir sharings.
"""

import numpy as np
import pytest

from sda_tpu_torch import native
from sda_tpu_torch.client import SdaClient
from sda_tpu_torch.client.embed import new_participation_embedded, participate_embedded
from sda_tpu_torch.crypto import MemoryKeystore, sodium
from sda_tpu_torch.protocol import (
    AdditiveSharing,
    Aggregation,
    AggregationId,
    AgentId,
    ChaChaMasking,
    EncryptionKeyId,
    FullMasking,
    NoMasking,
    PackedShamirSharing,
    SodiumEncryption,
)
from sda_tpu_torch.server import new_memory_server

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")

DIM, MOD = 5, 433


def _agg(masking, dim=DIM) -> Aggregation:
    return Aggregation(
        id=AggregationId.random(),
        title="embedded",
        vector_dimension=dim,
        modulus=MOD,
        recipient=AgentId.random(),
        recipient_key=EncryptionKeyId.random(),
        masking_scheme=masking,
        committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=MOD),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )


def _client(service):
    ks = MemoryKeystore()
    c = SdaClient(SdaClient.new_agent(ks), ks, service, device="cpu")
    c.upload_agent()
    return c


def _round(masking, embedded_input, python_inputs):
    """One aggregation where ONE participation is built by the C core."""
    service = new_memory_server()
    recipient = _client(service)
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    agg = _agg(masking).replace(recipient=recipient.agent.id,
                                recipient_key=rkey)
    recipient.upload_aggregation(agg)
    clerks = [_client(service) for _ in range(4)]
    for c in clerks:
        c.upload_encryption_key(c.new_encryption_key())
    recipient.begin_aggregation(agg.id)

    embedded = _client(service)
    participate_embedded(embedded, embedded_input, agg.id)
    for vals in python_inputs:
        _client(service).participate(vals, agg.id)

    recipient.end_aggregation(agg.id)
    recipient.run_chores(-1)
    for c in clerks:
        c.run_chores(-1)
    out = recipient.reveal_aggregation(agg.id).positive().values
    expected = (np.asarray([embedded_input] + list(python_inputs))
                .sum(axis=0) % MOD)
    np.testing.assert_array_equal(out, expected)


@pytest.mark.parametrize("masking", [
    NoMasking(),
    FullMasking(MOD),
    ChaChaMasking(MOD, DIM, 128),
], ids=["none", "full", "chacha"])
def test_embedded_participation_reveals_exact(masking):
    _round(masking,
           embedded_input=[5, 10, 432, 0, 7],
           python_inputs=[[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]])


def test_embedded_only_round():
    """A round where EVERY participant is the C core."""
    service = new_memory_server()
    recipient = _client(service)
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    agg = _agg(FullMasking(MOD)).replace(recipient=recipient.agent.id,
                                         recipient_key=rkey)
    recipient.upload_aggregation(agg)
    clerks = [_client(service) for _ in range(4)]
    for c in clerks:
        c.upload_encryption_key(c.new_encryption_key())
    recipient.begin_aggregation(agg.id)
    inputs = [[i + j for j in range(DIM)] for i in range(1, 4)]
    for vals in inputs:
        participate_embedded(_client(service), vals, agg.id)
    recipient.end_aggregation(agg.id)
    recipient.run_chores(-1)
    for c in clerks:
        c.run_chores(-1)
    out = recipient.reveal_aggregation(agg.id).positive().values
    np.testing.assert_array_equal(
        out, np.asarray(inputs).sum(axis=0) % MOD)


def test_embedded_canonicalizes_negative_and_large_inputs():
    _round(NoMasking(),
           embedded_input=[-1, MOD + 5, 2 * MOD, -MOD, 3],
           python_inputs=[[1, 1, 1, 1, 1]])


def _shamir_round(sharing, masking, embedded_input, python_inputs,
                  n_clerks=8, dim=DIM):
    """A committee round with one C-core participation: the share matrix
    (when Shamir) is computed host-side, evaluated in C, and the Python
    clerks/recipient must reconstruct the exact sum (the golden
    full_loop.rs PackedShamir config at p=433, omega=354/150)."""
    service = new_memory_server()
    recipient = _client(service)
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    agg = _agg(masking, dim=dim).replace(
        recipient=recipient.agent.id, recipient_key=rkey,
        committee_sharing_scheme=sharing,
    )
    recipient.upload_aggregation(agg)
    clerks = [_client(service) for _ in range(n_clerks)]
    for c in clerks:
        c.upload_encryption_key(c.new_encryption_key())
    recipient.begin_aggregation(agg.id)
    participate_embedded(_client(service), embedded_input, agg.id)
    for vals in python_inputs:
        _client(service).participate(vals, agg.id)
    recipient.end_aggregation(agg.id)
    recipient.run_chores(-1)
    for c in clerks:
        c.run_chores(-1)
    out = recipient.reveal_aggregation(agg.id).positive().values
    expected = (np.asarray([embedded_input] + list(python_inputs))
                .sum(axis=0) % MOD)
    np.testing.assert_array_equal(out, expected)


@pytest.mark.parametrize("masking", [
    NoMasking(), FullMasking(MOD), ChaChaMasking(MOD, DIM, 128),
], ids=["none", "full", "chacha"])
def test_embedded_packed_shamir_reveals_exact(masking):
    _shamir_round(PackedShamirSharing(3, 8, 4, MOD, 354, 150), masking,
                  embedded_input=[1, 2, 3, 4, 5],
                  python_inputs=[[10, 20, 30, 40, 50]])


def test_embedded_basic_shamir_reveals_exact():
    from sda_tpu_torch.protocol import BasicShamirSharing

    _shamir_round(BasicShamirSharing(share_count=8, privacy_threshold=3,
                                     prime_modulus=MOD),
                  FullMasking(MOD),
                  embedded_input=[7, 0, 432, 1, 2],
                  python_inputs=[[3, 3, 3, 3, 3], [5, 4, 3, 2, 1]])


def test_embed_core_blob_shapes():
    """Direct C-ABI contract: blob counts/sizes and masking gating."""
    pks = [sodium.box_keypair()[0] for _ in range(3)]
    rpk, _ = sodium.box_keypair()
    rec, clerk_blobs = native.embed_participate(
        [1, 2, 3], MOD, 3, masking="none", clerk_pks=pks)
    assert rec is None and len(clerk_blobs) == 3
    for b in clerk_blobs:
        assert len(b) >= 48 + 3  # sealedbox overhead + one byte per value
    rec, _ = native.embed_participate(
        [1, 2, 3], MOD, 3, masking="chacha", seed_bits=128,
        recipient_pk=rpk, clerk_pks=pks)
    # chacha uploads the SEED (4 words), not an O(d) mask
    assert rec is not None and len(rec) <= 48 + 4 * 10
    with pytest.raises(ValueError):
        native.embed_participate([1], MOD, 2, masking="full",
                                 recipient_pk=b"short", clerk_pks=pks[:2])


def test_embedded_chacha_odd_seed_bits():
    """seed_bitsize not a multiple of 32 rounds up to whole words, exactly
    like chacha.random_seed — any Python-accepted aggregation must work."""
    _round(ChaChaMasking(MOD, DIM, 80),
           embedded_input=[4, 3, 2, 1, 0],
           python_inputs=[[2, 2, 2, 2, 2]])


def test_embedded_rejects_scheme_modulus_drift():
    service = new_memory_server()
    recipient = _client(service)
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    agg = _agg(NoMasking()).replace(
        recipient=recipient.agent.id, recipient_key=rkey,
        committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=431),
    )
    recipient.upload_aggregation(agg)
    for _ in range(4):
        c = _client(service)
        c.upload_encryption_key(c.new_encryption_key())
    recipient.begin_aggregation(agg.id)
    with pytest.raises(ValueError, match="sharing modulus"):
        new_participation_embedded(_client(service), [1] * DIM, agg.id)


def test_embedded_shamir_two_ring_masking():
    """The production ring split: Shamir shares over a ~2^29 NTT prime,
    masks over the aggregation modulus 433 (the CLI's capacity-headroom
    policy) — the embedded participation must still reveal exactly."""
    from sda_tpu_torch.fields import numtheory

    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    sharing = PackedShamirSharing(3, 8, t, p, w2, w3)
    service = new_memory_server()
    recipient = _client(service)
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    agg = _agg(FullMasking(MOD)).replace(
        recipient=recipient.agent.id, recipient_key=rkey,
        committee_sharing_scheme=sharing,
    )
    recipient.upload_aggregation(agg)
    clerks = [_client(service) for _ in range(8)]
    for c in clerks:
        c.upload_encryption_key(c.new_encryption_key())
    recipient.begin_aggregation(agg.id)
    participate_embedded(_client(service), [1, 2, 3, 4, 5], agg.id)
    _client(service).participate([100, 200, 300, 400, 430], agg.id)
    recipient.end_aggregation(agg.id)
    recipient.run_chores(-1)
    for c in clerks:
        c.run_chores(-1)
    out = recipient.reveal_aggregation(agg.id).positive().values
    np.testing.assert_array_equal(
        out, (np.asarray([[1, 2, 3, 4, 5], [100, 200, 300, 400, 430]])
              .sum(axis=0) % MOD))


def test_embed_blobs_decode_to_telescoping_shares():
    """Wire-level check below the protocol: decrypt every C-built clerk
    blob with the clerk's secret key, varint-decode, and verify the share
    vectors telescope to the canonical secret (additive) — the exact
    parsing path the Python clerks run."""
    from sda_tpu_torch.crypto import varint

    secret = [5, -3, 432, 1000, 0]
    n = 4
    keys = [sodium.box_keypair() for _ in range(n)]
    rec, blobs = native.embed_participate(
        secret, MOD, n, masking="none",
        clerk_pks=[pk for pk, _ in keys])
    assert rec is None
    decoded = []
    for (pk, sk), blob in zip(keys, blobs):
        decoded.append(varint.decode(sodium.seal_open(blob, pk, sk)))
    total = np.sum(decoded, axis=0) % MOD
    np.testing.assert_array_equal(
        total, np.asarray(secret, dtype=np.int64) % MOD)
    for share in decoded:  # canonical residues on the wire
        assert share.min() >= 0 and share.max() < MOD


def test_embed_full_mask_blob_decodes_and_cancels():
    """Recipient blob = varint(mask); clerk shares telescope to the
    MASKED secret; mask subtraction recovers the canonical input."""
    from sda_tpu_torch.crypto import varint

    secret = [1, 2, 3]
    n = 3
    keys = [sodium.box_keypair() for _ in range(n)]
    rpk, rsk = sodium.box_keypair()
    rec, blobs = native.embed_participate(
        secret, MOD, n, masking="full", recipient_pk=rpk,
        clerk_pks=[pk for pk, _ in keys])
    mask = varint.decode(sodium.seal_open(rec, rpk, rsk))
    shares = [varint.decode(sodium.seal_open(b, pk, sk))
              for (pk, sk), b in zip(keys, blobs)]
    masked = np.sum(shares, axis=0) % MOD
    np.testing.assert_array_equal(
        (masked - mask) % MOD, np.asarray(secret) % MOD)


def test_embed_wrapper_validation_errors():
    pks = [sodium.box_keypair()[0] for _ in range(3)]
    with pytest.raises(ValueError, match="masking must be one of"):
        native.embed_participate([1], MOD, 3, masking="bogus",
                                 clerk_pks=pks)
    with pytest.raises(ValueError, match="one clerk public key"):
        native.embed_participate([1], MOD, 3, clerk_pks=pks[:2])
    with pytest.raises(ValueError, match="32 bytes"):
        native.embed_participate([1], MOD, 3, masking="full",
                                 recipient_pk=b"x" * 31, clerk_pks=pks)
    with pytest.raises(ValueError, match="share_matrix must be"):
        native.embed_participate(
            [1], MOD, 3, clerk_pks=pks,
            share_matrix=np.zeros((2, 5), dtype=np.int64), secret_count=1)
    with pytest.raises(ValueError, match="secret_count"):
        native.embed_participate(
            [1], MOD, 3, clerk_pks=pks,
            share_matrix=np.zeros((3, 5), dtype=np.int64), secret_count=0)


def test_embedded_randomized_config_sweep():
    """Property sweep: random dims/committees/schemes/maskings — every
    embedded participation must reveal exactly next to a Python one."""
    from sda_tpu_torch.protocol import BasicShamirSharing

    rng = np.random.default_rng(2026)
    for trial in range(6):
        dim = int(rng.integers(1, 40))
        scheme_pick = trial % 3
        if scheme_pick == 0:
            n = int(rng.integers(2, 6))
            sharing = AdditiveSharing(share_count=n, modulus=MOD)
        elif scheme_pick == 1:
            sharing = PackedShamirSharing(3, 8, 4, MOD, 354, 150)
            n = 8
        else:
            t = int(rng.integers(1, 4))
            sharing = BasicShamirSharing(share_count=8,
                                         privacy_threshold=t,
                                         prime_modulus=MOD)
            n = 8
        masking = [NoMasking(), FullMasking(MOD),
                   ChaChaMasking(MOD, dim, 128)][int(rng.integers(0, 3))]
        emb = rng.integers(0, MOD, size=dim).tolist()
        py = rng.integers(0, MOD, size=dim).tolist()
        _shamir_round(sharing, masking, emb, [py], n_clerks=n, dim=dim)


def test_embedded_near_64bit_modulus():
    """Edge coverage at a huge ring (just below the 2^62 share bound):
    uniform rejection sampling's acceptance zone, 9-10-byte varints, and
    the output-capacity sizing all get exercised; the round must reveal
    exactly against Python clerks."""
    # 2^63-1: the largest ring an i64 share can carry (additive sharing
    # only needs a ring modulus; primality unused). Shares >= 2^62 zigzag
    # to TEN-byte varints, exercising the encoder's widest path and
    # varint.decode's 10th-byte overflow guard
    big = (1 << 63) - 1
    from sda_tpu_torch.crypto import varint

    n = 3
    dim = 32  # enough draws that some share >= 2^62 w.p. 1 - 2^-64
    keys = [sodium.box_keypair() for _ in range(n)]
    secret = [0, 1, big - 1, 123456789012345678] + list(range(dim - 4))
    rec, blobs = native.embed_participate(
        secret, big, n, masking="none",
        clerk_pks=[pk for pk, _ in keys])
    assert rec is None  # masking none: no recipient blob, large ring or not
    decoded = [varint.decode(sodium.seal_open(b, pk, sk))
               for (pk, sk), b in zip(keys, blobs)]
    # telescoping mod big, computed in Python ints to avoid i64 overflow
    total = [(sum(int(s[i]) for s in decoded)) % big
             for i in range(len(secret))]
    assert total == [v % big for v in secret]
    widest = 0
    for share in decoded:
        assert share.min() >= 0 and int(share.max()) < big
        widest = max(widest, int(share.max()))
    # the 10-byte varint path actually ran
    assert widest >= (1 << 62)
