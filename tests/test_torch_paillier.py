"""The recipes of ``tests/test_paillier.py`` against the port: packed
Paillier's number theory, packing, scheme and keystore serde, the
encryptor and decryptor seam, homomorphic combining, the full loop with
Paillier in both encryption slots, committee election by key variant and
the device premix. The three server-premix recipes are twinned in
``test_torch_premix_server.py``.

Every client is an ``SdaClient(..., device="cpu")``; the device premix
runs K4's plain version (``encryption.PREMIX_DEVICE = "cpu"``). Keys and
ciphertexts cross between the packages as bytes and wire objects, so
what one package encrypts the other decrypts, and where both compute the
same thing (a combined frame, an unframed payload, a CRT decryption) the
results are held equal. Deliberate deviation: a device premix that fails
raises in the port, where the reference falls back to the host fold.
"""

import math

import numpy as np
import pytest

import sda_tpu.crypto as ref_crypto
import sda_tpu.protocol as ref_protocol
from sda_tpu.crypto import encryption as ref_encryption
from sda_tpu.crypto import paillier as ref_paillier
from sda_tpu_torch.client import SdaClient
from sda_tpu_torch.crypto import (DecryptionKey, MemoryKeystore, encryption,
                                  paillier, paillier_combine)
from sda_tpu_torch.protocol import (AdditiveEncryptionScheme,
                                    AdditiveSharing, Aggregation,
                                    AggregationId, Binary, ChaChaMasking,
                                    Encryption, EncryptionKeyId, FullMasking,
                                    NotFound, PackedPaillierEncryption,
                                    PackedShamirSharing, SodiumEncryption)
from sda_tpu_torch.server import new_memory_server

SCHEME = PackedPaillierEncryption(
    component_count=3, component_bitsize=32, max_value_bitsize=16,
    min_modulus_bitsize=512,
)


@pytest.fixture(scope="module")
def keypair():
    return encryption.new_encryption_keypair(SCHEME)


def ref_keypair(kp):
    """The reference's keypair of the port's, through its wire object."""
    return ref_crypto.EncryptionKeypair.from_obj(kp.to_obj())


def ref_scheme(scheme):
    return ref_protocol.AdditiveEncryptionScheme.from_obj(scheme.to_obj())


def ref_encryption_of(enc):
    return ref_protocol.Encryption.from_obj(enc.to_obj())


def decryptors(kp, scheme):
    """The port's and the reference's share decryptors of one keypair."""
    keystore, ref_keystore = MemoryKeystore(), ref_crypto.MemoryKeystore()
    key_id = EncryptionKeyId.random()
    keystore.put_encryption_keypair(key_id, kp)
    ref_id = ref_protocol.EncryptionKeyId.from_obj(key_id.to_obj())
    ref_keystore.put_encryption_keypair(ref_id, ref_keypair(kp))
    return (encryption.new_share_decryptor(key_id, scheme, keystore),
            ref_encryption.new_share_decryptor(ref_id, ref_scheme(scheme),
                                               ref_keystore))


def new_client(service):
    keystore = MemoryKeystore()
    agent = SdaClient.new_agent(keystore)
    return SdaClient(agent, keystore, service, device="cpu")


# ---------------------------------------------------------------------------
# number-theory core

def test_probable_prime_basics():
    cases = [2, 433, 2**61 - 1, 1, 433 * 433, 2**62 - 1]
    got = [paillier.is_probable_prime(n) for n in cases]
    assert got == [True, True, True, False, False, False]
    assert got == [ref_paillier.is_probable_prime(n) for n in cases]


def test_random_prime_width():
    p = paillier.random_prime(64)
    assert p.bit_length() == 64
    assert paillier.is_probable_prime(p) and ref_paillier.is_probable_prime(p)


def test_keygen_encrypt_decrypt_roundtrip():
    pk, sk = paillier.keygen(512)
    assert pk.n == sk.p * sk.q
    assert pk.bitsize == 512
    ref_pk = ref_paillier.PaillierPublicKey.from_bytes(pk.to_bytes())
    ref_sk = ref_paillier.PaillierSecretKey.from_bytes(sk.to_bytes())
    for m in [0, 1, 433, pk.n - 1]:
        c = paillier.encrypt(pk, m)
        assert paillier.decrypt(sk, c) == m
        # each package decrypts the other's ciphertexts
        assert ref_paillier.decrypt(ref_sk, c) == m
        assert paillier.decrypt(sk, ref_paillier.encrypt(ref_pk, m)) == m


def test_encryption_is_randomized():
    pk, _ = paillier.keygen(512)
    assert paillier.encrypt(pk, 42) != paillier.encrypt(pk, 42)


def test_homomorphic_addition():
    pk, sk = paillier.keygen(512)
    a, b = paillier.encrypt(pk, 1000), paillier.encrypt(pk, 2345)
    c = paillier.add(pk, a, b)
    assert paillier.decrypt(sk, c) == 3345
    ref_pk = ref_paillier.PaillierPublicKey.from_bytes(pk.to_bytes())
    assert ref_paillier.add(ref_pk, a, b) == c


def test_plaintext_range_enforced():
    pk, _ = paillier.keygen(512)
    ref_pk = ref_paillier.PaillierPublicKey.from_bytes(pk.to_bytes())
    for m in (pk.n, -1):
        with pytest.raises(ValueError):
            paillier.encrypt(pk, m)
        with pytest.raises(ValueError):
            ref_paillier.encrypt(ref_pk, m)


def test_key_byte_roundtrip():
    pk, sk = paillier.keygen(512)
    assert paillier.PaillierPublicKey.from_bytes(pk.to_bytes()) == pk
    assert paillier.PaillierSecretKey.from_bytes(sk.to_bytes()) == sk
    ref_pk = ref_paillier.PaillierPublicKey.from_bytes(pk.to_bytes())
    ref_sk = ref_paillier.PaillierSecretKey.from_bytes(sk.to_bytes())
    assert ref_pk.to_bytes() == pk.to_bytes()
    assert ref_sk.to_bytes() == sk.to_bytes()


# ---------------------------------------------------------------------------
# packing

def test_pack_unpack_roundtrip():
    values = [0, 65535, 433]
    m = paillier.pack(values, 32)
    assert m == ref_paillier.pack(values, 32)
    assert paillier.unpack(m, 3, 32) == values == ref_paillier.unpack(m, 3, 32)


def test_pack_rejects_oversized_component():
    for bad in ([1 << 32], [-1]):
        with pytest.raises(ValueError):
            paillier.pack(bad, 32)
        with pytest.raises(ValueError):
            ref_paillier.pack(bad, 32)


def test_packed_components_add_independently():
    """Sums stay inside their windows: packed ints add componentwise."""
    a, b = [1, 2, 3], [40, 50, 60]
    total = paillier.pack(a, 32) + paillier.pack(b, 32)
    assert paillier.unpack(total, 3, 32) == [41, 52, 63]
    assert total == ref_paillier.pack(a, 32) + ref_paillier.pack(b, 32)


# ---------------------------------------------------------------------------
# scheme serde

def test_scheme_serde_roundtrip():
    obj = SCHEME.to_obj()
    assert obj == {
        "PackedPaillier": {
            "component_count": 3,
            "component_bitsize": 32,
            "max_value_bitsize": 16,
            "min_modulus_bitsize": 512,
        }
    }
    assert AdditiveEncryptionScheme.from_obj(obj) == SCHEME
    assert ref_scheme(SCHEME).to_obj() == obj
    assert SCHEME.batch_size == 3 == ref_scheme(SCHEME).batch_size
    assert SCHEME.additive_capacity == 1 << 16


def test_scheme_parameter_validation():
    for args in ((3, 16, 32, 512), (32, 32, 16, 512)):
        with pytest.raises(ValueError):
            PackedPaillierEncryption(*args)
        with pytest.raises(ValueError):
            ref_protocol.PackedPaillierEncryption(*args)


def test_keystore_serde_roundtrip(keypair, tmp_path):
    """The port's file keystore round-trips the keypair, and the
    reference's opens the same directory to the same keypair."""
    from sda_tpu.store import Filebased as RefFilebased
    from sda_tpu_torch.store import Filebased

    store = Filebased(tmp_path)
    key_id = EncryptionKeyId.random()
    store.put_encryption_keypair(key_id, keypair)
    loaded = store.get_encryption_keypair(key_id)
    assert loaded.ek == keypair.ek
    assert loaded.dk.variant == "PackedPaillier"
    assert loaded.dk.value.data == keypair.dk.value.data
    ref_loaded = RefFilebased(tmp_path).get_encryption_keypair(
        ref_protocol.EncryptionKeyId.from_obj(key_id.to_obj()))
    assert ref_loaded.to_obj() == keypair.to_obj()


# ---------------------------------------------------------------------------
# encryptor / decryptor seam

def test_share_encrypt_decrypt_roundtrip(keypair):
    shares = [5, 0, 65535, 433, 1]  # not a multiple of component_count
    enc = encryption.new_share_encryptor(keypair.ek, SCHEME).encrypt(shares)
    assert enc.variant == "PackedPaillier"
    port, ref = decryptors(keypair, SCHEME)
    np.testing.assert_array_equal(port.decrypt(enc), shares)
    np.testing.assert_array_equal(ref.decrypt(ref_encryption_of(enc)), shares)
    # and the port decrypts the reference's encryption
    ref_enc = ref_encryption.new_share_encryptor(
        ref_keypair(keypair).ek, ref_scheme(SCHEME)).encrypt(shares)
    np.testing.assert_array_equal(
        port.decrypt(Encryption.from_obj(ref_enc.to_obj())), shares)


def test_encryptor_rejects_out_of_bound_share(keypair):
    enc = encryption.new_share_encryptor(keypair.ek, SCHEME)
    ref_enc = ref_encryption.new_share_encryptor(ref_keypair(keypair).ek,
                                                 ref_scheme(SCHEME))
    for bad in ([1 << 16], [-1]):  # max_value_bitsize=16
        with pytest.raises(ValueError):
            enc.encrypt(bad)
        with pytest.raises(ValueError):
            ref_enc.encrypt(bad)


def test_encryptor_rejects_undersized_key():
    small = encryption.new_encryption_keypair(
        PackedPaillierEncryption(3, 32, 16, 256))
    with pytest.raises(ValueError):
        encryption.PackedPaillierEncryptor(small.ek, SCHEME)
    with pytest.raises(ValueError):
        ref_encryption.PackedPaillierEncryptor(ref_keypair(small).ek,
                                               ref_scheme(SCHEME))


def test_sodium_key_rejected_for_paillier(keypair):
    sodium_kp = encryption.new_encryption_keypair()
    with pytest.raises(ValueError):
        encryption.new_share_encryptor(sodium_kp.ek, SCHEME)
    with pytest.raises(ValueError):
        encryption.new_share_encryptor(keypair.ek, SodiumEncryption())


# ---------------------------------------------------------------------------
# homomorphic combining — the point of the scheme

def test_homomorphic_share_combine(keypair):
    enc = encryption.new_share_encryptor(keypair.ek, SCHEME)
    rng = np.random.default_rng(7)
    vectors = rng.integers(0, 433, size=(5, 7))
    batches = [enc.encrypt(v) for v in vectors]
    combined = paillier_combine(keypair.ek, SCHEME, batches)
    port, ref = decryptors(keypair, SCHEME)
    out = port.decrypt(combined)
    # integer sums (no window overflow), so the modular sum is recoverable
    np.testing.assert_array_equal(out, vectors.sum(axis=0))
    np.testing.assert_array_equal(out % 433, vectors.sum(axis=0) % 433)
    # the reference's combine of the same ciphertexts is the same frame
    ref_combined = ref_encryption.paillier_combine(
        ref_keypair(keypair).ek, ref_scheme(SCHEME),
        [ref_encryption_of(b) for b in batches])
    assert ref_combined.to_obj() == combined.to_obj()
    np.testing.assert_array_equal(ref.decrypt(ref_combined), out)


def test_combine_enforces_additive_capacity(keypair):
    tight = PackedPaillierEncryption(3, 17, 16, 512)  # capacity 2^1
    enc = encryption.new_share_encryptor(keypair.ek, tight)
    batches = [enc.encrypt([1, 2, 3]) for _ in range(3)]
    with pytest.raises(ValueError):
        paillier_combine(keypair.ek, tight, batches)
    with pytest.raises(ValueError):
        ref_encryption.paillier_combine(
            ref_keypair(keypair).ek, ref_scheme(tight),
            [ref_encryption_of(b) for b in batches])


def test_combine_capacity_survives_nesting(keypair):
    """Summand counts ride the wire frame: incremental acc = combine(acc,
    new) cannot sneak past the window-overflow bound."""
    tight = PackedPaillierEncryption(3, 17, 16, 512)  # capacity 2
    enc = encryption.new_share_encryptor(keypair.ek, tight)
    acc = paillier_combine(
        keypair.ek, tight, [enc.encrypt([1, 2, 3]), enc.encrypt([4, 5, 6])])
    extra = enc.encrypt([7, 8, 9])
    with pytest.raises(ValueError):  # 2 + 1 accumulated summands > 2
        paillier_combine(keypair.ek, tight, [acc, extra])
    with pytest.raises(ValueError):
        ref_encryption.paillier_combine(
            ref_keypair(keypair).ek, ref_scheme(tight),
            [ref_encryption_of(acc), ref_encryption_of(extra)])

    # incremental combining up to exactly the capacity stays exact
    roomy = PackedPaillierEncryption(3, 32, 16, 512)
    enc2 = encryption.new_share_encryptor(keypair.ek, roomy)
    acc2 = enc2.encrypt([1, 1, 1])
    for _ in range(4):
        acc2 = paillier_combine(keypair.ek, roomy,
                                [acc2, enc2.encrypt([1, 1, 1])])
    port, ref = decryptors(keypair, roomy)
    np.testing.assert_array_equal(port.decrypt(acc2), [5, 5, 5])
    np.testing.assert_array_equal(ref.decrypt(ref_encryption_of(acc2)),
                                  [5, 5, 5])


def test_decryptor_rejects_truncated_payloads(keypair):
    port, ref = decryptors(keypair, SCHEME)
    enc = encryption.new_share_encryptor(keypair.ek, SCHEME).encrypt([1, 2, 3])
    for data in (enc.value.data[:-4],  # frame declares more than remain
                 b"",                  # empty payload: truncated varint
                 b"\x80" * 12):        # unterminated varint
        bad = Encryption("PackedPaillier", Binary(data))
        with pytest.raises(ValueError):
            port.decrypt(bad)
        with pytest.raises(ValueError):
            ref.decrypt(ref_encryption_of(bad))


def test_combine_rejects_wrong_key_variant(keypair):
    enc = encryption.new_share_encryptor(keypair.ek, SCHEME).encrypt([1, 2, 3])
    sodium_kp = encryption.new_encryption_keypair()
    with pytest.raises(ValueError):
        paillier_combine(sodium_kp.ek, SCHEME, [enc])


def test_decryption_key_rejects_unknown_variant():
    with pytest.raises(ValueError):
        DecryptionKey("PackedRSA", None)
    with pytest.raises(ValueError):
        DecryptionKey.from_obj({"sodium": "AAAA"})
    with pytest.raises(ValueError):
        ref_crypto.DecryptionKey.from_obj({"sodium": "AAAA"})


def test_combine_rejects_mismatched_batches(keypair):
    enc = encryption.new_share_encryptor(keypair.ek, SCHEME)
    with pytest.raises(ValueError):
        paillier_combine(keypair.ek, SCHEME,
                         [enc.encrypt([1, 2, 3]), enc.encrypt([1, 2])])
    with pytest.raises(ValueError):
        paillier_combine(keypair.ek, SCHEME, [])


# ---------------------------------------------------------------------------
# golden full loop, Paillier in both encryption slots (full_loop.rs shape)

@pytest.mark.parametrize(
    "sharing, masking, recipient_scheme",
    [
        (AdditiveSharing(share_count=3, modulus=433), FullMasking(433), SCHEME),
        (PackedShamirSharing(3, 8, 4, 433, 354, 150), FullMasking(433), SCHEME),
        # ChaCha "masks" on the recipient slot are 32-bit seed words, so
        # that slot needs a >= 32-bit fresh-value window
        (
            PackedShamirSharing(3, 8, 4, 433, 354, 150),
            ChaChaMasking(433, 4, 128),
            PackedPaillierEncryption(3, 33, 32, 512),
        ),
    ],
    ids=["additive", "packed-shamir", "chacha-mask"],
)
def test_full_loop_with_paillier_encryption(sharing, masking,
                                            recipient_scheme):
    service = new_memory_server()
    recipient = new_client(service)
    recipient_key = recipient.new_encryption_key(recipient_scheme)
    recipient.upload_agent()
    recipient.upload_encryption_key(recipient_key)
    aggregation = Aggregation(
        id=AggregationId.random(),
        title="paillier loop",
        vector_dimension=4,
        modulus=433,
        recipient=recipient.agent.id,
        recipient_key=recipient_key,
        masking_scheme=masking,
        committee_sharing_scheme=sharing,
        recipient_encryption_scheme=recipient_scheme,
        committee_encryption_scheme=SCHEME,
    )
    recipient.upload_aggregation(aggregation)
    # the reference reads the port's aggregation as its own
    assert ref_protocol.Aggregation.from_obj(
        aggregation.to_obj()).to_obj() == aggregation.to_obj()
    clerks = [new_client(service) for _ in range(8)]
    for clerk in clerks:
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk.new_encryption_key(SCHEME))
    recipient.begin_aggregation(aggregation.id)
    for _ in range(2):
        participant = new_client(service)
        participant.upload_agent()
        participant.participate([1, 2, 3, 4], aggregation.id)
    recipient.end_aggregation(aggregation.id)
    recipient.run_chores(-1)
    for clerk in clerks:
        clerk.run_chores(-1)
    output = recipient.reveal_aggregation(aggregation.id)
    np.testing.assert_array_equal(output.positive().values, [2, 4, 6, 8])


def test_premix_flag_leaves_sodium_aggregations_untouched():
    import test_torch_full_loop as fl

    service = new_memory_server()
    service.server.premix_paillier = True
    fl.check_full_aggregation(fl.agg_default(), service)


def test_crt_decrypt_matches_textbook():
    """The CRT shortcut agrees with the textbook lambda/mu path, and with
    the reference's decryption under the same key."""
    pk, sk = paillier.keygen(512)
    ref_sk = ref_paillier.PaillierSecretKey.from_bytes(sk.to_bytes())
    n, n2 = pk.n, pk.n_squared
    lam = (sk.p - 1) * (sk.q - 1) // math.gcd(sk.p - 1, sk.q - 1)
    mu = pow((pow(1 + n, lam, n2) - 1) // n, -1, n)
    rng = np.random.default_rng(23)
    for _ in range(25):
        m = int(rng.integers(0, 1 << 62)) * int(rng.integers(1, 1 << 60)) % n
        c = paillier.encrypt(pk, m)
        textbook = (pow(c, lam, n2) - 1) // n * mu % n
        assert paillier.decrypt(sk, c) == textbook == m
        assert ref_paillier.decrypt(ref_sk, c) == m


def test_unframe_fuzz_never_crashes():
    """Random payloads raise ValueError or parse, never IndexError,
    OverflowError or a hang; the reference parses each the same way."""
    from sda_tpu.crypto.encryption import _unframe_paillier as ref_unframe
    from sda_tpu_torch.crypto.encryption import _unframe_paillier

    rng = np.random.default_rng(31)
    parsed = 0
    for size in [0, 1, 2, 7, 64, 512]:
        for _ in range(50):
            raw = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            try:
                got = _unframe_paillier(raw)
            except ValueError:
                with pytest.raises(ValueError):
                    ref_unframe(raw)
                continue
            count, summands, _ = got
            assert count >= 0 and summands >= 1
            assert ref_unframe(raw) == got
            parsed += 1
    assert parsed > 0


def test_committee_election_filters_by_key_variant():
    """A Paillier aggregation must not elect Sodium-keyed clerks; election
    skips them and fails loudly when too few matching candidates exist."""
    service = new_memory_server()
    recipient = new_client(service)
    recipient_key = recipient.new_encryption_key(SCHEME)
    recipient.upload_agent()
    recipient.upload_encryption_key(recipient_key)
    aggregation = Aggregation(
        id=AggregationId.random(),
        title="election",
        vector_dimension=4,
        modulus=433,
        recipient=recipient.agent.id,
        recipient_key=recipient_key,
        masking_scheme=FullMasking(433),
        committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=433),
        recipient_encryption_scheme=SCHEME,
        committee_encryption_scheme=SCHEME,
    )
    recipient.upload_aggregation(aggregation)

    # 3 sodium-keyed decoys + (recipient + 1) paillier-keyed candidates:
    # one short of the 3-clerk committee -> loud error
    paillier_clerks = []
    for _ in range(3):
        decoy = new_client(service)
        decoy.upload_agent()
        decoy.upload_encryption_key(decoy.new_encryption_key())
    clerk = new_client(service)
    clerk.upload_agent()
    clerk.upload_encryption_key(clerk.new_encryption_key(SCHEME))
    paillier_clerks.append(clerk)
    with pytest.raises(NotFound, match="PackedPaillier"):
        recipient.begin_aggregation(aggregation.id)

    # a third candidate holding BOTH key types: the election must pick its
    # PAILLIER key id
    third = new_client(service)
    third.upload_agent()
    third.upload_encryption_key(third.new_encryption_key())
    third_paillier_key = third.new_encryption_key(SCHEME)
    third.upload_encryption_key(third_paillier_key)
    paillier_clerks.append(third)
    recipient.begin_aggregation(aggregation.id)
    committee = service.get_committee(recipient.agent, aggregation.id)
    eligible = {c.agent.id for c in paillier_clerks} | {recipient.agent.id}
    elected = dict(committee.clerks_and_keys)
    assert set(elected) == eligible
    assert elected[third.agent.id] == third_paillier_key


# ---------------------------------------------------------------------------
# the device premix (K4's plain version on the CPU)

@pytest.fixture
def device_legs(monkeypatch):
    """``SDA_PREMIX_DEVICE=1`` on the CPU; returns the row counts of every
    fold that took the device leg (the port has no fallback to hide one
    that did not)."""
    legs = []
    leg = encryption._device_premix_rows
    monkeypatch.setattr(encryption, "PREMIX_DEVICE", "cpu")
    monkeypatch.setattr(encryption, "_device_premix_rows",
                        lambda pk, rows: legs.append(len(rows))
                        or leg(pk, rows))
    return legs


def _premix_case(keypair, seed, rows, monkeypatch):
    """The host fold of ``rows`` random batches, and the reference's host
    fold of the same ciphertexts: one frame."""
    enc = encryption.new_share_encryptor(keypair.ek, SCHEME)
    vectors = np.random.default_rng(seed).integers(0, 433, size=(rows, 24))
    batches = [enc.encrypt(v) for v in vectors]
    monkeypatch.delenv("SDA_PREMIX_DEVICE", raising=False)
    host = paillier_combine(keypair.ek, SCHEME, batches)
    ref_host = ref_encryption.paillier_combine(
        ref_keypair(keypair).ek, ref_scheme(SCHEME),
        [ref_encryption_of(b) for b in batches])
    assert ref_host.to_obj() == host.to_obj()
    return batches, host


def test_combine_device_premix_bit_identical(keypair, monkeypatch,
                                             device_legs):
    """``SDA_PREMIX_DEVICE=1`` folds through K4 (9 rows x 8 ciphertexts,
    above the floor of 64): the framed product is byte-identical to the
    host fold, the reference's included."""
    batches, host = _premix_case(keypair, 23, 9, monkeypatch)
    monkeypatch.setenv("SDA_PREMIX_DEVICE", "1")
    dev = paillier_combine(keypair.ek, SCHEME, batches)
    assert device_legs == [9], "the device leg never ran"
    assert dev.value.data == host.value.data


def test_combine_device_premix_chunked_partials(keypair, monkeypatch,
                                                device_legs):
    """Row counts above the chunk bound fold chunk products of products:
    still byte-identical (the port pads no chunk)."""
    batches, host = _premix_case(keypair, 29, 11, monkeypatch)
    monkeypatch.setenv("SDA_PREMIX_DEVICE", "1")
    monkeypatch.setattr(encryption, "_DEVICE_PREMIX_CHUNK_ROWS", 4)
    dev = paillier_combine(keypair.ek, SCHEME, batches)
    assert device_legs == [11]
    assert dev.value.data == host.value.data


def test_combine_device_premix_falls_back_on_device_failure(keypair,
                                                            monkeypatch):
    """Deliberate deviation: where the reference degrades to the host fold
    with a warning, the port raises the device's error (no fallback), and
    the reference's fallback gives the host frame."""
    enc = encryption.new_share_encryptor(keypair.ek, SCHEME)
    vectors = np.arange(9 * 24).reshape(9, 24) % 433
    batches = [enc.encrypt(v) for v in vectors]
    host = paillier_combine(keypair.ek, SCHEME, batches)
    monkeypatch.setenv("SDA_PREMIX_DEVICE", "1")

    def boom(pk, rows):
        raise RuntimeError("no device")

    monkeypatch.setattr(encryption, "_device_premix_rows", boom)
    with pytest.raises(RuntimeError, match="no device"):
        paillier_combine(keypair.ek, SCHEME, batches)
    monkeypatch.setattr(ref_encryption, "_device_premix_rows", boom)
    ref_dev = ref_encryption.paillier_combine(
        ref_keypair(keypair).ek, ref_scheme(SCHEME),
        [ref_encryption_of(b) for b in batches])
    assert ref_dev.value.data == host.value.data
