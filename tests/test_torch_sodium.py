"""The port's host crypto (``sda_tpu_torch/crypto/csrc/sodium.c``) held to
libsodium, through the JAX package's ``sda_tpu.crypto.sodium`` and, for the
primitives that module does not expose, ``ctypes`` on the same library.

The tolerance is byte equality: every public key, signature and sealed box
of the port is the one libsodium gives for the same secret inputs, or opens
under libsodium; every input libsodium rejects, the port rejects. The
known-answer vectors are the ones ``chip_smoke.py`` checks on the card's
host. The last test runs a protocol round in a process where no library
named like libsodium can load.
"""

import ctypes
import functools
import hashlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sda_tpu.crypto import sodium as ref
from sda_tpu_torch import native
from sda_tpu_torch.crypto import sodium, varint
from sda_tpu_torch.fields import numtheory

pytestmark = pytest.mark.skipif(
    not ref.available(), reason="the reference's libsodium not present")

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _chip_smoke()
# the known answers chip_smoke.py checks on the card's host, from libsodium
# 1.0.18: crypto_scalarmult_base of bytes(range(32)); crypto_sign_seed_keypair
# of bytes(range(32, 64)) and its detached signature of KAT_MESSAGE;
# KAT_MESSAGE sealed to KAT_BOX_PK with the ephemeral secret key
# bytes(range(64, 96))
KAT_MESSAGE = chip_smoke.KAT_MESSAGE
KAT_BOX_PK = bytes.fromhex(chip_smoke.KAT_BOX_PK)
KAT_SIGN_PK = bytes.fromhex(chip_smoke.KAT_SIGN_PK)
KAT_SIG = bytes.fromhex(chip_smoke.KAT_SIG)
KAT_SEALED = bytes.fromhex(chip_smoke.KAT_SEALED)

SIZES = [0, 1, 63, 64, 65, 4096, 1_500_000]

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493


def _lib():
    return ref._load()


def _rng_bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _scalarmult_base(sk):
    out = ctypes.create_string_buffer(32)
    _lib().crypto_scalarmult_base(out, sk)
    return out.raw


def _ref_seed_keypair(seed):
    pk, sk = ctypes.create_string_buffer(32), ctypes.create_string_buffer(64)
    assert _lib().crypto_sign_seed_keypair(pk, sk, seed) == 0
    return pk.raw, sk.raw


def _ref_box_easy(m, nonce, pk, sk):
    c = ctypes.create_string_buffer(len(m) + 16)
    rc = _lib().crypto_box_easy(c, m, ctypes.c_ulonglong(len(m)), nonce, pk,
                                sk)
    assert rc == 0
    return c.raw


# -- Edwards25519 in Python integers, for hand-built signatures -------------

_D = -121665 * pow(121666, P - 2, P) % P
_SQRTM1 = pow(2, (P - 1) // 4, P)


def _ed_add(a, b):
    x1, y1 = a
    x2, y2 = b
    t = _D * x1 * x2 * y1 * y2 % P
    return ((x1 * y2 + x2 * y1) * pow(1 + t, P - 2, P) % P,
            (y1 * y2 + x1 * x2) * pow(1 - t, P - 2, P) % P)


def _ed_mul(k, pt):
    acc = (0, 1)
    while k:
        if k & 1:
            acc = _ed_add(acc, pt)
        pt = _ed_add(pt, pt)
        k >>= 1
    return acc


def _ed_decode(s):
    y = int.from_bytes(s, "little") & ((1 << 255) - 1)
    xx = (y * y - 1) * pow(_D * y * y + 1, P - 2, P) % P
    x = pow(xx, (P + 3) // 8, P)
    if (x * x - xx) % P:
        x = x * _SQRTM1 % P
    if x % 2 != s[31] >> 7:
        x = P - x
    return x, y


def _ed_encode(pt):
    x, y = pt
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


_B = _ed_decode((4 * pow(5, P - 2, P) % P).to_bytes(32, "little"))


def _secret_scalar(seed):
    h = bytearray(hashlib.sha512(seed).digest()[:32])
    h[0] &= 248
    h[31] &= 127
    h[31] |= 64
    return int.from_bytes(h, "little")


def _hram(r, a, m):
    return int.from_bytes(hashlib.sha512(r + a + m).digest(), "little") % L


# libsodium's Edwards small-order encodings (sign bit clear)
_ORDER8_Y = [
    "26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05",
    "c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac037a"]
ED_SMALL_ORDER = ([bytes(32), (1).to_bytes(32, "little")]
                  + [bytes.fromhex(h) for h in _ORDER8_Y]
                  + [(P - 1).to_bytes(32, "little"), P.to_bytes(32, "little"),
                     (P + 1).to_bytes(32, "little")])
_ORDER8_U = [
    "e0eb7a7c3b41b8ae1656e3faf19fc46ada098deb9c32b1fd866205165f49b800",
    "5f9c95bca3508c24b1d0b1559c83ef5b04445cc4581c8e86d8224eddd09f1157"]
X25519_SMALL_ORDER = (
    [bytes(32), (1).to_bytes(32, "little")]
    + [bytes.fromhex(h) for h in _ORDER8_U]
    + [(P - 1).to_bytes(32, "little"), P.to_bytes(32, "little"),
       (P + 1).to_bytes(32, "little"),
       # the ignored top bit set on an order-8 point and on 0
       (int.from_bytes(bytes.fromhex(_ORDER8_U[0]), "little")
        | (1 << 255)).to_bytes(32, "little"),
       (1 << 255).to_bytes(32, "little")])


# -- sealed boxes ------------------------------------------------------------


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("direction", ["port_seals", "reference_seals"])
def test_seal_round_trip_across_packages(direction, size):
    rng = np.random.default_rng(size)
    msg = _rng_bytes(rng, size)
    pk, sk = ref.box_keypair() if direction == "port_seals" \
        else sodium.box_keypair()
    if direction == "port_seals":
        box = sodium.seal(msg, pk)
        assert ref.seal_open(box, pk, sk) == msg
    else:
        box = ref.seal(msg, pk)
        assert sodium.seal_open(box, pk, sk) == msg
    assert len(box) == size + sodium.SEAL_OVERHEAD


@pytest.mark.parametrize("size", SIZES)
def test_sealed_box_layout_and_nonce(size):
    """epk || MAC || c, where MAC || c is libsodium's crypto_box_easy under
    the nonce BLAKE2b-192(epk || pk)."""
    rng = np.random.default_rng(1000 + size)
    msg = _rng_bytes(rng, size)
    pk, _ = ref.box_keypair()
    esk = _rng_bytes(rng, 32)
    epk = _scalarmult_base(esk)
    nonce = hashlib.blake2b(epk + pk, digest_size=24).digest()
    box = sodium.seal_with_ephemeral(msg, pk, esk)
    assert box == epk + _ref_box_easy(msg, nonce, pk, esk)


def test_box_public_is_scalarmult_base():
    rng = np.random.default_rng(5)
    for _ in range(64):
        sk = _rng_bytes(rng, 32)
        assert sodium.box_public(sk) == _scalarmult_base(sk)
    pk, sk = sodium.box_keypair()
    assert pk == _scalarmult_base(sk)


@given(msg=st.binary(max_size=300), esk=st.binary(min_size=32, max_size=32))
@settings(max_examples=40, deadline=None)
def test_seal_with_ephemeral_opens_under_reference(msg, esk):
    pk, sk = ref.box_keypair()
    assert ref.seal_open(sodium.seal_with_ephemeral(msg, pk, esk), pk, sk) \
        == msg


@functools.lru_cache(maxsize=None)
def _tampered_cases():
    rng = np.random.default_rng(11)
    pk, sk = ref.box_keypair()
    other_pk, other_sk = ref.box_keypair()
    box = bytearray(ref.seal(_rng_bytes(rng, 100), pk))
    cases = {}
    for name, at in (("epk", 3), ("mac", 40), ("body", 90)):
        flipped = bytearray(box)
        flipped[at] ^= 0x20
        cases[f"flip_{name}"] = (bytes(flipped), pk, sk)
    cases["wrong_sk"] = (bytes(box), pk, other_sk)
    cases["wrong_pk"] = (bytes(box), other_pk, sk)
    cases["short"] = (bytes(box[:47]), pk, sk)
    cases["empty"] = (b"", pk, sk)
    for i, bad in enumerate(X25519_SMALL_ORDER):
        cases[f"small_order_epk_{i}"] = (bad + bytes(box[32:]), pk, sk)
    return cases


_TAMPERED = (["flip_epk", "flip_mac", "flip_body", "wrong_sk", "wrong_pk",
              "short", "empty"]
             + [f"small_order_epk_{i}" for i in range(len(X25519_SMALL_ORDER))])


@pytest.mark.parametrize("case", _TAMPERED)
def test_seal_open_rejects_as_reference(case):
    box, pk, sk = _tampered_cases()[case]
    with pytest.raises(ValueError):
        ref.seal_open(box, pk, sk)
    with pytest.raises(ValueError):
        sodium.seal_open(box, pk, sk)


@pytest.mark.parametrize("index", range(len(X25519_SMALL_ORDER)))
def test_seal_to_small_order_key_fails_as_reference(index):
    bad = X25519_SMALL_ORDER[index]
    with pytest.raises(RuntimeError):
        ref.seal(b"x", bad)
    with pytest.raises(RuntimeError):
        sodium.seal(b"x", bad)


# -- Ed25519 ----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_sign_byte_equal_to_reference(seed):
    rng = np.random.default_rng(seed)
    key_seed = _rng_bytes(rng, 32)
    pk, sk = sodium.sign_seed_keypair(key_seed)
    assert (pk, sk) == _ref_seed_keypair(key_seed)
    assert sk == key_seed + pk
    for size in (0, 1, 64, 200, int(rng.integers(0, 5000))):
        msg = _rng_bytes(rng, size)
        sig = sodium.sign_detached(msg, sk)
        assert sig == ref.sign_detached(msg, sk)
        assert sodium.verify_detached(sig, msg, pk)
        assert ref.verify_detached(sig, msg, pk)


@given(seed=st.binary(min_size=32, max_size=32), msg=st.binary(max_size=500))
@settings(max_examples=40, deadline=None)
def test_sign_matches_reference_property(seed, msg):
    pk, sk = sodium.sign_seed_keypair(seed)
    assert (pk, sk) == _ref_seed_keypair(seed)
    assert sodium.sign_detached(msg, sk) == ref.sign_detached(msg, sk)


def test_sign_keypair_is_seed_keypair():
    pk, sk = sodium.sign_keypair()
    assert (pk, sk) == _ref_seed_keypair(sk[:32])


@functools.lru_cache(maxsize=None)
def _verify_cases():
    """(sig, msg, pk) triples, valid and not: tampered signatures, S >= L,
    small-order R, small-order and non-canonical keys, keys off the curve
    and keys with a torsion component."""
    rng = np.random.default_rng(21)
    seed = _rng_bytes(rng, 32)
    pk, sk = sodium.sign_seed_keypair(seed)
    msg = b"resource to sign"
    sig = sodium.sign_detached(msg, sk)
    a = _secret_scalar(seed)
    s_int = int.from_bytes(sig[32:], "little")
    cases = {"valid": (sig, msg, pk), "other_message": (sig, b"x", pk)}
    for at in (0, 17, 31, 32, 50, 63):
        bad = bytearray(sig)
        bad[at] ^= 0x04
        cases[f"flip_sig_{at}"] = (bytes(bad), msg, pk)
    # S + L and S + 2L verify mathematically; libsodium refuses them
    for k in (1, 2):
        cases[f"s_plus_{k}L"] = (
            sig[:32] + (s_int + k * L).to_bytes(32, "little"), msg, pk)
    cases["s_top_bits"] = (sig[:63] + bytes([sig[63] | 0xe0]), msg, pk)
    # small-order R with an S that satisfies the equation: refused
    for i, r in enumerate(ED_SMALL_ORDER):
        for sign in (0, 0x80):
            r_enc = r[:31] + bytes([r[31] | sign])
            s = _hram(r_enc, pk, msg) * a % L
            cases[f"small_order_r_{i}_{sign}"] = (
                r_enc + s.to_bytes(32, "little"), msg, pk)
    # small-order keys with a signature valid for them: refused
    for i, bad_pk in enumerate(ED_SMALL_ORDER):
        r = int(rng.integers(1, 1 << 62))
        r_enc = _ed_encode(_ed_mul(r, _B))
        cases[f"small_order_pk_{i}"] = (
            r_enc + r.to_bytes(32, "little"), msg, bad_pk)
    # non-canonical y = p + k
    for k in (2, 3, 9, 18):
        enc = (P + k).to_bytes(32, "little")
        cases[f"noncanonical_pk_{k}"] = (sig, msg, enc)
        cases[f"noncanonical_pk_{k}_neg"] = (
            sig, msg, enc[:31] + bytes([enc[31] | 0x80]))
    # keys off the curve
    for i in range(6):
        cases[f"random_pk_{i}"] = (sig, msg, _rng_bytes(rng, 32))
    # the key plus an order-8 point, with a signature honest under it
    t8 = _ed_decode(bytes.fromhex(_ORDER8_Y[0]))
    mixed = _ed_add(_ed_decode(pk), t8)
    mixed_enc = _ed_encode(mixed)
    r = int(rng.integers(1, 1 << 62))
    r_enc = _ed_encode(_ed_mul(r, _B))
    for trial in range(16):
        m = msg + bytes([trial])
        h = _hram(r_enc, mixed_enc, m)
        s = (r + h * a) % L
        cases[f"mixed_order_pk_{trial}"] = (
            r_enc + s.to_bytes(32, "little"), m, mixed_enc)
    return cases


_VERIFY = (
    ["valid", "other_message", "s_plus_1L", "s_plus_2L", "s_top_bits"]
    + [f"flip_sig_{at}" for at in (0, 17, 31, 32, 50, 63)]
    + [f"small_order_r_{i}_{sign}" for i in range(len(ED_SMALL_ORDER))
       for sign in (0, 0x80)]
    + [f"small_order_pk_{i}" for i in range(len(ED_SMALL_ORDER))]
    + [f"noncanonical_pk_{k}{neg}" for k in (2, 3, 9, 18)
       for neg in ("", "_neg")]
    + [f"random_pk_{i}" for i in range(6)]
    + [f"mixed_order_pk_{trial}" for trial in range(16)])


@pytest.mark.parametrize("case", _VERIFY)
def test_verify_agrees_with_reference(case):
    sig, msg, pk = _verify_cases()[case]
    want = ref.verify_detached(sig, msg, pk)
    assert sodium.verify_detached(sig, msg, pk) == want
    if case == "valid" or case.startswith("mixed_order_pk"):
        return
    assert not want


def test_verify_random_bit_flips_agree():
    rng = np.random.default_rng(33)
    pk, sk = sodium.sign_seed_keypair(_rng_bytes(rng, 32))
    msg = _rng_bytes(rng, 77)
    sig = sodium.sign_detached(msg, sk)
    for _ in range(64):
        which = int(rng.integers(0, 3))
        parts = [bytearray(sig), bytearray(msg), bytearray(pk)]
        target = parts[which]
        bit = int(rng.integers(0, 8 * len(target)))
        target[bit // 8] ^= 1 << (bit % 8)
        args = tuple(bytes(x) for x in parts)
        assert sodium.verify_detached(*args) == ref.verify_detached(*args)


# -- known answers, as chip_smoke.py checks them on the card's host ---------


def test_known_answers():
    assert sodium.box_public(bytes(range(32))) == KAT_BOX_PK
    pk, sk = sodium.sign_seed_keypair(bytes(range(32, 64)))
    assert pk == KAT_SIGN_PK
    assert sodium.sign_detached(KAT_MESSAGE, sk) == KAT_SIG
    assert sodium.seal_with_ephemeral(
        KAT_MESSAGE, KAT_BOX_PK, bytes(range(64, 96))) == KAT_SEALED
    # and they are libsodium's
    assert _scalarmult_base(bytes(range(32))) == KAT_BOX_PK
    assert ref.sign_detached(KAT_MESSAGE, sk) == KAT_SIG
    assert ref.seal_open(KAT_SEALED, KAT_BOX_PK, bytes(range(32))) \
        == KAT_MESSAGE


def test_chip_smoke_carries_the_same_known_answers():
    # the card's host-crypto check itself, at small sizes
    rec = chip_smoke.host_crypto(reps=1, sign_reps=2, sizes=(0, 1, 65),
                                 bundle=4096)
    assert rec["known_answers"] is True
    assert rec["round_trip_bytes"] == [0, 1, 65]


# -- the native participant core's boxes ------------------------------------


@pytest.mark.parametrize("masking", ["none", "full", "chacha"])
def test_embed_additive_blobs_open_under_reference(masking):
    keys = [ref.box_keypair() for _ in range(3)]
    rpk, rsk = ref.box_keypair()
    secret = [5, -3, 432, 1000, 0, 17]
    rec, blobs = native.embed_participate(
        secret, 433, 3, masking=masking, recipient_pk=rpk,
        clerk_pks=[pk for pk, _ in keys])
    shares = [varint.decode(ref.seal_open(b, pk, sk))
              for (pk, sk), b in zip(keys, blobs)]
    masked = np.sum(shares, axis=0) % 433
    if masking == "none":
        assert rec is None
        np.testing.assert_array_equal(masked, np.asarray(secret) % 433)
    elif masking == "full":
        mask = varint.decode(ref.seal_open(rec, rpk, rsk))
        np.testing.assert_array_equal((masked - mask) % 433,
                                      np.asarray(secret) % 433)
    else:
        assert len(varint.decode(ref.seal_open(rec, rpk, rsk))) == 4


def test_embed_packed_shamir_blobs_open_under_reference():
    from sda_tpu_torch.protocol import PackedShamirSharing

    scheme = PackedShamirSharing(secret_count=3, share_count=8,
                                 privacy_threshold=4, prime_modulus=433,
                                 omega_secrets=354, omega_shares=150)
    matrix = numtheory.share_matrix_for(scheme)
    keys = [ref.box_keypair() for _ in range(8)]
    secret = list(range(1, 10))
    rec, blobs = native.embed_participate(
        secret, 433, 8, clerk_pks=[pk for pk, _ in keys],
        share_matrix=matrix, secret_count=3)
    assert rec is None
    shares = np.stack([varint.decode(ref.seal_open(b, pk, sk))
                       for (pk, sk), b in zip(keys, blobs)])
    assert shares.shape == (8, 3)
    # the first 1 + k + t = 8 shares determine the polynomial; all lie on it
    assert ((shares >= 0) & (shares < 433)).all()


# -- no system libsodium -----------------------------------------------------

_NO_LIBSODIUM = r"""
import ctypes, ctypes.util, sys
_init = ctypes.CDLL.__init__
def _refuse(self, name, *args, **kwargs):
    if name is not None and "sodium" in str(name):
        raise OSError("refused: " + str(name))
    _init(self, name, *args, **kwargs)
ctypes.CDLL.__init__ = _refuse
ctypes.util.find_library = lambda name: None
sys.path.insert(0, sys.argv[1])
import test_torch_full_loop as fl
from sda_tpu_torch.protocol import FullMasking
from sda_tpu_torch.server import new_memory_server
fl.check_full_aggregation(
    fl.agg_default().replace(masking_scheme=FullMasking(modulus=433)),
    new_memory_server())
assert "sda_tpu" not in sys.modules and "jax" not in sys.modules
maps = open("/proc/self/maps").read()
assert "libsodium" not in maps, "a system libsodium was mapped"
print("revealed exactly")
"""


def test_full_loop_round_without_any_system_libsodium():
    res = subprocess.run(
        [sys.executable, "-c", _NO_LIBSODIUM, str(ROOT / "tests")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "revealed exactly" in res.stdout
