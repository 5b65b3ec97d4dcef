"""Role-level parity of the port's crypto modules with ``sda_tpu.crypto``.

Both packages draw their share and mask randomness from ChaCha seeds
(``fields.chacha.random_seed``); each test hands both the same seeded
sequence of seeds, so generators, combiners, reconstructors and maskers
must agree bit for bit. Every case runs at the sharing module's
``HOST_PATH_MAX`` default (small vectors take the numpy oracle) and at 0
(the JAX package's jnp path against the port's torch path on the CPU).
"""

import numpy as np
import pytest

from sda_tpu.crypto import masking as ref_masking
from sda_tpu.crypto import sharing as ref_sharing
from sda_tpu.fields import chacha as ref_chacha
from sda_tpu.fields import numtheory as ref_nt

from sda_tpu_torch.crypto import CryptoModule, MemoryKeystore, rand
from sda_tpu_torch.crypto import masking, sharing
from sda_tpu_torch.fields import chacha
from sda_tpu_torch.protocol import (
    CHACHA_PRG_RAND03,
    CHACHA_PRG_V1,
    AdditiveSharing,
    BasicShamirSharing,
    ChaChaMasking,
    FullMasking,
    NoMasking,
    PackedShamirSharing,
)
from sda_tpu_torch.convert import resource_from_reference

_T, P29, _W2, _W3 = ref_nt.generate_packed_params(3, 8, 28)

SHARING = {
    "additive": AdditiveSharing(share_count=3, modulus=433),
    "additive-wide": AdditiveSharing(share_count=5, modulus=(1 << 61) - 1),
    "packed-433": PackedShamirSharing(3, 8, 4, 433, 354, 150),
    "packed-flagship": PackedShamirSharing(3, 8, _T, P29, _W2, _W3),
    "basic-shamir": BasicShamirSharing(5, 2, 433),
}
DIMS = [4, 1000, 2999]


def _ref(scheme):
    """The reference package's scheme of the same wire object."""
    from sda_tpu.protocol import (
        LinearMaskingScheme as RefMasking,
        LinearSecretSharingScheme as RefSharing,
    )

    obj = scheme.to_obj()
    if isinstance(scheme, (NoMasking, FullMasking, ChaChaMasking)):
        return RefMasking.from_obj(obj)
    return RefSharing.from_obj(obj)


def _modulus(scheme):
    return getattr(scheme, "prime_modulus", None) or scheme.modulus


def _seeded(seed):
    """A ``random_seed`` replacement drawing its words from ``seed``."""
    rng = np.random.default_rng(seed)

    def random_seed(seed_bitsize):
        return [int(w) for w in rng.integers(0, 1 << 32,
                                             size=(seed_bitsize + 31) // 32)]
    return random_seed


@pytest.fixture(params=["default", "zero"])
def host_path_max(request, monkeypatch):
    if request.param == "zero":
        monkeypatch.setattr(sharing, "HOST_PATH_MAX", 0)
        monkeypatch.setattr(ref_sharing, "HOST_PATH_MAX", 0)
    return request.param


@pytest.fixture
def same_seeds(monkeypatch):
    """``run(seed, ref_fn, port_fn)``: each side's draws from ``seed``."""
    def run(seed, ref_fn, port_fn):
        monkeypatch.setattr(ref_chacha, "random_seed", _seeded(seed))
        want = ref_fn()
        monkeypatch.setattr(chacha, "random_seed", _seeded(seed))
        got = port_fn()
        return want, got
    return run


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.int64
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", sorted(SHARING))
def test_share_generator(name, d, host_path_max, same_seeds):
    scheme = SHARING[name]
    secrets = np.random.default_rng(d).integers(0, min(_modulus(scheme), 1 << 20),
                                                size=d)
    want, got = same_seeds(
        d,
        lambda: ref_sharing.new_share_generator(_ref(scheme)).generate(secrets),
        lambda: sharing.new_share_generator(scheme, "cpu").generate(secrets))
    _assert_rows_equal(got, want)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", sorted(SHARING))
def test_share_combiner(name, d, host_path_max):
    scheme = SHARING[name]
    m = _modulus(scheme)
    rng = np.random.default_rng(d + 1)
    vectors = list(rng.integers(0, m, size=(7, d)))
    # an unreduced vector (a Paillier-premixed clerk batch decrypts so)
    vectors.append(rng.integers(0, 1 << 62, size=d))
    want = ref_sharing.new_share_combiner(_ref(scheme)).combine(vectors)
    got = sharing.new_share_combiner(scheme, "cpu").combine(vectors)
    _assert_rows_equal([got], [want])
    _assert_rows_equal([sharing.mod_combine(vectors, m, "cpu")],
                       [ref_sharing.mod_combine(vectors, m)])
    assert sharing.mod_combine([], m, "cpu").shape == (0,)


SURVIVORS = {
    "all": lambda n: list(range(n)),
    "reversed": lambda n: list(range(n))[::-1],
    "drop-first": lambda n: list(range(1, n)),
    "drop-middle": lambda n: [i for i in range(n) if i != n // 2],
}


#: additive sharing is n-of-n: only the whole committee reveals
RECONSTRUCT_CASES = [
    (name, survivors) for name in sorted(SHARING) for survivors in
    (("all", "reversed") if name.startswith("additive") else sorted(SURVIVORS))
]


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name,survivors", RECONSTRUCT_CASES)
def test_reconstructor(name, survivors, d, host_path_max, same_seeds):
    scheme = SHARING[name]
    m = _modulus(scheme)
    secrets = np.random.default_rng(d + 2).integers(0, min(m, 1 << 20), size=d)
    shares, _ = same_seeds(
        d, lambda: ref_sharing.new_share_generator(_ref(scheme)).generate(
            secrets), lambda: None)
    picked = SURVIVORS[survivors](scheme.output_size)
    indexed = [(i, shares[i]) for i in picked]
    want = ref_sharing.new_secret_reconstructor(_ref(scheme), d).reconstruct(
        indexed)
    got = sharing.new_secret_reconstructor(scheme, d, "cpu").reconstruct(
        indexed)
    _assert_rows_equal([got], [want])
    np.testing.assert_array_equal(got, secrets)


def test_reconstructor_below_quorum_raises():
    scheme = SHARING["packed-433"]
    rec = sharing.new_secret_reconstructor(scheme, 4, "cpu")
    with pytest.raises(ValueError, match="need at least 7"):
        rec.reconstruct([(i, np.zeros(2, np.int64)) for i in range(6)])
    add = sharing.new_secret_reconstructor(SHARING["additive"], 4, "cpu")
    with pytest.raises(ValueError, match="cannot tolerate"):
        add.reconstruct([(0, np.zeros(4, np.int64))])


def _maskings(d):
    return {
        "none": NoMasking(),
        "full": FullMasking(433),
        "full-flagship": FullMasking(P29),
        "chacha-rand03": ChaChaMasking(433, d, 128, prg=CHACHA_PRG_RAND03),
        "chacha-v1": ChaChaMasking(P29, d, 256, prg=CHACHA_PRG_V1),
    }


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", ["none", "full", "full-flagship",
                                  "chacha-rand03", "chacha-v1"])
def test_masker_mask_combine_unmask(name, d, host_path_max, same_seeds):
    scheme = _maskings(d)[name]
    ref_scheme = _ref(scheme)
    m = getattr(scheme, "modulus", 433)
    inputs = np.random.default_rng(d + 3).integers(0, min(m, 1 << 20),
                                                   size=(3, d))
    want, got = same_seeds(
        d,
        lambda: [ref_masking.new_secret_masker(ref_scheme).mask(x)
                 for x in inputs],
        lambda: [masking.new_secret_masker(scheme, "cpu").mask(x)
                 for x in inputs])
    for (gm, gx), (wm, wx) in zip(got, want):
        _assert_rows_equal([gm, gx], [wm, wx])
    masks = [mk for mk, _ in got]
    masked_sum = np.sum([x for _, x in got], axis=0) % m
    want_total = ref_masking.new_mask_combiner(ref_scheme).combine(masks)
    got_total = masking.new_mask_combiner(scheme, "cpu").combine(masks)
    _assert_rows_equal([got_total], [want_total])
    want_out = ref_masking.new_secret_unmasker(ref_scheme).unmask(
        want_total, masked_sum)
    got_out = masking.new_secret_unmasker(scheme, "cpu").unmask(
        got_total, masked_sum)
    _assert_rows_equal([got_out], [want_out])
    np.testing.assert_array_equal(got_out, inputs.sum(axis=0) % m)


def test_chacha_masker_ignores_the_device():
    """On the CPU the ChaCha masker takes the host leg (native C++, else
    numpy) and never calls K3; on a CUDA device it hands every expansion
    and the recipient's combine to K3 (``fields.chacha_device``), here
    redirected to K3's plain version."""
    from sda_tpu_torch.fields import chacha_device

    scheme = ChaChaMasking(433, 8, 128)
    calls = []

    def spy(name):
        real = getattr(chacha_device, name)

        def run(*args, device, **kwargs):
            calls.append((name, str(device)))
            return real(*args, device="cpu", **kwargs)
        return run

    mp = pytest.MonkeyPatch()
    try:
        for name in ("expand_mask", "combine_masks"):
            mp.setattr(chacha_device, name, spy(name))
        mk = CryptoModule(MemoryKeystore(), device="cpu").new_secret_masker(
            scheme)
        assert mk.device.type == "cpu"
        seed, masked = mk.mask(np.arange(8))
        assert seed.shape == (4,) and masked.shape == (8,)
        mk.combine([seed])
        assert calls == []
        card = masking.new_secret_masker(scheme, "cuda")
        seed2, masked2 = card.mask(np.arange(8))
        total = card.combine([seed, seed2])
    finally:
        mp.undo()
    assert calls == [("expand_mask", "cuda"), ("combine_masks", "cuda")]
    np.testing.assert_array_equal(
        total, mk.combine([seed, seed2]))
    np.testing.assert_array_equal(
        card.unmask(total, (masked + masked2) % 433), 2 * np.arange(8) % 433)


@pytest.mark.parametrize("shape", [(7,), (3, 1000)])
@pytest.mark.parametrize("modulus", [433, P29, (1 << 61) - 1])
def test_rand_uniform_fast(shape, modulus):
    a = rand.uniform(shape, modulus, mode="fast", device="cpu")
    b = rand.uniform(shape, modulus, mode="fast", device="cpu")
    assert a.shape == shape and a.dtype == np.int64
    assert a.min() >= 0 and a.max() < modulus
    assert not np.array_equal(a, b)


def test_rand_uniform_fast_resolves_the_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rand.uniform((4,), 433, mode="fast")


def test_crypto_module_threads_its_device():
    cm = CryptoModule(MemoryKeystore(), device="cpu")
    assert cm.device.type == "cpu"
    for make in (cm.new_share_generator, cm.new_share_combiner):
        assert make(SHARING["packed-433"]).device == cm.device
    assert cm.new_secret_reconstructor(SHARING["additive"], 4).device \
        == cm.device
    for make in (cm.new_secret_masker, cm.new_mask_combiner,
                 cm.new_secret_unmasker):
        assert make(FullMasking(433)).device == cm.device


def _paillier_batches(rows, seed=5):
    """A 512-bit PackedPaillier key of the port and ``rows`` framed share
    batches under it (12 ciphertexts each)."""
    from sda_tpu_torch.crypto import encryption
    from sda_tpu_torch.protocol import PackedPaillierEncryption

    scheme = PackedPaillierEncryption(2, 48, 32, 512)
    kp = encryption.new_encryption_keypair(scheme)
    enc = encryption.new_share_encryptor(kp.ek, scheme)
    rng = np.random.default_rng(seed)
    batches = [enc.encrypt(rng.integers(0, 1 << 32, size=24))
               for _ in range(rows)]
    return scheme, kp.ek, batches


@pytest.mark.parametrize("chunk_rows", [512, 4], ids=["one-chunk", "chunked"])
def test_paillier_device_premix_matches_host_and_reference(
        chunk_rows, monkeypatch, caplog):
    """``SDA_PREMIX_DEVICE=1`` folds through K4 (its plain version on the
    CPU): the framed product is byte-identical to the port's host fold and
    to the reference's ``paillier_combine`` with its device premix on jax
    cpu (which must not have fallen back to its host fold)."""
    import logging

    from sda_tpu import protocol as ref_protocol
    from sda_tpu.crypto import encryption as ref_enc
    from sda_tpu_torch.crypto import encryption

    scheme, ek, batches = _paillier_batches(9)
    monkeypatch.delenv("SDA_PREMIX_DEVICE", raising=False)
    host = encryption.paillier_combine(ek, scheme, batches)
    monkeypatch.setenv("SDA_PREMIX_DEVICE", "1")
    monkeypatch.setattr(encryption, "PREMIX_DEVICE", "cpu")
    monkeypatch.setattr(encryption, "_DEVICE_PREMIX_CHUNK_ROWS", chunk_rows)
    monkeypatch.setattr(ref_enc, "_DEVICE_PREMIX_CHUNK_ROWS", chunk_rows)
    legs = []
    device_leg = encryption._device_premix_rows
    monkeypatch.setattr(encryption, "_device_premix_rows",
                        lambda pk, rows: legs.append(len(rows))
                        or device_leg(pk, rows))
    dev = encryption.paillier_combine(ek, scheme, batches)
    assert legs == [9]  # 9 rows x 12 ciphertexts: above the floor of 64
    ref_scheme = ref_protocol.PackedPaillierEncryption(2, 48, 32, 512)
    ref_ek = ref_protocol.EncryptionKey(
        "PackedPaillier", ref_protocol.Binary(ek.value.data))
    ref_batches = [ref_protocol.Encryption(
        "PackedPaillier", ref_protocol.Binary(b.value.data)) for b in batches]
    with caplog.at_level(logging.WARNING):
        ref = ref_enc.paillier_combine(ref_ek, ref_scheme, ref_batches)
    assert not any("falling back to host fold" in r.message
                   for r in caplog.records), "the reference's kernel never ran"
    assert dev.value.data == host.value.data == ref.value.data


def test_paillier_device_premix_failure_raises(monkeypatch):
    """A failing device leg raises: there is no fallback to the host fold
    (the reference logs a warning and folds on the host instead)."""
    from sda_tpu_torch.crypto import encryption, paillier_tpu

    scheme, ek, batches = _paillier_batches(9)
    monkeypatch.setenv("SDA_PREMIX_DEVICE", "1")

    def boom(self, cts, device=None):
        raise RuntimeError("no device")

    monkeypatch.setattr(encryption, "PREMIX_DEVICE", "cpu")
    monkeypatch.setattr(paillier_tpu.MontgomeryContext, "premix", boom)
    with pytest.raises(RuntimeError, match="no device"):
        encryption.paillier_combine(ek, scheme, batches)
    # below the floor of 64 modmuls the fold is the host's, by rule
    small = encryption.paillier_combine(ek, scheme, batches[:2])
    monkeypatch.delenv("SDA_PREMIX_DEVICE")
    assert small.value.data == encryption.paillier_combine(
        ek, scheme, batches[:2]).value.data


def test_scheme_crosses_as_its_wire_object():
    for scheme in list(SHARING.values()) + list(_maskings(4).values()):
        cls = ("LinearMaskingScheme"
               if isinstance(scheme, (NoMasking, FullMasking, ChaChaMasking))
               else "LinearSecretSharingScheme")
        back = resource_from_reference(cls, _ref(scheme).to_obj())
        assert back.to_obj() == scheme.to_obj()
