"""The recipes of ``tests/test_native.py`` against the port's native core
(``sda_tpu_torch/native/``, built from the port's ``native/src/
sda_native.cpp`` with its own ``crypto/csrc/sodium.c``): every function
bit-exact with the Python spec, and with the reference's native library
on the same inputs."""

import random

import numpy as np
import pytest

from sda_tpu import native as ref_native
from sda_tpu.crypto import masking as ref_masking
from sda_tpu.protocol import ChaChaMasking as RefChaChaMasking
from sda_tpu_torch import native
from sda_tpu_torch.fields import chacha
from sda_tpu_torch.fields.modular import np_modmatmul


def test_native_builds_here():
    """The port builds its core from its own sources wherever a host
    compiler is: no skip, unlike the reference's optional library."""
    assert native.available()


def test_native_modmatmul_matches_python_ints():
    rng = np.random.default_rng(0)
    p = (1 << 31) - 1  # Mersenne prime, above the int32 kernel limit
    a = rng.integers(0, p, size=(5, 37), dtype=np.int64)
    b = rng.integers(0, p, size=(37, 11), dtype=np.int64)
    got = native.modmatmul(a, b, p)
    expect = [[sum(int(a[i, k]) * int(b[k, j]) for k in range(37)) % p
               for j in range(11)] for i in range(5)]
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(got, ref_native.modmatmul(a, b, p))


def test_native_modmatmul_matches_numpy_kernel():
    rng = np.random.default_rng(1)
    p = 754974721
    a = rng.integers(0, p, size=(8, 16), dtype=np.int64)
    b = rng.integers(0, p, size=(16, 100), dtype=np.int64)
    got = native.modmatmul(a, b, p)
    np.testing.assert_array_equal(got, np_modmatmul(a, b, p))
    np.testing.assert_array_equal(got, ref_native.modmatmul(a, b, p))


def test_native_modsum():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 433, size=(50, 200), dtype=np.int64)
    got = native.modsum_axis0(x, 433)
    np.testing.assert_array_equal(got, x.sum(axis=0) % 433)
    np.testing.assert_array_equal(got, ref_native.modsum_axis0(x, 433))


@pytest.mark.parametrize("dim, m", [(1, 433), (1000, 433), (257, 754974721),
                                    (64, 2)])
def test_native_chacha_bit_exact_with_python_spec(dim, m):
    seed = [0xDEADBEEF, 0x12345678, 0x9ABCDEF0, 0x0F0F0F0F]
    got = native.chacha_expand_mask(seed, dim, m, prg=chacha.CHACHA_PRG_V1)
    np.testing.assert_array_equal(got, chacha.expand_mask(seed, dim, m))
    np.testing.assert_array_equal(got, ref_native.chacha_expand_mask(
        seed, dim, m, prg=chacha.CHACHA_PRG_V1))


def test_native_chacha_combine():
    seeds = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]],
                     dtype=np.int64)
    dim, m = 500, 433
    expect = np.zeros(dim, dtype=np.int64)
    for s in seeds:
        expect = (expect + chacha.expand_mask([int(w) for w in s], dim, m)) % m
    got = native.chacha_combine_masks(seeds, dim, m, prg=chacha.CHACHA_PRG_V1)
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(got, ref_native.chacha_combine_masks(
        seeds, dim, m, prg=chacha.CHACHA_PRG_V1))


def test_masking_layer_uses_native_consistently():
    """The ChaCha masker round-trips whichever backend serves it, and the
    reference's combiner re-expands the port's seed to the same mask."""
    from sda_tpu_torch.crypto import masking
    from sda_tpu_torch.protocol import ChaChaMasking

    scheme = ChaChaMasking(433, 100, 128)
    masker = masking.new_secret_masker(scheme, "cpu")
    s = np.arange(100, dtype=np.int64) % 433
    seed, masked = masker.mask(s)
    total = masking.new_mask_combiner(scheme, "cpu").combine([seed])
    out = masking.new_secret_unmasker(scheme, "cpu").unmask(total, masked)
    np.testing.assert_array_equal(out, s)
    ref_total = ref_masking.new_mask_combiner(
        RefChaChaMasking(433, 100, 128)).combine([seed])
    np.testing.assert_array_equal(ref_total, total)


def test_native_powmod_matches_pow():
    """Montgomery ladder == CPython pow across sizes, the Paillier shapes
    included (2048-bit exponent mod 4096-bit n^2), as the reference's."""
    random.seed(11)
    for bits in (64, 127, 256, 1024, 2048):
        mod = random.getrandbits(bits) | 1 | (1 << (bits - 1))
        base = random.getrandbits(bits + 7)
        exp = random.getrandbits(random.choice([1, 64, bits]))
        got = native.powmod(base, exp, mod)
        assert got == pow(base, exp, mod) == ref_native.powmod(base, exp, mod)
    assert native.powmod(5, 0, 7) == 1
    assert native.powmod(0, 123, 97) == 0
    mod = random.getrandbits(2048) | 1 | (1 << 2047)
    bases = [random.getrandbits(2040) for _ in range(4)]
    e = random.getrandbits(1024)
    assert native.powmod_batch(bases, e, mod) == [pow(b, e, mod)
                                                  for b in bases]
    with pytest.raises(ValueError):
        native.powmod(2, 3, 10)  # even modulus unsupported
    with pytest.raises(ValueError):
        ref_native.powmod(2, 3, 10)


def test_paillier_uses_native_powmod_consistently():
    """Paillier encrypt/decrypt are identical with and without the native
    ladder, and the reference decrypts the port's ciphertext."""
    from sda_tpu.crypto import paillier as ref_paillier
    from sda_tpu_torch.crypto import paillier

    pk, sk = paillier.keygen(512)
    m = 123456789
    c = paillier.encrypt(pk, m, r=987654321 % pk.n)
    orig = paillier._powmod
    try:
        paillier._powmod = pow
        c_py = paillier.encrypt(pk, m, r=987654321 % pk.n)
        m_py = paillier.decrypt(sk, c)
    finally:
        paillier._powmod = orig
    assert c == c_py
    assert paillier.decrypt(sk, c) == m_py == m
    ref_pk = ref_paillier.PaillierPublicKey.from_bytes(pk.to_bytes())
    ref_sk = ref_paillier.PaillierSecretKey.from_bytes(sk.to_bytes())
    assert ref_paillier.encrypt(ref_pk, m, r=987654321 % pk.n) == c
    assert ref_paillier.decrypt(ref_sk, c) == m
