"""K4's module (``sda_tpu_torch.crypto.paillier_tpu``) against Python ints
and the JAX package's ``MontgomeryContext``.

The port's R is 2^(32 L) over 32-bit limbs, the reference's 256^L over
8-bit limbs, so ``mont_mul`` is held to a * b * R^-1 mod m with the port's
R, and the premix (a product mod m, which no R changes) to the reference's
integers. On the CPU the wrapper runs the plain version (16-bit CIOS in
int64); the kernel's launch sequence (limb-major transposes, tree levels,
odd rows, the fix-up) is held here against a Python model of the C entry,
and the kernel itself on the card by ``chip_smoke.py``. Every check is
exact.
"""

import ctypes

import numpy as np
import pytest
import torch

from sda_tpu.crypto.paillier_tpu import MontgomeryContext as RefContext

from sda_tpu_torch.benchmarks.bounds import PIPE_OPS_PER_S, k4_bound
from sda_tpu_torch.crypto import encryption, paillier
from sda_tpu_torch.crypto import paillier_tpu as pt
from sda_tpu_torch.crypto.paillier_tpu import MontgomeryContext


def _rng_ints(rng, m, n):
    return [int.from_bytes(rng.bytes(m.bit_length() // 8 + 8), "little") % m
            for _ in range(n)]


def _limbs(ctx, values):
    return torch.from_numpy(ctx.to_limbs(values))


def _odd_modulus(rng, bits):
    return (1 << bits) | int(rng.integers(1, 1 << 32)) | 1


@pytest.mark.parametrize("bits", [64, 200, 521, 1024, 4096])
def test_mont_mul_exact_vs_python(bits):
    rng = np.random.default_rng(bits)
    m = _odd_modulus(rng, bits)
    ctx = MontgomeryContext(m)
    assert ctx.L == -(-m.bit_length() // 32)
    r_inv = pow(1 << (32 * ctx.L), -1, m)
    a = _rng_ints(rng, m, 6) + [0, 1, m - 1]
    b = _rng_ints(rng, m, 6) + [m - 1, 0, m - 1]
    got = ctx.from_limbs(ctx.mont_mul(_limbs(ctx, a), _limbs(ctx, b)))
    assert got == [(x * y * r_inv) % m for x, y in zip(a, b)]


def test_mont_mul_output_canonical_and_reduced():
    rng = np.random.default_rng(7)
    m = ((1 << 256) | int(rng.integers(1, 1 << 40))) | 1
    ctx = MontgomeryContext(m)
    a = _limbs(ctx, _rng_ints(rng, m, 16) + [m - 1] * 4)
    out = ctx.mont_mul(a, a)
    assert out.dtype == torch.int32 and out.shape == a.shape
    for v in ctx.from_limbs(out):
        assert 0 <= v < m  # fully reduced


@pytest.mark.parametrize("P", [1, 2, 3, 5, 16, 600])
def test_premix_matches_reference(P, monkeypatch):
    """The port's premix, and the device leg of ``paillier_combine``
    (chunked at 512 rows: 600 crosses the chunk tree), equal the JAX
    package's ``MontgomeryContext.premix`` as integers."""
    rng = np.random.default_rng(100 + P)
    m = ((1 << 300) | int(rng.integers(1, 1 << 40))) | 1
    B = 3
    cts = [_rng_ints(rng, m, B) for _ in range(P)]
    want = RefContext(m).premix(cts)
    assert MontgomeryContext(m).premix(cts, device="cpu") == want
    monkeypatch.setattr(encryption, "PREMIX_DEVICE", "cpu")
    monkeypatch.setattr(encryption, "_MONT_CTX_CACHE",
                        type(encryption._MONT_CTX_CACHE)())

    class Key:
        n_squared = m

    assert encryption._device_premix_rows(Key, cts) == want


def test_device_leg_folds_wire_values_as_residues(monkeypatch):
    """A wire ciphertext at or above n^2 folds as its residue, as the host
    ``paillier.add`` fold reduces it (K4 takes operands below m)."""
    rng = np.random.default_rng(9)
    m = ((1 << 200) | int(rng.integers(1, 1 << 40))) | 1
    rows = [_rng_ints(rng, m, 4) for _ in range(20)]
    rows[3][1] += m
    rows[7][2] += 5 * m

    class Key:
        n_squared = m

    monkeypatch.setattr(encryption, "PREMIX_DEVICE", "cpu")
    want = [1] * 4
    for row in rows:
        want = [w * c % m for w, c in zip(want, row)]
    assert encryption._device_premix_rows(Key, rows) == want


def test_premix_is_paillier_homomorphic_sum():
    pk, sk = paillier.keygen(512)
    ctx = MontgomeryContext(pk.n_squared)
    assert ctx.L == 32  # n^2 of a 512-bit key: K4's L=32 instance
    rng = np.random.default_rng(13)
    P, B = 5, 3
    plains = [[int(rng.integers(0, 1 << 48)) for _ in range(B)]
              for _ in range(P)]
    cts = [[paillier.encrypt(pk, plains[p][b]) for b in range(B)]
           for p in range(P)]
    got = ctx.premix(cts, device="cpu")
    for b in range(B):
        host = cts[0][b]
        for p in range(1, P):
            host = paillier.add(pk, host, cts[p][b])
        assert got[b] == host  # bit-identical ciphertext product
        assert paillier.decrypt(sk, got[b]) == sum(
            plains[p][b] for p in range(P))


@pytest.mark.parametrize("bits", [33, 200, 4096])
def test_limb_round_trip(bits):
    rng = np.random.default_rng(bits)
    m = _odd_modulus(rng, bits)
    ctx = MontgomeryContext(m)
    values = [0, 1, m - 1] + _rng_ints(rng, m, 5)
    limbs = ctx.to_limbs(values)
    assert limbs.dtype == np.int32 and limbs.shape == (len(values), ctx.L)
    assert ctx.from_limbs(limbs) == values
    assert ctx.from_limbs(torch.from_numpy(limbs)) == values
    want = [[(v >> (32 * j)) & 0xFFFFFFFF for j in range(ctx.L)]
            for v in values]
    assert limbs.view(np.uint32).tolist() == want
    with pytest.raises(ValueError, match="out of range"):
        ctx.to_limbs([m])
    assert ctx.from_limbs(ctx.fold_fix(3)[None]) == [pow(ctx.R, 3, m)]


def _words(addr, n):
    return sum(ctypes.c_uint32.from_address(addr + 4 * j).value << (32 * j)
               for j in range(n))


class _EntryModel:
    """``csrc/montgomery.cu``'s C entries modelled in Python ints on host
    memory: the same pointers, strides and layout as the kernels. Records
    the entry each launch took."""

    def __init__(self):
        self.entries = []

    def sda_montmul(self, *args):
        *operands, m, limbs, n_prime, stream = args
        assert limbs in pt.UNROLLED_LIMBS
        self.entries.append("unrolled")
        return self._montmul(*operands, _words(m.value, limbs), limbs,
                             n_prime)

    def sda_montmul_wide(self, *args):
        *operands, m, limbs, n_prime, work, threads, stream = args
        assert work and 1 <= threads <= pt.WIDE_THREADS
        self.entries.append("wide")
        return self._montmul(*operands, _words(m, limbs), limbs, n_prime)

    @staticmethod
    def _montmul(a, a_pair, b, b_pair, b_limb, b_lane, out, out_pair, lanes,
                 pairs, mod, limbs, n_prime):
        assert (-mod * n_prime) % (1 << 32) == 1
        r_inv = pow(1 << (32 * limbs), -1, mod)
        for k in range(pairs):
            for x in range(lanes):
                A = sum(ctypes.c_uint32.from_address(
                    a + 4 * (k * a_pair + j * lanes + x)).value << (32 * j)
                    for j in range(limbs))
                B = sum(ctypes.c_uint32.from_address(
                    b + 4 * (k * b_pair + i * b_limb + x * b_lane)).value
                    << (32 * i) for i in range(limbs))
                assert A < mod and B < mod
                r = A * B * r_inv % mod
                for j in range(limbs):
                    ctypes.c_uint32.from_address(
                        out + 4 * (k * out_pair + j * lanes + x)).value = (
                        (r >> (32 * j)) & 0xFFFFFFFF)
        return 0


@pytest.fixture
def k4_counts():
    k4 = pt.montgomery_kernel
    saved = (k4.launches, dict(k4.op_launches), k4.level_launches.copy())
    k4.launches = 0
    k4.op_launches = dict.fromkeys(pt.OPS, 0)
    k4.level_launches.clear()
    yield k4
    k4.launches, k4.op_launches = saved[0], saved[1]
    k4.level_launches.clear()
    k4.level_launches.update(saved[2])


@pytest.mark.parametrize("P", [1, 2, 3, 5, 7])
def test_launch_sequence_against_entry_model(P, k4_counts):
    rng = np.random.default_rng(P)
    m = _odd_modulus(rng, 100)
    ctx = MontgomeryContext(m)
    x = _limbs(ctx, _rng_ints(rng, m, P * 6)).reshape(P, 6, ctx.L)
    fix = torch.from_numpy(ctx.fold_fix(P))
    got = pt._launches(_EntryModel(), 0, "fold", ctx, x, fix)
    assert torch.equal(got, pt.premix_plain(ctx, x, fix))
    levels = (P - 1).bit_length()
    assert k4_counts.op_launches == {"mont_mul": 0, "fold": levels, "fix": 1}
    assert k4_counts.launches == levels + 1
    assert dict(k4_counts.level_launches) == {i: 1 for i in range(levels)}
    a, b = x[0], x[-1]
    assert torch.equal(pt._launches(_EntryModel(), 0, "mont_mul", ctx, a, b),
                       pt.mont_mul_plain(ctx, a, b))
    assert k4_counts.op_launches["mont_mul"] == 1


@pytest.mark.parametrize("bits, entry", [
    (1023, "unrolled"), (4095, "unrolled"), (4100, "wide"), (6143, "wide")])
def test_every_limb_count_has_an_entry(bits, entry, k4_counts):
    """n^2 of a 512- or 2048-bit key (L = 32, 128) takes an unrolled
    instance, a modulus above 4096 bits (a 3072-bit key's n^2 has L = 192)
    the wide one: no key size is refused on the card."""
    rng = np.random.default_rng(bits)
    m = _odd_modulus(rng, bits)
    ctx = MontgomeryContext(m)
    vals = _rng_ints(rng, m, 3 * 4)
    x = _limbs(ctx, vals).reshape(3, 4, ctx.L)
    fix = torch.from_numpy(ctx.fold_fix(3))
    model = _EntryModel()
    got = pt._launches(model, 0, "fold", ctx, x, fix)
    assert model.entries == [entry] * 3  # two tree levels and the fix-up
    assert ctx.from_limbs(got) == [vals[b] * vals[4 + b] * vals[8 + b] % m
                                   for b in range(4)]


def test_wrapper_checks_and_cpu_dispatch(k4_counts):
    rng = np.random.default_rng(3)
    m = _odd_modulus(rng, 90)
    ctx = MontgomeryContext(m)
    a = _limbs(ctx, _rng_ints(rng, m, 4))
    # a CPU tensor runs the plain version: no launch is counted
    assert torch.equal(ctx.mont_mul(a, a), pt.mont_mul_plain(ctx, a, a))
    assert torch.equal(ctx.premix_limbs(a[None]), a)
    assert k4_counts.launches == 0
    with pytest.raises(ValueError, match="int32 limbs"):
        ctx.mont_mul(a.to(torch.int64), a)
    with pytest.raises(ValueError, match="differ in shape"):
        ctx.mont_mul(a, a[:2])
    with pytest.raises(ValueError, match="nothing to fold"):
        ctx.premix_limbs(a[None][:0])
    # a device that cannot run K4 is not malformed input: RuntimeError
    with pytest.raises(RuntimeError, match="runs on CUDA or the CPU"):
        ctx.mont_mul(a.to("meta"), a.to("meta"))
    with pytest.raises(ValueError, match="odd modulus"):
        MontgomeryContext(1 << 64)
    if not torch.cuda.is_available():  # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ctx.premix([[1, 2]])


def test_k4_bound_counts_the_cios():
    ms, by, detail = k4_bound(100 * 7408, 128, 100, 7408)
    assert by == "operations" and "32896 wide multiplies" in detail
    assert ms == pytest.approx(740_800 * 32_896 / (PIPE_OPS_PER_S / 2) * 1e3)
    ms, by, _ = k4_bound(1, 1, 10**9, 1)
    assert by == "bytes"
