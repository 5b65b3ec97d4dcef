"""K4's module (``sda_tpu_torch.crypto.paillier_tpu``) against Python ints
and the JAX package's ``MontgomeryContext``.

The port's R is 2^(32 L) over 32-bit limbs, the reference's 256^L over
8-bit limbs, so ``mont_mul`` is held to a * b * R^-1 mod m with the port's
R, and the premix (a product mod m, which no R changes) to the reference's
integers. On the CPU the wrapper runs the plain version (16-bit CIOS in
int64); the kernel's launch sequence (rows read in place, one launch a
fold or two where a lane's rows are split, the fix-up) is held here
against a Python model of the C entries, and the kernel itself on the
card by ``chip_smoke.py``. Every check is
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


def _words(addr, n, stride=1):
    return sum(ctypes.c_uint32.from_address(addr + 4 * stride * j).value
               << (32 * j) for j in range(n))


#: csrc/montgomery.cu's group instances (threads a group, limbs a thread),
#: by capacity; a larger L takes the wide kernel
INSTANCES = ((4, 8), (8, 8), (16, 8), (16, 12), (16, 16), (32, 16))


def _instance(limbs):
    return next((i for i in INSTANCES if i[0] * i[1] >= limbs), None)


class _EntryModel:
    """``csrc/montgomery.cu``'s C entries modelled in Python ints on host
    memory: the same pointers, strides and layout as the kernels (rows
    [P, B, L] row-major, balanced slices of a lane's rows, partials at
    out + (slice * lanes + lane) * limbs). Records each launch's instance
    (``(TPI, LPT)`` or ``"wide"``) and split; ``shape`` is what the
    occupancy query reports (threads a group and limbs a thread follow
    the instance table)."""

    def __init__(self, block_groups=None, blocks_sm=1, sms=1):
        self.entries, self.splits = [], []
        self.block_groups, self.blocks_sm, self.sms = (block_groups,
                                                       blocks_sm, sms)

    def sda_montfold_shape(self, limbs, *refs):
        inst = _instance(limbs)
        tpi, lpt = inst if inst else (1, 0)
        vals = (tpi, lpt, self.block_groups or 128 // tpi, self.blocks_sm,
                self.sms)
        for ref, v in zip(refs, vals):
            ref._obj.value = v
        return 0

    def sda_montfold(self, a, b, row_stride, rows, lanes, m, limbs, n_prime,
                     fix, split, out, work, stream):
        inst = _instance(limbs)
        assert 1 <= split <= rows and (rows == 1 or b)
        assert bool(work) == (inst is None)  # only the wide one has one
        self.entries.append(inst or "wide")
        self.splits.append(split)
        mod = _words(m, limbs)
        assert mod % 2 and (-mod * n_prime) % (1 << 32) == 1
        r_inv = pow(1 << (32 * limbs), -1, mod)

        def row(p, x):
            base = a if p == 0 else b + 4 * (p - 1) * row_stride
            v = _words(base + 4 * x * limbs, limbs)
            assert v < mod
            return v

        f = _words(fix, limbs) if fix else None
        for s in range(split):
            lo, hi = s * rows // split, (s + 1) * rows // split
            for x in range(lanes):
                acc = row(lo, x)
                for p in range(lo + 1, hi):
                    acc = acc * row(p, x) * r_inv % mod
                if f is not None:
                    acc = acc * f * r_inv % mod
                dst = out + 4 * (s * lanes + x) * limbs
                for j in range(limbs):
                    ctypes.c_uint32.from_address(dst + 4 * j).value = (
                        (acc >> (32 * j)) & 0xFFFFFFFF)
        return 0


@pytest.fixture
def k4_counts():
    k4 = pt.montgomery_kernel
    saved = (k4.launches, dict(k4.op_launches))
    k4.launches = 0
    k4.op_launches = dict.fromkeys(pt.OPS, 0)
    yield k4
    k4.launches, k4.op_launches = saved


def _fold_case(rng, bits, P, B):
    m = _odd_modulus(rng, bits)
    ctx = MontgomeryContext(m)
    vals = _rng_ints(rng, m, P * B)
    x = _limbs(ctx, vals).reshape(P, B, ctx.L)
    want = [1] * B
    for p in range(P):
        want = [w * v % m for w, v in zip(want, vals[p * B:(p + 1) * B])]
    return ctx, x, torch.from_numpy(ctx.fold_fix(P)), want


@pytest.mark.parametrize("P", [1, 2, 3, 5, 7])
def test_launch_sequence_against_entry_model(P, k4_counts):
    """The fold reads the [P, B, L] rows in place (no limb-major copy) in
    one launch, or two where six lanes leave the card idle and the split
    pays for its second launch (P >= 5 here), and ``mont_mul`` is one
    launch of the two rows."""
    rng = np.random.default_rng(P)
    ctx, x, fix, want = _fold_case(rng, 100, P, 6)
    model = _EntryModel(blocks_sm=4, sms=132)
    got = pt._launches(model, 0, "fold", ctx, x, fix)
    assert torch.equal(got, pt.premix_plain(ctx, x, fix))
    assert ctx.from_limbs(got) == want
    split = pt.fold_split(P, 6, 32, 4 * 132) if P > 1 else 1
    assert (split > 1) == (P >= 5) and model.splits[0] == split
    assert k4_counts.op_launches == {"mont_mul": 0, "fold": 1,
                                     "partials": int(split > 1)}
    assert k4_counts.launches == 1 + (split > 1) <= 2
    a, b = x[0], x[-1]
    assert torch.equal(pt._launches(_EntryModel(), 0, "mont_mul", ctx, a, b),
                       pt.mont_mul_plain(ctx, a, b))
    assert k4_counts.op_launches["mont_mul"] == 1


@pytest.mark.parametrize("bits, entry", [
    (1023, (4, 8)), (4095, (16, 8)), (4100, (16, 12)), (6143, (16, 12)),
    (16_400, "wide")])
def test_every_limb_count_has_an_entry(bits, entry, k4_counts):
    """n^2 of a 512- or 2048-bit key (L = 32, 128) and of a 3072-bit key
    (L = 192) fill a group instance, L = 129 takes the L = 192 one with a
    masked tail, and only a modulus above 16,384 bits (L > 512) the wide
    one: no key size is refused on the card."""
    rng = np.random.default_rng(bits)
    ctx, x, fix, want = _fold_case(rng, bits, 3, 4)
    model = _EntryModel()
    got = pt._launches(model, 0, "fold", ctx, x, fix)
    assert model.entries == [entry] * len(model.splits)
    assert ctx.from_limbs(got) == want


def test_split_path_small_clerk(k4_counts):
    """Four lanes of 33 rows (a small clerk) cannot fill the card, so each
    lane's rows are split among groups and a second launch folds the
    partials with the fix-up: exact against Python ints and the plain
    version."""
    rng = np.random.default_rng(33)
    ctx, x, fix, want = _fold_case(rng, 300, 33, 4)
    model = _EntryModel(blocks_sm=4, sms=132)
    got = pt._launches(model, 0, "fold", ctx, x, fix)
    split = pt.fold_split(33, 4, 128 // 4, 4 * 132)
    assert split > 1 and model.splits == [split, 1]
    assert k4_counts.op_launches == {"mont_mul": 0, "fold": 1, "partials": 1}
    assert ctx.from_limbs(got) == want
    assert torch.equal(got, pt.premix_plain(ctx, x, fix))


@pytest.mark.parametrize("L", [4, 129, 192])
def test_masked_tail_limb_counts(L):
    """L not a multiple of the instance's threads or capacity (4 limbs on
    the 4 x 8 instance, 129 on the 16 x 12 one) and L = 192: the fold (its
    three lanes split on a card of 132 SMs) and ``mont_mul`` exact against
    Python ints and the plain version, with R = 2^(32 L)."""
    rng = np.random.default_rng(L)
    ctx, x, fix, want = _fold_case(rng, 32 * L - 1, 5, 3)
    assert ctx.L == L and _instance(L) is not None
    model = _EntryModel(blocks_sm=4, sms=132)
    got = pt._launches(model, 0, "fold", ctx, x, fix)
    assert model.splits[0] > 1
    assert ctx.from_limbs(got) == want
    assert torch.equal(got, pt.premix_plain(ctx, x, fix))
    a, b = x[0], x[1]
    r_inv = pow(1 << (32 * L), -1, ctx.modulus)
    got = pt._launches(_EntryModel(), 0, "mont_mul", ctx, a, b)
    assert ctx.from_limbs(got) == [u * v * r_inv % ctx.modulus for u, v in
                                   zip(ctx.from_limbs(a), ctx.from_limbs(b))]


def test_fold_fix_is_the_same_under_every_split(monkeypatch):
    """Any split of P rows does P - 1 montmuls, so one fix-up by R^P
    (``fold_fix(P)``) gives the exact product for every split 1..P (the
    split ``fold_split`` would choose is overridden)."""
    rng = np.random.default_rng(8)
    P = 8
    ctx, x, fix, want = _fold_case(rng, 200, P, 3)
    for split in range(1, P + 1):
        monkeypatch.setattr(pt, "fold_split", lambda *_, s=split: s)
        model = _EntryModel()
        got = pt._launches(model, 0, "fold", ctx, x, fix)
        assert model.splits == ([1] if split == 1 else [split, 1])
        assert ctx.from_limbs(got) == want, split


def test_fold_split_fills_the_card():
    """A split pays only where a lane has rows enough (not at two), grows
    as the lanes get fewer, never exceeds the rows or MAX_SPLIT, and at the
    flagship column (P=100 x 7,408, L=128 on 132 SMs) keeps the fold at
    two launches."""
    assert pt.fold_split(2, 132 * 64, 16, 4 * 132) == 1
    assert (pt.fold_split(100, 4, 32, 528) >= pt.fold_split(100, 7408, 32, 528)
            > 1)
    assert pt.fold_split(1, 4, 16, 528) == 1
    assert pt.fold_split(3, 4, 16, 528) <= 3
    assert 1 < pt.fold_split(33, 256, 32, 528) < 33
    assert pt.fold_split(10_000, 4, 32, 528) == pt.MAX_SPLIT
    assert 1 <= pt.fold_split(100, 7408, 16, 4 * 132) <= pt.MAX_SPLIT


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
