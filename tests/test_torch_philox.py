"""The arithmetic K1's main-path instance moved into the kernel
(``sda_tpu_torch/fields/csrc/columns.cuh``, ``philox.cuh``), mirrored in
torch and held to the port's existing functions on the CPU:

- the round keys the host passes (``philox_round_keys``) are the key
  schedule of ``philox4x32_10``;
- Philox4x32-10 with rounds 1-3 factored as the kernel factors them (by
  what the counter (b mod 2^32, b >> 32, q, pair) makes invariant) gives
  ``philox_bits``' words;
- the Solinas reduction that replaces ``%`` in the kernels' epilogue equals
  ``%`` up to the largest values the kernels reduce;
- the main-path instances' whole column (raw sums of the input words and
  of the drawn rows' words, one reduction a column, the contraction),
  masked and unmasked, gives ``fused_mask_share_combine_plain``'s output.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
to their plain versions bit for bit.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sda_tpu.fields import numtheory as ref_nt

from sda_tpu_torch.fields import fused_round, numtheory
from sda_tpu_torch.fields.fastfield import SolinasPrime
from sda_tpu_torch.fields.sharing import batch_columns
from sda_tpu_torch.protocol import PackedShamirSharing

M32 = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
P29 = ref_nt.generate_packed_params(3, 8, 28)[1]
SP = SolinasPrime.try_from(P29)


def _mulhilo(m, c):
    """(hi, lo) of m * c for int64 word tensors c (no int64 overflow)."""
    return fused_round._mulhilo32(m, c)


def _round(c, k0, k1):
    hi0, lo0 = _mulhilo(M0, c[0])
    hi1, lo1 = _mulhilo(M1, c[2])
    return [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]


def philox_keyed(c, keys):
    """Ten Philox rounds on int64 word tensors, round r keyed by
    ``keys[:, r]``: the kernels' ``philox4x32_10`` (philox.cuh)."""
    c = list(c)
    for r in range(10):
        c = _round(c, int(keys[0, r]), int(keys[1, r]))
    return c


def philox_factored(b, q, pair, keys):
    """The words of block (b, q, pair) as columns.cuh's ``Fold::run``
    computes them, with rounds 1-3 split into what depends on the column
    alone (hoisted before the participant loop), on the participant alone
    (once a participant) and on both (in the loop). The kernel runs it for
    b < 2^32, where b_hi = 0 and the participant terms need no column."""
    k0, k1 = [int(k) for k in keys[0]], [int(k) for k in keys[1]]
    b_lo, b_hi = b & M32, b >> 32
    # per thread: round 1's M0*b, round 2's M1*c2 of the pair
    hA, lA = _mulhilo(M0, b_lo)
    hC, lC = _mulhilo(M1, hA ^ pair ^ k1[0])
    # per participant: round 1's M1*q, round 2's M0*c0, round 3's M1*c2
    hQ, lQ = _mulhilo(M1, q)
    hB, lB = _mulhilo(M0, hQ ^ b_hi ^ k0[0])
    hE, lE = _mulhilo(M1, hB ^ lA ^ k1[1])
    # per pair, in the loop: round 3's M0*c0, then rounds 4-10
    hD, lD = _mulhilo(M0, hC ^ lQ ^ k0[1])
    c = [hE ^ lC ^ k0[2], lE, hD ^ lB ^ k1[2], lD]
    for r in range(3, 10):
        c = _round(c, k0[r], k1[r])
    return c


def mod_solinas(x, sp: SolinasPrime):
    """x mod p for int64 x in [0, 2^63) as the kernels' ``mod_p`` takes it
    (columns.cuh): fold the bits above e down (2^e = c mod p) while there
    are any, then one conditional subtract."""
    low = (1 << sp.b) - 1
    while bool((x >> sp.b).any()):
        x = (x >> sp.b) * sp.delta + (x & low)
    return torch.where(x >= sp.p, x - sp.p, x)


# -- round keys ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2**32 - 1, 2**32, 2**40 + 5,
                                  2**64 - 1, 123456789012345678])
def test_round_keys_are_philox_key_schedule(seed):
    keys = fused_round.philox_round_keys(seed)
    assert keys.shape == (2, 10) and keys.dtype == np.uint32
    assert (int(keys[0, 0]), int(keys[1, 0])) == (seed & M32, seed >> 32)
    rng = np.random.default_rng(seed % 1000)
    c = [torch.from_numpy(rng.integers(0, 1 << 32, size=64, dtype=np.int64))
         for _ in range(4)]
    want = fused_round.philox4x32_10(*c, seed & M32, seed >> 32)
    for g, w in zip(philox_keyed(c, keys), want):
        assert torch.equal(g, w)


def test_round_keys_wrap_mod_2_32():
    keys = fused_round.philox_round_keys(2**64 - 1).astype(np.int64)
    steps = (keys[:, 1:] - keys[:, :-1]) % (1 << 32)
    assert (steps[0] == 0x9E3779B9).all() and (steps[1] == 0xBB67AE85).all()


# -- the factored Philox --------------------------------------------------------

def _bits_words(seed, P, B, b, q, pair):
    """Words (0..3) of block (b, q, pair) read back from ``philox_bits``
    (masked k=3, t=4: pair j holds value rows 2j and 2j+1)."""
    k, t = 3, 4
    bits = fused_round.philox_bits(seed, P, k, t, B, True, "cpu")
    nmask = k

    def rows(c):
        if c < k:
            return c, k + c
        return 2 * nmask + (c - k), 2 * nmask + t + (c - k)

    hi0, lo0 = rows(2 * pair)
    words = [bits[q, hi0, b], bits[q, lo0, b]]
    if 2 * pair + 1 < k + t:
        hi1, lo1 = rows(2 * pair + 1)
        words += [bits[q, hi1, b], bits[q, lo1, b]]
    return words


@pytest.mark.parametrize("seed", [0, 2**40 + 3, 2**64 - 1])
def test_factored_philox_is_philox_bits(seed):
    P, B = 5, 37
    keys = fused_round.philox_round_keys(seed)
    b = torch.arange(B, dtype=torch.int64)[None, :].expand(P, B)
    q = torch.arange(P, dtype=torch.int64)[:, None].expand(P, B)
    for pair in range(4):
        got = philox_factored(b, q, pair, keys)
        want = _bits_words(seed, P, B, slice(None), slice(None), pair)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@settings(max_examples=60, deadline=None)
@given(b=st.integers(0, 2**33), q=st.integers(0, 2**31 - 1),
       pair=st.integers(0, 3), seed=st.integers(0, 2**64 - 1))
def test_factored_philox_any_counter(b, q, pair, seed):
    """Random (b, q, pair, seed), b up to 2^33 (b_hi != 0 included):
    the factoring is exact against the unfactored ``philox4x32_10``, the
    function ``philox_bits`` draws with."""
    keys = fused_round.philox_round_keys(seed)
    one = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    got = philox_factored(one(b), one(q), pair, keys)
    want = fused_round.philox4x32_10(one(b & M32), one(b >> 32), one(q),
                                     one(pair), seed & M32, seed >> 32)
    assert [int(g) for g in got] == [int(w) for w in want]


# -- the Solinas epilogue --------------------------------------------------------

PRIMES = [P29, (1 << 20) - 3, (1 << 29) - 3]


def _limits(p, P=100, k=3, t=4):
    """The largest values the kernels reduce: a word sum over P
    participants, the hi/lo combine of two residues, a share row."""
    return [P * M32, (p - 1) * ((1 << 32) % p) + p - 1, (k + t) * (p - 1) ** 2]


@pytest.mark.parametrize("p", PRIMES)
def test_mod_solinas_edges(p):
    sp = SolinasPrime.try_from(p)
    assert sp is not None and sp.p == p
    vals = [0, 1, p - 1, p, p + 1, 2 * p - 1, 2 * p, (1 << sp.b) - 1,
            1 << sp.b, M32, 1 << 32, (2**31 - 1) * M32, 2**63 - 1]
    for lim in _limits(p):
        vals += [lim, lim - 1]
    x = torch.tensor(vals, dtype=torch.int64)
    assert torch.equal(mod_solinas(x, sp), x % p)


@settings(max_examples=50, deadline=None)
@given(st.sampled_from(PRIMES), st.integers(0, 2), st.data())
def test_mod_solinas_below_the_limits(p, which, data):
    sp = SolinasPrime.try_from(p)
    lim = _limits(p)[which]
    vals = data.draw(st.lists(st.integers(0, lim), min_size=1, max_size=32))
    x = torch.tensor(vals, dtype=torch.int64)
    assert torch.equal(mod_solinas(x, sp), x % p)


def test_kernel_scalars_match_the_prime():
    keys, p, e, c = fused_round.kernel_scalars(SP, 2**40 + 9)
    assert p == P29 == (1 << e) - c and 20 <= e <= 29 and c < (1 << 14)
    assert np.array_equal(keys, fused_round.philox_round_keys(2**40 + 9))


# -- the main-path instances' column ------------------------------------------

def fold_columns(x, seed, sp: SolinasPrime, m_host, t: int, masked: bool):
    """K1's main-path instances (``Fold`` in columns.cuh, driven by
    ``fused_round_columns`` in fused_round.cu) in torch: over the
    participants, raw sums of the input words and of the hi and lo words of
    every drawn row (the factored Philox; the first drawn pair is k // 2
    when unmasked), one reduction a column, masks added, the share matrix
    minus its zero column contracted."""
    P, k, B = x.shape
    keys = fused_round.philox_round_keys(seed)
    b = torch.arange(B, dtype=torch.int64)[None, :].expand(P, B)
    q = torch.arange(P, dtype=torch.int64)[:, None].expand(P, B)
    rows = k + t
    vd = torch.zeros((rows, B), dtype=torch.int64)
    for pair in range(0 if masked else k // 2, (rows + 1) // 2):
        w = philox_factored(b, q, pair, keys)
        for h in range(2):
            row = 2 * pair + h
            if row < rows and (masked or row >= k):
                hi = mod_solinas(w[2 * h].sum(0), sp)
                lo = mod_solinas(w[2 * h + 1].sum(0), sp)
                vd[row] = mod_solinas(hi * ((1 << 32) % sp.p) + lo, sp)
    vx = mod_solinas((x.to(torch.int64) & M32).sum(0), sp)
    mask = vd[:k] if masked else torch.zeros_like(vx)
    v = torch.cat([mod_solinas(vx + mask, sp), vd[k:]])
    m = torch.from_numpy(np.asarray(m_host, dtype=np.int64)[:, 1:] % sp.p)
    return mod_solinas((m[:, :, None] * v[None]).sum(1), sp), mask


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("P", [1, 2, 5, 8])
def test_column_fold_is_the_plain_version(P, masked):
    """Odd and even P: the loop's pairs of participants and its tail."""
    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    scheme = PackedShamirSharing(3, 8, t, p, w2, w3)
    m_host = numtheory.share_matrix_for(scheme)
    words = np.random.default_rng(P).integers(0, 1 << 32, size=(P, 3 * 41),
                                              dtype=np.uint32)
    x = batch_columns(torch.from_numpy(words).view(torch.int32), 3)
    seed = 2**40 + P
    got = fold_columns(x, seed, SP, m_host, t, masked)
    want = fused_round.fused_mask_share_combine_plain(x, seed, SP, m_host, t,
                                                      masked)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
