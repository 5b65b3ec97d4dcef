"""Solinas-prime field algebra on int64 tensors — port of
``sda_tpu/fields/fastfield.py``.

For primes of Solinas form

    p = 2^b - delta,   20 <= b <= 29,   delta < 2^14,

reduction is shift/add (``2^b ≡ delta (mod p)``). The reference holds
residues in uint32 lanes; torch has almost no uint32 arithmetic (``+``,
``>>``, comparisons and ``where`` are missing), so here every residue
lives in an int64 tensor. The functions keep the reference's limb streams,
fan bounds and canonicalization points, so every intermediate stays below
2^32 exactly as there, and every output is the canonical residue in
[0, p): bit-identical to the reference on the same inputs
(tests/test_torch_fastfield.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from .._lazy import torch

from .modular import _random_words

_LOW = 15  # low-limb width: limbs < 2^15 keep 15x15-bit products < 2^30
_MASK32 = 0xFFFFFFFF


class SolinasPrime:
    """Parameter pack for p = 2^b - delta; ``try_from`` gates eligibility."""

    __slots__ = ("p", "b", "delta")

    def __init__(self, p: int, b: int, delta: int):
        self.p = p
        self.b = b
        self.delta = delta

    @staticmethod
    def try_from(p: int) -> Optional["SolinasPrime"]:
        b = p.bit_length()
        delta = (1 << b) - p
        if not (20 <= b <= 29):
            return None
        if delta >= (1 << 14):
            return None
        # canon32 does ONE conditional subtract after _reduce; its input
        # r < 2^b + (2^(32-b))*delta must stay < 2p
        if delta * (1 + (1 << (32 - b))) >= p:
            return None
        return SolinasPrime(p, b, delta)

    def __repr__(self):
        return f"SolinasPrime(2^{self.b} - {self.delta})"


def supported(p: int) -> bool:
    return SolinasPrime.try_from(p) is not None


# ---------------------------------------------------------------------------
# Scalar helpers (int64 tensors holding values < 2^32)

def _reduce(v, sp: SolinasPrime):
    """v < 2^32  ->  r ≡ v (mod p), r < p + 8*delta (< 2p)."""
    q = v >> sp.b
    return v - q * sp.p


def canon32(v, sp: SolinasPrime):
    """v < 2^32 -> canonical residue in [0, p)."""
    r = _reduce(v, sp)
    return torch.where(r >= sp.p, r - sp.p, r)


def to_residues32(inputs, sp: SolinasPrime):
    """Any-integer tensor -> canonical int64 residues mod p.

    uint32 words are canonicalized directly; int32 negatives are read as
    their two's-complement words (v + 2^32) and corrected by 2^32 mod p,
    as in the reference; wider integers take a plain floor-mod.
    """
    if inputs.dtype == torch.uint32:
        return canon32(inputs.to(torch.int64), sp)
    if inputs.dtype == torch.int32:
        bits = inputs.to(torch.int64) & _MASK32
        r = canon32(bits, sp)
        r32 = torch.full_like(r, (1 << 32) % sp.p)
        return torch.where(inputs < 0, modsub32(r, r32, sp), r)
    return torch.remainder(inputs.to(torch.int64), sp.p)


def modadd32(a, b, sp: SolinasPrime):
    """Canonical a, b -> canonical a+b (sum < 2p < 2^30)."""
    s = a + b
    return torch.where(s >= sp.p, s - sp.p, s)


def modsub32(a, b, sp: SolinasPrime):
    """Canonical a, b -> canonical a-b."""
    d = a - b
    return torch.where(a >= b, d, d + sp.p)


def _compose(t1, t0, sp: SolinasPrime):
    """t1*2^15 + t0 mod p -> canonical, for t1 < 2^31, t0 < 2^31."""
    t1 = canon32(t1, sp)                                     # < p < 2^b
    t1h = t1 >> (sp.b - _LOW)                                # < 2^15
    t1l = t1 & ((1 << (sp.b - _LOW)) - 1)                    # < 2^(b-15)
    # t1*2^15 = t1h*2^b + t1l*2^15 ≡ t1h*delta + t1l*2^15
    v = t0 + t1h * sp.delta + (t1l << _LOW)
    # bound: 2^31 + 2^29 + 2^29 < 2^32
    return canon32(v, sp)


def mulmod32_const(x, c: int, sp: SolinasPrime):
    """Canonical x (< p) times Python-int constant c (< p), canonical out."""
    c = c % sp.p
    c15 = (c << _LOW) % sp.p
    xh = x >> _LOW                                           # < 2^(b-15) <= 2^14
    xl = x & ((1 << _LOW) - 1)                               # < 2^15
    # x*c = xh*(c*2^15) + xl*c; split both constants into 15-bit limbs
    t1 = xh * (c15 >> _LOW) + xl * (c >> _LOW)               # < 2^30
    t0 = xh * (c15 & 0x7FFF) + xl * (c & 0x7FFF)             # < 2^31
    return _compose(t1, t0, sp)


def modsum32(x, sp: SolinasPrime, axis: int = 0):
    """Canonical residues summed along ``axis`` -> canonical (clerk kernel).

    Tree reduction with a canonicalizing fold every ``fan`` terms, fan
    chosen so partial sums stay < 2^32 (fan*(p-1) < 2^32).
    """
    fan = (0xFFFFFFFF) // (sp.p - 1) if sp.p > 1 else 8
    fan = max(2, min(256, fan))
    x = torch.movedim(x.to(torch.int64), axis, 0)
    while x.shape[0] > 1:
        n = x.shape[0]
        chunk = min(fan, n)
        pad = (-n) % chunk
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)
        x = x.reshape((x.shape[0] // chunk, chunk) + tuple(x.shape[1:]))
        x = canon32(x.sum(dim=1), sp)
    return x[0]


def uniform_from_bits(hi_bits, lo_bits, sp: SolinasPrime):
    """Two 32-bit words (int64 in [0, 2^32)) -> canonical uniform residue:
    (hi*2^32 + lo) mod p with the exact constant-multiply reduction."""
    hi = canon32(hi_bits, sp)
    lo = canon32(lo_bits, sp)
    r32 = (1 << 32) % sp.p
    return modadd32(mulmod32_const(hi, r32, sp), lo, sp)


def uniform32(generator: torch.Generator, shape, sp: SolinasPrime):
    """Uniform canonical residues from 64 random bits per element, drawn
    from ``generator`` on its device — same <= p/2^64 statistical distance
    as the generic uniform_mod."""
    bits = _random_words(generator, tuple(shape) + (2,))
    return uniform_from_bits(bits[..., 0], bits[..., 1], sp)


# ---------------------------------------------------------------------------
# The contraction kernel: out = (M @ v) mod p, M a small host-side matrix

def matrix_limbs(m_host, sp: SolinasPrime, device):
    """[n, k] host matrix (ints mod p) -> (high, low) 15-bit limb tensors."""
    m = np.asarray(m_host, dtype=np.int64) % sp.p
    low_mask = (1 << _LOW) - 1
    mh = torch.as_tensor(m >> _LOW, dtype=torch.int64, device=device)
    ml = torch.as_tensor(m & low_mask, dtype=torch.int64, device=device)
    return mh, ml


def modmatmul32(m_host, v, sp: SolinasPrime):
    """[n, k] host matrix (ints mod p) times canonical [..., k, B] int64.

    Builds the matrix limbs host-side and contracts via
    :func:`modmatmul32_limbs`.
    """
    m_host = np.asarray(m_host)
    n, k = m_host.shape
    if v.shape[-2] != k:
        raise ValueError(f"contraction mismatch: M has k={k}, v has {v.shape[-2]}")
    mh, ml = matrix_limbs(m_host, sp, v.device)
    return modmatmul32_limbs(mh, ml, v, sp)


def modmatmul32_limbs(mh, ml, v, sp: SolinasPrime):
    """Core contraction on pre-split matrix limbs.

    ``mh``/``ml``: [n, k] int64 high/low 15-bit limbs of a matrix of
    canonical residues; ``v``: canonical [..., k, B] int64.

    Limb streams with per-stream overflow-safe fan-in (bounds for b <= 29,
    low limbs < 2^15, high limbs < 2^(b-15) <= 2^14):

      hh = mh*vh < 2^28   (scale 2^30)    hl/lh = *h**l < 2^29 (scale 2^15)
      ll = ml*vl < 2^30   (scale 1)

    Each stream folds (canonical reduce) whenever another chunk of terms
    would overflow 32 bits; the scale-2^30 stream re-enters through
    ``mulmod32_const(.., 2^30 mod p)``.
    """
    n, k = mh.shape
    low_mask = (1 << _LOW) - 1
    vh = v >> _LOW                                           # [..., k, B] < 2^14
    vl = v & low_mask                                        # [..., k, B] < 2^15

    hi_max = (1 << (sp.b - _LOW)) - 1
    bounds = {
        "hh": hi_max * hi_max,
        "hl": hi_max * low_mask,
        "ll": low_mask * low_mask,
    }
    fans = {s: max(1, 0xFFFFFFFF // bound) for s, bound in bounds.items()}
    # one chunking of the contraction axis serves all streams
    chunk = max(1, min(fans.values()))

    def stream(a_limbs, b_limbs):
        # a: [n, k]; b: [..., k, B] -> sum over k of a*b, folded per chunk
        acc = None
        for start in range(0, k, chunk):
            part = None
            for j in range(start, min(start + chunk, k)):
                term = a_limbs[:, j][:, None] * b_limbs[..., j, :][..., None, :]
                part = term if part is None else part + term  # [..., n, B]
            part = canon32(part, sp)
            acc = part if acc is None else modadd32(acc, part, sp)
        return acc                                           # canonical < p

    s_hh = stream(mh, vh)
    s_hl = stream(mh, vl)
    s_lh = stream(ml, vh)
    s_ll = stream(ml, vl)

    c30 = (1 << 30) % sp.p
    t0 = modadd32(s_ll, mulmod32_const(s_hh, c30, sp), sp)   # < p
    t1 = modadd32(s_hl, s_lh, sp)                            # < p
    return _compose(t1, t0, sp)                              # t1*2^15 + t0


# ---------------------------------------------------------------------------
# NumPy mirror (oracle for bit-exactness tests)

def np_modmatmul32(m_host: np.ndarray, v: np.ndarray, sp: SolinasPrime) -> np.ndarray:
    m = np.asarray(m_host, dtype=object) % sp.p
    vv = np.asarray(v, dtype=object)
    return (m @ vv % sp.p).astype(np.uint32)
