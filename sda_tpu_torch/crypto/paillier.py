"""Packed Paillier: additively homomorphic share-transport encryption.

The reference *declares* this scheme but ships it disabled —
``AdditiveEncryptionScheme::PackedPaillier`` is commented out with exactly
four parameters (`protocol/src/crypto.rs:164-174`): ``component_count``
(values packed per ciphertext), ``component_bitsize`` (bit window per
component), ``max_value_bitsize`` (bound on fresh values), and
``min_modulus_bitsize`` (plaintext-modulus floor). This module implements
the scheme for real, so a committee can *sum ciphertexts without ever
decrypting shares*: Paillier ciphertexts multiply to add their plaintexts,
and the bit-window headroom ``component_bitsize - max_value_bitsize``
guarantees packed components never carry into each other for up to
``2^headroom`` summands.

Everything here is host-side ``int`` arithmetic (public-key crypto has no
business on the MXU); the bulk field math stays on device. Keys are
CRT-accelerated on decrypt. No external dependencies — primality testing is
deterministic-for-64-bit / random-witness Miller-Rabin over ``secrets``.
"""

from __future__ import annotations

import functools
import math
import secrets
from dataclasses import dataclass
from typing import List, Sequence

# deterministic witness set: correct for all n < 3.3e24 (Sorenson & Webster)
_SMALL_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41)
_SMALL_PRIMES = [p for p in range(2, 1000) if all(p % q for q in range(2, p)) and p > 1]


def is_probable_prime(n: int, rounds: int = 40) -> bool:
    """Miller-Rabin. Deterministic below 3.3e24, else ``rounds`` random bases."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n == p:
            return True
        if n % p == 0:
            return False
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    if n < 3_317_044_064_679_887_385_961_981:
        witnesses: Sequence[int] = _SMALL_WITNESSES
    else:
        witnesses = [secrets.randbelow(n - 3) + 2 for _ in range(rounds)]
    for a in witnesses:
        x = pow(a % n, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def random_prime(bits: int) -> int:
    """A uniform ``bits``-bit probable prime (top two bits set so p*q is full-width)."""
    if bits < 8:
        raise ValueError("prime size must be at least 8 bits")
    while True:
        candidate = secrets.randbits(bits) | (1 << (bits - 1)) | (1 << (bits - 2)) | 1
        if is_probable_prime(candidate):
            return candidate


@dataclass(frozen=True)
class PaillierPublicKey:
    """n = p*q; g is fixed to n+1 (standard, makes encryption one mulmod)."""

    n: int

    @property
    def n_squared(self) -> int:
        return self.n * self.n

    @property
    def bitsize(self) -> int:
        return self.n.bit_length()

    def to_bytes(self) -> bytes:
        return self.n.to_bytes((self.n.bit_length() + 7) // 8, "big")

    @classmethod
    def from_bytes(cls, raw: bytes) -> "PaillierPublicKey":
        return cls(int.from_bytes(raw, "big"))


@dataclass(frozen=True)
class PaillierSecretKey:
    """Factorisation of n, with CRT decryption precomputation."""

    p: int
    q: int

    @functools.cached_property
    def n(self) -> int:
        return self.p * self.q

    @functools.cached_property
    def _crt(self) -> tuple:
        """Per-key constants: (p^2, q^2, hp, hq, p^-1 mod q).

        hp = L((n+1)^(p-1) mod p^2)^-1 mod p = ((p-1)*q)^-1 mod p; likewise
        hq. Cached so decrypting a large ciphertext batch does one extended
        gcd per key, not three per ciphertext.
        """
        p, q = self.p, self.q
        hp = pow((p - 1) * q % p, -1, p)
        hq = pow((q - 1) * p % q, -1, q)
        return (p * p, q * q, hp, hq, pow(p, -1, q))

    def to_bytes(self) -> bytes:
        pb = self.p.to_bytes((self.p.bit_length() + 7) // 8, "big")
        qb = self.q.to_bytes((self.q.bit_length() + 7) // 8, "big")
        return len(pb).to_bytes(4, "big") + pb + qb

    @classmethod
    def from_bytes(cls, raw: bytes) -> "PaillierSecretKey":
        plen = int.from_bytes(raw[:4], "big")
        return cls(int.from_bytes(raw[4 : 4 + plen], "big"),
                   int.from_bytes(raw[4 + plen :], "big"))


def _powmod(base: int, exp: int, mod: int) -> int:
    """pow() with the native Montgomery ladder when it wins (odd moduli at
    Paillier sizes — ~3-4x CPython's pow at 2048-bit keys, sda_native.cpp
    sda_powmod); falls back to builtin pow silently."""
    if exp >= 0 and (mod & 1) and mod.bit_length() >= 512:
        from .. import native

        if native.available():
            try:
                return native.powmod(base, exp, mod)
            except (ValueError, RuntimeError):
                pass
    return pow(base, exp, mod)


def keygen(modulus_bits: int) -> tuple[PaillierPublicKey, PaillierSecretKey]:
    """Fresh keypair with an exactly-``modulus_bits``-bit n."""
    half = modulus_bits // 2
    while True:
        p = random_prime(half)
        q = random_prime(modulus_bits - half)
        if p != q:
            n = p * q
            if n.bit_length() == modulus_bits:
                return PaillierPublicKey(n), PaillierSecretKey(p, q)


def encrypt(pk: PaillierPublicKey, m: int, r: int | None = None) -> int:
    """c = (1 + m*n) * r^n  mod n^2 (g = n+1 shortcut)."""
    if not 0 <= m < pk.n:
        raise ValueError("plaintext out of range [0, n)")
    n, n2 = pk.n, pk.n_squared
    if r is None:
        while True:
            r = secrets.randbelow(n)
            if r and math.gcd(r, n) == 1:
                break
    return (1 + m * n) % n2 * _powmod(r, n, n2) % n2


def add(pk: PaillierPublicKey, c1: int, c2: int) -> int:
    """Homomorphic plaintext addition: ciphertext multiplication mod n^2."""
    return c1 * c2 % pk.n_squared


def decrypt(sk: PaillierSecretKey, c: int) -> int:
    """CRT decryption: ~4x faster than the textbook lambda/mu path."""
    p, q, n = sk.p, sk.q, sk.n
    if not 0 <= c < n * n:
        raise ValueError("ciphertext out of range [0, n^2)")
    p2, q2, hp, hq, p_inv_q = sk._crt
    mp = (_powmod(c % p2, p - 1, p2) - 1) // p * hp % p
    mq = (_powmod(c % q2, q - 1, q2) - 1) // q * hq % q
    return mp + p * ((mq - mp) * p_inv_q % q)


# ---------------------------------------------------------------------------
# Component packing (crypto.rs:165-173 parameter semantics)

def pack(values: Sequence[int], component_bitsize: int) -> int:
    """Pack values little-endian-component-first into one plaintext int."""
    m = 0
    for i, v in enumerate(values):
        if v < 0 or v.bit_length() > component_bitsize:
            raise ValueError(
                f"component {v} exceeds the {component_bitsize}-bit window"
            )
        m |= v << (i * component_bitsize)
    return m


def unpack(m: int, component_count: int, component_bitsize: int) -> List[int]:
    mask = (1 << component_bitsize) - 1
    return [(m >> (i * component_bitsize)) & mask for i in range(component_count)]
