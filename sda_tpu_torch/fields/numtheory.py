"""Host-side exact number theory: primes, roots of unity, NTT/Lagrange matrices.

A copy of ``sda_tpu/fields/numtheory.py`` (numpy and Python integers only),
kept here so the port imports nothing of the JAX package;
tests/test_torch_numtheory.py pins the two copies to the same matrices.

Everything here runs in Python integers (exact, no overflow) and is cheap:
matrices are committee-sized (tens of rows), built once per scheme and cached.
The *device* side (``sda_tpu_torch.fields.modular``) then applies them as batched
modular matmuls over millions of batch columns — that split is the central
TPU-first design decision: polynomial evaluation/interpolation of the packed
Shamir scheme (reference: external crate ``threshold-secret-sharing`` 0.2,
used via client/src/crypto/sharing/packed_shamir.rs:13-44) becomes a single
``[n, m2] @ [m2, B]`` matmul on the MXU instead of per-batch FFTs.

Scheme structure (reference protocol/src/crypto.rs:98-113):
- ``omega_secrets`` has power-of-2 order ``m2 = secret_count + privacy_threshold + 1``;
- ``omega_shares`` has power-of-3 order ``m3 = share_count + 1``;
- the share polynomial is the unique degree < m2 polynomial through
  ``(1, 0), (omega_secrets^1, secret_1), ..., (omega_secrets^k, secret_k),
  (omega_secrets^{k+1}, r_1), ...``;
- share i (1-based) is its value at ``omega_shares^i``.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Primality and roots

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all i64)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in _SMALL_PRIMES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def mod_inv(a: int, p: int) -> int:
    return pow(a % p, p - 2, p)


def element_of_order(order: int, p: int) -> int:
    """Find an element of exact multiplicative order ``order`` in Z_p*."""
    if (p - 1) % order != 0:
        raise ValueError(f"{order} does not divide p-1={p - 1}")
    # factor `order` (orders here are 2^a * 3^b, tiny)
    factors = set()
    o = order
    for f in (2, 3):
        while o % f == 0:
            factors.add(f)
            o //= f
    if o != 1:
        d = 2
        while d * d <= o:
            while o % d == 0:
                factors.add(d)
                o //= d
            d += 1
        if o > 1:
            factors.add(o)
    for g in range(2, p):
        w = pow(g, (p - 1) // order, p)
        if all(pow(w, order // f, p) != 1 for f in factors):
            return w
    raise ValueError("no element of requested order found")


def next_power(base: int, minimum: int) -> int:
    v = 1
    while v < minimum:
        v *= base
    return v


def find_prime_with_orders(order2: int, order3: int, min_bits: int = 0) -> int:
    """A prime p >= 2^min_bits with order2*order3 | p-1 (orders coprime).

    Prefers Solinas-form primes (p = 2^b - small delta) so device rounds hit
    the uint32 fast path (``fields.fastfield``); falls back to the smallest
    qualifying prime otherwise.
    """
    from . import fastfield

    step = order2 * order3
    # p = 2^b - delta >= 2^min_bits needs b > min_bits; fastfield caps b at 29
    for b in range(max(min_bits + 1, 20), 30):
        for delta in range(1, 1 << 13):
            p = (1 << b) - delta
            # step == 1 (no order constraints, e.g. BasicShamir primes) is
            # trivially satisfied; p % 1 == 0 would otherwise skip every
            # candidate and silently lose the Solinas fast path
            if p < (1 << min_bits) or (step > 1 and p % step != 1):
                continue
            if fastfield.supported(p) and is_prime(p):
                return p
    c = max(1, ((1 << min_bits) - 1) // step)
    while True:
        p = c * step + 1
        if p.bit_length() > 31:
            raise ValueError("no suitable prime below 2^31 (device kernel limit)")
        if p >= (1 << min_bits) and is_prime(p):
            return p
        c += 1


def validate_packed_scheme(secret_count, share_count, privacy_threshold,
                           prime_modulus, omega_secrets, omega_shares) -> None:
    """Check the algebraic preconditions of a PackedShamir parameter set."""
    m2 = secret_count + privacy_threshold + 1
    m3 = share_count + 1
    if m2 & (m2 - 1):
        raise ValueError(f"secret_count+privacy_threshold+1={m2} must be a power of 2")
    n3 = m3
    while n3 % 3 == 0:
        n3 //= 3
    if n3 != 1:
        raise ValueError(f"share_count+1={m3} must be a power of 3")
    if not is_prime(prime_modulus):
        raise ValueError(f"{prime_modulus} is not prime")
    if prime_modulus >= (1 << 31):
        raise ValueError(
            f"prime modulus {prime_modulus} >= 2^31: residues must fit 31 bits "
            "for the device limb kernels to stay exact"
        )
    p = prime_modulus
    if pow(omega_secrets, m2, p) != 1 or pow(omega_secrets, m2 // 2, p) == 1:
        raise ValueError("omega_secrets does not have exact order m2")
    if pow(omega_shares, m3, p) != 1 or pow(omega_shares, m3 // 3, p) == 1:
        raise ValueError("omega_shares does not have exact order m3")


def generate_packed_params(
    secret_count: int, share_count: int, min_modulus_bits: int = 0
) -> Tuple[int, int, int, int]:
    """Choose (privacy_threshold, prime, omega_secrets, omega_shares).

    ``share_count + 1`` must be a power of 3 (2, 8, 26, 80, ... clerks);
    the privacy threshold is maximised under the power-of-2 constraint:
    t = next_pow2(secret_count+2) - secret_count - 1 at least 1.
    Mirrors the parameter discipline tss users had to follow by hand.
    """
    m3 = share_count + 1
    v = m3
    while v % 3 == 0:
        v //= 3
    if v != 1:
        raise ValueError("share_count must be 3^a - 1 (2, 8, 26, 80, ...)")
    m2 = next_power(2, secret_count + 2)
    t = m2 - secret_count - 1
    if t >= share_count:
        raise ValueError(
            f"derived privacy threshold {t} >= share_count {share_count}; "
            "use more clerks or fewer packed secrets"
        )
    p = find_prime_with_orders(m2, m3, min_modulus_bits)
    w2 = element_of_order(m2, p)
    w3 = element_of_order(m3, p)
    return t, p, w2, w3


# ---------------------------------------------------------------------------
# Matrix builders (exact, host-side, cached per scheme)

def _ntt_matrix(omega: int, n: int, p: int) -> List[List[int]]:
    """V[i][j] = omega^(i*j) mod p — evaluation at the omega^i points."""
    pow_cache = [pow(omega, e, p) for e in range(n)]
    return [[pow_cache[(i * j) % n] for j in range(n)] for i in range(n)]


def _intt_matrix(omega: int, n: int, p: int) -> List[List[int]]:
    """Inverse NTT: (1/n) * omega^(-i*j); values at omega^i -> coefficients."""
    n_inv = mod_inv(n, p)
    w_inv = mod_inv(omega, p)
    pow_cache = [pow(w_inv, e, p) for e in range(n)]
    return [[n_inv * pow_cache[(i * j) % n] % p for j in range(n)] for i in range(n)]


@functools.lru_cache(maxsize=64)
def packed_share_matrix(
    secret_count: int,
    share_count: int,
    privacy_threshold: int,
    prime_modulus: int,
    omega_secrets: int,
    omega_shares: int,
) -> np.ndarray:
    """The [share_count, m2] matrix M with shares = M @ values (mod p).

    values = column vector [0; secrets (k); randomness (t)] — the polynomial's
    values at 1, omega_secrets^1..^{k+t}. M composes the inverse NTT (values ->
    coefficients, degree < m2) with evaluation at omega_shares^1..^n
    (coefficients zero-padded to m3). Share j (0-based row) is the value at
    omega_shares^{j+1}; the value at omega_shares^0 = 1 is the fixed 0 and is
    not a share.
    """
    validate_packed_scheme(secret_count, share_count, privacy_threshold,
                           prime_modulus, omega_secrets, omega_shares)
    p = prime_modulus
    m2 = secret_count + privacy_threshold + 1
    m3 = share_count + 1
    inv = _intt_matrix(omega_secrets, m2, p)          # [m2, m2]
    ev = _ntt_matrix(omega_shares, m3, p)             # [m3, m3]
    # compose: rows 1..m3-1 of (ev[:, :m2] @ inv)
    M = [
        [
            sum(ev[i][c] * inv[c][j] for c in range(m2)) % p
            for j in range(m2)
        ]
        for i in range(1, m3)
    ]
    out = np.array(M, dtype=np.int64)
    out.setflags(write=False)  # cached and shared; callers must not mutate
    return out


@functools.lru_cache(maxsize=64)
def basic_share_matrix(
    share_count: int, privacy_threshold: int, prime_modulus: int
) -> np.ndarray:
    """The [share_count, 2+t] matrix M with shares = M @ values (mod p) for
    classic Shamir (protocol BasicShamirSharing; reference declaration
    crypto.rs:89-95).

    values = [0 (fixed, keeps the packed-layout convention); secret;
    t random coefficients]. Share i (0-based row) is f(i+1) for
    f(x) = secret + sum_j r_j x^j — so M[i] = [0, 1, x_i, ..., x_i^t] with
    x_i = i + 1. No root-of-unity structure needed: any prime >
    share_count works (points 1..n stay distinct and nonzero).
    """
    n, t, p = share_count, privacy_threshold, prime_modulus
    if not 1 <= t < n:
        raise ValueError(f"privacy threshold {t} must be in [1, {n})")
    if p <= n:
        raise ValueError(f"prime {p} must exceed share_count {n}")
    M = [[0, 1] + [pow(i + 1, j, p) for j in range(1, t + 1)]
         for i in range(n)]
    out = np.array(M, dtype=np.int64)
    out.setflags(write=False)  # cached and shared; callers must not mutate
    return out


@functools.lru_cache(maxsize=256)
def basic_reconstruct_matrix(
    share_count: int, privacy_threshold: int, prime_modulus: int,
    indices: Tuple[int, ...],
) -> np.ndarray:
    """The [1, len(indices)+1] matrix L with [secret] = L @ [0; shares]:
    Lagrange interpolation at zero through points {i+1 for i in indices}.
    Any ``privacy_threshold + 1`` of the shares suffice; interpolating
    through a superset of surviving points yields the same degree-<=t
    polynomial, so larger sets stay exact."""
    n, t, p = share_count, privacy_threshold, prime_modulus
    if len(set(indices)) != len(indices):
        raise ValueError("duplicate share indices")
    if any(i < 0 or i >= n for i in indices):
        raise ValueError("share index out of range")
    if len(indices) < t + 1:
        raise ValueError(
            f"need at least {t + 1} shares to reconstruct, got {len(indices)}"
        )
    points = [i + 1 for i in indices]
    row = _lagrange_basis_row(points, 0, p)
    out = np.array([[0] + row], dtype=np.int64)
    out.setflags(write=False)
    return out


def share_matrix_for(scheme) -> np.ndarray:
    """Scheme-dispatched share matrix (PackedShamir | BasicShamir)."""
    if hasattr(scheme, "omega_secrets"):
        return packed_share_matrix(
            scheme.secret_count, scheme.share_count, scheme.privacy_threshold,
            scheme.prime_modulus, scheme.omega_secrets, scheme.omega_shares,
        )
    return basic_share_matrix(
        scheme.share_count, scheme.privacy_threshold, scheme.prime_modulus
    )


def reconstruct_matrix_for(scheme, indices: Tuple[int, ...]) -> np.ndarray:
    """Scheme-dispatched reconstruction matrix for surviving ``indices``."""
    if hasattr(scheme, "omega_secrets"):
        return packed_reconstruct_matrix(
            scheme.secret_count, scheme.share_count, scheme.privacy_threshold,
            scheme.prime_modulus, scheme.omega_secrets, scheme.omega_shares,
            tuple(indices),
        )
    return basic_reconstruct_matrix(
        scheme.share_count, scheme.privacy_threshold, scheme.prime_modulus,
        tuple(indices),
    )


def _lagrange_basis_row(points: Sequence[int], x: int, p: int) -> List[int]:
    """Lagrange basis weights l_j(x) for interpolation points ``points``."""
    n = len(points)
    row = []
    for j in range(n):
        num, den = 1, 1
        for m in range(n):
            if m == j:
                continue
            num = num * ((x - points[m]) % p) % p
            den = den * ((points[j] - points[m]) % p) % p
        row.append(num * mod_inv(den, p) % p)
    return row


@functools.lru_cache(maxsize=256)
def packed_reconstruct_matrix(
    secret_count: int,
    share_count: int,
    privacy_threshold: int,
    prime_modulus: int,
    omega_secrets: int,
    omega_shares: int,
    indices: Tuple[int, ...],
) -> np.ndarray:
    """The [secret_count, len(indices)+1] matrix L with secrets = L @ values.

    ``indices`` are surviving 0-based share indices (clerk committee
    positions); share i sits at point omega_shares^{i+1}. values = [0;
    shares at indices] — the leading zero is the implicit point-1 value, so
    column 0 multiplies 0 and exists only to keep the matmul uniform.
    Interpolates through ALL supplied points (any superset of a reconstructing
    set yields the same polynomial) and evaluates at omega_secrets^1..^k.
    Fault tolerance: any ``privacy_threshold + secret_count`` of the
    ``share_count`` shares suffice (crypto.rs:146-153).
    """
    p = prime_modulus
    k = secret_count
    if len(set(indices)) != len(indices):
        raise ValueError("duplicate share indices")
    if any(i < 0 or i >= share_count for i in indices):
        raise ValueError("share index out of range")
    if len(indices) < privacy_threshold + secret_count:
        raise ValueError(
            f"need at least {privacy_threshold + secret_count} shares to "
            f"reconstruct, got {len(indices)}"
        )
    points = [1] + [pow(omega_shares, i + 1, p) for i in indices]
    targets = [pow(omega_secrets, e, p) for e in range(1, k + 1)]
    L = [_lagrange_basis_row(points, x, p) for x in targets]
    out = np.array(L, dtype=np.int64)
    out.setflags(write=False)  # cached and shared; callers must not mutate
    return out
