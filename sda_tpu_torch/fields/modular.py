"""Generic modular arithmetic on int64 tensors — port of
``sda_tpu/fields/modular.py``.

All tensors carry int64 values in canonical form [0, m). The contraction
(``modmatmul``) keeps the reference's broadcast-multiply-then-sum form:
integer ``torch.matmul`` does not exist on CUDA, and the contraction axis
is committee-sized, so the broadcast product is small.

Overflow discipline (p < 2^31 enforced by schemes): products < p^2 < 2^62;
``group = (2^63 - 1) // p^2 >= 2`` terms are accumulated between
reductions, so partial sums stay < 2^63.
"""

from __future__ import annotations

import numpy as np
import torch

#: Largest supported modulus (exclusive): residues must fit 31 bits so
#: products fit s64 and at least two terms accumulate between reductions.
MAX_MODULUS = 1 << 31


def canon(x, m):
    """Canonical representative in [0, m) of any int64 residues."""
    return torch.remainder(x, m)


def modadd(a, b, m):
    return torch.remainder(a + b, m)


def modsub(a, b, m):
    return torch.remainder(a - b, m)


def modsum(x, m, axis=0):
    """Sum of canonical residues along ``axis`` mod m — the clerk kernel.

    Exact for any m < 2^62 and any term count: when a flat int64 sum could
    wrap (n_terms * (m-1) >= 2^63), the reduction folds in chunks small
    enough that every partial sum provably fits, canonicalizing between
    levels. For m < 2^31 the fan exceeds any realistic axis and this is a
    single plain sum.
    """
    x = x.to(torch.int64)
    n = x.shape[axis]
    fan = max(2, ((1 << 63) - 1) // max(1, int(m) - 1))
    if n <= fan:
        return torch.remainder(x.sum(dim=axis), m)
    x = torch.movedim(x, axis, 0)
    while x.shape[0] > 1:
        k = x.shape[0]
        chunk = min(fan, k)
        pad = (-k) % chunk
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)
        x = x.reshape((x.shape[0] // chunk, chunk) + tuple(x.shape[1:]))
        x = torch.remainder(x.sum(dim=1), m)
    return x[0]


def modmatmul(a, b, p: int):
    """(a @ b) mod p for canonical int64 operands; p < 2^31.

    ``a`` is a small scheme matrix ([n, m2] share or [k, r] reconstruct),
    ``b`` the batch-column data [..., m2, B] with B huge. Contraction runs
    as broadcast multiply + chunked modular sum; exact for any contraction
    size since partial sums are reduced every ``group`` terms.
    """
    if p >= MAX_MODULUS:
        raise ValueError(f"modulus {p} >= 2^31 unsupported by modmatmul")
    if not isinstance(a, torch.Tensor):  # host matrix: a writable copy
        a = torch.from_numpy(np.array(a, dtype=np.int64))
    a = a.to(device=b.device, dtype=torch.int64)
    a_vec, b_vec = a.ndim == 1, b.ndim == 1  # matmul vector promotion rules
    if a_vec:
        a = a[None, :]
    if b_vec:
        b = b[:, None]
    k = b.shape[-2]  # contraction axis
    group = max(1, ((1 << 63) - 1) // (p * p))
    # a: [..., n, k] -> [..., n, k, 1]; b: [..., k, B] -> [..., 1, k, B]
    a = a[..., :, :, None]
    b = b[..., None, :, :]
    if k <= group:
        out = torch.remainder((a * b).sum(dim=-2), p)
    else:
        acc = None
        for start in range(0, k, group):
            part = (
                a[..., start:start + group, :] * b[..., start:start + group, :]
            ).sum(dim=-2)
            acc = part if acc is None else acc + torch.remainder(part, p)
            acc = torch.remainder(acc, p)
        out = acc
    if a_vec:
        out = out[..., 0, :]
    if b_vec:
        out = out[..., 0]
    return out


def _random_words(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform 32-bit words as int64 in [0, 2^32), on the generator's device."""
    return torch.randint(0, 1 << 32, tuple(shape), generator=generator,
                         dtype=torch.int64, device=generator.device)


def uniform_mod(generator: torch.Generator, shape, m: int):
    """Uniform draws in [0, m) from 64 random bits each; m < 2^62.

    ``(hi * 2^32 + lo) mod m`` as in the reference, computed in int64 (torch
    has no uint64 add): ``(hi * (2^32 mod m) + lo) mod m`` while the product
    fits, else ``hi * 2^32 mod m`` by 32 exact doublings. Statistical
    distance from uniform is <= m / 2^64.
    """
    if not 0 < m < (1 << 62):
        raise ValueError(f"modulus {m} out of range for uniform_mod")
    bits = _random_words(generator, tuple(shape) + (2,))
    hi = torch.remainder(bits[..., 0], m)
    lo = torch.remainder(bits[..., 1], m)
    if m <= (1 << 31):
        return torch.remainder(hi * ((1 << 32) % m) + lo, m)
    for _ in range(32):  # hi < m < 2^62, so 2*hi < 2^63
        hi = torch.remainder(hi * 2, m)
    return torch.remainder(hi + lo, m)


# ---------------------------------------------------------------------------
# NumPy mirrors (host oracle building blocks — bit-exact same algorithms)

def np_modmatmul(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    if p >= MAX_MODULUS:
        raise ValueError(f"modulus {p} >= 2^31 unsupported by modmatmul")
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    k = b.shape[-2] if b.ndim >= 2 else b.shape[0]  # contraction axis
    group = max(1, ((1 << 63) - 1) // (p * p))
    if k * p * p < (1 << 63):
        return np.matmul(a, b) % p
    b_vec = b.ndim == 1
    if b_vec:
        b = b[:, None]
    acc = None
    for start in range(0, k, group):
        part = np.matmul(a[..., start : start + group], b[..., start : start + group, :])
        acc = part % p if acc is None else (acc + part % p) % p
    return acc[..., 0] if b_vec else acc


def np_modsum(x: np.ndarray, m: int, axis=0) -> np.ndarray:
    x = np.asarray(x, dtype=np.int64)
    n = x.shape[axis]
    fan = max(2, ((1 << 63) - 1) // max(1, int(m) - 1))
    if n <= fan:
        return np.sum(x, axis=axis) % m
    x = np.moveaxis(x, axis, 0)
    acc = np.zeros(x.shape[1:], dtype=np.int64)
    for start in range(0, n, fan):
        part = np.sum(x[start : start + fan], axis=0) % m
        acc = (acc + part) % m  # both canonical: sum < 2m < 2^63
    return acc
