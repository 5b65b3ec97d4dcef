"""CPU oracle: numpy re-implementation of every field kernel, bit-exact.

A copy of ``sda_tpu/fields/oracle.py``, wired to this package's copies of
``numtheory`` and the ``modular`` numpy mirrors.

The reference's math lives in scalar Rust loops (client/src/crypto/sharing/*,
the tss crate); this oracle mirrors those semantics in plain numpy so device
kernels can be asserted identical given identical randomness — the test
discipline SURVEY.md §4 calls out as missing upstream (sharing kernels there
are only covered via full-loop integration).

Outputs are canonical residues [0, m); the reference's possibly-negative
representatives (Rust `%` keeps sign, additive.rs:46-48) are congruent and
equal after the `positive()` lift (receive.rs:14-21).
"""

from __future__ import annotations

import numpy as np

from .modular import np_modmatmul, np_modsum
from . import numtheory


def batch_columns(secrets: np.ndarray, input_size: int) -> np.ndarray:
    d = secrets.shape[-1]
    B = -(-d // input_size)
    padded = np.zeros(secrets.shape[:-1] + (B * input_size,), dtype=np.int64)
    padded[..., :d] = secrets
    return np.moveaxis(padded.reshape(secrets.shape[:-1] + (B, input_size)), -1, -2)


def unbatch_columns(batched: np.ndarray, dimension: int) -> np.ndarray:
    out = np.moveaxis(batched, -2, -1)
    out = out.reshape(out.shape[:-2] + (-1,))
    return out[..., :dimension]


def additive_share_from_randomness(secrets, draws, modulus: int) -> np.ndarray:
    """[d] secrets + [n-1, d] draws -> [n, d] shares (additive.rs:32-52)."""
    secrets = np.asarray(secrets, dtype=np.int64)
    draws = np.asarray(draws, dtype=np.int64)
    last = (secrets - np_modsum(draws, modulus, axis=-2)) % modulus
    return np.concatenate([draws, last[..., None, :]], axis=-2)


def combine(shares, modulus: int) -> np.ndarray:
    # % first: np_modsum's overflow-exact fan assumes canonical residues,
    # and callers may feed unreduced values (e.g. Paillier-premixed sums).
    return np_modsum(np.asarray(shares, dtype=np.int64) % modulus, modulus, axis=0)


def packed_share_from_randomness(secrets, randomness, scheme) -> np.ndarray:
    """[d] secrets + [t, B] randomness -> [n, B] clerk share rows."""
    M = numtheory.share_matrix_for(scheme)
    sk = batch_columns(np.asarray(secrets, dtype=np.int64), scheme.secret_count)
    zeros = np.zeros(sk.shape[:-2] + (1,) + sk.shape[-1:], dtype=np.int64)
    values = np.concatenate([zeros, sk, np.asarray(randomness, dtype=np.int64)], axis=-2)
    return np_modmatmul(M, values, scheme.prime_modulus)


def packed_reconstruct(indices, shares, scheme, dimension: int) -> np.ndarray:
    """Surviving (indices, [r, B] share rows) -> [d] secrets."""
    L = numtheory.reconstruct_matrix_for(scheme, tuple(indices))
    shares = np.asarray(shares, dtype=np.int64)
    values = np.concatenate([np.zeros((1,) + shares.shape[1:], dtype=np.int64), shares], axis=0)
    return unbatch_columns(np_modmatmul(L, values, scheme.prime_modulus), dimension)
