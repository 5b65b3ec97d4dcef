"""Scheme-dispatched sharing: generators, combiner, reconstructors — port
of ``sda_tpu/crypto/sharing.py``.

The role-level interface of the reference (client/src/crypto/sharing/mod.rs:
ShareGenerator :14-17, ShareCombiner :23-25, SecretReconstructor :31-33),
re-based on the torch field ops in sda_tpu_torch.fields: additive sharing
is a fused draw-and-subtract; packed Shamir is a cached share-matrix
contraction; both are already batched over the full vector dimension (the
reference's per-batch loop, batched.rs:18-99, is a reshape here). Every
generator, combiner and reconstructor holds the role's device: numpy comes
in, the algebra runs on that device, numpy goes out (varint encoding and
sealing are host work).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from .._lazy import torch

from .. import fields
from ..fields import numtheory, oracle
from ..protocol import (
    AdditiveSharing,
    BasicShamirSharing,
    LinearSecretSharingScheme,
    PackedShamirSharing,
)
from . import rand

import os

#: Below this much output work (elements), run the exact host/NumPy oracle
#: path instead of dispatching to the device: a phone-sized vector (the
#: reference's design point, README.md:8-11) costs microseconds on host but
#: a round of kernel launches and copies on the device. Both paths are
#: bit-identical given identical randomness (tests assert device ==
#: oracle), so the dispatch is purely a latency decision, not a fallback.
HOST_PATH_MAX = int(os.environ.get("SDA_HOST_PATH_MAX", 1 << 16))


def _small(total_elements: int) -> bool:
    return total_elements <= HOST_PATH_MAX


def _to_device(array: np.ndarray, device) -> torch.Tensor:
    # decoded share vectors may be read-only views of the wire bytes; torch
    # wraps host memory without copying, so hand it a writable array
    return torch.as_tensor(np.require(array, np.int64, "W"), device=device)


def _to_host(tensor: torch.Tensor) -> np.ndarray:
    return tensor.cpu().numpy()


def mod_combine(vectors: Sequence[np.ndarray], modulus: int,
                device) -> np.ndarray:
    """Elementwise modular sum across participants — the clerk kernel
    (combiner.rs:15-30); shared by share- and mask-combining."""
    vecs = [np.asarray(v, dtype=np.int64) for v in vectors]
    if not vecs:
        return np.zeros(0, dtype=np.int64)
    stacked = np.stack(vecs)
    if _small(stacked.size):
        # oracle.combine canonicalizes internally — no second % pass
        return oracle.combine(stacked, modulus)
    # Canonicalize before the device sum: modsum's overflow-exact chunking
    # derives its fan from the modulus and assumes residues in [0, m).
    # Fresh shares satisfy that, but Paillier-premixed clerk batches
    # decrypt to UNREDUCED sums (encryption.py PackedPaillierDecryptor),
    # and at wide component windows those could wrap an int64 partial sum.
    return _to_host(fields.combine(_to_device(stacked % modulus, device),
                                   modulus=modulus))


class ShareGenerator:
    def generate(self, secrets: Sequence[int]) -> List[np.ndarray]:
        """Secrets vector -> per-clerk share vectors (len == output_size)."""
        raise NotImplementedError


class ShareCombiner:
    def __init__(self, modulus: int, device):
        self.modulus = modulus
        self.device = device

    def combine(self, share_vectors: Sequence[np.ndarray]) -> np.ndarray:
        return mod_combine(share_vectors, self.modulus, self.device)


class SecretReconstructor:
    def reconstruct(self, indexed_shares: Sequence[Tuple[int, np.ndarray]]) -> np.ndarray:
        """(clerk index, share vector) pairs -> secrets vector."""
        raise NotImplementedError


class AdditiveShareGenerator(ShareGenerator):
    def __init__(self, scheme: AdditiveSharing, device):
        self.scheme = scheme
        self.device = device

    def generate(self, secrets):
        arr = np.asarray(secrets, dtype=np.int64)
        draws = rand.uniform((self.scheme.share_count - 1, arr.shape[-1]),
                             self.scheme.modulus, device=self.device)
        if _small(self.scheme.share_count * arr.shape[-1]):
            return list(oracle.additive_share_from_randomness(
                arr, draws, modulus=self.scheme.modulus
            ))
        shares = fields.additive_share_from_randomness(
            _to_device(arr, self.device), _to_device(draws, self.device),
            modulus=self.scheme.modulus,
        )
        return list(_to_host(shares))


class AdditiveReconstructor(SecretReconstructor):
    def __init__(self, scheme: AdditiveSharing, device):
        self.scheme = scheme
        self.device = device

    def reconstruct(self, indexed_shares):
        # additive sharing is n-of-n: a missing share makes the sum an
        # unrelated uniform value, so fail closed like the Shamir
        # reconstructor does below its quorum — silently summing a
        # partial set would reveal garbage as if it were the aggregate
        r = self.scheme.reconstruction_threshold
        if len(indexed_shares) < r:
            raise ValueError(
                f"need at least {r} shares to reconstruct, got "
                f"{len(indexed_shares)} (additive sharing cannot tolerate "
                f"share loss)"
            )
        return mod_combine([v for (_, v) in indexed_shares],
                           self.scheme.modulus, self.device)


class PackedShamirShareGenerator(ShareGenerator):
    def __init__(self, scheme: PackedShamirSharing, device):
        self.scheme = scheme
        self.device = device
        self._M_device = None

    @property
    def _M(self):
        # built lazily so host-path-only use never touches the device
        if self._M_device is None:
            self._M_device = _to_device(
                numtheory.share_matrix_for(self.scheme), self.device)
        return self._M_device

    def generate(self, secrets):
        s = self.scheme
        arr = np.asarray(secrets, dtype=np.int64)
        B = -(-arr.shape[-1] // s.secret_count)
        randomness = rand.uniform((s.privacy_threshold, B), s.prime_modulus,
                                  device=self.device)
        if _small(s.share_count * B):
            return list(oracle.packed_share_from_randomness(arr, randomness, s))
        shares = fields.packed_share_from_randomness(
            _to_device(arr, self.device), _to_device(randomness, self.device),
            self._M, prime=s.prime_modulus, secret_count=s.secret_count,
        )
        return list(_to_host(shares))


class PackedShamirReconstructor(SecretReconstructor):
    def __init__(self, scheme: PackedShamirSharing, dimension: int, device):
        self.scheme = scheme
        self.dimension = dimension
        self.device = device

    def reconstruct(self, indexed_shares):
        s = self.scheme
        # fixed-survivor-count contraction (SURVEY §7d): any quorum of
        # exactly reconstruction_threshold shares interpolates the same
        # polynomial, so truncate larger survivor sets — the device
        # contraction then has ONE shape [r+1, B] per (scheme, dimension),
        # and both packages use the same survivors, so the same bits
        r = s.reconstruction_threshold
        if len(indexed_shares) < r:
            raise ValueError(
                f"need at least {r} shares to reconstruct, got "
                f"{len(indexed_shares)}"
            )
        indexed_shares = list(indexed_shares)[:r]
        indices = tuple(int(i) for (i, _) in indexed_shares)
        stacked_np = np.stack([np.asarray(v, dtype=np.int64) for (_, v) in indexed_shares])
        if _small(stacked_np.size):
            return oracle.packed_reconstruct(indices, stacked_np, s, self.dimension)
        # the host matrix: K7 takes it in its launch arguments
        L = numtheory.reconstruct_matrix_for(s, indices)
        return _to_host(fields.reconstruct(
            _to_device(stacked_np, self.device), L, prime=s.prime_modulus,
            dimension=self.dimension,
        ))


def new_share_generator(scheme: LinearSecretSharingScheme,
                        device) -> ShareGenerator:
    if isinstance(scheme, AdditiveSharing):
        return AdditiveShareGenerator(scheme, device)
    if isinstance(scheme, (PackedShamirSharing, BasicShamirSharing)):
        # BasicShamir rides the packed machinery as its k=1 degenerate:
        # same [0; secrets; randomness] column layout, scheme-dispatched
        # matrices (numtheory.share_matrix_for)
        return PackedShamirShareGenerator(scheme, device)
    raise ValueError(f"unknown sharing scheme {scheme!r}")


def new_share_combiner(scheme: LinearSecretSharingScheme,
                       device) -> ShareCombiner:
    if isinstance(scheme, AdditiveSharing):
        return ShareCombiner(scheme.modulus, device)
    if isinstance(scheme, (PackedShamirSharing, BasicShamirSharing)):
        return ShareCombiner(scheme.prime_modulus, device)
    raise ValueError(f"unknown sharing scheme {scheme!r}")


def new_secret_reconstructor(
    scheme: LinearSecretSharingScheme, dimension: int, device
) -> SecretReconstructor:
    if isinstance(scheme, AdditiveSharing):
        return AdditiveReconstructor(scheme, device)
    if isinstance(scheme, (PackedShamirSharing, BasicShamirSharing)):
        return PackedShamirReconstructor(scheme, dimension, device)
    raise ValueError(f"unknown sharing scheme {scheme!r}")
