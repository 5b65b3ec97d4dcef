"""Secret sharing on tensors: additive and packed Shamir — port of
``sda_tpu/fields/sharing.py``.

The reference's batching layer chunks a d-vector into ceil(d/k) batches of
k secrets; here that layer is a reshape: the batch axis becomes the
contraction's column axis, so sharing a participant's vector is ONE
[n, m2] @ [m2, B] modular contraction and reconstruction is ONE
[k, r+1] @ [r+1, B] contraction. Canonical int64 residues throughout.
"""

from __future__ import annotations

import torch

from . import fastfield
from .modular import modmatmul, modsub, modsum, uniform_mod


def batch_columns(secrets, input_size: int):
    """[..., d] -> [..., input_size, B] column-per-batch layout (zero-padded).

    Batch b holds secrets[b*k:(b+1)*k]. When d is a whole number of
    batches the result is a strided VIEW of ``secrets`` (no copy: element
    (j, b) sits at b*k + j); otherwise the padded copy is viewed the same
    way.
    """
    d = secrets.shape[-1]
    B = -(-d // input_size)
    pad = B * input_size - d
    if pad:
        secrets = torch.cat(
            [secrets, secrets.new_zeros(tuple(secrets.shape[:-1]) + (pad,))],
            dim=-1)
    return torch.movedim(
        secrets.reshape(tuple(secrets.shape[:-1]) + (B, input_size)), -1, -2)


def unbatch_columns(batched, dimension: int):
    """[..., k, B] -> [..., d], inverse of batch_columns (truncates padding)."""
    out = torch.movedim(batched, -2, -1)
    out = out.reshape(tuple(out.shape[:-2]) + (-1,))
    return out[..., :dimension]


# ---------------------------------------------------------------------------
# Additive sharing (reference: client/src/crypto/sharing/additive.rs)

def additive_share_from_randomness(secrets, draws, *, modulus: int):
    """[..., d] secrets + [..., n-1, d] draws -> [..., n, d] shares.

    Last share is secret minus the sum of the draws (additive.rs:32-52);
    split out so tests can feed identical randomness to both packages.
    """
    last = modsub(secrets, modsum(draws, modulus, axis=-2), modulus)
    return torch.cat([draws, last[..., None, :]], dim=-2)


def additive_share(generator, secrets, *, share_count: int, modulus: int):
    """[..., d] secrets -> [..., n, d] shares with fresh draws."""
    d = secrets.shape[-1]
    draws = uniform_mod(
        generator, tuple(secrets.shape[:-1]) + (share_count - 1, d), modulus)
    return additive_share_from_randomness(secrets, draws, modulus=modulus)


def combine(shares, *, modulus: int):
    """Elementwise modular sum across the leading axis — the clerk kernel
    (combiner.rs:15-30) and the additive reconstructor (additive.rs:55-73)."""
    return modsum(shares, modulus, axis=0)


# ---------------------------------------------------------------------------
# Packed Shamir (matrices built host-side in sda_tpu_torch.fields.numtheory)

def _values(secret_cols, randomness):
    """[..., k, B] secrets, [..., t, B] randomness -> [..., m2, B] values
    column [0; secrets; randomness]."""
    zeros = secret_cols.new_zeros(
        tuple(secret_cols.shape[:-2]) + (1,) + tuple(secret_cols.shape[-1:]))
    return torch.cat([zeros, secret_cols.to(torch.int64),
                      randomness.to(torch.int64)], dim=-2)


def packed_share_from_randomness(secrets, randomness, share_matrix, *,
                                 prime: int, secret_count: int):
    """Share [..., d] secrets given explicit [..., t, B] randomness.

    values column = [0; k secrets; t randomness]; shares = M @ values.
    """
    sk = batch_columns(secrets, secret_count)                    # [..., k, B]
    return modmatmul(share_matrix, _values(sk, randomness), prime)


def packed_share(generator, secrets, share_matrix, *, prime: int,
                 secret_count: int, privacy_threshold: int):
    """Share with fresh randomness; returns [..., n, B] clerk rows."""
    d = secrets.shape[-1]
    B = -(-d // secret_count)
    randomness = uniform_mod(
        generator, tuple(secrets.shape[:-1]) + (privacy_threshold, B), prime)
    return packed_share_from_randomness(
        secrets, randomness, share_matrix, prime=prime,
        secret_count=secret_count)


def packed_share32(generator, secrets32, share_matrix_host,
                   sp: fastfield.SolinasPrime, *, secret_count: int,
                   privacy_threshold: int):
    """Canonical [..., d] secrets -> [..., n, B] canonical shares on the
    Solinas lane."""
    d = secrets32.shape[-1]
    B = -(-d // secret_count)
    randomness = fastfield.uniform32(
        generator, tuple(secrets32.shape[:-1]) + (privacy_threshold, B), sp)
    sk = batch_columns(secrets32, secret_count)                  # [..., k, B]
    return fastfield.modmatmul32(share_matrix_host, _values(sk, randomness), sp)


def _with_zero_row(shares):
    """[r, B] clerk rows -> [r+1, B] with the implicit point-1 zero row."""
    return torch.cat([shares.new_zeros((1,) + tuple(shares.shape[1:])),
                      shares], dim=0).to(torch.int64)


def packed_reconstruct32(shares32, recon_matrix_host, sp: fastfield.SolinasPrime,
                         *, dimension: int):
    """[r, B] canonical clerk rows -> [d] canonical secrets."""
    secrets = fastfield.modmatmul32(recon_matrix_host, _with_zero_row(shares32), sp)
    return unbatch_columns(secrets, dimension)


def packed_reconstruct(shares, recon_matrix, *, prime: int, dimension: int):
    """[r, B] surviving clerk share rows -> [d] secrets.

    recon_matrix is built for the surviving index set
    (numtheory.packed_reconstruct_matrix); the implicit point-1 zero row is
    prepended here.
    """
    secrets = modmatmul(recon_matrix, _with_zero_row(shares), prime)  # [k, B]
    return unbatch_columns(secrets, dimension)
