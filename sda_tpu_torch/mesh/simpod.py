"""The aggregation round on one device — the single-device part of
``sda_tpu/mesh/simpod.py``.

One round is mask -> share -> clerk combine -> reconstruct -> unmask, with
the whole clerk committee resident on one device. The stages below are
plain torch on int64 residues (the Solinas or generic lane of
``fields.ops.FieldOps``); ``fields.fused_round.single_chip_round_pallas``
runs the same round with mask, share and combine fused into one CUDA
kernel. The mesh modes (``SimulatedPod`` and friends) come with the
multi-device slice, device ChaCha masks with their own slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..device import resolve_device
from ..fields import fastfield, modular, numtheory, sharing
from ..fields.ops import FieldOps
from ..protocol import (
    AdditiveSharing,
    BasicShamirSharing,
    ChaChaMasking,
    FullMasking,
    LinearMaskingScheme,
    LinearSecretSharingScheme,
    NoMasking,
    PackedShamirSharing,
)

#: schemes whose share/reconstruct are host-built matrices applied as
#: device contractions (numtheory.share_matrix_for / reconstruct_matrix_for)
SHAMIR_SCHEMES = (PackedShamirSharing, BasicShamirSharing)


def _scheme_modulus(scheme: LinearSecretSharingScheme) -> int:
    if isinstance(scheme, SHAMIR_SCHEMES):
        return scheme.prime_modulus
    if isinstance(scheme, AdditiveSharing):
        return scheme.modulus
    raise ValueError(f"unsupported sharing scheme {type(scheme).__name__}")


def _check_mask_modulus(masking, scheme) -> None:
    # the mask/unmask algebra only cancels when masking and sharing operate
    # in the same group
    mask_mod = getattr(masking, "modulus", None)
    if mask_mod is not None and mask_mod != _scheme_modulus(scheme):
        raise ValueError(
            f"masking modulus {mask_mod} != sharing modulus "
            f"{_scheme_modulus(scheme)}: masks would not cancel"
        )


def _check_masking_supported(masking) -> None:
    if isinstance(masking, ChaChaMasking):
        raise ValueError(
            "ChaCha masking is not ported yet: it comes with the device "
            "ChaCha-mask slice (ROADMAP queue 1, item 8)")
    if not isinstance(masking, (NoMasking, FullMasking)):
        raise ValueError(
            f"unsupported masking scheme {type(masking).__name__}"
        )


# ---------------------------------------------------------------------------
# Round stages. Every function takes canonical int64 residues.

def _mask_stage(masking, f: FieldOps, x, generator):
    """-> (masked [S, d_loc], local_mask_sum [d_loc] or None)."""
    _check_masking_supported(masking)
    if isinstance(masking, NoMasking):
        return x, None
    masks = f.uniform(generator, x.shape)
    return f.add(x, masks), f.sum(masks, axis=0)


def _share_sum_stage(scheme, f: FieldOps, M_host, masked, generator):
    """[S, d_loc] masked residues -> [n, B] participant-SUMMED share rows.

    Share generation is linear in the (secrets, randomness) vector, so the
    clerk-combined output Σ_p M @ v_p equals M @ Σ_p v_p: participants
    fold with modular adds FIRST and the share contraction runs once —
    the [S, n, B] per-participant share tensor is never materialized.
    """
    S, d = masked.shape
    if isinstance(scheme, SHAMIR_SCHEMES):
        k, t = scheme.secret_count, scheme.privacy_threshold
        B = -(-d // k)
        rand = f.uniform(generator, (S, t, B))
        rsum = f.sum(rand, axis=0)                             # [t, B]
        sk = sharing.batch_columns(f.sum(masked, axis=0), k)   # [k, B]
        zeros = sk.new_zeros((1, B))
        values = torch.cat([zeros, sk, rsum], dim=0)           # [m2, B]
        if f.sp is not None:
            return fastfield.modmatmul32(M_host, values, f.sp)
        return modular.modmatmul(M_host, values, f.m)
    # additive: Σ_p last_p = Σ_p masked_p - Σ over all draws
    n = scheme.share_count
    draws = f.uniform(generator, (S, n - 1, d))
    dsum = f.sum(draws, axis=0)                                # [n-1, d]
    last = f.sub(f.sum(masked, axis=0), f.sum(dsum, axis=0))   # [d]
    return torch.cat([dsum, last[None, :]], dim=0)


def _reconstruct_stage(scheme, f: FieldOps, L_host, gathered, d_loc: int):
    """[n, B] clerk rows -> [d_loc] masked totals."""
    if isinstance(scheme, SHAMIR_SCHEMES):
        if f.sp is not None:
            return sharing.packed_reconstruct32(
                gathered, L_host, f.sp, dimension=d_loc
            )
        return sharing.packed_reconstruct(
            gathered, L_host, prime=scheme.prime_modulus, dimension=d_loc,
        )
    return f.sum(gathered, axis=0)  # additive: plain share sum


def _build_matrices(scheme, survivors: Optional[Tuple[int, ...]] = None):
    if not isinstance(scheme, SHAMIR_SCHEMES):
        return None, None
    M = numtheory.share_matrix_for(scheme)
    L = numtheory.reconstruct_matrix_for(
        scheme,
        tuple(range(scheme.share_count)) if survivors is None else survivors,
    )
    return M, L


def single_chip_round(
    sharing_scheme: LinearSecretSharingScheme,
    masking_scheme: Optional[LinearMaskingScheme] = None,
    dim_tile: Optional[int] = None,
    device=None,
):
    """Collective-free full aggregation round on one device.

    Same algebra as the reference's ``single_chip_round`` (mask -> share ->
    combine -> reconstruct -> unmask). Returns ``round_fn(inputs,
    generator)``: [P, d] integer inputs -> [d] int64 aggregate mod m, with
    masks and share randomness drawn from ``generator`` (a
    ``torch.Generator`` on the round's device).

    ``dim_tile``: process the dimension in fixed-width tiles, each a
    complete round over its own columns (masks cancel per tile), so the
    working set is bounded by the tile rather than the dimension.
    """
    dev = resolve_device(device)
    scheme = sharing_scheme
    masking = masking_scheme or NoMasking()
    _check_masking_supported(masking)
    _check_mask_modulus(masking, scheme)
    M_host, L_host = _build_matrices(scheme)
    f = FieldOps.create(_scheme_modulus(scheme))
    # tile grain: whole packing columns (input_size) and whole ChaCha
    # blocks (8 u64 draws) — the same grain as the reference
    grain = scheme.input_size * 8 // math.gcd(scheme.input_size, 8)

    def one_tile(x, generator, d_loc):
        masked, mask_total = _mask_stage(masking, f, x, generator)
        # share + clerk combine fused via linearity (see _share_sum_stage)
        combined = _share_sum_stage(scheme, f, M_host, masked, generator)
        masked_total = _reconstruct_stage(scheme, f, L_host, combined, d_loc)
        if mask_total is None:
            return f.to_int64(masked_total)
        return f.to_int64(f.sub(masked_total, mask_total))

    if dim_tile is None:
        tiled = None
    else:
        from ..fields.dimtile import scan_dim_tiles

        # per-tile residue conversion keeps the int64 working set to a tile
        tiled = scan_dim_tiles(
            lambda blk, generator, i, width: one_tile(
                f.to_residues(blk), generator, width),
            grain, dim_tile)

    def round_fn(inputs, generator: torch.Generator):
        if generator.device.type != dev.type:
            raise ValueError(
                f"generator on {generator.device}, round on {dev}")
        inputs = torch.as_tensor(inputs, device=dev)
        if tiled is None:
            return one_tile(f.to_residues(inputs), generator, inputs.shape[1])
        return tiled(inputs, generator)

    return round_fn
