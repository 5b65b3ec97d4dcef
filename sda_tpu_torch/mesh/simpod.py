"""The aggregation round on one device — the single-device part of
``sda_tpu/mesh/simpod.py``.

One round is mask -> share -> clerk combine -> reconstruct -> unmask, with
the whole clerk committee resident on one device. The stages below are
plain torch on int64 residues (the Solinas or generic lane of
``fields.ops.FieldOps``), but for ChaCha seed masks, which K3 expands
(``fields.chacha_device``) at each tile's offset in every participant's
stream; ``fields.fused_round.single_chip_round_pallas`` runs the round with
mask, share and combine fused into one CUDA kernel (K1), and
``_pallas_stage`` is that kernel as a stage of the streamed driver
(``mesh.streaming``). The mesh modes (``SimulatedPod`` and friends) come
with the multi-device slice.

Randomness: torch has no ``fold_in``. Per-tile randomness is keyed by
``_tile_seed`` (a hash of the round seed and the tile's indices) and the
ChaCha seed words of participant i by Philox4x32-10 under the round seed
at counter (i, word pair, ``_SEED_TAG``): both are pure functions of the
round seed and the indices, as the reference's keys are of its round key.
The bits differ from threefry's; masks cancel within the round, so the
aggregate is exact either way, and parity tests feed both packages the
same seed words.
"""

from __future__ import annotations

import hashlib
import math
from typing import Optional, Tuple

import torch

from ..device import resolve_device
from ..fields import (chacha_device, fastfield, fused_round, modular,
                      numtheory, sharing)
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
    if not isinstance(masking, (NoMasking, FullMasking, ChaChaMasking)):
        raise ValueError(
            f"unsupported masking scheme {type(masking).__name__}"
        )


def _dim_grain(scheme, masking) -> int:
    """Smallest dim-chunk size a single device can hold: packing width,
    times the ChaCha block width when masks are stream-expanded."""
    grain = scheme.input_size
    if isinstance(masking, ChaChaMasking):
        grain = math.lcm(grain, 8)
    return grain


# ---------------------------------------------------------------------------
# Round randomness: pure functions of (round seed, indices)

#: Philox counter word separating the ChaCha-seed stream
_SEED_TAG = 0x5EED
#: hash domain of per-tile seeds, apart from the ChaCha-seed stream
_TILE_TAG = 0x711E
_MASK32 = 0xFFFFFFFF


def _round_seed(generator: torch.Generator) -> int:
    """A round's 62-bit seed, one draw of ``generator``."""
    return int(torch.randint(0, 1 << 62, (), generator=generator,
                             device=generator.device))


def _tile_seed(round_seed: int, *indices: int) -> int:
    """63-bit seed of one tile's randomness (its Full masks, share rows and
    K1 key): a hash of the round seed and the tile's indices, so a resumed
    or re-tiled run draws what an uninterrupted one does."""
    h = hashlib.blake2b(digest_size=8)
    for v in (round_seed, _TILE_TAG) + indices:
        h.update(int(v).to_bytes(16, "little", signed=True))
    return int.from_bytes(h.digest(), "little") >> 1


def _chacha_seed_words(round_seed: int, global_ids, seed_bitsize: int):
    """[S] global participant ids -> [S, 8] int64 seed words in [0, 2^32).

    The seed depends only on (round seed, participant id) — every dim tile
    of one participant derives the SAME seed and expands disjoint windows
    of one stream, which is the whole point of seed-compressed masks.
    Words beyond ceil(seed_bitsize/32) are zero, matching the host spec's
    zero-padded ChaCha key (fields/chacha.py).
    """
    words = (int(seed_bitsize) + 31) // 32
    if words > 8:
        raise ValueError("seed_bitsize > 256 unsupported")
    ids = torch.as_tensor(global_ids, dtype=torch.int64)
    key0, key1 = round_seed & _MASK32, (round_seed >> 32) & _MASK32
    tag = torch.full_like(ids, _SEED_TAG)
    out = []
    for pair in range(2):
        out += fused_round.philox4x32_10(
            ids & _MASK32, ids >> 32, tag, torch.full_like(ids, pair),
            key0, key1)
    seeds = torch.stack(out, dim=1)
    seeds[:, words:] = 0
    return seeds


# ---------------------------------------------------------------------------
# Round stages. Every function takes canonical int64 residues.

def _chacha_masks(f: FieldOps, seeds, d_block0: int, d_loc: int):
    """[S, 8] seed words -> [S, d_loc] residues: the window of each
    CHACHA_PRG_V1 stream at block ``d_block0`` (= dim offset / 8), by K3."""
    return chacha_device.stream_residues_at(seeds, d_block0,
                                            dimension=d_loc, modulus=f.m)


def _mask_stage(masking, f: FieldOps, x, generator, *, round_seed=None,
                pid_base: int = 0, d_block0: int = 0):
    """-> (masked [S, d_loc], local_mask_sum [d_loc] or None).

    Full masks are drawn from ``generator``. ChaCha masks are a function of
    (``round_seed``, global participant id, dim offset): ``pid_base`` is
    the global id of the first row, ``d_block0`` the ChaCha block counter
    at this tile's dim offset."""
    S, d_loc = x.shape
    if isinstance(masking, FullMasking):
        masks = f.uniform(generator, x.shape)
    elif isinstance(masking, ChaChaMasking):
        gids = pid_base + torch.arange(S, dtype=torch.int64, device=x.device)
        seeds = _chacha_seed_words(round_seed, gids, masking.seed_bitsize)
        masks = _chacha_masks(f, seeds, d_block0, d_loc)
    else:
        return x, None
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


def _pallas_supported(scheme, masking, f: FieldOps) -> bool:
    """K1 serves packed Shamir over a Solinas prime with any masking in the
    lattice. None/Full draw inside the kernel; ChaCha masks are expanded
    by K3 FIRST and the kernel runs mask-free on the pre-masked input (see
    _pallas_stage). Round-internal masks are generated AND cancelled inside
    the round (never wire-visible), so the scheme's ``prg`` tag does not
    matter here and the aggregate is exact either way."""
    return (
        isinstance(scheme, SHAMIR_SCHEMES)
        and f.sp is not None
        and isinstance(masking, (NoMasking, FullMasking, ChaChaMasking))
    )


def _resolve_pallas(scheme, masking, f: FieldOps, use_pallas: bool,
                    what: str) -> bool:
    """Constructor gating of the K1 lane: ``use_pallas=True`` on a config
    K1 cannot run raises."""
    if use_pallas and not _pallas_supported(scheme, masking, f):
        raise ValueError(
            f"pallas {what} step requires packed-Shamir over a Solinas "
            f"prime (none/full/chacha masking)"
        )
    return bool(use_pallas)


def _pallas_stage(scheme, f: FieldOps, M_host, masking, x, seed: int, *,
                  round_seed=None, pid_base: int = 0, d_block0: int = 0):
    """[S, d_loc] canonical residues -> (combined shares [n, B0], mask sum
    [d_loc] | None) on K1 (``fields.fused_round``), keyed by ``seed``.

    Drop-in replacement for the _mask_stage + _share_sum_stage pair: the
    round result is exact for ANY mask/share randomness — masks cancel in
    the final subtract and the random polynomial rows are annihilated by
    the reconstruction matrix — so K1's Philox draws never change the
    aggregate. ChaCha masking: the masks are the CHACHA_PRG_V1 windows of
    _mask_stage, applied first; the kernel then runs mask-free on the
    pre-masked input (the ``columns_unmasked`` instance for the flagship
    scheme).
    """
    chacha_mask_sum = None
    if isinstance(masking, ChaChaMasking):
        x, chacha_mask_sum = _mask_stage(
            masking, f, x, None, round_seed=round_seed, pid_base=pid_base,
            d_block0=d_block0)
        masking = NoMasking()
    d_loc = x.shape[1]
    masked = isinstance(masking, FullMasking)
    x_cols = sharing.batch_columns(x.to(torch.int32), scheme.secret_count)
    shares, mask_tot = fused_round.fused_mask_share_combine(
        x_cols, seed, f.sp, M_host, scheme.privacy_threshold, masked)
    if not masked:
        return shares, chacha_mask_sum
    return shares, sharing.unbatch_columns(mask_tot, d_loc)


def _normalize_survivors(scheme, surviving_clerks) -> Optional[Tuple[int, ...]]:
    """Validate a clerk-dropout quorum for the streamed finale (reference
    semantics crypto.rs:146-153): the finale reconstructs from clerk ROWS,
    and a lost clerk loses its rows, never the mask sums. Truncates to
    exactly reconstruction_threshold rows, as
    crypto/sharing.py::PackedShamirReconstructor does."""
    if surviving_clerks is None:
        return None
    survivors = tuple(int(i) for i in surviving_clerks)
    n = scheme.output_size
    if any(i < 0 or i >= n for i in survivors) or len(set(survivors)) != len(survivors):
        raise ValueError(f"surviving clerks {survivors} must be distinct in [0, {n})")
    if not isinstance(scheme, SHAMIR_SCHEMES):
        if len(survivors) < n:
            raise ValueError(
                "additive sharing needs every clerk row; clerk dropout "
                "requires a Shamir scheme (crypto.rs:146-153)"
            )
        return None  # all rows = the normal finale
    r = scheme.reconstruction_threshold
    if len(survivors) < r:
        raise ValueError(
            f"need at least reconstruction_threshold={r} surviving clerks, "
            f"got {len(survivors)}"
        )
    return survivors[:r]


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
    ``torch.Generator`` on the round's device). ChaCha masking draws one
    round seed from it and expands every participant's stream by K3; it
    requires the dimension (or ``dim_tile``) to be a multiple of 8, one
    ChaCha block.

    ``dim_tile``: process the dimension in fixed-width tiles, each a
    complete round over its own columns (masks cancel per tile; ChaCha
    tiles read their window of the global stream at block ``i * width /
    8``), so the working set is bounded by the tile rather than the
    dimension.
    """
    dev = resolve_device(device)
    scheme = sharing_scheme
    masking = masking_scheme or NoMasking()
    _check_masking_supported(masking)
    _check_mask_modulus(masking, scheme)
    M_host, L_host = _build_matrices(scheme)
    f = FieldOps.create(_scheme_modulus(scheme))
    chacha = isinstance(masking, ChaChaMasking)
    # tile grain: whole packing columns (input_size) and whole ChaCha
    # blocks (8 u64 draws) — the same grain as the reference
    grain = scheme.input_size * 8 // math.gcd(scheme.input_size, 8)

    def one_tile(x, generator, d_loc, round_seed=None, d_block0=0):
        masked, mask_total = _mask_stage(
            masking, f, x, generator, round_seed=round_seed,
            d_block0=d_block0)
        # share + clerk combine fused via linearity (see _share_sum_stage)
        combined = _share_sum_stage(scheme, f, M_host, masked, generator)
        masked_total = _reconstruct_stage(scheme, f, L_host, combined, d_loc)
        if mask_total is None:
            return f.to_int64(masked_total)
        return f.to_int64(f.sub(masked_total, mask_total))

    def round_fn(inputs, generator: torch.Generator):
        if generator.device.type != dev.type:
            raise ValueError(
                f"generator on {generator.device}, round on {dev}")
        inputs = torch.as_tensor(inputs, device=dev)
        round_seed = _round_seed(generator) if chacha else None
        if dim_tile is None:
            return one_tile(f.to_residues(inputs), generator,
                            inputs.shape[1], round_seed)
        from ..fields.dimtile import scan_dim_tiles

        # per-tile residue conversion keeps the int64 working set to a tile
        return scan_dim_tiles(
            lambda blk, generator, i, width: one_tile(
                f.to_residues(blk), generator, width, round_seed,
                i * (width // 8)),
            grain, dim_tile)(inputs, generator)

    return round_fn
