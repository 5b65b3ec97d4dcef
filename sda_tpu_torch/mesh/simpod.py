"""The aggregation round on a device mesh: counterpart of
``sda_tpu/mesh/simpod.py``.

One round is mask -> share -> clerk combine -> reconstruct -> unmask. The
stages below are plain torch on int64 residues (the Solinas or generic lane
of ``fields.ops.FieldOps``), but for ChaCha seed masks, whose seeds K3
derives and whose windows it expands, adds and sums in one pass
(``fields.chacha_device.mask_residues_derived``) at each shard's offset in
every participant's stream; with
``use_pallas=True`` a shard's mask, share and combine run on K1, the
fused CUDA kernel (``_pallas_stage``, ``fields.fused_round``).

``single_chip_round`` keeps the whole clerk committee on one device.
``SimulatedPod`` runs the round over a ``('p', 'd')`` mesh of devices in
ONE process, as the reference's single-controller ``shard_map`` does:

- ``p`` -- participant shards; the clerk committee also lives along this
  axis (clerk c's combined row lands on shard c // (n / p_shards));
- ``d`` -- vector-dimension shards.

Each shard ``(pi, di)`` masks, shares and folds its local [P/p, d/d']
block on its device (``_local_round``), then the reference's collectives
become one pass a ``d`` column on the column's home device
(``_ShardComm``): the ``p`` partials move there (the ``all_gather``'s
move) and K9 (``fields.shardsum``) sums and canonicalizes them, which is
the ``psum_scatter`` and the ``all_gather`` at once, and the mask
``psum`` beside them. ``mesh.multihost`` swaps in ``torch.distributed``
collectives across processes. A device may hold several shards (a mesh
of ``[cuda:0] * 8`` is the port's counterpart of XLA's virtual host
devices).

Randomness: torch has no ``fold_in``. Per-shard and per-tile randomness is
keyed by ``_tile_seed`` (a hash of the round seed and the indices) and the
ChaCha seed words of participant i by Philox4x32-10 under the round seed
at counter (i, word pair, ``SEED_TAG``; ``_chacha_seed_words``, which K3's
mask op derives itself on a card): both are pure functions of the round
seed and the indices, as the reference's keys are of its round key, so a
participant's ChaCha seed does not depend on the mesh's shape. The bits
differ from threefry's; masks cancel within the round, so the aggregate
is exact either way, and parity tests feed both packages the same inputs
and hold both to the exact sum.
"""

from __future__ import annotations

import collections
import hashlib
import math
import secrets
from typing import Optional, Tuple

import numpy as np
import torch

from ..benchmarks import bounds
from ..device import resolve_device
from ..fields import (chacha_device, fastfield, fused_round, modular,
                      numtheory, sharing, shardsum)
from ..fields.residues import residues_int32
from ..fields.reveal import reconstruct
from ..fields.ops import FieldOps
from ..obs import devprof
from ..utils import timed_phase
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


def _check_collective_headroom(field: FieldOps, p_shards: int) -> None:
    """The clerk scatter and the mask sum add ``p_shards`` canonical
    residues before the next canonicalize; the generic lane cannot chunk
    inside a collective, so the bound must hold up front (the Solinas
    lane's bound is enforced by FieldOps.create falling back to the
    generic lane)."""
    if field.sp is None and p_shards * (field.m - 1) >= (1 << 63):
        raise ValueError(
            f"modulus {field.m} too large for {p_shards}-way participant "
            f"shards: cross-shard sums would overflow int64 — use fewer "
            f"p shards or a smaller modulus"
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

#: hash domain of per-tile seeds, apart from the ChaCha-seed stream
_TILE_TAG = 0x711E


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


#: [S] global participant ids -> [S, 8] int64 ChaCha seed words in
#: [0, 2^32) (the reference's ``_chacha_seed_words``): the plain version of
#: the keys K3's mask op derives in the kernel, which runs on the CPU only
_chacha_seed_words = chacha_device.chacha_seed_words


# ---------------------------------------------------------------------------
# Round stages. Every function takes what ``_fold_input`` makes of a block:
# canonical residues, but for ChaCha masks, which reduce the raw block.

def _fold_input(f: FieldOps, masking, pallas: bool, block, width=None):
    """A block of integer inputs as the fold stage takes it, with the
    residue pass folded into the kernel that reads the block where there is
    one: ChaCha masks take the raw block as int64 (the same values; K3's
    mask op takes their floor mod m in registers), the K1 lane without them
    K8's int32 residues (``fields.residues``), the plain lane
    ``f.to_residues``' int64 ones.

    ``width``: the tile's width when ``block`` is a narrower ragged last
    tile. On the K1 lane the kernel that first reads the block writes the
    zero columns past its edge into its own output (K8 here; K3's mask op,
    given the width by ``_fold_stage``, for ChaCha masks), so no copy pads
    the tile; the plain lane appends them with a ``torch.cat``."""
    chacha = isinstance(masking, ChaChaMasking)
    if pallas:
        if chacha:
            return block.to(torch.int64)
        return residues_int32(block, f.sp, width=width)
    x = block.to(torch.int64) if chacha else f.to_residues(block)
    if width is not None and x.shape[1] < width:
        x = torch.cat([x, x.new_zeros((x.shape[0], width - x.shape[1]))],
                      dim=1)
    return x


def _mask_stage(masking, f: FieldOps, x, generator, *, round_seed=None,
                pid_base: int = 0, d_block0: int = 0, out_dtype=None,
                acc_mask=None, width=None):
    """-> (masked [S, d_loc], local_mask_sum [d_loc] or None).

    Full masks are drawn from ``generator``. ChaCha masks are a function of
    (``round_seed``, global participant id, dim offset): ``pid_base`` is
    the global id of the first row, ``d_block0`` the ChaCha block counter
    at this tile's dim offset; K3's mask op derives the seeds of the rows
    from them, adds and sums the masks in one pass (the reference's
    ``_chacha_seed_words`` and mask stage, one launch) and writes the
    masked rows as ``out_dtype`` (int64 when None; int32 for a modulus
    below 2^31). ``acc_mask``: the step's [d_loc] mask accumulator; the
    sum is added into it (in place by K3 for ChaCha masks) and it, or the
    new sum, is returned in the sum's place (None masks leave it).
    ``width``: ChaCha masks only, the tile's width when ``x`` is a
    narrower ragged tile (K3 reads the columns past x's as zeros)."""
    if isinstance(masking, FullMasking):
        masks = f.uniform(generator, x.shape)
        total = f.sum(masks, axis=0)
        return f.add(x, masks), (total if acc_mask is None
                                 else f.add(acc_mask, total))
    if isinstance(masking, ChaChaMasking):
        return chacha_device.mask_residues_derived(
            round_seed, pid_base, masking.seed_bitsize, d_block0, x,
            modulus=f.m, out_dtype=out_dtype, acc_mask=acc_mask, width=width)
    return x, acc_mask


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
                  round_seed=None, pid_base: int = 0, d_block0: int = 0,
                  acc_shares=None, acc_mask=None, width=None):
    """[S, d_loc] block from ``_fold_input`` -> (combined shares [n, B0],
    mask sum [d_loc] | None) on K1 (``fields.fused_round``), keyed by
    ``seed``; with the step's accumulators (``acc_shares`` [n, B0],
    ``acc_mask`` [d_loc]) the kernels add into them in place and return
    them instead (the reference's donated accumulators).

    Drop-in replacement for the _mask_stage + _share_sum_stage pair: the
    round result is exact for ANY mask/share randomness — masks cancel in
    the final subtract and the random polynomial rows are annihilated by
    the reconstruction matrix — so K1's Philox draws never change the
    aggregate. ChaCha masking: the masks are the CHACHA_PRG_V1 windows of
    _mask_stage, applied first by K3's mask op, which writes the masked
    rows as the int32 words K1 reads (p < 2^29); the kernel then runs
    mask-free on the pre-masked input (the ``columns_unmasked`` instance
    for the flagship scheme). ``width``: the tile's width when the raw
    ChaCha block ``x`` is a narrower ragged tile (``_fold_input``).
    """
    chacha_mask_sum = acc_mask
    if isinstance(masking, ChaChaMasking):
        x, chacha_mask_sum = _mask_stage(
            masking, f, x, None, round_seed=round_seed, pid_base=pid_base,
            d_block0=d_block0, out_dtype=torch.int32, acc_mask=acc_mask,
            width=width)
        masking = NoMasking()
    d_loc = x.shape[1]
    masked = isinstance(masking, FullMasking)
    # no copy for the mask op's int32 rows: a view of them (d % k == 0)
    x_cols = sharing.batch_columns(x.to(torch.int32), scheme.secret_count)
    shares, mask_tot = fused_round.fused_mask_share_combine(
        x_cols, seed, f.sp, M_host, scheme.privacy_threshold, masked,
        acc_shares=acc_shares, acc_mask=acc_mask if masked else None)
    if not masked:
        return shares, chacha_mask_sum
    if acc_mask is not None:
        return shares, mask_tot
    return shares, sharing.unbatch_columns(mask_tot, d_loc)


def _fold_stage(scheme, f: FieldOps, M_host, masking, pallas: bool, x,
                seed: int, *, round_seed=None, pid_base: int = 0,
                d_block0: int = 0, acc_shares=None, acc_mask=None,
                width=None):
    """[S, d_loc] block from ``_fold_input`` -> (participant-summed shares
    [n, B], mask sum [d_loc] | None), keyed by ``seed``: K1 when
    ``pallas``, else the plain mask and share stages drawing from a
    generator on ``x``'s device seeded with ``seed``. ``pid_base`` and
    ``d_block0`` locate the block in the global ChaCha streams, so every
    tiling of a round sees the same masks.

    ``acc_shares`` and ``acc_mask``: a streamed step's accumulators, both
    or neither; the fold is added into them and (acc_shares, acc_mask)
    come back. On the K1 lane the kernels add in their stores, in place
    (K3's mask op for ChaCha masks, K1 for the shares and Full masks); the
    plain lane adds with ``f.add``, as the reference's XLA lane does.

    ``width``: the tile's width, where ``x`` from ``_fold_input`` of a
    ragged last tile may still be narrower (the K1 lane's raw ChaCha
    block, which K3's mask op pads as it reads)."""
    if pallas:
        return _pallas_stage(scheme, f, M_host, masking, x, seed,
                             round_seed=round_seed, pid_base=pid_base,
                             d_block0=d_block0, acc_shares=acc_shares,
                             acc_mask=acc_mask, width=width)
    generator = torch.Generator(device=x.device)
    generator.manual_seed(seed)
    masked, mask_sum = _mask_stage(masking, f, x, generator,
                                   round_seed=round_seed, pid_base=pid_base,
                                   d_block0=d_block0, acc_mask=acc_mask)
    # share + participant-combine fused via linearity (_share_sum_stage):
    # no [S, n, B] tensor
    shares = _share_sum_stage(scheme, f, M_host, masked, generator)
    if acc_shares is not None:
        shares = f.add(acc_shares, shares)
    return shares, mask_sum


def _scan_combine(f: FieldOps, scheme, masking, M_host, x, seed: int,
                  round_seed, pid0: int, dblk0: int, chunk: int):
    """[P, d] block from ``_fold_input`` -> (acc_shares [n, B], acc_mask
    [d] | None).

    Folds participants in blocks of ``chunk`` rows: the live share
    randomness is [chunk, t, B] instead of [P, t, B]. Block i draws from a
    generator seeded ``_tile_seed(seed, i)``; its ChaCha masks are those of
    global participants ``pid0 + i * chunk ..``. The ragged last block
    keeps its rows (eager torch compiles no shapes, so it needs no zero
    padding)."""
    P = x.shape[0]
    chunk = max(1, min(int(chunk), P))
    acc_s = acc_m = None
    for i, r0 in enumerate(range(0, P, chunk)):
        shares, mask_sum = _fold_stage(
            scheme, f, M_host, masking, False, x[r0:r0 + chunk],
            _tile_seed(seed, i), round_seed=round_seed, pid_base=pid0 + r0,
            d_block0=dblk0)
        acc_s = shares if acc_s is None else f.add(acc_s, shares)
        if mask_sum is not None:
            acc_m = mask_sum if acc_m is None else f.add(acc_m, mask_sum)
    return acc_s, acc_m


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

    def one_tile(blk, generator, d_loc, round_seed=None, d_block0=0):
        x = _fold_input(f, masking, False, blk)
        masked, mask_total = _mask_stage(
            masking, f, x, generator, round_seed=round_seed,
            d_block0=d_block0)
        # share + clerk combine fused via linearity (see _share_sum_stage)
        combined = _share_sum_stage(scheme, f, M_host, masked, generator)
        return _reveal(scheme, f, L_host, None, combined, mask_total, d_loc)

    def round_fn(inputs, generator: torch.Generator):
        if generator.device.type != dev.type:
            raise ValueError(
                f"generator on {generator.device}, round on {dev}")
        inputs = torch.as_tensor(inputs, device=dev)
        round_seed = _round_seed(generator) if chacha else None
        if dim_tile is None:
            return one_tile(inputs, generator, inputs.shape[1], round_seed)
        from ..fields.dimtile import scan_dim_tiles

        # per-tile residue conversion keeps the int64 working set to a tile
        return scan_dim_tiles(
            lambda blk, generator, i, width: one_tile(
                blk, generator, width, round_seed, i * (width // 8)),
            grain, dim_tile)(inputs, generator)

    return round_fn


# ---------------------------------------------------------------------------
# The mesh: a [p, d] grid of devices in one process

class Mesh:
    """A ``[p, d]`` grid of ``torch.device`` under the axis names
    ``('p', 'd')``: the port's counterpart of ``jax.sharding.Mesh``.
    ``devices`` is a numpy object array, so ``mesh.devices.shape`` reads as
    in JAX. A device may hold several shards; each runs its own local
    round there (the counterpart of XLA's virtual host devices)."""

    axis_names = ("p", "d")

    def __init__(self, devices):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != 2:
            raise ValueError(f"mesh devices must be a [p, d] grid, got "
                             f"shape {grid.shape}")
        self.devices = grid

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        return tuple(dict.fromkeys(self.devices.reshape(-1)))

    def shards_per_device(self) -> int:
        """The most shards any one device of the mesh holds."""
        return max(collections.Counter(self.devices.reshape(-1)).values())


def _as_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _device_list(devices=None):
    """``devices`` (any sequence or grid of devices or their names) as a
    flat list of ``torch.device``; None means every CUDA device, and raises
    without CUDA (a CPU mesh is asked for by name: ``["cpu"] * 8``)."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [_as_device(d) for d in np.asarray(devices, dtype=object)
            .reshape(-1)]


def _grid(devs, rows: int, cols: int) -> Mesh:
    grid = np.empty(rows * cols, dtype=object)
    for i, dev in enumerate(devs[:rows * cols]):
        grid[i] = dev
    return Mesh(grid.reshape(rows, cols))


def make_mesh(p_shards: int, d_shards: int, devices=None) -> Mesh:
    devs = _device_list(devices)
    n = p_shards * d_shards
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return _grid(devs, p_shards, d_shards)


def default_mesh_shape(n_devices: int, share_count: int) -> Tuple[int, int]:
    """Largest p axis that divides both the device count and the committee."""
    p_shards = math.gcd(n_devices, share_count)
    return p_shards, n_devices // p_shards


def make_multislice_mesh(
    n_slices: int, p_per_slice: int, d_shards: int, devices=None
) -> Mesh:
    """A ('p', 'd') mesh whose participant axis spans multiple slices.

    The reference's layout rule: the ``d`` axis stays *inside* a slice, as
    the minor axis of each slice's contiguous device block, and the
    participant axis is slice-major, so only the fold over ``p`` crosses a
    slice boundary. Device order: ``devices`` in blocks of ``p_per_slice *
    d_shards`` a slice. ``mesh.multihost`` gives each process one slice:
    the ``p`` rows ``[rank * p_per_slice, (rank + 1) * p_per_slice)``. The
    returned mesh has plain ('p', 'd') axes, so every pod code path works
    unchanged on it.
    """
    devs = _device_list(devices)
    n = n_slices * p_per_slice * d_shards
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return _grid(devs, n_slices * p_per_slice, d_shards)


def _sync(devices) -> None:
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _sum_on(device, parts):
    """The int64 sum of ``parts`` on ``device`` (no canonicalize): the
    cross-process combine's local sum (``multihost._ProcessComm``)."""
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


class _ShardComm:
    """The pod's collectives among the shards of one process, as explicit
    tensor moves between the shards' devices (``multihost._ProcessComm``
    is the cross-process counterpart). ``p_rows``: the ``p`` rows whose
    shards this process runs (all of them here)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.p_rows = range(mesh.devices.shape[0])

    def home(self, di: int) -> torch.device:
        """Where column ``di``'s gathered rows and reveal live."""
        return self.mesh.devices[self.p_rows[0], di]

    def combine(self, f: FieldOps, sums, masks):
        """``sums[j][di]``: shard ``(p_rows[j], di)``'s [n, B_loc]
        participant-summed shares; ``masks[j][di]`` its [d_loc] mask sum
        (``masks`` None without masking). -> (per ``d`` column: the
        gathered [n, B_loc] clerk rows, the [d_loc] mask total or None),
        both on ``home(di)``.

        A column's ``psum_scatter`` (clerk block c of the p partials' sum,
        canonicalized), its ``all_gather`` and the mask ``psum`` are one
        K9 pass on the column's home (``fields.shardsum``; its plain
        version on the CPU): each partial moves there first, the
        ``all_gather``'s move, which copies nothing where the shards share
        the device."""
        _, d_shards = self.mesh.devices.shape
        gathered, totals = [], []
        for di in range(d_shards):
            home = self.home(di)
            parts = [row[di].to(home) for row in sums]
            mask_parts = (None if masks is None
                          else [row[di].to(home) for row in masks])
            rows, total = shardsum.shard_combine(parts, mask_parts, f.m)
            gathered.append(rows)
            totals.append(total)
        return gathered, totals


def _reveal(scheme, f: FieldOps, L_host, survivors, gathered, mask_total,
            d_loc: int):
    """Gathered [n, B] clerk rows (and the [d_loc] mask total) -> [d_loc]
    int64 aggregate. A quorum reveal reads the surviving rows of the
    GATHERED clerk axis. Shamir reveals through ``fields.reveal``'s
    ``reconstruct`` (over a Solinas prime one K7 pass, whichever lane the
    round's sums ran on: the surviving rows read in place, the canonical
    mask total subtracted there); additive sharing sums the rows."""
    if isinstance(scheme, SHAMIR_SCHEMES):
        return reconstruct(gathered, L_host, prime=scheme.prime_modulus,
                           dimension=d_loc, mask=mask_total,
                           rows_index=survivors)
    if survivors is not None:
        gathered = gathered[list(survivors)]
    total = f.sum(gathered, axis=0)
    if mask_total is None:
        return f.to_int64(total)
    return f.to_int64(f.sub(total, mask_total))


def _fold_ops(pod, rows: int, width: int) -> int:
    """Integer operations of one fold of [rows, width] inputs into their
    participant-summed shares and mask sum (``_fold_stage``), counted from
    the algorithm: K1's (``bounds.k1_pipe_ops``) and K3's mask op
    (``bounds.k3_pipe_ops``) where they run, and one operation an element
    for each plain-torch modular pass (residues, Full-mask and share-row
    draws, sums, the share contraction's multiply-adds). ``pod``: the
    round's driver (scheme, masking, share matrix, lane)."""
    s, masking = pod.scheme, pod.masking
    k, n = s.input_size, s.output_size
    B = width // k
    ops = rows * width                              # residues
    if isinstance(masking, ChaChaMasking):
        ops += bounds.k3_pipe_ops(rows, width, "mask")  # stream, add, sum
    elif isinstance(masking, FullMasking) and not pod.pallas_active:
        ops += 3 * rows * width                     # draw, add, sum
    if pod.pallas_active:
        t = s.privacy_threshold
        draws = t + (k if isinstance(masking, FullMasking) else 0)
        return ops + bounds.k1_pipe_ops(rows, B, k, draws, True)
    if pod._M_host is not None:
        t = s.privacy_threshold
        return ops + 2 * rows * t * B + rows * width + n * (1 + k + t) * B
    return ops + 3 * rows * (n - 1) * width + rows * width


def _reveal_ops(pod, p_shards: int, B: int, width: int) -> int:
    """Integer operations of one reveal of ``width`` columns ([n, B] clerk
    rows): the collectives' adds over ``p_shards`` partials (0 on one
    device), the reconstruction's multiply-adds (a share sum for additive
    sharing) and the unmask."""
    n = pod.scheme.output_size
    ops = p_shards * (n * B + width) + width
    if pod._L_host is None:
        return ops + n * B
    k, r = pod._L_host.shape
    return ops + k * r * B


def _as_inputs(inputs) -> torch.Tensor:
    """[P, d] integers as a tensor (numpy arrays and lists by value)."""
    if isinstance(inputs, torch.Tensor):
        return inputs
    return torch.from_numpy(np.ascontiguousarray(np.asarray(inputs)))


def _pod_mesh(mesh, scheme) -> Mesh:
    """The default mesh over the CUDA devices, and the committee check."""
    if mesh is None:
        p_shards, d_shards = default_mesh_shape(
            len(_device_list(None)), scheme.output_size)
        mesh = make_mesh(p_shards, d_shards)
    p_shards = mesh.devices.shape[0]
    if scheme.output_size % p_shards:
        raise ValueError(
            f"committee size {scheme.output_size} must be divisible "
            f"by the p axis ({p_shards})"
        )
    return mesh


class SimulatedPod:
    """One secure-aggregation round over a ``('p', 'd')`` mesh.

    Committee size must be divisible by the ``p`` axis; participant and
    dimension counts are auto-padded to the mesh/scheme grain (zero rows
    and components aggregate as zero; padding is stripped from the
    output). ``mesh=None`` spans every CUDA device. ``use_pallas=True``
    runs each shard's mask + share + combine on K1 (one launch a shard);
    otherwise ``_scan_combine`` folds ``scan_chunk`` participants at a
    time in plain torch. ``surviving_clerks``: reveal from that quorum's
    rows only (a lost device loses its clerk rows, never the mask sums).
    """

    def __init__(
        self,
        sharing_scheme: LinearSecretSharingScheme,
        masking_scheme: Optional[LinearMaskingScheme] = None,
        mesh: Optional[Mesh] = None,
        scan_chunk: int = 8,
        use_pallas: bool = False,
        surviving_clerks=None,
    ):
        self.scan_chunk = int(scan_chunk)
        self.scheme = sharing_scheme
        self.modulus = _scheme_modulus(sharing_scheme)
        self.masking = masking_scheme or NoMasking()
        _check_masking_supported(self.masking)
        _check_mask_modulus(self.masking, sharing_scheme)
        self.mesh = _pod_mesh(mesh, sharing_scheme)
        p_shards = self.mesh.devices.shape[0]
        self.surviving_clerks = _normalize_survivors(
            sharing_scheme, surviving_clerks
        )
        self._M_host, self._L_host = _build_matrices(
            sharing_scheme, self.surviving_clerks
        )
        # cross-shard share/mask sums ride collectives between canonicalizes
        self._field = FieldOps.create(self.modulus, cross_terms=p_shards)
        _check_collective_headroom(self._field, p_shards)
        self.pallas_active = _resolve_pallas(
            sharing_scheme, self.masking, self._field, use_pallas, "local"
        )
        # one registry entry for every round, whatever its shape
        self._round = devprof.instrument("mesh.simpod.round", self._run,
                                         cost=self._round_ops)

    @property
    def _sp(self):
        """Solinas parameters when the Solinas lane is active, else None."""
        return self._field.sp

    # ------------------------------------------------------------------
    def _local_round(self, x, seed: int, round_seed: int, pid_base: int,
                     d_block0: int):
        """One shard's [P_loc, d_loc] residues -> ([n, B_loc] shares,
        [d_loc] mask sum | None), its randomness keyed by ``seed``."""
        f = self._field
        if self.pallas_active:
            # fused mask + share + combine, one K1 launch
            return _fold_stage(
                self.scheme, f, self._M_host, self.masking, True, x, seed,
                round_seed=round_seed, pid_base=pid_base, d_block0=d_block0)
        return _scan_combine(
            f, self.scheme, self.masking, self._M_host, x, seed, round_seed,
            pid_base, d_block0, self.scan_chunk)

    def _run(self, inputs, round_seed: int, comm):
        """The padded participant rows of ``comm.p_rows`` ([rows, d_pad])
        -> the [d_pad] int64 aggregate on ``comm.home(0)``."""
        f = self._field
        p_shards, d_shards = self.mesh.devices.shape
        rows, d_pad = inputs.shape
        P_loc, d_loc = rows // len(comm.p_rows), d_pad // d_shards
        sums, masks = [], []
        for j, pi in enumerate(comm.p_rows):
            srow, mrow = [], []
            for di in range(d_shards):
                block = inputs[j * P_loc:(j + 1) * P_loc,
                               di * d_loc:(di + 1) * d_loc]
                x = _fold_input(f, self.masking, self.pallas_active,
                                block.to(self.mesh.devices[pi, di]))
                # per-shard randomness; ChaCha seeds key on global ids
                s, m = self._local_round(
                    x, _tile_seed(round_seed, pi, di), round_seed,
                    pi * P_loc, di * (d_loc // 8))
                srow.append(s)
                mrow.append(m)
            sums.append(srow)
            masks.append(mrow)
        masked = not isinstance(self.masking, NoMasking)
        gathered, totals = comm.combine(f, sums, masks if masked else None)
        home = comm.home(0)
        return torch.cat([
            _reveal(self.scheme, f, self._L_host, self.surviving_clerks,
                    gathered[di], totals[di], d_loc).to(home)
            for di in range(d_shards)])

    def _round_ops(self, inputs, _round_seed, comm) -> int:
        """Integer operations of one round (``_run``'s arguments), counted
        from the algorithm: each shard's fold, then each ``d`` column's
        clerk combine, reconstruct and unmask."""
        p_shards, d_shards = self.mesh.devices.shape
        rows, d_pad = inputs.shape
        P_loc, d_loc = rows // len(comm.p_rows), d_pad // d_shards
        B_loc = d_loc // self.scheme.input_size
        return (len(comm.p_rows) * d_shards * _fold_ops(self, P_loc, d_loc)
                + d_shards * _reveal_ops(self, p_shards, B_loc, d_loc))

    def _check_shape(self, P_total: int, d_total: int) -> None:
        p_shards, d_shards = self.mesh.devices.shape
        if P_total % p_shards:
            raise ValueError(f"participants {P_total} not divisible by p "
                             f"axis {p_shards}")
        grain = _dim_grain(self.scheme, self.masking) * d_shards
        if d_total % grain:
            raise ValueError(
                f"dimension {d_total} must be divisible by the scheme/mesh "
                f"grain {grain}"
            )

    def padded_shape(self, P_total: int, d_total: int) -> Tuple[int, int]:
        p_shards, d_shards = self.mesh.devices.shape
        grain = _dim_grain(self.scheme, self.masking) * d_shards
        return (
            -(-P_total // p_shards) * p_shards,
            -(-d_total // grain) * grain,
        )

    def aggregate(self, inputs, seed: Optional[int] = None) -> torch.Tensor:
        """[P, d] participant inputs -> [d] int64 aggregate (one full
        round) on the mesh's first device, where the inputs land first
        (so the round's memory peak is that device's). ``seed``: the round
        seed (an int; None draws a fresh one)."""
        inputs = _as_inputs(inputs).to(self.mesh.devices[0, 0])
        if seed is None:
            seed = secrets.randbits(62)
        P_total, d_total = inputs.shape
        P_pad, d_pad = self.padded_shape(P_total, d_total)
        if (P_pad, d_pad) != (P_total, d_total):
            # zero participants/components aggregate as zero (masks on the
            # padding cancel like any other mask); stripped below
            padded = inputs.new_zeros((P_pad, d_pad))
            padded[:P_total, :d_total] = inputs
            inputs = padded
        fn = self.aggregate_fn(P_pad, d_pad)
        with timed_phase("mesh.round"):
            out = fn(inputs, seed)
            _sync(self.mesh.distinct_devices())
        return out[:d_total]

    def aggregate_fn(self, P_total: int, d_total: int):
        """The raw round ``fn(inputs, seed)`` for shapes already on the
        mesh/scheme grain (benchmarks and shape checks)."""
        self._check_shape(P_total, d_total)
        comm = _ShardComm(self.mesh)
        return lambda inputs, seed: self._round(inputs, seed, comm)
