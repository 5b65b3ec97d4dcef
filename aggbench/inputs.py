"""The benchmark's inputs, made from ``--seed`` in plain PyTorch.

Participants' vectors are fixed-point encoded updates, uniform below
``2**value_bits``. Holding P x d of them is more than a card has, so the
benchmark makes a pool of two flat int64 blocks on the device, once, each
of one participant chunk by one dim tile and ``WINDOWS`` x ``STRIDE``
elements more, and a provider hands the round, for each (participant
chunk, dim tile), a window of one pool block: a [rows, width] view of
``rows * width`` elements from a start that is a multiple of ``STRIDE``
(512 bytes, so every kernel's loads stay aligned). A window is contiguous
and read in place, so the provider copies nothing.

Every (chunk, tile) of a round reads its own window start, and the
starts move on with the round: in round ``r`` the chunk ``c`` of tile
``t`` (of ``C`` chunks and ``T`` tiles) starts at window
``c + C * (t + T * r)`` mod ``WINDOWS``. So no two chunks of a round hold
the same values, a tile read in another's place reads other values, and
consecutive rounds (as long as ``2 C T <= WINDOWS``) share no window.
Which pool block a chunk reads alternates too: in round ``r`` the chunks
of dim tile ``t`` below ``(r + t) mod (C + 1)`` read block 1 and the others
block 0. ``reference.py`` sums the pool's windows by the same map.

Nothing here imports the program.
"""

from __future__ import annotations

import torch

MASK64 = (1 << 64) - 1
#: hash domains of the seeds derived from ``--seed``
_POOL_TAG = 0x9001
_ROUND_TAG = 0x7C0D
#: window starts lie this many elements apart (512 bytes)
STRIDE = 64
#: window starts a pool block offers
WINDOWS = 1024


def splitmix64(x: int) -> int:
    """One splitmix64 step of a 64-bit word: the seed derivation."""
    z = (x + 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def derive(seed: int, tag: int, index: int = 0) -> int:
    """A 63-bit seed of domain ``tag`` and ``index`` from ``--seed``, any
    non-negative whole number (large ones too)."""
    z = splitmix64((int(seed) & MASK64) ^ splitmix64(tag))
    return splitmix64(z ^ (int(index) & MASK64)) >> 1


def round_seed(seed: int, round_index: int) -> int:
    """The 62-bit seed of round ``round_index``: its masks and shares."""
    return derive(seed, _ROUND_TAG, round_index) >> 1


def make_pool(rows: int, width: int, value_bits: int, seed: int,
              device) -> list:
    """The pool: two flat int64 tensors of ``rows * width + WINDOWS *
    STRIDE`` elements on ``device``, uniform below ``2**value_bits``; one
    generator on the device, one call a block."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, _POOL_TAG))
    size = int(rows) * int(width) + WINDOWS * STRIDE
    return [torch.randint(0, 1 << int(value_bits), (size,),
                          dtype=torch.int64, device=device, generator=gen)
            for _ in range(2)]


def block_index(round_index: int, chunk: int, tile: int, chunks: int) -> int:
    """The pool block that participant chunk ``chunk`` reads in dim tile
    ``tile`` of round ``round_index`` (of ``chunks`` chunks a tile)."""
    return 1 if chunk < (round_index + tile) % (chunks + 1) else 0


def window_index(round_index: int, chunk: int, tile: int, chunks: int,
                 tiles: int) -> int:
    """The window that participant chunk ``chunk`` reads in dim tile
    ``tile`` of round ``round_index`` (of ``chunks`` chunks and ``tiles``
    tiles): its start is this index times ``STRIDE``."""
    if chunks * tiles > WINDOWS:
        raise ValueError(f"{chunks} chunks x {tiles} tiles need more than "
                         f"the pool's {WINDOWS} windows")
    return (chunk + chunks * (tile + tiles * round_index)) % WINDOWS


def pool_view(pool: list, block: int, window: int, rows: int, width: int):
    """Window ``window`` of pool block ``block`` as a contiguous [rows,
    width] view."""
    start = window * STRIDE
    return pool[block][start: start + rows * width].view(rows, width)


def provider(pool: list, round_index: int, participants: int,
             dimension: int, participants_chunk: int, dim_tile: int):
    """The round's ``get_block(p0, p1, d0, d1)``: the window of a pool
    block that the map gives the chunk at ``p0`` in the tile at ``d0``.
    ``participants_chunk`` and ``dim_tile`` are the tiling the entry
    drives, so each call is one whole (chunk, tile)."""
    chunks = -(-participants // participants_chunk)
    tiles = -(-dimension // dim_tile)

    def get_block(p0, p1, d0, d1):
        c, t = p0 // participants_chunk, d0 // dim_tile
        return pool_view(pool, block_index(round_index, c, t, chunks),
                         window_index(round_index, c, t, chunks, tiles),
                         p1 - p0, d1 - d0)

    return get_block
