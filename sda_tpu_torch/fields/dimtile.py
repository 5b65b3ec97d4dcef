"""Dim-tiled round schedule: a loop over fixed-width dimension tiles — port
of ``sda_tpu/fields/dimtile.py``.

Each tile is a complete round over its own columns, so a round's working
set is bounded by the tile width rather than the dimension. Shared by the
plain (mesh.simpod.single_chip_round) and kernel
(fields.fused_round.single_chip_round_pallas) drivers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TilePlan(NamedTuple):
    """The fixed-width tiling of a dimension.

    ``width``   — the grain-rounded tile width actually used;
    ``n_tiles`` — number of tiles covering the (padded) dimension;
    ``pad``     — zero columns appended so ``n_tiles * width`` covers
                  ``dim`` (zero columns aggregate as zero and are
                  sliced off the output).
    """

    width: int
    n_tiles: int
    pad: int

    @property
    def padded_dim(self) -> int:
        return self.n_tiles * self.width


def tile_plan(dim: int, grain: int, dim_tile: int) -> TilePlan:
    """Fixed-width tiling of ``dim`` at the requested ``dim_tile`` width.

    The width is rounded UP to a whole multiple of ``grain`` (whole
    packing columns x whole ChaCha blocks — a tile must be a complete
    round over its own columns). A dimension narrower than one tile is
    a single tile of its own grain-rounded width: a wide tile knob must
    not inflate small shapes.
    """
    if dim_tile <= 0:
        raise ValueError(f"dim_tile must be positive, got {dim_tile}")
    if grain <= 0:
        raise ValueError(f"grain must be positive, got {grain}")
    T = -(-int(dim_tile) // grain) * grain
    if dim < T:
        width = -(-int(dim) // grain) * grain
        return TilePlan(width, 1, width - dim)
    n_tiles = -(-dim // T)
    return TilePlan(T, n_tiles, n_tiles * T - dim)


def scan_dim_tiles(one_tile, grain: int, dim_tile: int):
    """Wrap a per-tile round into a full-round function.

    ``one_tile(blk, generator, tile_idx, width)`` computes a complete round
    over ``blk`` ([P, width] raw inputs) and returns the [width] int64
    aggregate; it draws its randomness from ``generator``, which advances
    from tile to tile (the reference's per-tile ``fold_in`` keys).

    Returns ``round_fn(inputs, generator)``. Inputs narrower than one tile
    run ``one_tile`` directly; everything else runs the tile loop,
    including the exactly-one-tile case.
    """
    if dim_tile <= 0:
        raise ValueError(f"dim_tile must be positive, got {dim_tile}")
    T = -(-int(dim_tile) // grain) * grain

    def round_fn(inputs, generator):
        P, d = inputs.shape
        if d < T:
            return one_tile(inputs, generator, 0, d)
        plan = tile_plan(d, grain, T)
        out = torch.empty(plan.padded_dim, dtype=torch.int64,
                          device=inputs.device)
        for i in range(plan.n_tiles):
            lo = i * plan.width
            blk = inputs[:, lo:lo + plan.width]
            if blk.shape[1] < plan.width:  # zero columns aggregate as zero
                blk = torch.cat([blk, blk.new_zeros(
                    (P, plan.width - blk.shape[1]))], dim=1)
            out[lo:lo + plan.width] = one_tile(blk, generator, i, plan.width)
        return out[:d]

    return round_fn
