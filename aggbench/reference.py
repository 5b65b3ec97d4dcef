"""The plain reference of a round and the comparison that decides
``correct``.

A round's aggregate is the column sum mod p of every participant's
vector. The benchmark's inputs are windows of pool blocks chosen by
``inputs.py``'s map. A window of [rows, width] from start ``s`` has the
column sums ``S[s:s + width]``, where ``S[c]`` sums the block's elements
``c + i * width`` for ``i < rows``; so the reference sums each pool block's
columns once for each (rows, width), in int64 with ``torch.sum`` over a
strided view, and adds the windows' slices by the same map, mod p. It
takes the pool that the benchmark made and nothing that the program made,
and imports nothing of the program. ``dtype=torch.float32`` is the
control: the same arithmetic accumulated in float32, which gives up the
exact sum.
"""

from __future__ import annotations

import numpy as np
import torch

from .inputs import STRIDE, WINDOWS, block_index, window_index


class Reference:
    """Aggregates of the rounds of one cell, from the pool's column sums.

    ``participants`` x ``dimension`` vectors, tiled as the entry drives
    them (``participants_chunk`` rows by ``dim_tile`` columns), summed mod
    ``modulus``; ``dtype``: the accumulation's (int64, or float32 for the
    control)."""

    def __init__(self, pool, participants: int, dimension: int,
                 participants_chunk: int, dim_tile: int, modulus: int,
                 dtype=torch.int64):
        self.pool = pool
        self.participants = int(participants)
        self.dimension = int(dimension)
        self.pc = int(participants_chunk)
        self.dc = int(dim_tile)
        self.modulus = int(modulus)
        self.dtype = dtype
        self.chunks = -(-self.participants // self.pc)
        self._sums = {}

    def _window_sums(self, block: int, rows: int, width: int):
        """S of pool block ``block`` for windows of [rows, width]: every
        window start's column sums, as slices."""
        key = (block, rows, width)
        if key not in self._sums:
            flat = self.pool[block].to(self.dtype)
            span = width + STRIDE * (WINDOWS - 1)
            self._sums[key] = flat.as_strided((rows, span), (width, 1)).sum(
                0, dtype=self.dtype)
        return self._sums[key]

    def layout(self, round_index: int):
        """((d0, width), ((block, window, rows) a chunk)) for each dim
        tile: what decides the round's aggregate."""
        tiles = -(-self.dimension // self.dc)
        out = []
        for t, d0 in enumerate(range(0, self.dimension, self.dc)):
            width = min(self.dc, self.dimension - d0)
            out.append(((d0, width), tuple(
                (block_index(round_index, c, t, self.chunks),
                 window_index(round_index, c, t, self.chunks, tiles),
                 min(self.pc, self.participants - p0))
                for c, p0 in enumerate(range(0, self.participants,
                                             self.pc)))))
        return tuple(out)

    def aggregate_of(self, layout) -> np.ndarray:
        """The [dimension] int64 aggregate of a round of ``layout``, on the
        host."""
        tiles = []
        for (_, width), chunks in layout:
            acc = None
            for block, window, rows in chunks:
                start = window * STRIDE
                part = self._window_sums(block, rows, width)[
                    start: start + width]
                acc = part if acc is None else acc + part
            tiles.append(torch.remainder(acc, self.modulus).to(torch.int64))
        return torch.cat(tiles).cpu().numpy()

    def aggregate(self, round_index: int) -> np.ndarray:
        """The [dimension] int64 aggregate of round ``round_index``."""
        return self.aggregate_of(self.layout(round_index))


def mismatched_elements(reference: Reference, outputs) -> dict:
    """{round index: elements of its aggregate that differ from the
    reference's} of the ``(round_index, aggregate)`` pairs; an aggregate
    of the wrong length counts each element of the longer as a mismatch.
    Rounds of one layout are held to one reference aggregate, made once."""
    groups = {}
    for round_index, out in outputs:
        groups.setdefault(reference.layout(round_index), []).append(
            (round_index, np.asarray(out)))
    bad = {}
    for layout, outs in groups.items():
        want = reference.aggregate_of(layout)
        for round_index, out in outs:
            bad[round_index] = (
                int(np.count_nonzero(out != want)) if out.shape == want.shape
                else max(out.size, want.size))
    return bad
