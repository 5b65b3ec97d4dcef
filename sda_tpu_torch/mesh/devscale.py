"""The single-device part of ``sda_tpu/mesh/devscale.py``: the host ->
device landing of share tiles.

The clerk decrypt pipeline (``crypto/batch.prefetch_map``) lands decoded
``[B, tile]`` share bundles as device-resident tiles:
:class:`DeviceTileSink` decodes on the bounded crypto pool ahead of the
consumer, so the streamed drivers consume device tensors instead of host
arrays; :class:`DeviceTileCombiner` is the clerk-side consumer
(``SDA_CLERK_DEVICE_TILES=1``), bit-exact with
``crypto.sharing.mod_combine``.

The watermark tile rule (``watermark_dim_tile`` and its byte model
``bytes_per_dim_column``) sizes the tiles of the sharded rounds, and comes
with them in the multi-device slice, as does ``ModelScaleRound``. The fold
step is plain torch, as it is jnp in the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..fields.dimtile import tile_plan
from ..fields.ops import FieldOps
from ..obs import devprof
from ..utils import metrics

__all__ = [
    "DeviceTileCombiner",
    "DeviceTileSink",
    "stream_schedule",
]


# ---------------------------------------------------------------------------
# Host -> device sink: the clerk pipeline lands device-resident tiles


def stream_schedule(participants: int, dimension: int, pc: int, dc: int,
                    grain: int):
    """The (p0, p1, d0, d1, d_size) block sequence the streamed drivers
    request, in drive order (d-tiles outer, participant tiles inner) —
    mirrors ``mesh.streaming._drive_stream`` (the dim tail pads to
    ``grain``) so a prefetching sink can stay one block ahead of the
    consumer. The sink VERIFIES each request against this prediction and
    decodes directly on any mismatch, so a schedule drift degrades to
    synchronous, never to wrong data."""
    out = []
    for d0 in range(0, dimension, dc):
        d1 = min(d0 + dc, dimension)
        d_size = -(-(d1 - d0) // grain) * grain
        for p0 in range(0, participants, pc):
            out.append((p0, min(p0 + pc, participants), d0, d1, d_size))
    return out


class DeviceTileSink:
    """Prefetched host->device landing of decoded share tiles.

    ``decode(p0, p1, d0, d1) -> [rows, cols] host array`` is the clerk
    pipeline's product (a decoded share bundle — or a host-side block
    generator standing in for the decrypt stage). The sink runs decode and
    the copy to ``device`` (CUDA unless ``device="cpu"``) on the bounded
    crypto pool (``crypto.batch.submit``), keeping ``prefetch`` future
    blocks in flight while the consumer combines the current one.
    ``provider()`` adapts the sink to the streamed drivers'
    ``BlockProvider`` seam: the drivers see device-resident tiles, never
    host arrays, and pad a tile's columns to the grain themselves.
    """

    def __init__(self, decode, participants: int, dimension: int,
                 participants_chunk: int, dim_chunk: int, *,
                 device=None, dtype=None, prefetch: int = 1):
        from ..crypto import batch as crypto_batch

        self._decode = decode
        self._device = resolve_device(device)
        self._dtype = dtype
        self._batch = crypto_batch
        self._prefetch = max(0, int(prefetch))
        # the requests' coordinates; blocks land at their natural width,
        # so the schedule's padded d_size (grain 1 here) plays no part
        self._schedule = [c[:4] for c in stream_schedule(
            participants, dimension, participants_chunk, dim_chunk, 1)]
        self._next = 0       # next schedule index to launch
        self._queue = []     # [(coords, handle)] in flight, oldest first
        self._fill()

    def _fill(self) -> None:
        while (self._next < len(self._schedule)
               and len(self._queue) < self._prefetch + 1):
            coords = self._schedule[self._next]
            self._queue.append((coords, self._land(coords)))
            self._next += 1

    def _land(self, coords):
        def job():
            host = np.asarray(self._decode(*coords))
            if self._dtype is not None:
                host = host.astype(self._dtype, copy=False)
            return torch.from_numpy(np.ascontiguousarray(host)).to(
                self._device)

        return self._batch.submit(job)

    def provider(self):
        """A ``BlockProvider`` serving device-resident tiles in stream
        order (prefetched); out-of-order requests decode synchronously."""

        def get_block(p0, p1, d0, d1):
            if self._queue and self._queue[0][0] == (p0, p1, d0, d1):
                _, handle = self._queue.pop(0)
                self._fill()  # keep the pipeline primed
                metrics.count("devscale.sink.hit")
                return handle.result()
            # drift between consumer and predicted schedule: stay correct
            metrics.count("devscale.sink.miss")
            return np.asarray(self._decode(p0, p1, d0, d1))

        return get_block


class DeviceTileCombiner:
    """Device-resident clerk combine: fold decoded share bundles into a
    tiled device accumulator, bit-exact with
    ``crypto.sharing.mod_combine``.

    The clerk hot path's per-bundle ``[B, dim]`` fold runs as uniform
    ``[B, tile]`` device tiles on ``device`` (CUDA unless
    ``device="cpu"``; width from the device-memory watermark unless
    given). The fold is synchronous: each tile's copy from pageable host
    memory blocks the host before its sum is queued on the device, and
    no copy is staged ahead. What runs alongside is the decrypt pipeline
    (``prefetch_map``), decoding the next bundles. Enabled on the clerk via
    ``SDA_CLERK_DEVICE_TILES=1`` (``client.process_clerking_job``).
    """

    def __init__(self, modulus: int, dim_tile: Optional[int] = None,
                 device=None):
        self._device = resolve_device(device)
        self._f = FieldOps.create(int(modulus))
        self._dim_tile = None if dim_tile is None else max(128, int(dim_tile))
        self._tiles = None     # list of per-tile device accumulators
        self._dim = None
        self._folds = 0

    def _plan(self, rows: int, dim: int):
        if self._dim_tile is None:
            # watermark rule, combiner flavor: the live set per tile is
            # the [rows, tile] bundle (double-buffered), its residue
            # copy, and the accumulator — ~ (2*rows + 2) int64 lanes per
            # column, 25% slack
            per_col = int((2 * rows + 2) * 8 * 1.25)
            self._dim_tile = max(
                128, devprof.hbm_watermark(self._device) // per_col)
        plan = tile_plan(dim, 1, self._dim_tile)
        self._dim = dim
        self._plan_t = plan
        self._tiles = [torch.zeros(plan.width, dtype=torch.int64,
                                   device=self._device)
                       for _ in range(plan.n_tiles)]

    def _step(self, acc, blk):
        f = self._f
        return f.add(acc, f.sum(f.to_residues(blk), axis=0))

    def fold(self, share_rows) -> None:
        """Fold one decoded bundle (``[B, dim]`` array or sequence of
        ``[dim]`` vectors) into the device accumulator."""
        stacked = np.asarray(share_rows, dtype=np.int64)
        if stacked.ndim == 1:
            stacked = stacked[None, :]
        if self._tiles is None:
            self._plan(stacked.shape[0], stacked.shape[1])
        if stacked.shape[1] != self._dim:
            raise ValueError(
                f"bundle dim {stacked.shape[1]} != combiner dim {self._dim}")
        plan = self._plan_t
        if plan.pad:
            stacked = np.pad(stacked, ((0, 0), (0, plan.pad)))

        for j in range(plan.n_tiles):
            lo = j * plan.width
            tile = torch.from_numpy(np.ascontiguousarray(
                stacked[:, lo: lo + plan.width])).to(self._device)
            self._tiles[j] = self._step(self._tiles[j], tile)
        self._folds += 1
        metrics.count("devscale.clerk_combine.bundles")

    @property
    def folded(self) -> int:
        return self._folds

    def result(self) -> np.ndarray:
        """The combined [dim] int64 vector (canonical residues)."""
        if self._tiles is None:
            return np.zeros(0, dtype=np.int64)
        return torch.cat(self._tiles).cpu().numpy()[: self._dim]
