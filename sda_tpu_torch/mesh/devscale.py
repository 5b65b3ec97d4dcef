"""Model-scale device plane: counterpart of ``sda_tpu/mesh/devscale.py``.

- **The watermark tile rule** (:func:`watermark_dim_tile`): the dim-tile
  width is derived from the per-device memory watermark
  (``obs.devprof.hbm_watermark``) and an explicit per-column byte model
  of the sharded round stage (:func:`bytes_per_dim_column`), counted at
  8 bytes a lane because the port's residues are int64. Where several
  shards of a mesh share one device, each shard plans under the device's
  watermark divided by the shards placed on it.

- **The sharded tile round** (:class:`ModelScaleRound`): the ``[P,
  dim]`` round over the ``('p', 'd')`` mesh, each shard streaming its
  local dim shard in watermark-wide tiles; per tile: mask + share + local
  combine (K1 when active, one launch a shard a tile), the clerk scatter
  and gather (K9, one launch a d column), reconstruct, unmask. A ragged
  last tile reaches the kernel that first reads it at its own width (K8,
  or K3's mask op with ChaCha masks), which writes the zero columns past
  its edge: no copy pads it.

- **The host -> device landing of share tiles**: the clerk decrypt
  pipeline (``crypto/batch.prefetch_map``) lands decoded ``[B, tile]``
  share bundles as device-resident tiles: :class:`DeviceTileSink`
  decodes on the bounded crypto pool ahead of the consumer, so the
  streamed drivers consume device tensors instead of host arrays;
  :class:`DeviceTileCombiner` is the clerk-side consumer
  (``SDA_CLERK_DEVICE_TILES=1``), bit-exact with
  ``crypto.sharing.mod_combine``: one K10 launch a tile, each tile landed
  through pinned staging buffers on a copy stream while the previous one
  folds.

The benched configuration itself lives in ``loadgen/devscale.py``
(``run_devscale``). The stages run on the port's kernels (K1, K3, K7,
K8, K9, K10) where the reference's are jitted or Pallas.
"""

from __future__ import annotations

import math
import secrets
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..fields.dimtile import tile_plan
from ..fields.residues import fold_columns, fold_constants
from ..fields.ops import FieldOps
from ..obs import devprof
from ..utils import metrics, timed_phase
from .simpod import (
    _ShardComm,
    _as_inputs,
    _build_matrices,
    _check_collective_headroom,
    _check_mask_modulus,
    _check_masking_supported,
    _dim_grain,
    _fold_input,
    _fold_stage,
    _normalize_survivors,
    _pod_mesh,
    _resolve_pallas,
    _reveal,
    _scheme_modulus,
    _sync,
    _tile_seed,
)

__all__ = [
    "DeviceTileCombiner",
    "DeviceTileSink",
    "ModelScaleRound",
    "bytes_per_dim_column",
    "stream_schedule",
    "watermark_dim_tile",
]

#: bytes of one lane of the round stage: residues are int64 tensors
LANE_BYTES = 8


# ---------------------------------------------------------------------------
# The watermark tile-width rule


def bytes_per_dim_column(scheme, masking, local_rows: int,
                         pallas: bool = False) -> int:
    """Conservative per-shard device bytes one LOCAL dim column costs the
    sharded round stage — the denominator of the watermark tile rule.

    The reference's model counts every live lane of the per-tile stage
    body (S = participant rows resident on the shard, k/t/n/m2/r from the
    scheme):

    - input block + residue copy, double-buffered against the next
      tile's landing: ``3 * S``
    - full-mask draws ``[S, d]``: ``S`` (K1 draws in the kernel, but the
      plain lane's bound is kept: the rule must hold for either lane);
    - share randomness ``[S, t, B]``: ``S * t / k``;
    - contraction operands+result ``[m2, B] + [n, B]``: ``(m2 + n) / k``;
    - accumulators / clerk rows / reconstruct output:
      ``(2n + r) / k + 2``;

    with a 25% allocator slack, rounded up in the reference's 4-byte
    lanes; each of the port's int64 lanes is two of those, so a column
    costs exactly twice what the reference counts, and a budget of 2W
    gives the tile the reference gives at W.
    """
    k = int(getattr(scheme, "secret_count", 1) or 1)
    t = int(getattr(scheme, "privacy_threshold", 0) or 0)
    n = int(scheme.output_size)
    m2 = 1 + k + t
    r = int(getattr(scheme, "reconstruction_threshold", n) or n)
    S = max(1, int(local_rows))
    from ..protocol import NoMasking

    mask_rows = 0 if isinstance(masking, (NoMasking, type(None))) else 1
    lanes = (
        3 * S                      # block + residues, double-buffered
        + mask_rows * S            # mask draws
        + S * t / k                # share randomness
        + (m2 + n) / k             # contraction operands + result
        + (2 * n + r) / k + 2      # accs + gathered rows + output
    )
    del pallas  # the plain lane's bound covers K1 too
    return max(16, int(math.ceil(lanes * 4 * 1.25))) * (LANE_BYTES // 4)


def watermark_dim_tile(
    scheme,
    masking=None,
    *,
    participants_chunk: int,
    p_shards: int,
    d_shards: int,
    pallas: bool = False,
    watermark_bytes: Optional[int] = None,
    dim: Optional[int] = None,
    shards_per_device: int = 1,
    device=None,
) -> int:
    """The GLOBAL dim-tile width the memory watermark affords.

    Each shard plans under ``watermark // shards_per_device`` (the shards
    placed on one device share its memory): that budget over
    ``bytes_per_dim_column`` local columns fit one shard; times
    ``d_shards`` for the global width, rounded DOWN to the mesh/scheme
    grain (whole packing columns x whole ChaCha blocks x d_shards — a tile
    must be a complete round over its own columns on every shard).
    Clamped to at least one grain and, when ``dim`` is given, to the
    grain-rounded dimension (no tile wider than the workload).
    ``watermark_bytes=None`` reads the live
    :func:`~sda_tpu_torch.obs.devprof.hbm_watermark` of ``device`` (CUDA
    unless ``device="cpu"``).
    """
    from ..protocol import NoMasking

    masking = masking if masking is not None else NoMasking()
    budget = int(watermark_bytes if watermark_bytes is not None
                 else devprof.hbm_watermark(device))
    budget //= max(1, int(shards_per_device))
    # whole packing columns x whole ChaCha blocks, like the scan lane
    grain_loc = math.lcm(_dim_grain(scheme, masking), 8)
    grain = grain_loc * int(d_shards)
    local_rows = -(-int(participants_chunk) // int(p_shards))
    per_col = bytes_per_dim_column(scheme, masking, local_rows, pallas)
    cols_loc = max(grain_loc, budget // per_col)
    tile = max(grain, (cols_loc * int(d_shards)) // grain * grain)
    if dim is not None:
        tile = min(tile, -(-int(dim) // grain) * grain)
    return tile


# ---------------------------------------------------------------------------
# The sharded tile round


class ModelScaleRound:
    """The ``[P, dim]`` round over the ``('p', 'd')`` mesh, each shard
    streaming its local dim shard in tiles.

    Every shard ``(pi, di)`` walks its local ``[P_loc, d_loc]`` block in
    tiles of ``dim_tile / d_shards`` columns (the watermark rule's width
    unless given, with the mesh's per-device share); per tile: mask +
    share + local combine (K1 when active, keyed per (round, tile, shard)
    by ``_tile_seed``), one clerk scatter + gather over ``p``
    (``_ShardComm``), reconstruct, unmask. Peak live memory per shard is
    one tile's intermediates. Exact against the plain lane and the column
    sum for any seed: masks cancel within each tile and random polynomial
    rows are annihilated by the reconstruction.

    Use it when the sharded INPUT fits device memory; for inputs larger
    than memory, compose :class:`~sda_tpu_torch.mesh.streaming.StreamedPod`
    with the same watermark tile width (``loadgen/devscale.py`` drives
    both).
    """

    def __init__(
        self,
        sharing_scheme,
        masking_scheme=None,
        mesh=None,
        dim_tile: Optional[int] = None,
        use_pallas: bool = False,
        surviving_clerks=None,
        participants_chunk: int = 8,
    ):
        from ..protocol import NoMasking

        self.scheme = s = sharing_scheme
        self.modulus = _scheme_modulus(s)
        self.masking = masking_scheme or NoMasking()
        _check_masking_supported(self.masking)
        _check_mask_modulus(self.masking, s)
        self.mesh = _pod_mesh(mesh, s)
        p_shards, d_shards = self.mesh.devices.shape
        self.surviving_clerks = _normalize_survivors(s, surviving_clerks)
        self._M_host, self._L_host = _build_matrices(s, self.surviving_clerks)
        self._field = FieldOps.create(self.modulus, cross_terms=p_shards)
        _check_collective_headroom(self._field, p_shards)
        self.pallas_active = _resolve_pallas(
            s, self.masking, self._field, use_pallas, "model-scale")
        # tile grain: whole packing columns AND whole ChaCha blocks (the
        # per-tile d_block0 window arithmetic needs 8-aligned widths)
        self._grain_loc = math.lcm(_dim_grain(s, self.masking), 8)
        self._grain = self._grain_loc * d_shards
        if dim_tile is None:
            dim_tile = watermark_dim_tile(
                s, self.masking, participants_chunk=participants_chunk,
                p_shards=p_shards, d_shards=d_shards,
                pallas=self.pallas_active,
                shards_per_device=self.mesh.shards_per_device(),
                device=self.mesh.devices[0, 0])
        # the per-shard tile width; the global tile is d_shards of these
        self.dim_tile = max(self._grain,
                            int(dim_tile) // self._grain * self._grain)
        self._tile_loc = self.dim_tile // d_shards
        self._round = devprof.instrument("devscale.round", self._run)

    @property
    def _sp(self):
        return self._field.sp

    def _run(self, inputs, round_seed: int, comm):
        """Padded [P_pad, d_pad] inputs -> [d_pad] int64 on
        ``comm.home(0)``, tile by tile."""
        from ..protocol import NoMasking

        f = self._field
        p_shards, d_shards = self.mesh.devices.shape
        P_pad, d_pad = inputs.shape
        P_loc, d_loc = P_pad // p_shards, d_pad // d_shards
        # a local shard narrower than one tile is one tile of its own width
        plan = tile_plan(d_loc, self._grain_loc, self._tile_loc)
        width = plan.width
        masked = not isinstance(self.masking, NoMasking)
        home = comm.home(0)
        out = torch.empty(d_pad, dtype=torch.int64, device=home)
        for i in range(plan.n_tiles):
            lo = i * width
            hi = min(lo + width, d_loc)
            sums, masks = [], []
            for pi in comm.p_rows:
                srow, mrow = [], []
                for di in range(d_shards):
                    dev = self.mesh.devices[pi, di]
                    blk = inputs[pi * P_loc:(pi + 1) * P_loc,
                                 di * d_loc + lo:di * d_loc + hi].to(dev)
                    # a ragged last tile's zero columns (which aggregate
                    # as zero) come from the kernel that first reads it
                    x = _fold_input(f, self.masking, self.pallas_active,
                                    blk, width=width)
                    # the tile's window of the global ChaCha streams
                    s, m = _fold_stage(
                        self.scheme, f, self._M_host, self.masking,
                        self.pallas_active, x,
                        _tile_seed(round_seed, i, pi, di),
                        round_seed=round_seed, pid_base=pi * P_loc,
                        d_block0=(di * d_loc + lo) // 8, width=width)
                    srow.append(s)
                    mrow.append(m)
                sums.append(srow)
                masks.append(mrow)
            gathered, totals = comm.combine(f, sums,
                                            masks if masked else None)
            for di in range(d_shards):
                total = _reveal(self.scheme, f, self._L_host,
                                self.surviving_clerks, gathered[di],
                                totals[di], width)
                out[di * d_loc + lo:di * d_loc + hi] = \
                    total[:hi - lo].to(home)
        return out

    def padded_shape(self, P_total: int, d_total: int) -> Tuple[int, int]:
        p_shards, _ = self.mesh.devices.shape
        return (
            -(-P_total // p_shards) * p_shards,
            -(-d_total // self._grain) * self._grain,
        )

    def aggregate(self, inputs, seed: Optional[int] = None) -> torch.Tensor:
        """[P, d] participant inputs -> [d] int64 aggregate (one full
        round) on the mesh's first device. ``seed``: the round seed (an
        int; None draws a fresh one)."""
        inputs = _as_inputs(inputs)
        if seed is None:
            seed = secrets.randbits(62)
        P_total, d_total = inputs.shape
        P_pad, d_pad = self.padded_shape(P_total, d_total)
        if (P_pad, d_pad) != (P_total, d_total):
            # zero rows/columns aggregate as zero; masks on the padding
            # cancel like any other mask; stripped below
            padded = inputs.new_zeros((P_pad, d_pad))
            padded[:P_total, :d_total] = inputs
            inputs = padded
        with timed_phase("devscale.round"):
            out = self._round(inputs, seed, _ShardComm(self.mesh))
            _sync(self.mesh.distinct_devices())
        return out[:d_total]


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


#: bytes of one pinned host staging buffer of the device-tile fold at most:
#: on a card the fold's tile is also capped so that rows x tile int64 fit
#: one (two of them are staged)
STAGE_BYTES = 256 << 20


class _TileStager:
    """The host -> device landing of the fold's [rows, width] tiles: two
    pinned host buffers and two device buffers used in turn, the copies on
    a copy stream of their own, ordered by CUDA events: a host buffer is
    refilled only once its last copy has finished (the host waits for
    that copy's event), and a device buffer is overwritten only once the
    fold that read it has run (the copy stream waits for that fold's
    event). A pin that fails raises."""

    def __init__(self, device: torch.device):
        self._device = device
        self._cap = 0
        self._host = self._dev = None
        self._copy = torch.cuda.Stream(device)
        self._copied = [torch.cuda.Event(), torch.cuda.Event()]
        self._folded = [torch.cuda.Event(), torch.cuda.Event()]
        self._done = torch.cuda.Event()
        self._used = [False, False]
        self._slot = 0

    def _reserve(self, elements: int) -> None:
        if elements <= self._cap:
            return
        # nothing may still read or write the buffers being replaced
        torch.cuda.synchronize(self._device)
        host = [torch.empty(elements, dtype=torch.int64, pin_memory=True)
                for _ in range(2)]
        if not all(h.is_pinned() for h in host):
            raise RuntimeError("could not pin the fold's staging buffers")
        self._host = host
        self._dev = [torch.empty(elements, dtype=torch.int64,
                                 device=self._device) for _ in range(2)]
        self._cap = elements
        self._used = [False, False]

    def land(self, tile: np.ndarray):
        """Issue the copy of ``tile`` (an int64 [rows, cols] view, any
        strides) to the device -> (slot, its [rows, cols] device tensor);
        the tensor may be read once the current stream waits on
        :meth:`wait`."""
        rows, cols = tile.shape
        self._reserve(rows * cols)
        s = self._slot
        self._slot ^= 1
        if self._used[s]:
            self._copied[s].synchronize()   # the buffer's last copy is done
        host = self._host[s][:rows * cols].view(rows, cols)
        np.copyto(host.numpy(), tile)
        dst = self._dev[s][:rows * cols].view(rows, cols)
        with torch.cuda.stream(self._copy):
            if self._used[s]:
                self._copy.wait_event(self._folded[s])
            dst.copy_(host, non_blocking=True)
            self._copied[s].record(self._copy)
        self._used[s] = True
        return s, dst

    def wait(self, slot: int) -> None:
        """The current stream waits for ``slot``'s copy."""
        torch.cuda.current_stream(self._device).wait_event(
            self._copied[slot])

    def release(self, slot: int) -> None:
        """``slot``'s device tile has been read by the work queued so far
        on the current stream."""
        self._folded[slot].record(torch.cuda.current_stream(self._device))

    def done(self) -> None:
        """A bundle's folds are queued on the current stream."""
        self._done.record(torch.cuda.current_stream(self._device))

    def wait_done(self) -> None:
        """The current stream waits for the last bundle's folds (a reader
        on another stream sees the whole sum)."""
        torch.cuda.current_stream(self._device).wait_event(self._done)


class DeviceTileCombiner:
    """Device-resident clerk combine: fold decoded share bundles into a
    tiled device accumulator, bit-exact with
    ``crypto.sharing.mod_combine``.

    The clerk hot path's per-bundle ``[B, dim]`` fold runs as ``[B,
    tile]`` device tiles on ``device`` (CUDA unless ``device="cpu"``;
    width from the device-memory watermark unless given), one K10 launch a
    tile (``fields.residues.fold_columns``: the tile's floor mod m added
    into the tile's accumulator in place). On a card each tile lands
    through two pinned host buffers on a copy stream
    (:class:`_TileStager`): tile j+1's copy is issued before tile j's fold,
    so the host -> device transfer overlaps the fold, as the reference's
    ``pending`` tile does; a ragged last tile is copied and folded at its
    own width. On the CPU the fold is today's synchronous plain path. What
    runs alongside is the decrypt pipeline (``prefetch_map``), decoding
    the next bundles. Enabled on the clerk via ``SDA_CLERK_DEVICE_TILES=1``
    (``client.process_clerking_job``).
    """

    def __init__(self, modulus: int, dim_tile: Optional[int] = None,
                 device=None):
        self._device = resolve_device(device)
        self._m = int(modulus)
        fold_constants(self._m)   # a modulus K10 cannot fold raises here
        self._dim_tile = None if dim_tile is None else max(128, int(dim_tile))
        self._tiles = None     # list of per-tile device accumulators
        self._dim = None
        self._folds = 0
        self._stager = (_TileStager(self._device)
                        if self._device.type == "cuda" else None)

    def _plan(self, rows: int, dim: int):
        if self._dim_tile is None:
            # watermark rule, combiner flavor: the live set per tile is
            # the [rows, tile] bundle (double-buffered), its residue
            # copy, and the accumulator — ~ (2*rows + 2) int64 lanes per
            # column, 25% slack; on a card no wider than a staging buffer
            per_col = int((2 * rows + 2) * 8 * 1.25)
            self._dim_tile = max(
                128, devprof.hbm_watermark(self._device) // per_col)
            if self._stager is not None:
                self._dim_tile = max(128, min(
                    self._dim_tile, STAGE_BYTES // (8 * max(1, rows))))
        plan = tile_plan(dim, 1, self._dim_tile)
        self._dim = dim
        self._plan_t = plan
        self._tiles = [torch.zeros(plan.width, dtype=torch.int64,
                                   device=self._device)
                       for _ in range(plan.n_tiles)]

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
        spans = [(j * plan.width, min((j + 1) * plan.width, self._dim))
                 for j in range(plan.n_tiles)]
        if self._stager is None:
            for j, (lo, hi) in enumerate(spans):
                tile = torch.from_numpy(np.ascontiguousarray(
                    stacked[:, lo:hi]))
                fold_columns(self._tiles[j][:hi - lo], tile, self._m)
        else:
            stager = self._stager
            # land tile j+1 while tile j folds: transfer overlaps compute
            pending = stager.land(stacked[:, spans[0][0]:spans[0][1]])
            for j, (lo, hi) in enumerate(spans):
                slot, tile = pending
                if j + 1 < len(spans):
                    pending = stager.land(
                        stacked[:, spans[j + 1][0]:spans[j + 1][1]])
                stager.wait(slot)
                fold_columns(self._tiles[j][:hi - lo], tile, self._m)
                stager.release(slot)
            stager.done()
        self._folds += 1
        metrics.count("devscale.clerk_combine.bundles")

    @property
    def folded(self) -> int:
        return self._folds

    def result(self) -> np.ndarray:
        """The combined [dim] int64 vector (canonical residues), read after
        the last fold."""
        if self._tiles is None:
            return np.zeros(0, dtype=np.int64)
        if self._stager is not None:
            self._stager.wait_done()
        return torch.cat(self._tiles).cpu().numpy()[: self._dim]
