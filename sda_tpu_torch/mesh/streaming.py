"""Streamed secure-aggregation rounds for workloads larger than device
memory: counterpart of ``sda_tpu/mesh/streaming.py``.

The flagship configs (10k participants x 10M-dim vectors) cannot
materialize [P, d] on one device, let alone the [P, n, B] share tensor.
But the whole pipeline is a sum over participants of per-participant
shares, so it streams: tile the participant axis and the dimension axis,
push each [P_chunk, d_chunk] block through mask -> share -> local combine
on the device, and fold it into running [n, B_chunk] share and [d_chunk]
mask accumulators. Peak memory is one block plus accumulators,
independent of P. Per dim tile, reconstruction and unmasking run once at
the end.

``StreamingAggregator`` drives one device: plain torch stages, or K1 (the
fused kernel, ``use_pallas=True``) through ``simpod._fold_stage``, with
ChaCha seed masks expanded by K3 at each tile's offset. ``StreamedPod``
drives a ``('p', 'd')`` mesh: every tile step is collective-free (each
shard folds its piece of the block into its own accumulators) and the
clerk scatter + gather + reconstruct run once a dim tile; the multihost
driver (``mesh.multihost``) runs the same tile loop across processes.

The accumulate step and the per-tile finale run through
``obs.devprof.instrument`` as ``stream.step`` and ``stream.finale``
(``stream.pod.step`` and ``stream.pod.finale`` for the pod: the
reference's names), with their costs counted from the block shapes.

Randomness: a tile's Full masks, share rows and K1 key come from
``simpod._tile_seed(round seed, participant tile, dim tile)`` and ChaCha
seeds from ``simpod._chacha_seed_words(round seed, participant id)``, pure
functions of the round seed and the tile's indices, so a resumed run is
bit-identical to an uninterrupted one.
"""

from __future__ import annotations

import functools
import secrets
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..fields.ops import FieldOps
from ..obs import devprof
from ..protocol import ChaChaMasking, FullMasking, LinearMaskingScheme, NoMasking
from ..utils import timed_phase
from .simpod import (
    Mesh,
    _ShardComm,
    _build_matrices,
    _check_collective_headroom,
    _check_mask_modulus,
    _check_masking_supported,
    _dim_grain,
    _fold_ops,
    _fold_stage,
    _normalize_survivors,
    _pod_mesh,
    _reconstruct_stage,
    _resolve_pallas,
    _reveal,
    _reveal_ops,
    _scheme_modulus,
    _sync,
    _tile_seed,
)

#: get_block(p0, p1, d0, d1) -> integer array or tensor [p1-p0, d1-d0]
BlockProvider = Callable[[int, int, int, int], object]

_MASK32 = 0xFFFFFFFF


def array_block_provider(inputs) -> BlockProvider:
    """Adapt an in-memory (or np.memmap) [P, d] array to a BlockProvider."""

    def get_block(p0, p1, d0, d1):
        return inputs[p0:p1, d0:d1]

    return get_block


def _hash32(rows, cols, seed, xp):
    """Deterministic uint32 hash of absolute (participant, component)
    coordinates (numpy); :func:`_hash32_torch` is its int64 torch twin."""
    u = (lambda v: xp.uint32(v))
    x = rows * u(0x9E3779B1) ^ cols * u(0x85EBCA77) ^ u(seed)
    x = x ^ (x >> u(16))
    x = x * u(0x7FEB352D)
    x = x ^ (x >> u(15))
    x = x * u(0x846CA68B)
    x = x ^ (x >> u(16))
    return x


def _mul32(x, c: int):
    """x * c mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32,
    split into 16-bit halves of c so no product reaches 2^63."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def _hash32_torch(rows, cols, seed: int):
    """:func:`_hash32` on int64 tensors holding uint32 values."""
    x = _mul32(rows, 0x9E3779B1) ^ _mul32(cols, 0x85EBCA77) ^ seed
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def synthetic_block_provider32(
    modulus: int, seed: int = 0, max_value: Optional[int] = None
) -> BlockProvider:
    """Host (numpy) uint32 coordinate-hash blocks, bit-identical to the
    device generator below — streamed runs check device aggregates against
    host column sums of the same virtual matrix."""
    bound_i = int(max_value if max_value is not None else modulus)
    if not 0 < bound_i <= 0xFFFFFFFF:
        raise ValueError("synthetic32 values must fit uint32")
    bound = np.uint32(bound_i)
    sd = np.uint32((seed ^ 0x5851F42D) & 0xFFFFFFFF)

    def get_block(p0, p1, d0, d1):
        with np.errstate(over="ignore"):
            rows = np.arange(p0, p1, dtype=np.uint32)[:, None]
            cols = np.arange(d0, d1, dtype=np.uint32)[None, :]
            return _hash32(rows, cols, sd, np) % bound

    return get_block


def synthetic_device_block_provider32(
    modulus: int, seed: int = 0, max_value: Optional[int] = None,
    device=None,
) -> BlockProvider:
    """Device (torch) twin of :func:`synthetic_block_provider32`: generates
    each block on ``device`` (CUDA unless ``device="cpu"``) from its
    absolute coordinates, as int64 tensors of the same values, so
    flagship-scale runs are not bound by host hashing or host-to-device
    copies."""
    bound = int(max_value if max_value is not None else modulus)
    if not 0 < bound <= 0xFFFFFFFF:
        raise ValueError("synthetic32 values must fit uint32")
    sd = (seed ^ 0x5851F42D) & 0xFFFFFFFF
    dev = resolve_device(device)

    def get_block(p0, p1, d0, d1):
        rows = (p0 + torch.arange(p1 - p0, dtype=torch.int64,
                                  device=dev))[:, None] & _MASK32
        cols = (d0 + torch.arange(d1 - d0, dtype=torch.int64,
                                  device=dev))[None, :] & _MASK32
        return torch.remainder(_hash32_torch(rows, cols, sd), bound)

    return get_block


def synthetic_block_provider(
    modulus: int, seed: int = 0, max_value: Optional[int] = None
) -> BlockProvider:
    """Deterministic pseudo-random blocks without materializing [P, d] —
    benchmark-scale inputs. Each element is a splitmix64-style hash of its
    absolute (participant, component) coordinates, so every tiling reads
    the same virtual matrix."""
    bound = np.uint64(max_value if max_value is not None else modulus)
    s = np.uint64(seed * 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF)

    def _mix(z):
        z = (z + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))

    # uint32 blocks when values fit: half the host->device bytes, and the
    # device residue pass skips emulated 64-bit ops (_to_residues32)
    out_dtype = np.uint32 if int(bound) <= (1 << 32) else np.int64

    def get_block(p0, p1, d0, d1):
        with np.errstate(over="ignore"):
            rows = _mix(np.arange(p0, p1, dtype=np.uint64)[:, None] + s)
            cols = _mix(np.arange(d0, d1, dtype=np.uint64)[None, :] ^ s)
            vals = _mix(rows ^ cols)
        return (vals % bound).astype(out_dtype)

    return get_block


def _atomic_npz(path, **arrays):
    """Atomic, crash-durable npz write: temp file, fsync, rename, dir
    fsync — the durability primitive under every streamed snapshot."""
    import os
    import tempfile

    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            # data must reach stable storage BEFORE the rename lands, or a
            # power loss leaves a truncated snapshot at the destination
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # ... and the rename itself must reach the journal: fsync the
        # containing directory, else a crash can roll back to the prior
        # snapshot (harmless to correctness, but the durability claim
        # would be false)
        try:
            dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # platform without directory fsync
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _snapshot_header(fingerprint, out, done_dims, di, pi):
    """The cursor/prefix fields every streamed snapshot carries."""
    return {
        "fingerprint": np.frombuffer(fingerprint.encode(), dtype=np.uint8),
        "out": out[:done_dims],
        "done_dims": np.int64(done_dims),
        "di": np.int64(di),
        "pi": np.int64(pi),
    }


def _read_snapshot(path, fingerprint, keys=None):
    """Fingerprint-guarded snapshot read; ``keys=None`` loads every entry,
    a key list loads only those (npz members load lazily, so a cursor-only
    probe does not materialize accumulator payloads). Returns None for a
    missing/foreign/corrupt snapshot — never trusts one."""
    import os
    import zipfile

    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if bytes(z["fingerprint"]).decode() != fingerprint:
                return None  # different round/config: start fresh
            return {k: z[k] for k in (keys if keys is not None else z.files)}
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None  # unreadable/truncated snapshot: start fresh


def _checkpoint_load(path, fingerprint):
    return _read_snapshot(path, fingerprint,
                          keys=("out", "done_dims", "di", "pi",
                                "acc_shares", "acc_mask"))


class _FileCheckpointer:
    """Single-process snapshot/resume: one atomic npz at ``path``,
    fingerprint-guarded, removed on completion. ``host_accs(acc_shares,
    acc_mask)`` brings the accumulators to host arrays and
    ``restore_accs`` re-places loaded ones (on the device for a single
    device; onto the shards' devices for a pod)."""

    def __init__(self, path, fingerprint, host_accs, restore_accs):
        self.path = path
        self.fingerprint = fingerprint
        self.host_accs = host_accs
        self.restore_accs = restore_accs

    def load(self):
        return _checkpoint_load(self.path, self.fingerprint)

    def restore(self, resume):
        return self.restore_accs(resume["acc_shares"], resume["acc_mask"])

    def save(self, out, done_dims, di, pi, acc_shares, acc_mask):
        acc_shares, acc_mask = self.host_accs(acc_shares, acc_mask)
        _atomic_npz(
            self.path,
            **_snapshot_header(self.fingerprint, out, done_dims, di, pi),
            acc_shares=acc_shares,
            acc_mask=acc_mask,
        )

    def finish(self):
        import os

        try:
            os.unlink(self.path)
        except OSError:
            pass


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _block_tensor(raw, rows: int, d_size: int, device) -> torch.Tensor:
    """A provider's block as int64 on ``device``, zero-padded to
    [rows, d_size] (zero rows and columns aggregate as zero). A host block
    is copied at its own width (uint32 blocks at half the bytes) and
    widened on the device."""
    if not isinstance(raw, torch.Tensor):
        raw = torch.from_numpy(np.ascontiguousarray(np.asarray(raw)))
    block = raw.to(device).to(torch.int64)
    if tuple(block.shape) != (rows, d_size):
        padded = block.new_zeros((rows, d_size))
        padded[:block.shape[0], :block.shape[1]] = block
        block = padded
    return block


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _drive_stream(owner, participants, dimension, seed, *, make_block,
                  make_accs, step, final, checkpoint_path=None,
                  checkpoint_every_chunks=16, checkpointer=None):
    """THE streamed tile loop: one definition of the tile/seed derivation
    and of the checkpoint/resume state machine, shared by
    StreamingAggregator, StreamedPod and (via StreamedPod.drive_tiles) the
    multihost driver. d-tiles outer, participant tiles inner, one
    accumulate ``step`` per tile, one ``final`` per d-tile; snapshots every
    ``checkpoint_every_chunks`` chunks (0 = boundaries only) and at every
    d-tile boundary, removed on completion. Mask windows and share
    randomness depend on the tile indexing here — any change breaks
    resume bit-identity.
    """
    if seed is None:
        seed = secrets.randbits(62)
    pc, dc = owner.participants_chunk, owner.dim_chunk
    out = np.empty(dimension, dtype=np.int64)
    resume = None
    if checkpoint_path is not None and checkpointer is None:
        if _world_size() > 1:
            raise ValueError(
                "checkpoint_path is the single-process snapshot; for "
                "multihost rounds pass checkpoint_path to "
                "multihost.streamed_aggregate_process_local, which builds "
                "the per-process coordinated checkpointer"
            )
        checkpointer = _FileCheckpointer(
            checkpoint_path,
            owner._checkpoint_fingerprint(participants, dimension, seed),
            owner._host_accs, owner._restore_accs,
        )
    if checkpointer is not None:
        resume = checkpointer.load()
        if resume is not None:
            out[: int(resume["done_dims"])] = resume["out"]
    # ground truth for callers recording resumed runs (e.g. benches)
    owner.last_resumed = resume is not None
    resume_di = int(resume["di"]) if resume is not None else -1
    resume_pi = int(resume["pi"]) if resume is not None else 0
    empty = np.zeros((0,), np.int64)
    for di, d0 in enumerate(range(0, dimension, dc)):
        d1 = min(d0 + dc, dimension)
        # the dim tail pads to the grain; the participant tail keeps its
        # ragged row count (a pod pads it to the chunk in make_block)
        d_size = -(-(d1 - d0) // owner._grain) * owner._grain
        if resume is not None and di < resume_di:
            continue  # completed tile: out prefix already restored
        if resume is not None and di == resume_di and resume_pi > 0:
            acc_shares, acc_mask = checkpointer.restore(resume)
            start_pi = resume_pi
        else:
            acc_shares, acc_mask = make_accs(d_size)
            start_pi = 0
        for pi, p0 in enumerate(range(0, participants, pc)):
            if pi < start_pi:
                continue  # chunk already folded into the snapshot accs
            p1 = min(p0 + pc, participants)
            with timed_phase("stream.feed"):
                block = make_block(p0, p1, d0, d1, d_size)
            with timed_phase("stream.dispatch"):
                acc_shares, acc_mask = step(
                    block, _tile_seed(seed, pi, di), seed, p0, d0 // 8,
                    acc_shares, acc_mask)
            if (checkpointer is not None
                    and checkpoint_every_chunks > 0
                    and (pi + 1) % checkpoint_every_chunks == 0):
                with timed_phase("stream.checkpoint"):
                    checkpointer.save(out, d0, di, pi + 1,
                                      acc_shares, acc_mask)
        # sync before the finale so stream.finale times the reconstruct
        # (for pods: the clerk scatter, gather and reconstruct) alone, not
        # the queued accumulate backlog
        with timed_phase("stream.steps_sync"):
            _sync(owner._devices)
        with timed_phase("stream.finale"):
            out[d0:d1] = _host(final(acc_shares, acc_mask))[: d1 - d0]
        if checkpointer is not None:
            with timed_phase("stream.checkpoint"):
                checkpointer.save(out, d1, di + 1, 0, empty, empty)
    if checkpointer is not None:
        checkpointer.finish()  # round complete
    return out


def _round_fingerprint(scheme, masking, participants, dimension, pc, dc,
                       pallas, survivors, seed, extra=None):
    """sha256 over everything that determines a streamed round's bytes."""
    import hashlib

    from ..protocol.helpers import canonical_json

    payload = {
        "scheme": scheme.to_obj(),
        "masking": masking.to_obj(),
        "participants": int(participants),
        "dimension": int(dimension),
        "participants_chunk": int(pc),
        "dim_chunk": int(dc),
        "pallas": bool(pallas),
        "survivors": survivors,
        "seed": int(seed),
        **(extra or {}),
    }
    return hashlib.sha256(canonical_json(payload)).hexdigest()


class StreamingAggregator:
    """Chunked single-device rounds: fixed device memory for any P and d.

    Full scheme-lattice coverage: Packed-Shamir OR additive sharing x
    none/full/chacha masking — ChaCha seed masks are expanded by K3 per
    tile at the tile's (participant, dim) offset, so every tiling of the
    same round seed sees the same masks. ``use_pallas=True`` runs each
    tile's mask + share + combine on K1 (packed Shamir over a Solinas
    prime). ``device``: CUDA unless ``device="cpu"``.
    """

    def __init__(
        self,
        sharing_scheme,
        masking_scheme: Optional[LinearMaskingScheme] = None,
        participants_chunk: int = 64,
        dim_chunk: int = 3 * (1 << 20),
        use_pallas: bool = False,
        surviving_clerks=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self._devices = (self.device,)
        self.scheme = s = sharing_scheme
        self.modulus = _scheme_modulus(s)  # also validates the scheme type
        self.masking = masking_scheme or NoMasking()
        _check_masking_supported(self.masking)
        _check_mask_modulus(self.masking, s)
        # ChaCha seed masks expand a window of one per-participant stream at
        # each tile's dim offset, so tiles align to the 8-word block grain
        self._grain = _dim_grain(s, self.masking)
        self.participants_chunk = int(participants_chunk)
        self.dim_chunk = -(-int(dim_chunk) // self._grain) * self._grain
        self.surviving_clerks = _normalize_survivors(s, surviving_clerks)
        self._M_host, self._L_host = _build_matrices(
            s, self.surviving_clerks
        )  # None for additive
        self._field = FieldOps.create(self.modulus)
        self._sp = self._field.sp
        self.pallas_active = _resolve_pallas(
            s, self.masking, self._field, use_pallas, "streamed"
        )

    # -- the device pieces ------------------------------------------------
    def _step(self, block, tile_seed, round_seed, pid0, dblk0, acc_shares,
              acc_mask):
        """Fold one [rows, d_size] block into the accumulators."""
        f = self._field
        # fused mask + share + combine on K1 when active, keyed by the
        # tile's seed; pid0/dblk0 locate the tile in the ChaCha streams
        shares, mask_sum = _fold_stage(
            self.scheme, f, self._M_host, self.masking, self.pallas_active,
            f.to_residues(block), tile_seed, round_seed=round_seed,
            pid_base=pid0, d_block0=dblk0)
        acc_shares = f.add(acc_shares, shares)
        if mask_sum is not None:
            acc_mask = f.add(acc_mask, mask_sum)
        return acc_shares, acc_mask

    def _final(self, acc_shares, acc_mask):
        """[n, B] share and [d_size] mask accumulators -> [d_size] int64."""
        s, f = self.scheme, self._field
        d_size = acc_mask.shape[0]
        if self.surviving_clerks is not None:
            # clerk dropout: reveal from the quorum's rows only
            acc_shares = acc_shares[list(self.surviving_clerks), :]
        total = _reconstruct_stage(s, f, self._L_host, acc_shares, d_size)
        if not isinstance(self.masking, NoMasking):
            total = f.sub(total, acc_mask)
        return f.to_int64(total)

    # -- counted costs (obs.devprof) ---------------------------------------
    def _step_ops(self, block, *_args) -> int:
        """Integer operations of one accumulate step, counted from the
        algorithm: the fold's (``simpod._fold_ops``) and the accumulates."""
        rows, width = block.shape
        n = self.scheme.output_size
        return (_fold_ops(self, rows, width)
                + n * (width // self.scheme.input_size) + width)

    def _final_ops(self, acc_shares, acc_mask) -> int:
        """Integer operations of one finale: the reconstruction's
        multiply-adds (a plain share sum for additive sharing) and the
        unmask."""
        return _reveal_ops(self, 0, acc_shares.shape[-1], acc_mask.shape[0])

    # -- checkpoint/resume -----------------------------------------------
    # A flagship streamed round is minutes of accumulate steps, so the
    # driver can persist (completed output prefix, in-flight accumulators,
    # tile cursor) and resume mid-round. Tile seeds are a pure function of
    # (round seed, tile indices), so a resumed run draws identical
    # masks/shares and the result is bit-identical to an uninterrupted one.

    def _checkpoint_fingerprint(self, participants, dimension, seed):
        return _round_fingerprint(
            self.scheme, self.masking, participants, dimension,
            self.participants_chunk, self.dim_chunk, self.pallas_active,
            self.surviving_clerks, seed,
        )

    def _host_accs(self, acc_shares, acc_mask):
        return _host(acc_shares), _host(acc_mask)

    def _restore_accs(self, acc_shares, acc_mask):
        return (torch.from_numpy(acc_shares).to(self.device),
                torch.from_numpy(acc_mask).to(self.device))

    # -- driver ----------------------------------------------------------
    def aggregate_blocks(
        self, get_block: BlockProvider, participants: int, dimension: int,
        seed: Optional[int] = None, *, checkpoint_path: Optional[str] = None,
        checkpoint_every_chunks: int = 16,
    ) -> np.ndarray:
        """Stream all blocks; returns the [dimension] aggregate (host array).

        ``seed``: the round seed (an int; None draws a fresh one).
        ``checkpoint_path``: persist an atomic, fsync'd resume snapshot
        there every ``checkpoint_every_chunks`` participant chunks (0 =
        only at dim-tile boundaries) and at every dim-tile boundary; an
        existing snapshot for the identical round (scheme, shape,
        chunking, seed — sha256 fingerprint) resumes where it left off,
        bit-identically. A snapshot from a different round, or a damaged
        one, is ignored, never trusted.
        """
        s, dev = self.scheme, self.device

        def make_block(p0, p1, d0, d1, d_size):
            # zero columns sum to zero; the participant tail keeps its rows
            return _block_tensor(get_block(p0, p1, d0, d1), p1 - p0, d_size,
                                 dev)

        def make_accs(d_size):
            B = d_size // s.input_size
            return (torch.zeros((s.output_size, B), dtype=torch.int64,
                                device=dev),
                    torch.zeros((d_size,), dtype=torch.int64, device=dev))

        return _drive_stream(
            self, participants, dimension, seed,
            make_block=make_block, make_accs=make_accs,
            step=devprof.instrument("stream.step", self._step,
                                    cost=self._step_ops),
            final=devprof.instrument("stream.finale", self._final,
                                     cost=self._final_ops),
            checkpoint_path=checkpoint_path,
            checkpoint_every_chunks=checkpoint_every_chunks,
        )

    def aggregate(self, inputs, seed: Optional[int] = None) -> np.ndarray:
        inputs = np.asarray(inputs)
        return self.aggregate_blocks(
            array_block_provider(inputs), inputs.shape[0], inputs.shape[1],
            seed)


class StreamedPod:
    """Streamed rounds over a SimulatedPod mesh — the flagship-scale mode.

    A host loop tiles (participants x dim); each tile step is
    collective-free: every shard ``(pi, di)`` folds its [Pc/p, d_size/d']
    block of the tile into its own [n, B_loc] share and [d_loc] mask
    accumulators on its device; one clerk scatter + gather + reconstruct
    (``_ShardComm``, or ``multihost._ProcessComm`` across processes) runs
    per dim tile at the end, so collective traffic is independent of the
    participant count. Covers the full scheme lattice (additive/packed x
    none/full/chacha) via the simpod stages; ``use_pallas=True`` runs each
    shard's step on K1 (one launch a shard a tile). Every block is padded
    to ``participants_chunk`` rows. Peak device memory is one block plus
    accumulators, independent of the participant count.
    """

    def __init__(
        self,
        sharing_scheme,
        masking_scheme: Optional[LinearMaskingScheme] = None,
        mesh: Optional[Mesh] = None,
        participants_chunk: int = 64,
        dim_chunk: int = 3 * (1 << 20),
        use_pallas: bool = False,
        surviving_clerks=None,
    ):
        self.scheme = s = sharing_scheme
        self.modulus = _scheme_modulus(s)
        self.masking = masking_scheme or NoMasking()
        _check_masking_supported(self.masking)
        _check_mask_modulus(self.masking, s)
        self.mesh = _pod_mesh(mesh, s)
        self._devices = self.mesh.distinct_devices()
        p_shards, d_shards = self.mesh.devices.shape
        grain = _dim_grain(s, self.masking) * d_shards
        self._grain = grain
        # round the tile sizes up to the mesh grain
        self.participants_chunk = -(-int(participants_chunk) // p_shards) * p_shards
        self.dim_chunk = -(-int(dim_chunk) // grain) * grain
        self.surviving_clerks = _normalize_survivors(s, surviving_clerks)
        self._M_host, self._L_host = _build_matrices(s, self.surviving_clerks)
        self._field = FieldOps.create(self.modulus, cross_terms=p_shards)
        _check_collective_headroom(self._field, p_shards)
        self.pallas_active = _resolve_pallas(
            s, self.masking, self._field, use_pallas, "streamed"
        )

    # -- the accumulators: [local p row][d column] grids of tensors --------
    def _new_accs(self, d_size: int, comm):
        n, d_shards = self.scheme.output_size, self.mesh.devices.shape[1]
        d_loc = d_size // d_shards
        B_loc = d_loc // self.scheme.input_size
        devs = [[self.mesh.devices[pi, di] for di in range(d_shards)]
                for pi in comm.p_rows]
        return (
            [[torch.zeros((n, B_loc), dtype=torch.int64, device=dev)
              for dev in row] for row in devs],
            [[torch.zeros(d_loc, dtype=torch.int64, device=dev)
              for dev in row] for row in devs],
        )

    def _host_accs(self, acc_shares, acc_mask):
        """The grids as the reference's global host arrays: shares
        [p_shards * n, B], masks [p_shards, d_size] (a boundary snapshot's
        empty arrays pass through)."""
        if isinstance(acc_shares, np.ndarray):
            return acc_shares, acc_mask
        return (
            torch.cat([torch.cat([t.cpu() for t in row], dim=1)
                       for row in acc_shares]).numpy(),
            torch.stack([torch.cat([t.cpu() for t in row])
                         for row in acc_mask]).numpy(),
        )

    def _restore_accs(self, acc_shares, acc_mask):
        """Re-place loaded global host accumulators onto the shards."""
        n = self.scheme.output_size
        p_shards, d_shards = self.mesh.devices.shape
        B_loc = acc_shares.shape[1] // d_shards
        d_loc = acc_mask.shape[1] // d_shards
        devs = self.mesh.devices
        return (
            [[torch.from_numpy(np.ascontiguousarray(
                acc_shares[pi * n:(pi + 1) * n,
                           di * B_loc:(di + 1) * B_loc])).to(devs[pi, di])
              for di in range(d_shards)] for pi in range(p_shards)],
            [[torch.from_numpy(np.ascontiguousarray(
                acc_mask[pi, di * d_loc:(di + 1) * d_loc])).to(devs[pi, di])
              for di in range(d_shards)] for pi in range(p_shards)],
        )

    # -- the device pieces ------------------------------------------------
    def _step(self, block, tile_seed, round_seed, p0, dblk0, acc_shares,
              acc_mask, *, comm):
        """Fold one tile into the accumulators: ``block`` holds the tile's
        rows of ``comm.p_rows``, [rows, d_size]; each shard folds its own
        [rows / len(p_rows), d_size / d'] piece, collective-free."""
        f, s, masking = self._field, self.scheme, self.masking
        d_shards = self.mesh.devices.shape[1]
        Pc_loc = block.shape[0] // len(comm.p_rows)
        d_loc = block.shape[1] // d_shards
        for j, pi in enumerate(comm.p_rows):
            for di in range(d_shards):
                dev = self.mesh.devices[pi, di]
                x = f.to_residues(block[j * Pc_loc:(j + 1) * Pc_loc,
                                        di * d_loc:(di + 1) * d_loc].to(dev))
                shares, mask_sum = _fold_stage(
                    s, f, self._M_host, masking, self.pallas_active, x,
                    _tile_seed(tile_seed, pi, di), round_seed=round_seed,
                    pid_base=p0 + pi * Pc_loc,
                    d_block0=dblk0 + di * (d_loc // 8))
                acc_shares[j][di] = f.add(acc_shares[j][di], shares)
                if mask_sum is not None:
                    acc_mask[j][di] = f.add(acc_mask[j][di], mask_sum)
        return acc_shares, acc_mask

    def _final(self, acc_shares, acc_mask, *, comm):
        """Clerk scatter + gather, reconstruct and unmask of one dim tile
        -> [d_size] int64 on ``comm.home(0)``."""
        f = self._field
        masked = not isinstance(self.masking, NoMasking)
        gathered, totals = comm.combine(f, acc_shares,
                                        acc_mask if masked else None)
        home = comm.home(0)
        return torch.cat([
            _reveal(self.scheme, f, self._L_host, self.surviving_clerks,
                    gathered[di], totals[di], row.shape[0]).to(home)
            for di, row in enumerate(acc_mask[0])])

    # the same counted algorithm as the single-device step, over the tile
    _step_ops = StreamingAggregator._step_ops

    def _final_ops(self, acc_shares, acc_mask) -> int:
        """Integer operations of one finale (``simpod._reveal_ops``): the
        collectives' adds, the reconstruction's multiply-adds and the
        unmask."""
        return _reveal_ops(self, self.mesh.devices.shape[0],
                           sum(t.shape[-1] for t in acc_shares[0]),
                           sum(t.shape[0] for t in acc_mask[0]))

    # -- checkpoint/resume -----------------------------------------------
    def _checkpoint_fingerprint(self, participants, dimension, seed):
        return _round_fingerprint(
            self.scheme, self.masking, participants, dimension,
            self.participants_chunk, self.dim_chunk, self.pallas_active,
            self.surviving_clerks, seed,
            extra={"mesh": list(self.mesh.devices.shape)},
        )

    # -- driver ----------------------------------------------------------
    def aggregate_blocks(
        self, get_block: BlockProvider, participants: int, dimension: int,
        seed: Optional[int] = None, *, checkpoint_path: Optional[str] = None,
        checkpoint_every_chunks: int = 16,
    ) -> np.ndarray:
        """Stream all blocks; returns the [dimension] aggregate (host array).

        ``checkpoint_path``: the same atomic snapshot / bit-identical resume
        contract as StreamingAggregator (single-process; the fingerprint
        also pins the mesh shape). Loaded accumulators are re-placed onto
        the shards' devices. Blocks land on the mesh's first device and
        each shard's piece moves to its own.
        """
        comm = _ShardComm(self.mesh)
        home = self.mesh.devices[0, 0]

        def make_block(p0, p1, d0, d1, d_size):
            return _block_tensor(get_block(p0, p1, d0, d1),
                                 self.participants_chunk, d_size, home)

        return self.drive_tiles(
            participants, dimension, seed, make_block=make_block,
            make_accs=lambda d_size: self._new_accs(d_size, comm),
            comm=comm, checkpoint_path=checkpoint_path,
            checkpoint_every_chunks=checkpoint_every_chunks,
        )

    def drive_tiles(
        self, participants: int, dimension: int, seed, *, make_block,
        make_accs, comm=None, checkpoint_path: Optional[str] = None,
        checkpoint_every_chunks: int = 16, checkpointer=None,
    ) -> np.ndarray:
        """The tile loop shared by single-process streaming and the
        multihost driver (mesh/multihost.py): ``make_block(p0, p1, d0, d1,
        d_size)`` supplies each tile's rows of ``comm.p_rows`` as an int64
        tensor; ``make_accs(d_size)`` the zeroed accumulator grids; ``comm``
        the collectives (``_ShardComm`` when None). The tile/seed derivation
        in ``_drive_stream`` is THE definition — mask windows and share
        randomness depend on it."""
        comm = comm if comm is not None else _ShardComm(self.mesh)
        return _drive_stream(
            self, participants, dimension, seed,
            make_block=make_block, make_accs=make_accs,
            step=devprof.instrument(
                "stream.pod.step", functools.partial(self._step, comm=comm),
                cost=self._step_ops),
            final=devprof.instrument(
                "stream.pod.finale",
                functools.partial(self._final, comm=comm),
                cost=self._final_ops),
            checkpoint_path=checkpoint_path,
            checkpoint_every_chunks=checkpoint_every_chunks,
            checkpointer=checkpointer,
        )

    def aggregate(self, inputs, seed: Optional[int] = None) -> np.ndarray:
        """[P, d] inputs (an array, or a tensor read in place on its
        device) -> the [d] aggregate (host array)."""
        if not isinstance(inputs, torch.Tensor):
            inputs = np.asarray(inputs)
        return self.aggregate_blocks(
            array_block_provider(inputs), inputs.shape[0], inputs.shape[1],
            seed)
