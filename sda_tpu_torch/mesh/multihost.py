"""Multi-process execution over ``torch.distributed``: counterpart of
``sda_tpu/mesh/multihost.py``.

The pod modes run one process over a mesh of devices (``mesh.simpod``);
this module runs them across processes, each owning a contiguous block of
the mesh's ``p`` axis (one slice of ``make_multislice_mesh(n_slices=
world_size, ...)``) and only its own participant rows:

- ``initialize()`` forms the process group (NCCL when the process's
  device is CUDA, gloo on the CPU) with an explicit timeout: a group that
  fails to form raises within it;
- ``aggregate_process_local(pod, local_inputs)`` runs one round where
  every process contributes its own rows and every process receives the
  full [d] aggregate;
- ``streamed_aggregate_process_local(spod, get_local_block, ...)`` streams
  every process's rows through the ``StreamedPod`` tile loop, with
  coordinated per-process snapshots (``_MultihostCheckpointer``).

Within a process the local ``p`` shards fold in-process; across processes
the clerk axis is one ``reduce_scatter_tensor``, the recipient leg one
``all_gather_into_tensor`` and the mask sum one ``all_reduce``, all int64
SUM (``_ProcessComm``). Every process builds the same mesh; it runs only
the shards of its own ``p`` rows, on their devices.
"""

from __future__ import annotations

import datetime
import math
import secrets
import warnings
from typing import Optional

import numpy as np
import torch

from ..utils import timed_phase
from .simpod import _as_device, _as_inputs, _sum_on, _sync

#: seconds the process group waits for its peers (to form, and in each
#: collective) before it raises
INIT_TIMEOUT_S = 120.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    device=None,
    timeout_s: float = INIT_TIMEOUT_S,
) -> None:
    """Form the process group: ``coordinator_address`` ("host:port" of
    rank 0) or ``init_method`` (e.g. a ``file://`` store), with explicit
    ``num_processes`` and ``process_id`` (nothing tells a process of its
    cluster). ``backend`` None means NCCL when ``device`` is CUDA (the
    default) and gloo when ``device="cpu"``. Raises if the group has not
    formed within ``timeout_s``."""
    import torch.distributed as dist

    if num_processes is None or process_id is None:
        raise ValueError("num_processes and process_id are required")
    if init_method is None:
        if coordinator_address is None:
            raise ValueError("pass coordinator_address or init_method")
        init_method = f"tcp://{coordinator_address}"
    dev = _as_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)))


def _check_mesh_process_split(mesh, nproc: int) -> None:
    p_shards, d_shards = mesh.devices.shape
    if p_shards % nproc:
        raise ValueError(
            f"mesh ({p_shards}, {d_shards}) does not split its p axis "
            f"evenly over {nproc} processes; build it with "
            f"make_multislice_mesh(n_slices={nproc}, p_per_slice, d_shards)"
        )


def _quiet(collective, *args):
    """A collective under the name every torch version has (newer ones
    warn that it is deprecated)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        collective(*args)


class _ProcessComm:
    """The pod's collectives across processes: this process's ``p`` rows
    fold in-process, then one ``reduce_scatter_tensor`` (clerk axis), one
    ``all_gather_into_tensor`` (recipient leg) and one ``all_reduce``
    (mask sum) span the processes, on ``device`` (the process's CUDA
    device under NCCL, the CPU under gloo)."""

    def __init__(self, mesh):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("no process group: call multihost.initialize")
        self.mesh = mesh
        self.nproc, self.rank = dist.get_world_size(), dist.get_rank()
        _check_mesh_process_split(mesh, self.nproc)
        per = mesh.devices.shape[0] // self.nproc
        self.p_rows = range(self.rank * per, (self.rank + 1) * per)
        self.device = (self.home(0) if dist.get_backend() == "nccl"
                       else torch.device("cpu"))

    def home(self, di: int) -> torch.device:
        return self.mesh.devices[self.p_rows[0], di]

    def gather_rows(self, values):
        """Each process's int list -> [nproc, len] numpy, on every one."""
        import torch.distributed as dist

        mine = torch.tensor(list(values), dtype=torch.int64,
                            device=self.device)
        out = torch.empty(self.nproc * mine.numel(), dtype=torch.int64,
                          device=self.device)
        _quiet(dist.all_gather_into_tensor, out, mine)
        return out.cpu().numpy().reshape(self.nproc, -1)

    def broadcast_seed(self, seed: Optional[int]) -> int:
        """One round seed for every process: rank 0's."""
        import torch.distributed as dist

        if seed is None:
            seed = secrets.randbits(62)
        t = torch.tensor([int(seed)], dtype=torch.int64, device=self.device)
        dist.broadcast(t, src=0)
        return int(t.item())

    def combine(self, f, sums, masks):
        """As ``simpod._ShardComm.combine``, over the shards of every
        process: each returns every clerk row and the total mask sum."""
        import torch.distributed as dist

        d_shards = self.mesh.devices.shape[1]
        local = [_sum_on(self.device, [row[di] for row in sums])
                 for di in range(d_shards)]
        widths = [t.shape[1] for t in local]
        flat = torch.cat(local, dim=1)
        n = flat.shape[0]
        block = torch.empty((n // self.nproc, flat.shape[1]),
                            dtype=torch.int64, device=self.device)
        _quiet(dist.reduce_scatter_tensor, block, flat)
        block = f.canon(block)
        rows = torch.empty_like(flat)
        _quiet(dist.all_gather_into_tensor, rows, block)
        gathered = [g.to(self.home(di)) for di, g in
                    enumerate(rows.split(widths, dim=1))]
        if masks is None:
            return gathered, [None] * d_shards
        local_m = [_sum_on(self.device, [row[di] for row in masks])
                   for di in range(d_shards)]
        total = torch.cat(local_m)
        dist.all_reduce(total)
        total = f.canon(total)
        return gathered, [t.to(self.home(di)) for di, t in enumerate(
            total.split([t.shape[0] for t in local_m]))]


def aggregate_process_local(pod, local_inputs, seed: Optional[int] = None):
    """One secure-aggregation round over process-local participant rows.

    Every process passes its own ``[P_local, d]`` block (same ``d``
    everywhere; ragged ``P_local`` is fine — blocks are zero-padded to the
    max, and zero rows aggregate as zero with their masks cancelling).
    Returns the full [d] aggregate as host numpy, identical on every
    process. ``seed``: rank 0's round seed (None draws one).
    """
    inputs = _as_inputs(local_inputs)
    if inputs.ndim != 2:
        raise ValueError("local_inputs must be [P_local, d]")
    comm = _ProcessComm(pod.mesh)
    nproc = comm.nproc
    P_local, d_total = inputs.shape
    # processes must agree on the dimension; ragged participant counts are
    # fine — every process sizes its block to the max
    shapes = comm.gather_rows([P_local, d_total])
    if not (shapes[:, 1] == d_total).all():
        raise ValueError(
            f"process-local dimensions disagree: {shapes[:, 1].tolist()}"
        )
    P_global = int(shapes[:, 0].max()) * nproc
    # the participant axis must honor BOTH grains: the mesh p axis (via
    # pod.padded_shape) and an integer per-process row count
    p_grain = math.lcm(pod.mesh.devices.shape[0], nproc)
    P_pad, d_pad = pod.padded_shape(-(-P_global // p_grain) * p_grain,
                                    d_total)
    padded = inputs.new_zeros((P_pad // nproc, d_pad))
    padded[: inputs.shape[0], :d_total] = inputs
    seed = comm.broadcast_seed(seed)
    pod._check_shape(P_pad, d_pad)
    with timed_phase("mesh.multihost_round"):
        out = pod._round(padded, seed, comm)
        _sync(pod.mesh.distinct_devices())
    return out[:d_total].cpu().numpy()


class _MultihostCheckpointer:
    """Coordinated per-process snapshots for multihost streamed rounds.

    Every process snapshots its OWN shards of the accumulators (plus the —
    identical-everywhere — completed output prefix and tile cursor) to
    ``path.r{rank}of{n}`` at the same deterministic loop boundaries,
    rotating TWO slots. A crash can leave ranks one boundary apart (saves
    are lockstep but not atomic across processes), so resume picks the
    newest cursor EVERY rank still holds: each rank allgathers its
    available cursors and the same minimum is chosen everywhere; if the
    spread exceeds the two-slot history the round restarts from scratch
    rather than resuming inconsistently. Shards are re-placed by their
    global index, so resume is bit-identical to an uninterrupted run.
    """

    SLOTS = 2

    def __init__(self, path, spod, fingerprint, comm):
        self.comm = comm
        self.spod = spod
        self.nproc, self.rank = comm.nproc, comm.rank
        self.fingerprint = f"{fingerprint}|nproc={self.nproc}|rank={self.rank}"
        base = f"{path}.r{self.rank}of{self.nproc}"
        self.paths = [f"{base}.{s}" for s in ("a", "b")]
        self._slot = 0

    # -- save --------------------------------------------------------------

    def _acc_payload(self, name, grid, row_height: int):
        """This process's shards with their starts in the global layout
        (shares [p * n, B], masks [p, d_size]); a d-tile boundary's empty
        array passes through."""
        if isinstance(grid, np.ndarray):
            return {f"{name}_host": grid}
        p_shards = self.spod.mesh.devices.shape[0]
        widths = [t.shape[-1] for t in grid[0]]
        payload = {f"{name}_shape": np.asarray(
            [p_shards * row_height, sum(widths)], dtype=np.int64)}
        j = 0
        for row, pi in zip(grid, self.comm.p_rows):
            for di, t in enumerate(row):
                payload[f"{name}_{j}_start"] = np.asarray(
                    [pi * row_height, sum(widths[:di])], dtype=np.int64)
                payload[f"{name}_{j}_data"] = t.cpu().numpy()
                j += 1
        return payload

    def save(self, out, done_dims, di, pi, acc_shares, acc_mask):
        from .streaming import _atomic_npz, _snapshot_header

        payload = _snapshot_header(self.fingerprint, out, done_dims, di, pi)
        payload.update(self._acc_payload(
            "accS", acc_shares, self.spod.scheme.output_size))
        payload.update(self._acc_payload("accM", acc_mask, 1))
        _atomic_npz(self.paths[self._slot], **payload)
        self._slot ^= 1

    # -- load / coordinate -------------------------------------------------

    def _local_candidates(self):
        """cursor -> path, probing ONLY the cursor header (no accumulator
        payloads are materialized until the fleet has picked a target)."""
        from .streaming import _read_snapshot

        cands = {}
        for path in self.paths:
            header = _read_snapshot(path, self.fingerprint,
                                    keys=("done_dims", "di", "pi"))
            if header is not None:
                cursor = (int(header["di"]), int(header["pi"]),
                          int(header["done_dims"]))
                cands[cursor] = path
        return cands

    def load(self):
        from .streaming import _read_snapshot

        cands = self._local_candidates()
        # encode this rank's available cursors as a fixed [SLOTS, 3] block
        # (-1 rows = no snapshot) and allgather — every rank computes the
        # SAME resume decision from the identical gathered table
        enc = np.full((self.SLOTS, 3), -1, dtype=np.int64)
        for j, cursor in enumerate(sorted(cands)[: self.SLOTS]):
            enc[j] = cursor
        table = self.comm.gather_rows(enc.reshape(-1)).reshape(
            self.nproc, self.SLOTS, 3)
        per_rank = []
        for r in range(self.nproc):
            have = {tuple(int(v) for v in row)
                    for row in table[r] if row[0] >= 0}
            if not have:
                return None  # a rank with no snapshot: fresh start
            per_rank.append(have)
        target = min(max(have) for have in per_rank)
        if any(target not in have for have in per_rank):
            return None  # spread beyond history: restart, never mix
        payload = _read_snapshot(cands[target], self.fingerprint)
        # the full-read outcome must stay a FLEET decision: a snapshot
        # lost between probe and read on one rank must send every rank
        # down the fresh-start path together, not split them
        ok = self.comm.gather_rows([1 if payload is not None else 0])
        if int(ok.sum()) != self.nproc:
            return None
        return {
            "out": payload["out"],
            "done_dims": payload["done_dims"],
            "di": payload["di"],
            "pi": payload["pi"],
            "_payload": payload,
        }

    def restore(self, resume):
        payload = resume["_payload"]
        devs = self.spod.mesh.devices
        d_shards = devs.shape[1]

        def rebuild(name, row_height):
            width = int(payload[f"{name}_shape"][1]) // d_shards
            blocks = {}
            j = 0
            while f"{name}_{j}_data" in payload:
                start = tuple(int(v) for v in payload[f"{name}_{j}_start"])
                blocks[start] = payload[f"{name}_{j}_data"]
                j += 1
            # owned copies the kernels may write in place
            return [[torch.from_numpy(blocks[(pi * row_height, di * width)])
                     .to(devs[pi, di], copy=True) for di in range(d_shards)]
                    for pi in self.comm.p_rows]

        return (rebuild("accS", self.spod.scheme.output_size),
                rebuild("accM", 1))

    def finish(self):
        import os

        for path in self.paths:
            try:
                os.unlink(path)
            except OSError:
                pass


def streamed_aggregate_process_local(
    spod, get_local_block, local_participants: int, dimension: int,
    seed: Optional[int] = None, *, checkpoint_path=None,
    checkpoint_every_chunks: int = 16,
):
    """Flagship-scale multihost rounds: every process STREAMS its own
    participant rows through the StreamedPod tile loop.

    ``get_local_block(lp0, lp1, d0, d1)`` returns this process's local rows
    ``[lp0:lp1]`` for dim window ``[d0:d1)`` (short or empty edge blocks
    are zero-padded here, so ragged per-process ``local_participants`` is
    fine). All processes iterate in lockstep to the max local count; a
    global tile's rows map process-major onto the processes' local rows,
    and no process ever holds another's rows. Aggregation is a sum, so the
    global participant order is irrelevant to the result. Returns the
    [dimension] aggregate on every process.

    ``checkpoint_path``: coordinated multi-process resume — every process
    snapshots its own accumulator shards at the same loop boundaries
    (two-slot history; see _MultihostCheckpointer) and a relaunched fleet
    resumes bit-identically from the newest cursor all ranks still hold.
    """
    from .streaming import _block_tensor

    comm = _ProcessComm(spod.mesh)
    nproc = comm.nproc
    shapes = comm.gather_rows([local_participants, dimension])
    if not (shapes[:, 1] == dimension).all():
        raise ValueError(
            f"process-local stream dimensions disagree: {shapes[:, 1].tolist()}"
        )
    # ragged local counts: iterate to the max, but never ask the caller's
    # provider for rows beyond what IT declared — short/empty blocks are
    # zero-padded and zeros aggregate as zero
    my_count = local_participants
    local_participants = int(shapes[:, 0].max())
    seed = comm.broadcast_seed(seed)

    pc = spod.participants_chunk
    # StreamedPod rounds pc up to a multiple of p_shards, and the mesh check
    # guarantees nproc divides p_shards — so whole local rows per tile
    pc_local = pc // nproc
    home = comm.home(0)

    def make_block(p0, p1, d0, d1, d_size):
        # global tile rows [p0:p1) map process-major onto local rows
        lp0 = min(p0 // nproc, my_count)
        lp1 = min(p1 // nproc, my_count)
        return _block_tensor(get_local_block(lp0, max(lp0, lp1), d0, d1),
                             pc_local, d_size, home)

    checkpointer = None
    if checkpoint_path is not None:
        checkpointer = _MultihostCheckpointer(
            checkpoint_path, spod,
            spod._checkpoint_fingerprint(
                local_participants * nproc, dimension, seed),
            comm,
        )

    with timed_phase("mesh.multihost_streamed_round"):
        # drive over the GLOBAL participant count so every process iterates
        # the identical tile sequence in lockstep
        return spod.drive_tiles(
            local_participants * nproc, dimension, seed,
            make_block=make_block,
            make_accs=lambda d_size: spod._new_accs(d_size, comm),
            comm=comm, checkpointer=checkpointer,
            checkpoint_every_chunks=checkpoint_every_chunks,
        )
