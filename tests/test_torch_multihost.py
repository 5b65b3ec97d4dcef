"""Multi-process rounds of the port (``sda_tpu_torch.mesh.multihost``) over
``torch.distributed`` with gloo on the CPU, mirroring
``tests/test_multihost.py``: two and four OS processes, each owning one
slice of the mesh's ``p`` axis and only its own participant rows, reveal
the exact int64 column sum mod m on every process (tolerance 0), and a
fleet that dies mid-round resumes from its coordinated per-process
snapshots. The process groups meet through ``file://`` stores under
``tmp_path`` (no fixed ports), with a timeout of their own; the workers
import the port only, never JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from sda_tpu_torch.mesh import make_mesh, multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a worker may take; the group's own timeout is shorter
WORKER_TIMEOUT_S = 180

_PRELUDE = r"""
import os
import sys

store, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
attempt, ckdir = int(sys.argv[4]), sys.argv[5]
from sda_tpu_torch.mesh import multihost
multihost.initialize(num_processes=nproc, process_id=pid,
                     init_method=f"file://{store}", device="cpu",
                     timeout_s=60)
import numpy as np
import torch.distributed as dist
from sda_tpu_torch.mesh import (SimulatedPod, StreamedPod,
                                make_multislice_mesh)
from sda_tpu_torch.protocol import (AdditiveSharing, ChaChaMasking,
                                    FullMasking, PackedShamirSharing)
assert dist.get_world_size() == nproc and dist.get_backend() == "gloo"


def no_jax():
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "sda_tpu")]
    assert not bad, bad
"""

_POD_WORKER = _PRELUDE + r"""
scheme = PackedShamirSharing(3, 8, 4, 433, 354, 150)
# one slice block per process: participant rows never leave a process
mesh = make_multislice_mesh(2, 2, 2, devices=["cpu"] * 8)
pod = SimulatedPod(scheme, masking_scheme=FullMasking(433), mesh=mesh)

def rows(process):  # deterministic, RAGGED per-process participant rows
    return np.random.default_rng(100 + process).integers(
        0, 433, size=(2 + process, 12))

out = multihost.aggregate_process_local(pod, rows(pid), seed=7)
np.testing.assert_array_equal(out, (rows(0).sum(0) + rows(1).sum(0)) % 433)
# K1's lane (its plain version on the CPU) over the flagship prime
from sda_tpu_torch.fields import numtheory
t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
k1_pod = SimulatedPod(PackedShamirSharing(3, 8, t, p, w2, w3),
                      FullMasking(p), mesh=mesh, use_pallas=True)
k1 = multihost.aggregate_process_local(k1_pod, rows(pid) << 16)
np.testing.assert_array_equal(
    k1, ((rows(0) << 16).sum(0) + (rows(1) << 16).sum(0)) % p)

# streamed: every process streams its own rows in tiles; RAGGED local
# counts (5 rows on process 0, 4 on process 1) and several dim tiles
spod = StreamedPod(AdditiveSharing(share_count=8, modulus=433),
                   ChaChaMasking(433, 40, 128), mesh=mesh,
                   participants_chunk=4, dim_chunk=16)

def srows(process):
    return np.random.default_rng(900 + process).integers(
        0, 433, size=(5 - process, 40))

mine = srows(pid)

def strict_provider(lp0, lp1, d0, d1):
    # the driver never asks for rows beyond what THIS process declared
    assert 0 <= lp0 <= lp1 <= mine.shape[0], (lp0, lp1, mine.shape)
    return mine[lp0:lp1, d0:d1]

sout = multihost.streamed_aggregate_process_local(
    spod, strict_provider, local_participants=mine.shape[0], dimension=40,
    seed=9)
np.testing.assert_array_equal(sout, (srows(0).sum(0) + srows(1).sum(0)) % 433)

# clerk dropout: process 1 hosts p shards 2-3 = clerk rows 4..7; with k=2,
# n=8, t=1 the reconstruction threshold is 3, so the rows of process 0
# alone reveal, read from the GATHERED clerk axis
t2, p2, w22, w32 = numtheory.generate_packed_params(2, 8, 8)
assert t2 + 2 <= 4
dpod = StreamedPod(PackedShamirSharing(2, 8, t2, p2, w22, w32),
                   FullMasking(p2), mesh=mesh, participants_chunk=4,
                   dim_chunk=16, surviving_clerks=(0, 1, 2, 3))

def drows(process):
    return np.random.default_rng(700 + process).integers(0, p2, size=(4, 36))

mine_d = drows(pid)
dout = multihost.streamed_aggregate_process_local(
    dpod, lambda lp0, lp1, d0, d1: mine_d[lp0:lp1, d0:d1],
    local_participants=4, dimension=36, seed=13)
np.testing.assert_array_equal(dout, (drows(0).sum(0) + drows(1).sum(0)) % p2)
dist.destroy_process_group()
no_jax()
print(f"MULTIHOST_OK process={pid}", flush=True)
"""

_CK_WORKER = _PRELUDE + r"""
mesh = make_multislice_mesh(2, 2, 2, devices=["cpu"] * 8)
spod = StreamedPod(AdditiveSharing(share_count=8, modulus=433),
                   FullMasking(433), mesh=mesh, participants_chunk=4,
                   dim_chunk=16)

def rows(process):
    return np.random.default_rng(40 + process).integers(0, 433, size=(8, 48))

mine = rows(pid)
calls = {"n": 0}

def provider(lp0, lp1, d0, d1):
    calls["n"] += 1
    if attempt == 0 and calls["n"] > 4:
        # the fleet dies mid-round (both ranks at the same lockstep tile)
        os._exit(3)
    return mine[lp0:lp1, d0:d1]

out = multihost.streamed_aggregate_process_local(
    spod, provider, local_participants=8, dimension=48, seed=21,
    checkpoint_path=f"{ckdir}/ck", checkpoint_every_chunks=1)
np.testing.assert_array_equal(out, (rows(0).sum(0) + rows(1).sum(0)) % 433)
dist.destroy_process_group()
no_jax()
print(f"CK_OK rank={pid} calls={calls['n']}", flush=True)
"""

_QUAD_WORKER = _PRELUDE + r"""
# FOUR slices of (1 participant shard x 2 dim shards): every process owns
# one slice, and only the participant fold crosses the processes
mesh = make_multislice_mesh(4, 1, 2, devices=["cpu"] * 8)
spod = StreamedPod(AdditiveSharing(share_count=8, modulus=433),
                   ChaChaMasking(433, 48, 128), mesh=mesh,
                   participants_chunk=4, dim_chunk=16)

def rows(process):  # ragged local counts: 3/2/2/2 rows across the ranks
    return np.random.default_rng(500 + process).integers(
        0, 433, size=(2 + (process == 0), 48))

mine = rows(pid)
calls = {"n": 0}

def provider(lp0, lp1, d0, d1):
    assert 0 <= lp0 <= lp1 <= mine.shape[0], (lp0, lp1, mine.shape)
    calls["n"] += 1
    if attempt == 0 and calls["n"] > 2 + pid:
        # STAGGERED loss: each rank dies at another tile count (the first
        # death may also fail its peers' next collective before they reach
        # their own limits: any spread is valid)
        os._exit(3)
    return mine[lp0:lp1, d0:d1]

out = multihost.streamed_aggregate_process_local(
    spod, provider, local_participants=mine.shape[0], dimension=48,
    seed=33, checkpoint_path=f"{ckdir}/qk", checkpoint_every_chunks=1)
expected = sum(rows(r).sum(axis=0) for r in range(4)) % 433
np.testing.assert_array_equal(out, expected)
dist.destroy_process_group()
no_jax()
print(f"QUAD_OK rank={pid} calls={calls['n']}", flush=True)
"""


def _run_fleet(code, nproc, tmp_path, attempt=0, tag="fleet"):
    """Start ``nproc`` workers on a fresh ``file://`` store; return their
    (returncode, stdout, stderr). Every worker is killed if any wait
    times out."""
    store = tmp_path / f"{tag}.{attempt}.store"
    env = {key: val for key, val in os.environ.items()
           if not key.startswith(("XLA_", "JAX_"))}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"  # small tensors: no spinning for cores
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(store), str(pid), str(nproc),
         str(attempt), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _cursor(path):
    with np.load(path) as z:
        return (int(z["di"]), int(z["pi"]), int(z["done_dims"]))


def _rank_slots(tmp_path, prefix, rank, nproc):
    return [p for p in (tmp_path / f"{prefix}.r{rank}of{nproc}.{s}"
                        for s in "ab") if p.exists()]


def test_two_process_pod_round(tmp_path):
    """Two processes, each with its own ragged rows: the one-shot pod,
    the streamed pod (ChaCha, ragged local counts) and a quorum reveal
    from process 0's clerk rows alone, exact on both."""
    for pid, (rc, out, err) in enumerate(_run_fleet(_POD_WORKER, 2,
                                                    tmp_path)):
        assert rc == 0, f"process {pid} failed:\n{err[-3000:]}"
        assert f"MULTIHOST_OK process={pid}" in out


def test_multihost_streamed_checkpoint_resume(tmp_path):
    """The fleet dies mid-round; a relaunch resumes from the coordinated
    per-rank snapshots and reveals EXACTLY — including the staggered case
    where one rank's newest snapshot is lost: every rank falls back to
    the newest cursor all of them still hold."""
    for rc, out, err in _run_fleet(_CK_WORKER, 2, tmp_path, 0, "ck"):
        assert rc != 0, (rc, err[-2000:])
    assert _rank_slots(tmp_path, "ck", 1, 2), "rank 1 saved no snapshot"
    slots1 = _rank_slots(tmp_path, "ck", 1, 2)
    if len(slots1) == 2:
        older, newest = sorted(slots1, key=_cursor)
        if _cursor(older) in {_cursor(p) for p in
                              _rank_slots(tmp_path, "ck", 0, 2)}:
            newest.unlink()
    common = ({_cursor(p) for p in _rank_slots(tmp_path, "ck", 0, 2)}
              & {_cursor(p) for p in _rank_slots(tmp_path, "ck", 1, 2)})
    full_calls = (16 // 4) * (48 // 16)  # p-tiles x d-tiles = 12
    for pid, (rc, out, err) in enumerate(
            _run_fleet(_CK_WORKER, 2, tmp_path, 1, "ck")):
        assert rc == 0, f"rank {pid} failed:\n{err[-3000:]}"
        assert f"CK_OK rank={pid}" in out
        calls = int(out.split("calls=")[1].split()[0])
        if common:
            assert calls < full_calls, (calls, full_calls)
        else:  # coordinated restart: still exact, full provider sweep
            assert calls == full_calls, (calls, full_calls)
    assert not list(tmp_path.glob("ck.r*")), "snapshots left"


def test_four_process_multislice_staggered_loss_resume(tmp_path):
    """FOUR processes over a 4-slice mesh run a streamed ChaCha round, die
    with STAGGERED per-rank cursors (plus one rank's newest snapshot
    deleted), and a full relaunch resumes from the newest cursor common to
    all four histories — or restarts cleanly when none exists — revealing
    the exact aggregate either way."""
    for rc, out, err in _run_fleet(_QUAD_WORKER, 4, tmp_path, 0, "qk"):
        assert rc != 0, (rc, err[-2000:])
    assert any(_rank_slots(tmp_path, "qk", r, 4) for r in range(4))
    slots3 = _rank_slots(tmp_path, "qk", 3, 4)
    if len(slots3) == 2:
        older, newest = sorted(slots3, key=_cursor)
        if all(_cursor(older) in {_cursor(p) for p in
                                  _rank_slots(tmp_path, "qk", r, 4)}
               for r in range(3)):
            newest.unlink()
    histories = [{_cursor(p) for p in _rank_slots(tmp_path, "qk", r, 4)}
                 for r in range(4)]
    resume_expected = all(histories) and bool(set.intersection(*histories))
    # lockstep: the global count padded to the chunk (3+2+2+2 -> 12/4 = 3
    # p-tiles) x 48/16 = 3 d-tiles
    full_calls = 3 * 3
    for pid, (rc, out, err) in enumerate(
            _run_fleet(_QUAD_WORKER, 4, tmp_path, 1, "qk")):
        assert rc == 0, f"rank {pid} failed:\n{err[-3000:]}"
        assert f"QUAD_OK rank={pid}" in out
        calls = int(out.split("calls=")[1].split()[0])
        if resume_expected:
            assert calls < full_calls, (calls, full_calls)
        else:
            assert calls == full_calls, (calls, full_calls)
    assert not list(tmp_path.glob("qk.r*")), "snapshots left"


_LONE_WORKER = r"""
import sys
from sda_tpu_torch.mesh import multihost
multihost.initialize(num_processes=2, process_id=0,
                     init_method=f"file://{sys.argv[1]}", device="cpu",
                     timeout_s=3)
print("FORMED", flush=True)
"""


def test_a_group_that_cannot_form_raises_within_its_timeout(tmp_path):
    """No fallback: a peer that never comes makes ``initialize`` raise
    once its own timeout passes."""
    env = {key: val for key, val in os.environ.items()
           if not key.startswith(("XLA_", "JAX_"))}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run(
        [sys.executable, "-c", _LONE_WORKER, str(tmp_path / "lone.store")],
        env=env, capture_output=True, text=True, timeout=WORKER_TIMEOUT_S)
    assert res.returncode != 0 and "FORMED" not in res.stdout
    assert "imeout" in res.stderr or "timed out" in res.stderr, \
        res.stderr[-2000:]


def test_initialize_needs_its_cluster():
    with pytest.raises(ValueError, match="num_processes and process_id"):
        multihost.initialize("localhost:1234", device="cpu")
    with pytest.raises(ValueError, match="coordinator_address or init"):
        multihost.initialize(num_processes=1, process_id=0, device="cpu")


def test_mesh_must_split_over_the_processes():
    multihost._check_mesh_process_split(make_mesh(4, 2, ["cpu"] * 8), 2)
    multihost._check_mesh_process_split(make_mesh(4, 2, ["cpu"] * 8), 4)
    with pytest.raises(ValueError, match="does not split its p axis"):
        multihost._check_mesh_process_split(make_mesh(3, 2, ["cpu"] * 6), 2)


def test_no_process_group_raises():
    from sda_tpu_torch.mesh import SimulatedPod
    from sda_tpu_torch.protocol import PackedShamirSharing

    pod = SimulatedPod(PackedShamirSharing(3, 8, 4, 433, 354, 150),
                       mesh=make_mesh(4, 2, ["cpu"] * 8))
    with pytest.raises(RuntimeError, match="no process group"):
        multihost.aggregate_process_local(pod, np.ones((2, 12)))
