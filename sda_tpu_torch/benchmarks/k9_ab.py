"""The pod, the model-scale round and the clerk's fold of another checkout
of the port against this one's, on the card, in turns.

    python -m sda_tpu_torch.benchmarks.k9_ab --parent DIR

DIR is the root of another checkout of the repository (``git archive
<commit> | tar x -C DIR``, in a directory outside the checkout or one
``.gitignore`` lists). Each side runs in a process of its own whose
``sda_tpu_torch`` is that side's package (this file is run as a script
with the side's root first on ``sys.path``, so it uses only what both
sides export), builds that side's CUDA libraries into the side's own
``sda_tpu_torch/_build/`` (side by side, before anything is timed) and
prints one JSON line:

- ``pod``: ``SimulatedPod`` on K1 (Full masks, the flagship scheme: packed
  Shamir k=3, n=8, t=4 over 2^29 - 679) at P=100 x d=999,999 uint32
  inputs below 2^20 on the 1x1 mesh and on a virtual 4x2 mesh of the
  card: the median of 5 round times (host clock, ended by a
  synchronize), and one round under ``torch.profiler``: its device
  events (kernels, copies, memsets) and device time;
- ``devscale``: one round of ``run_devscale``'s pod at dim 1e8 (a
  ``StreamedPod`` on K1, Full masks, P=8 on the virtual 4x2 mesh, the
  watermark rule's dim tile, the device block provider), timed after a
  warm one and then profiled the same way;
- ``fold``: ``DeviceTileCombiner`` folding 100 rows of 1,000,008 residues
  in 4 bundles, a fresh combiner each time (the first fold's set-up
  included): the median wall time of 3, at the watermark's tile and at a
  tile of 262,144 (4 tiles, the last ragged).

Every round must be exact against the column sum mod p and every fold
against numpy's. The sides run in turns (parent, this checkout, this
checkout, parent, by default); the last line holds each side's medians
over its turns, the card's name and its power limit. Exits non-zero when
a side fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
P_POD, D_POD = 100, 999_999
DEVSCALE_DIM, DEVSCALE_P = 100_000_000, 8
FOLD_ROWS, FOLD_DIM, FOLD_BUNDLES, FOLD_TILE = 100, 1_000_008, 4, 262_144


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profile_round(fn, torch, dev):
    """(device events, device ms) of one call of ``fn`` under
    ``torch.profiler``, after one call unprofiled; (None, None) off a
    card (the CUDA activity hangs in a torch built for the CPU)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    if dev.type != "cuda":
        return None, None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events, busy_us = 0, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            events += e.count
            busy_us += us
    return events, busy_us / 1e3


def _wall_ms(fn, torch, dev, reps):
    fn()
    _sync(torch, dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(torch, dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def measure(device="cuda", pod_shape=(P_POD, D_POD),
            devscale_shape=(DEVSCALE_P, DEVSCALE_DIM),
            fold_shape=(FOLD_ROWS, FOLD_DIM, FOLD_BUNDLES, FOLD_TILE),
            build=True) -> dict:
    """One side's measurements (this process's ``sda_tpu_torch``); the
    shapes and ``device="cpu"`` (no builds, no profiles) rehearse it."""
    import numpy as np
    import torch

    from sda_tpu_torch.fields import _build, numtheory
    from sda_tpu_torch.mesh import (DeviceTileCombiner, SimulatedPod,
                                    StreamedPod, make_mesh,
                                    synthetic_device_block_provider32,
                                    watermark_dim_tile)
    from sda_tpu_torch.protocol import FullMasking, PackedShamirSharing

    dev = torch.device(device)
    names = [f.stem for f in sorted(_build.CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    if build:
        with ThreadPoolExecutor(len(names)) as pool:
            list(pool.map(_build.build, names))
    rec = {"package": str(Path(_build.__file__).resolve().parents[2]),
           "built": names, "build_s": time.perf_counter() - t0}
    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    scheme, full = PackedShamirSharing(3, 8, t, p, w2, w3), FullMasking(p)

    inputs = torch.from_numpy(np.random.default_rng(18).integers(
        0, 1 << 20, size=pod_shape, dtype=np.uint32)).to(dev)
    expect = inputs.to(torch.int64).sum(0) % p
    rec["pod"] = {}
    for shape in ((1, 1), (4, 2)):
        pod = SimulatedPod(scheme, full, mesh=make_mesh(
            *shape, devices=[dev] * (shape[0] * shape[1])), use_pallas=True)
        if not torch.equal(pod.aggregate(inputs, seed=18), expect):
            raise SystemExit(f"pod {shape}: != column sum mod p")
        fn = lambda: pod.aggregate(inputs, seed=18)  # noqa: E731
        events, device_ms = _profile_round(fn, torch, dev)
        rec["pod"][f"{shape[0]}x{shape[1]}"] = {
            "round_ms": _wall_ms(fn, torch, dev, 5), "device_events": events,
            "device_ms": device_ms}
    del inputs, expect

    P, dim = devscale_shape
    mesh = make_mesh(4, 2, devices=[dev] * 8)
    tile = watermark_dim_tile(
        scheme, full, participants_chunk=P, p_shards=4, d_shards=2,
        pallas=True, dim=dim, shards_per_device=8, device=dev)
    spod = StreamedPod(scheme, full, mesh=mesh, participants_chunk=P,
                       dim_chunk=tile, use_pallas=True)
    prov = synthetic_device_block_provider32(p, seed=20260804, device=dev)
    out = spod.aggregate_blocks(prov, P, dim, 7)
    want = sum(prov(i, i + 1, 0, dim)[0].to(torch.int64)
               for i in range(P)) % p
    if not np.array_equal(out, want.cpu().numpy()):
        raise SystemExit("devscale round: != column sum mod p")
    del want
    fn = lambda: spod.aggregate_blocks(prov, P, dim, 7)  # noqa: E731
    events, device_ms = _profile_round(fn, torch, dev)
    rec["devscale"] = {"dim_tile": spod.dim_chunk,
                       "tiles": -(-dim // spod.dim_chunk),
                       "round_ms": _wall_ms(fn, torch, dev, 1),
                       "device_events": events, "device_ms": device_ms}
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    fold_rows, fold_dim, fold_bundles, fold_tile = fold_shape
    rows = np.random.default_rng(15).integers(0, p,
                                              size=(fold_rows, fold_dim))
    bundles = np.array_split(rows, fold_bundles)
    want = rows.sum(0) % p
    rec["fold"] = {}
    for label, dim_tile in (("watermark tile", None), ("tile", fold_tile)):
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            comb = DeviceTileCombiner(p, dim_tile=dim_tile, device=dev)
            for bundle in bundles:
                comb.fold(bundle)
            got = comb.result()
            walls.append(time.perf_counter() - t0)
            if not np.array_equal(got, want):
                raise SystemExit(f"fold ({label}): != numpy's sum mod p")
        rec["fold"][label] = {"tile": comb._dim_tile,
                              "tiles": comb._plan_t.n_tiles,
                              "wall_s": statistics.median(walls)}
    return rec


def _side(root: Path, timeout: float) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    res = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--measure",
         str(root)], env=env, cwd=str(root), capture_output=True, text=True,
        timeout=timeout)
    if res.returncode != 0:
        raise SystemExit(f"k9_ab: the side at {root} failed:\n"
                         f"{res.stdout[-4000:]}{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def _medians(recs):
    """Each number's median over a side's turns, by its key path."""
    def walk(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: walk([r[k] for r in items]) for k in first}
        if isinstance(first, (int, float)) and not isinstance(first, bool):
            return statistics.median(items)
        return first
    return walk(recs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sda_tpu_torch.benchmarks.k9_ab",
        description="the pod rounds, the 1e8 model-scale round and the "
                    "clerk's fold of another checkout against this one's, "
                    "in turns, on the card")
    ap.add_argument("--parent", type=Path,
                    help="the root of the other checkout")
    ap.add_argument("--order", default="pccp",
                    help="turns: p (parent) and c (this checkout)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a turn may take")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure is not None:
        print(json.dumps(measure()), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    import torch

    if not torch.cuda.is_available():
        print("k9_ab: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    roots = {"p": args.parent.resolve(), "c": ROOT}
    turns = {"p": [], "c": []}
    for i, side in enumerate(args.order):
        rec = _side(roots[side], args.timeout)
        turns[side].append(rec)
        print(json.dumps({"turn": i, "side": "parent" if side == "p"
                          else "change", **rec}), flush=True)
    print(json.dumps({"card": smi[0] if smi else None,
                      "parent": _medians(turns["p"]) if turns["p"] else None,
                      "change": _medians(turns["c"]) if turns["c"] else None,
                      "turns": args.order}), flush=True)
    return 0


if __name__ == "__main__":
    if "--measure" in sys.argv:
        # the side's package, not this file's directory, on the path
        sys.path[0] = sys.argv[sys.argv.index("--measure") + 1]
    sys.exit(main())
