"""Device timing for the port's benchmarks — counterpart of
``sda_tpu/utils/benchtime.py``.

- ``median_ms`` times a kernel: a pair of CUDA events around each call,
  after a warm-up, median of the calls. On the CPU (the tests' rehearsal)
  it reads ``time.perf_counter`` instead; such a number is a host time,
  never a device metric.
- ``chain_seconds`` / ``marginal_seconds`` time a whole round as the
  reference does: dispatch a chain of r rounds, drain the device queue once
  (``torch.cuda.synchronize``: CUDA launches are asynchronous), and
  difference two chain lengths, so the fixed launch-and-sync overhead
  cancels: ``per_rep = (T(r2) - T(r1)) / (r2 - r1)``. Their ``chain`` and
  ``fixed_overhead_s`` diagnostics feed ``obs.regress.chain_rel_uncertainty``.
- ``dim_tile_knob`` / ``stream_pc_knob``: the bench's dim-tile width and
  streamed participant chunk, from ``SDA_PALLAS_DIMTILE`` /
  ``SDA_BENCH_STREAM_PC``.

The JAX module's ``pallas_knobs``, ``tile_from_sweep``,
``export_knobs_to_env``, ``tree_fold_knob`` and
``benchmarks/PALLAS_KNOBS.json`` carry the TPU's block-size sweep
(``p_block``, ``tile``); the CUDA kernels have no such knobs (a thread owns
a column and folds every participant), so they are not carried over.
"""

from __future__ import annotations

import os
import statistics
import time
from typing import Callable, Tuple

import torch


#: device clock cycles the stream spins before each timed call (~1 ms at
#: an H100's 1.98 GHz), longer than a wrapper's host work before a launch
_BUSY_CYCLES = 2_000_000


def median_ms(fn: Callable[[], object], device, reps: int = 20,
              warmup: int = 3) -> float:
    """Median time of one call of ``fn()`` in ms, over ``reps`` calls
    after ``warmup`` untimed ones.

    On a CUDA ``device``: device time between CUDA events recorded on the
    current stream just before and just after each call. The stream is
    first kept busy for about a millisecond (``torch.cuda._sleep``), so
    that the host has queued the call's launches before the first event
    fires: the time is the device's, not the host's work in ``fn`` before
    its first launch. Inputs larger than the card's 50 MB L2 need no flush
    between calls. On the CPU: host time by ``perf_counter``.
    """
    dev = torch.device(device)
    for _ in range(warmup):
        fn()
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_BUSY_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _drain(out) -> None:
    """Wait for the device work behind ``out``: a CUDA tensor's device is
    synchronized; anything else (a host array, a CPU tensor) is already
    complete when the call returns."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def chain_seconds(dispatch: Callable[[int], object], reps: int) -> float:
    """Wall time to dispatch ``reps`` calls and drain the device queue.

    ``dispatch(i)`` issues rep ``i`` and returns its output; the chain
    ends in one synchronize of the last output's device.
    """
    t0 = time.perf_counter()
    out = None
    for i in range(reps):
        out = dispatch(i)
    _drain(out)
    return time.perf_counter() - t0


def marginal_seconds(
    dispatch: Callable[[int], object],
    target_seconds: float = 10.0,
    max_reps: int = 64,
) -> Tuple[float, dict]:
    """Marginal per-rep seconds of ``dispatch``, with diagnostics.

    Probes one rep to size the chains, then returns
    ``(T(r2) - T(r1)) / (r2 - r1)`` with r2 ~ target_seconds of work.
    The dict records the raw chain timings for the bench JSON.
    """
    probe = chain_seconds(dispatch, 1)  # includes the fixed sync: overestimates
    r2 = int(min(max_reps, max(10, round(target_seconds / max(probe, 1e-4)))))
    r1 = max(1, r2 // 5)
    t1 = chain_seconds(dispatch, r1)
    t2 = chain_seconds(dispatch, r2)
    if t2 > t1 and r2 > r1:
        per = (t2 - t1) / (r2 - r1)
    else:  # noise swamped the difference; fall back to the long chain
        per = t2 / r2
    info = {
        "timing": "chained-dispatch marginal (cancels the fixed "
                  "launch-and-sync overhead)",
        "probe_s": round(probe, 4),
        "chain": {"r1": r1, "t1_s": round(t1, 4), "r2": r2, "t2_s": round(t2, 4)},
        "fixed_overhead_s": round(max(t1 - r1 * per, 0.0), 4),
    }
    return per, info


#: default monolithic dim-tile width: 4 tiles at the flagship d=999,999
#: (the width ``chip_smoke.py`` times the tiled round at)
DEFAULT_DIM_TILE = 262_144


def dim_tile_knob(default: int = DEFAULT_DIM_TILE):
    """Monolithic dim-tile width: SDA_PALLAS_DIMTILE env (0 disables
    tiling -> None), else ``default``."""
    env = os.environ.get("SDA_PALLAS_DIMTILE")
    val = int(env) if env else default
    return val if val > 0 else None


def stream_pc_knob(default: int = 64) -> int:
    """Streamed participant-chunk size: SDA_BENCH_STREAM_PC env, else
    ``default``."""
    env = os.environ.get("SDA_BENCH_STREAM_PC")
    return int(env) if env else default
