"""Device timing for the port's benchmarks — counterpart of
``sda_tpu/utils/benchtime.py``.

The JAX module's ``marginal_seconds`` differences two chains of
dispatches so that the fixed round trip of a remote TPU cancels. A local
CUDA device has no such round trip: ``median_ms`` times each call with a
pair of CUDA events around it, after a warm-up, and takes the median. On
the CPU (the tests' rehearsal) it reads ``time.perf_counter`` instead; such
a number is a host time, never a device metric.

The JAX module's ``pallas_knobs``, ``export_knobs_to_env`` and
``benchmarks/PALLAS_KNOBS.json`` carry TPU block sizes (``p_block``,
``tile``); the CUDA kernels have no such knobs (a thread owns a column and
folds every participant), so they are not carried over.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

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
