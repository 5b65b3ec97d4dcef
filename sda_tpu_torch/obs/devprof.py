"""The device-memory watermark of model-scale rounds and the compile
totals of ``/statusz`` — the ``hbm_watermark`` and ``compile_totals``
parts of ``sda_tpu/obs/devprof.py``.

The reference's compile/retrace registry and roofline blocks describe
``jit``-compiled programs and have no counterpart in an eager torch port
(ROADMAP item 13); the watermark sizes the device-tile clerk fold's tiles
(``mesh.devscale.DeviceTileCombiner``).
"""

from __future__ import annotations

import os

import torch

from ..device import resolve_device
from ..utils import metrics

#: Per-device memory budget (bytes) of a device that reports none: the CPU
#: row is a deliberately small stand-in, so CPU runs exercise the SAME
#: tiling arithmetic a card would (a host-RAM-sized budget would let them
#: pick untiled widths no card could hold).
HBM_WATERMARK_DEFAULTS = {
    "cpu": 1 << 30,
}

#: fraction of the device budget the round may plan against — headroom
#: for the allocator, collective scratch, and the framework itself
DEFAULT_WATERMARK_FRACTION = 0.8


def hbm_watermark(device=None) -> int:
    """The per-device memory budget (bytes) model-scale rounds must plan
    under — what ``DeviceTileCombiner`` sizes its tiles by.

    Resolution order:

    1. ``SDA_HBM_WATERMARK`` — explicit budget in bytes (already
       fraction-adjusted: what the operator says is what the planner
       gets).
    2. On a CUDA ``device`` (the default; ``device="cpu"`` for the host),
       the card's total memory (``torch.cuda.mem_get_info``) times the
       headroom fraction (``SDA_HBM_WATERMARK_FRACTION``, default 0.8).
    3. On the CPU, :data:`HBM_WATERMARK_DEFAULTS` times the fraction.
    """
    dev = resolve_device(device)
    raw = os.environ.get("SDA_HBM_WATERMARK")
    if raw:
        try:
            value = int(float(raw))
            if value > 0:
                return value
        except ValueError:
            pass
    frac = DEFAULT_WATERMARK_FRACTION
    fraw = os.environ.get("SDA_HBM_WATERMARK_FRACTION")
    if fraw:
        try:
            frac = min(1.0, max(0.05, float(fraw)))
        except ValueError:
            pass
    if dev.type == "cuda":
        _, total = torch.cuda.mem_get_info(dev)
        return int(total * frac)
    return int(HBM_WATERMARK_DEFAULTS["cpu"] * frac)


def compile_totals() -> dict:
    """The compile-telemetry summary of ``/statusz``, with the reference's
    keys. Eager torch compiles nothing and the port registers no function,
    so ``functions`` is empty and the counts read the same ``xla.compile.*``
    metrics counters as the reference's, which nothing in the port
    increments: they are 0 unless a caller counts them."""
    counters = metrics.counter_report("xla.compile.")
    hist = metrics.histogram_report("xla.compile.seconds").get(
        "xla.compile.seconds")
    return {
        "functions": {},
        "backend_compiles": counters.get("xla.compile.backend", 0),
        "retraces": counters.get("xla.compile.retrace", 0),
        "compile_seconds": hist,
        "cache": {
            "hit": counters.get("xla.compile.cache.hit", 0),
            "miss": counters.get("xla.compile.cache.miss", 0),
        },
    }
