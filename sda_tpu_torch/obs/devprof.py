"""Device observability plane of the port: the call/shape registry, counted
costs and the roofline, device-memory peaks and the watermark, and the
compile totals of ``/statusz`` — counterpart of ``sda_tpu/obs/devprof.py``.

- **Call/shape registry** — ``instrument(name, fn, cost=None)`` wraps an
  eager callable: per-function call counts and the set of distinct
  argument signatures (shapes + dtypes + static values), first-seen order.
  Eager torch compiles nothing, so ``compiles`` and ``retraces`` stay 0 by
  construction (the reference's rule for a wrapped eager function); its
  ``jax.monitoring`` taps and retrace span events have no counterpart.
  The wrapper adds no synchronize and no host copy.

- **Counted costs / roofline** — XLA's ``cost_analysis`` has no torch
  counterpart. With ``enable_cost_analysis()`` on, each instrumented call
  whose site gives ``cost`` records, once per signature, the integer
  operations ``cost(*args, **kwargs)`` counts from the algorithm for the
  call's shapes (K1's from ``benchmarks/bounds.py::k1_ops``, the count its
  bound uses) and the bytes of its input and output tensors (``nbytes``,
  each read or written once); and, on every call on a CUDA device, its
  device-memory peak (``torch.cuda.max_memory_allocated`` after
  ``reset_peak_memory_stats``; an instrumented call nested in another
  gets its own peak, and the outer call's covers it). ``roofline()``
  folds them into the bench JSON's ``roofline`` block against the card's
  peaks (``CHIP_PEAKS``).

- **Watermark** — ``hbm_watermark`` is the memory budget model-scale
  rounds plan under (``mesh.devscale.DeviceTileCombiner`` sizes its tiles
  by it); ``watermark_report`` holds a recorded peak against it.

State resets through ``obs.reset_all()``.
"""

from __future__ import annotations

import functools
import os
import threading
from typing import Dict, Optional, Tuple

from .._lazy import torch
from ..benchmarks import bounds
from ..device import resolve_device
from ..utils import metrics

__all__ = [
    "CHIP_PEAKS",
    "FnProfile",
    "HBM_WATERMARK_DEFAULTS",
    "OPS_UNIT",
    "compile_totals",
    "cost_analysis_enabled",
    "enable_cost_analysis",
    "hbm_peak_recorded",
    "hbm_watermark",
    "instrument",
    "profile",
    "report",
    "reset",
    "roofline",
    "roofline_block",
    "watermark_report",
]

#: Card peaks for the roofline model, per platform. The cuda row is the
#: H100 SXM's (``benchmarks/bounds.py``: one integer pipe of 132 SMs x 64
#: lanes at the clock its fp32 peak implies, and the HBM3 rate), against
#: which the counted operations of the busiest pipe are read; the cpu row
#: is a nominal placeholder so CPU runs still produce a finite utilization
#: — CPU numbers are advisory only. Override with SDA_ROOFLINE_PEAK_FLOPS /
#: SDA_ROOFLINE_PEAK_BW.
CHIP_PEAKS = {
    "cuda": {
        "flops_per_s": bounds.PIPE_OPS_PER_S,
        "hbm_bytes_per_s": bounds.HBM_BYTES_PER_S,
        "source": "sda_tpu_torch/benchmarks/bounds.py (H100 SXM data "
                  "sheet: an integer pipe of 132 SMs x 64 lanes, HBM3)",
    },
    "cpu": {
        "flops_per_s": 1.0e11,
        "hbm_bytes_per_s": 5.0e10,
        "source": "nominal CPU placeholder — utilization advisory only",
    },
}

#: what the roofline block's ``flops`` counts
OPS_UNIT = "int32/int64 pipe ops, counted"

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

_lock = threading.Lock()
_profiles: "Dict[str, FnProfile]" = {}
_cost_enabled = False
#: per thread: the open instrumented calls' memory frames (see _MemoryFrame)
_frames = threading.local()


class FnProfile:
    """Per-instrumented-function state: the shape registry plus call
    tallies and (opt-in) counted-cost entries. Mutated under the module
    lock. ``compiles`` and ``retraces`` are the reference's keys and stay 0:
    eager torch compiles nothing."""

    __slots__ = ("name", "calls", "compiles", "retraces", "shapes", "costs")

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.compiles = 0
        self.retraces = 0
        #: signature -> call count; signature order == first-seen order
        self.shapes: Dict[Tuple, int] = {}
        #: signature -> {"flops", "bytes_accessed", "hbm_peak_bytes"}
        self.costs: Dict[Tuple, dict] = {}

    def block_shapes(self):
        """The leading array shape of each seen signature (tests use this
        to pin the "at most 2 shapes per axis" claim)."""
        out = []
        for sig in self.shapes:
            for entry in sig:
                if entry[0] == "a":
                    out.append(entry[1])
                    break
        return out

    def totals(self) -> dict:
        """Cost totals across every call (per-signature cost x calls)."""
        flops = bytes_acc = 0.0
        hbm_peak = 0
        for sig, cost in self.costs.items():
            n = self.shapes.get(sig, 0)
            flops += n * float(cost.get("flops") or 0.0)
            bytes_acc += n * float(cost.get("bytes_accessed") or 0.0)
            hbm_peak = max(hbm_peak, int(cost.get("hbm_peak_bytes") or 0))
        return {"flops": flops, "bytes_accessed": bytes_acc,
                "hbm_peak_bytes": hbm_peak}

    def to_obj(self) -> dict:
        return {
            "calls": self.calls,
            "compiles": self.compiles,
            "retraces": self.retraces,
            "compiled_shapes": len(self.shapes),
            "block_shapes": [list(s) for s in self.block_shapes()],
        }


def _sig_entry(value, out) -> None:
    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    if shape is not None and dtype is not None:
        out.append(("a", tuple(shape), str(dtype)))
        return
    if isinstance(value, (tuple, list)):  # containers, by structure
        out.append(("[", len(value)))
        for item in value:
            _sig_entry(item, out)
        return
    if isinstance(value, dict):
        out.append(("{", len(value)))
        for key in sorted(value, key=str):
            out.append(("k", str(key)))
            _sig_entry(value[key], out)
        return
    if value is None or isinstance(value, (bool, str, bytes)):
        out.append(("s", value))  # flags and names, by value
        return
    # numbers and every other object by type: eager torch keys no program
    # on them, a seed or a tile offset is a new value every call (the
    # reference passes those as traced arrays, keyed by shape), and an
    # object's value is most often its identity (a pod's collectives, a
    # generator), a new one every round: keyed so, the registry would grow
    # a "shape" a call
    out.append(("t", type(value).__name__))


def _signature(args, kwargs) -> Tuple:
    """Hashable signature of a call: tensor and array leaves by (shape,
    dtype) — containers flattened structurally — flags and names by
    value, and numbers and other objects by type."""
    entries = []
    items = list(enumerate(args)) + sorted(
        kwargs.items(), key=lambda kv: str(kv[0]))
    for _key, value in items:
        _sig_entry(value, entries)
    return tuple(entries)


def _tensors(value):
    """The torch tensors among ``value``'s leaves (containers walked)."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for item in value:
            yield from _tensors(item)
    elif isinstance(value, dict):
        for item in value.values():
            yield from _tensors(item)


def enable_cost_analysis(on: bool = True) -> None:
    """Opt in to counted costs and device-memory peaks (bench/sim entry
    points only; library and test runs keep the wrapper to its call
    counts). SDA_DEVPROF_COST=0/1 overrides."""
    global _cost_enabled
    _cost_enabled = bool(on)


def cost_analysis_enabled() -> bool:
    env = os.environ.get("SDA_DEVPROF_COST")
    if env is not None and env != "":
        return env not in ("0", "false", "no")
    return _cost_enabled


class _MemoryFrame:
    """Device-memory peak of one instrumented call on a CUDA device.

    torch keeps one peak counter a device, so nested calls share it: a
    call entering inside another folds the counter into its parent's
    ``carry`` before resetting it, and on exit hands its own peak to the
    parent, whose peak is the larger of its carry and the counter."""

    def __init__(self, device: torch.device):
        self.device = device
        self.carry = 0

    def __enter__(self):
        stack = getattr(_frames, "stack", None)
        if stack is None:
            stack = _frames.stack = []
        for frame in stack:
            if frame.device == self.device:
                frame.carry = max(
                    frame.carry, torch.cuda.max_memory_allocated(self.device))
        torch.cuda.reset_peak_memory_stats(self.device)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        stack = _frames.stack
        stack.pop()
        self.peak = max(self.carry,
                        torch.cuda.max_memory_allocated(self.device))
        for frame in stack:
            if frame.device == self.device:
                frame.carry = max(frame.carry, self.peak)


def _record_cost(prof: FnProfile, sig: Tuple, cost, args, kwargs, out,
                 peak: Optional[int]) -> None:
    """Record the call's counted cost (first call of a signature) and its
    memory peak. Any surprise in the cost function is recorded, never
    raised — profiling must not fail the round it observes."""
    with _lock:
        entry = prof.costs.get(sig)
    if entry is None:
        try:
            ops = int(cost(*args, **kwargs))
            nbytes = sum(t.nbytes for t in _tensors((args, kwargs, out)))
            entry = {"flops": ops, "bytes_accessed": nbytes,
                     "hbm_peak_bytes": 0}
        except Exception as e:  # noqa: BLE001 — observability stays best-effort
            entry = {"error": f"{type(e).__name__}: {str(e)[:200]}"}
    if peak:
        entry["hbm_peak_bytes"] = max(int(entry.get("hbm_peak_bytes") or 0),
                                      int(peak))
        metrics.gauge_max("device.hbm.peak_bytes", peak)
        metrics.gauge_max(f"device.hbm.peak_bytes.{prof.name}", peak)
    with _lock:
        prof.costs[sig] = entry


def profile(name: str) -> FnProfile:
    """The (created-on-demand) profile entry for ``name``."""
    with _lock:
        prof = _profiles.get(name)
        if prof is None:
            prof = _profiles[name] = FnProfile(name)
        return prof


def instrument(name: str, fn, cost=None):
    """Wrap an eager callable with the call/shape registry.

    Repeated ``instrument`` calls with the same ``name`` accumulate into
    ONE profile entry, so the registry reflects the logical phase, not
    the python object. ``cost(*args, **kwargs)``: the integer operations
    of a call, counted from the algorithm for its shapes; with cost
    capture on, the wrapper records it with the call's tensor bytes and
    device-memory peak.
    """
    profile(name)  # eager registration; the wrapper re-resolves per call

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        # re-resolved per call, NOT closed over: module-level wrappers
        # (fields/sharing.py) outlive obs.reset_all(), and stats written
        # into a pre-reset profile object would be invisible forever
        prof = profile(name)
        sig = _signature(args, kwargs)
        with _lock:
            prof.calls += 1
            prof.shapes[sig] = prof.shapes.get(sig, 0) + 1
        if cost is None or not cost_analysis_enabled():
            return fn(*args, **kwargs)
        device = next((t.device for t in _tensors((args, kwargs))
                       if t.is_cuda), None)
        if device is None:
            out, peak = fn(*args, **kwargs), None
        else:
            with _MemoryFrame(device) as frame:
                out = fn(*args, **kwargs)
            peak = frame.peak
        _record_cost(prof, sig, cost, args, kwargs, out, peak)
        return out

    return wrapper


def install_monitoring() -> bool:
    """The reference registers ``jax.monitoring`` listeners here, feeding
    the ``xla.compile.*`` counters. Eager torch compiles nothing, so the
    port registers nothing and returns False, as the reference does where
    jax is missing."""
    return False


# -- reports ------------------------------------------------------------------

def report() -> Dict[str, dict]:
    """{function name: call/shape summary} for every instrumented function
    CALLED since the last reset (instrument() registers profiles eagerly
    at import; zero-call entries are noise)."""
    with _lock:
        return {name: prof.to_obj()
                for name, prof in sorted(_profiles.items()) if prof.calls}


def compile_totals() -> dict:
    """The compile-telemetry summary of ``/statusz`` and the bench's
    ``xla`` block, with the reference's keys: the per-function registry,
    and the ``xla.compile.*`` metrics counters, which nothing in the port
    increments (eager torch compiles nothing): they are 0 unless a caller
    counts them."""
    counters = metrics.counter_report("xla.compile.")
    hist = metrics.histogram_report("xla.compile.seconds").get(
        "xla.compile.seconds")
    return {
        "functions": report(),
        "backend_compiles": counters.get("xla.compile.backend", 0),
        "retraces": counters.get("xla.compile.retrace", 0),
        "compile_seconds": hist,
        "cache": {
            "hit": counters.get("xla.compile.cache.hit", 0),
            "miss": counters.get("xla.compile.cache.miss", 0),
        },
    }


def _peaks(platform: Optional[str]) -> Tuple[str, dict]:
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if platform in CHIP_PEAKS:
        label, peaks = platform, dict(CHIP_PEAKS[platform])
        if platform == "cuda" and torch.cuda.is_available():
            peaks["source"] += f"; this card: {torch.cuda.get_device_name()}"
    else:
        # a platform with no pinned peaks must not be scored against — or
        # labeled as — the card's roofline
        label, peaks = platform, dict(CHIP_PEAKS["cpu"])
        peaks["source"] = (f"no pinned peaks for platform {platform!r} — "
                           f"nominal placeholders, override via env")
    for env, key in (("SDA_ROOFLINE_PEAK_FLOPS", "flops_per_s"),
                     ("SDA_ROOFLINE_PEAK_BW", "hbm_bytes_per_s")):
        raw = os.environ.get(env)
        if raw:
            try:
                peaks[key] = float(raw)
                peaks["source"] = "env override"
            except ValueError:
                pass
    return label, peaks


def roofline_block(flops: float, bytes_accessed: float,
                   seconds: Optional[float] = None,
                   platform: Optional[str] = None,
                   hbm_peak_bytes: int = 0) -> dict:
    """The bench-JSON ``roofline`` block for explicit totals: arithmetic
    intensity, attainable rate under the card's peaks (``min(peak_ops,
    AI x peak_bw)``), and achieved utilization when ``seconds`` is given.
    ``flops`` holds the counted integer operations (``ops_unit``)."""
    family, peaks = _peaks(platform)
    ai = flops / bytes_accessed if bytes_accessed else 0.0
    attainable = min(peaks["flops_per_s"], ai * peaks["hbm_bytes_per_s"]) \
        if ai else peaks["flops_per_s"]
    block = {
        "platform": family,
        "peaks": peaks,
        "flops": flops,
        "bytes": bytes_accessed,
        "arithmetic_intensity": round(ai, 4),
        "attainable_flops_per_s": attainable,
        "hbm_peak_bytes": int(hbm_peak_bytes),
        "ops_unit": OPS_UNIT,
    }
    if seconds and seconds > 0:
        achieved = flops / seconds
        block["seconds"] = round(seconds, 6)
        block["achieved_flops_per_s"] = achieved
        # significant digits, not decimal places: a CPU run sits many
        # orders below the card's roofline and must not round to zero
        block["utilization"] = float(f"{achieved / attainable:.4g}") \
            if attainable else 0.0
    return block


def roofline(seconds: Optional[float] = None, names=None,
             platform: Optional[str] = None, basis: str = "total") -> dict:
    """Fold the recorded cost entries into one ``roofline`` block.

    ``basis="total"`` sums cost x calls over every signature (pair with
    the wall-clock of the whole measured region); ``basis="per_call"``
    takes one call's worth per function (pair with a per-round time, as
    the bench does). ``names`` filters which instrumented functions
    contribute (default: all with cost data).
    """
    with _lock:
        profs = [p for n, p in sorted(_profiles.items())
                 if (names is None or n in names) and p.costs]
    flops = bytes_acc = 0.0
    hbm_peak = 0
    phases = {}
    for prof in profs:
        totals = prof.totals()
        if basis == "per_call":
            last_sig = next(reversed(prof.costs))
            cost = prof.costs[last_sig]
            f = float(cost.get("flops") or 0.0)
            b = float(cost.get("bytes_accessed") or 0.0)
        else:
            f, b = totals["flops"], totals["bytes_accessed"]
        flops += f
        bytes_acc += b
        hbm_peak = max(hbm_peak, totals["hbm_peak_bytes"])
        phases[prof.name] = {
            "calls": prof.calls,
            "flops": f,
            "bytes": b,
            "arithmetic_intensity": round(f / b, 4) if b else 0.0,
            "hbm_peak_bytes": totals["hbm_peak_bytes"],
        }
    block = roofline_block(flops, bytes_acc, seconds=seconds,
                           platform=platform, hbm_peak_bytes=hbm_peak)
    block["basis"] = basis
    block["phases"] = phases
    return block


# -- the memory watermark -----------------------------------------------------

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


def hbm_peak_recorded(names=None) -> int:
    """Max recorded device-memory peak across the cost entries (0 when
    cost capture was off or no instrumented call ran on a card — the
    caller should say so, not guess)."""
    with _lock:
        profs = [p for n, p in _profiles.items()
                 if names is None or n in names]
    peak = 0
    for prof in profs:
        peak = max(peak, prof.totals()["hbm_peak_bytes"])
    return peak


def watermark_report(peak_bytes: Optional[int] = None, device=None,
                     names=None) -> dict:
    """The ``hbm`` advisory block: measured peak, the watermark it was
    planned against, and their ratio (< 1.0 means the round kept its
    memory promise)."""
    watermark = hbm_watermark(device)
    peak = int(peak_bytes if peak_bytes is not None
               else hbm_peak_recorded(names))
    block = {
        "hbm_peak_bytes": peak,
        "watermark_bytes": watermark,
        "within_watermark": peak <= watermark,
    }
    if watermark:
        block["hbm_watermark_ratio"] = round(peak / watermark, 4)
    if peak == 0:
        block["note"] = ("no peak recorded — enable_cost_analysis was off "
                         "or no instrumented call ran on a card")
    return block


def reset() -> None:
    """Clear the shape registry and cost entries (the ``xla.compile.*``
    counters and memory gauges live in the metrics registry, which
    ``obs.reset_all()`` clears alongside this)."""
    with _lock:
        _profiles.clear()
