"""Run one cell of the benchmark once and print its result line.

    python3 aggbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the inputs from ``--seed`` (``inputs.py``), builds the
program's entry that the cell's configuration names, and runs one warm
round, which builds and loads every kernel and allocates every shape.
The window then runs back-to-back rounds in a closed loop (one recipient;
the next round starts when the previous aggregate is on the host), each
with its own round seed, for ``--seconds``, and the run's last round ends
it. Once the window has closed, every round's aggregate is compared with
the plain reference (``reference.py``); where that would hold more than
``KEEP_ROUNDS`` aggregates or ``KEEP_BYTES`` of host memory, a sample of
the rounds drawn from the seed is. The cap on rounds keeps the harness
from changing the program's host memory use: every aggregate held is one
the program's next round cannot reuse, and it writes into fresh pages.

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` runs the
window under ``torch.profiler`` (started one round early, so that it has
warmed up) and prints the cell's per-layer metrics, each read by
``metrics/<name>.py`` from the trace of the window's rounds.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error repeat the checks. Exits 2 without a
result where the cell's chips are not there or the program is missing,
and 3 where a forbidden module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "aggbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level modules that no run may load: JAX, and the JAX package the
#: program was ported from (compared by whole top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "sda_tpu")
#: the host range around each measured round in a traced run
ROUND_RANGE = "aggbench.round"
#: aggregates, and their host bytes, held for the comparison; past either,
#: a sample of the rounds drawn from the seed is held (each round equally
#: likely)
KEEP_ROUNDS = 32
KEEP_BYTES = 2 << 30
#: hash domain of that sample's seed
_SAMPLE_TAG = 0x5A3B


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _p90(values) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def _read_trace(prof) -> dict:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda:0", t_start: float = T_START) -> dict:
    """One run of ``cell`` (from ``cell.load_cell``) on ``device``: set-up,
    the window, the comparison; returns the result line as a dict."""
    import torch

    from aggbench import inputs
    from aggbench.cell import build_entry, metric_reader, tiles, tiling
    from aggbench.reference import Reference, mismatched_elements
    from aggbench.traceparse import TraceView

    config, traffic = cell["config"], cell["traffic"]
    chips = cell["workload"]["chips"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    P, d = config["participants"], config["dimension"]
    pc, dc = tiling(config, traffic)
    entry, modulus = build_entry(config, traffic, dev, chips)
    if (entry.participants_chunk, entry.dim_chunk) != (pc, dc):
        raise RuntimeError(
            f"the entry tiles by ({entry.participants_chunk}, "
            f"{entry.dim_chunk}), the benchmark's map by ({pc}, {dc})")
    pool = inputs.make_pool(min(pc, P), min(dc, d), config["value_bits"],
                            seed, dev)
    sample = random.Random(inputs.derive(seed, _SAMPLE_TAG))
    outputs = []  # (round index, aggregate) of the rounds to compare
    rounds = 0

    def one_round():
        nonlocal rounds
        r = rounds
        out = entry.aggregate_blocks(inputs.provider(pool, r, P, d, pc, dc),
                                     P, d, seed=inputs.round_seed(seed, r))
        rounds += 1
        keep = min(KEEP_ROUNDS, max(1, KEEP_BYTES // max(1, out.nbytes)))
        if len(outputs) < keep:
            outputs.append((r, out))
        else:
            j = sample.randrange(rounds)
            if j < keep:
                outputs[j] = (r, out)

    one_round()  # every tile shape: kernels built, loaded, allocated
    prof = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        one_round()  # the profiler's own warm-up
    gc.collect()
    if on_card:
        torch.cuda.synchronize(dev)
        peak_setup = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    setup_s = time.perf_counter() - t_start

    times = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a = time.perf_counter()
        with torch.profiler.record_function(ROUND_RANGE):
            one_round()
        times.append(time.perf_counter() - a)
    window_s = time.perf_counter() - t0

    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else dev.type),
                   "count": chips}
    if on_card:
        peak_window = torch.cuda.max_memory_allocated(dev)
        device_info["memory_peak_bytes"] = max(peak_setup, peak_window)
    result = {}
    if trace:
        prof.stop()
        view = TraceView(_read_trace(prof), ROUND_RANGE, {
            "config": config, "traffic": traffic,
            "tiles": tiles(config, traffic)})
        del prof
        device_info["busy_s"] = view.busy_us() * 1e-6
        device_info["window_s"] = view.window_us * 1e-6
        metrics = {}
        for m in cell["per_layer"]:
            value = metric_reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": view.top_device_ops(),
                               "idle_gaps": view.idle_gaps()}
        del view
    else:
        known = {
            "shared_elements_per_s": len(times) * P * d / window_s,
            "round_s_p90": _p90(times),
            "setup_s": setup_s,
        }
        if on_card:
            known["round_device_peak_gib"] = (peak_window - base) / 2**30
        # a metric split by cells (``<quantity>.<cells>``) reads its quantity
        metrics = {m["name"]: {"value": known[m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]
                   if m["name"].split(".")[0] in known}

    # the program's state goes before the reference runs on the device
    del entry
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    per_round = mismatched_elements(
        Reference(pool, P, d, pc, dc, modulus), outputs)
    bad = sum(per_round.values())
    return {"correct": bad == 0, "attempted": rounds,
            "failed": sum(1 for n in per_round.values() if n),
            "metrics": metrics, "device": device_info, **result,
            "round_s": times, "compared_rounds": len(per_round),
            "checks": {"mismatched_elements": {"value": bad, "limit": 0}}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a non-negative whole number")
    if args.seconds <= 0:
        ap.error("--seconds is a positive number")

    from aggbench.cell import load_cell

    try:
        cell = load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"aggbench: {e}", file=sys.stderr)
        return 2
    if importlib.util.find_spec("sda_tpu_torch") is None:
        print("aggbench: the program (sda_tpu_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"aggbench: {args.workload} needs {chips} CUDA device(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"aggbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"{name} {check['value']} limit {check['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
