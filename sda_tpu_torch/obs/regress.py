"""Bench regression gate: compare the newest BENCH record to its history.

The committed ``BENCH_r*.json`` trajectory was inspected by hand: a 2x
slowdown in round N+1 would be noticed only if someone happened to diff
the JSON. This module is the consumer the devprof plane feeds — a
noise-aware per-metric gate:

- **Records** are either the driver wrapper shape committed at the repo
  root (``{"n": .., "rc": .., "parsed": {bench line}}``) or a raw bench
  line (``{"value": .., "metric": ..}``). Honest error records — the
  bench's "no rung finished" line, a wrapper whose ``parsed`` is null —
  are SKIPPED, never flagged: a failed measurement is not a regression.
- **Comparability**: a record only gates against trailing records with
  the same ``platform``, ``metric``, ``framework`` (an untagged record is
  the JAX package's, ``"jax"``; the port's bench tags ``"torch"``) and
  (when tagged) ``codec`` string (a CPU fallback must never be judged
  against chip numbers; a torch record never gates against the JAX
  package's history, nor a JAX record against the port's; a binary-wire
  loadgen number must never gate against JSON-wire history).
- **Noise awareness**: the threshold is
  ``max(floor, Z x relstd(window), Z x chain_rel)`` where ``relstd`` is
  the trailing window's empirical run-to-run variance and ``chain_rel``
  is the per-record resolution of the chained-dispatch marginal method
  (``utils/benchtime.py`` diagnostics: the un-cancelled
  ``fixed_overhead_s`` spread over the differenced chain). The floor
  (default 25%) absorbs the CPU rung's scheduler noise, which the
  committed r02-r05 spread shows runs to ~19%.

A copy of ``sda_tpu/obs/regress.py`` except ``_comparable``
(``tests/test_torch_drift.py`` pins every other function).

CLI: ``python -m sda_tpu_torch.obs.regress BENCH_r*.json`` or
``python -m sda_tpu_torch.cli.bench --check``. Exit codes: 0 ok, 1
confirmed regression (suppressed by ``--advisory``), 2 malformed records.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
from typing import List, Optional, Tuple

__all__ = ["check", "load_records", "main", "repo_root"]

#: (record key, direction, gates_exit) — compile_seconds is reported but
#: advisory-only: it varies with cache state by design, as is
#: scaling_efficiency: the fleet drill's speedup-over-ideal ratio
#: (docs/scaling.md) is bounded by the host's core count, which varies
#: across CI machines. The headline ``value`` defaults to higher-is-
#: better (throughput), but a record may carry its own ``"direction":
#: "lower"`` tag — e.g. the FL suite's rounds-to-target-accuracy record
#: (docs/federated.md), where MORE rounds is the regression.
METRICS = (
    ("value", "higher", True),
    ("round_seconds_marginal", "lower", True),
    ("compile_seconds", "lower", False),
    ("scaling_efficiency", "higher", False),
    # model-scale device records (loadgen/devscale.py): utilization is
    # chip-peak-relative (advisory — CPU peaks are nominal placeholders)
    # and the watermark ratio is a promise-keeping advisory (peak HBM
    # over the budget the tile width was derived from; > 1.0 means the
    # round broke its HBM contract, creeping UP means headroom eroding)
    ("roofline_utilization", "higher", False),
    ("hbm_watermark_ratio", "lower", False),
)

DEFAULT_WINDOW = 4
DEFAULT_FLOOR = 0.25
DEFAULT_ZSCORE = 3.0


class MalformedRecord(ValueError):
    """A file that is not a bench record at all (vs an honest error
    record, which is well-formed and skipped)."""


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _parse_file(path: str) -> dict:
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        raise MalformedRecord(f"{path}: not JSON ({e})")
    if not isinstance(obj, dict):
        raise MalformedRecord(f"{path}: expected a JSON object")
    return obj


def load_records(paths) -> List[dict]:
    """Parse bench files into ``{"path", "seq", "record"|None,
    "skip_reason"}`` entries, ordered oldest -> newest (the driver
    wrapper's ``n`` when present, else input order)."""
    entries = []
    for order, path in enumerate(paths):
        obj = _parse_file(path)
        if "parsed" in obj or "rc" in obj:  # driver wrapper shape
            seq = obj.get("n", order)
            rec = obj.get("parsed")
            if not isinstance(rec, dict):
                entries.append({"path": path, "seq": seq, "order": order,
                                "record": None,
                                "skip_reason": "no parsed measurement "
                                               "(honest error record)"})
                continue
        elif "value" in obj:  # raw bench line
            seq, rec = order, obj
        else:
            raise MalformedRecord(
                f"{path}: neither a driver wrapper (parsed/rc) nor a "
                f"bench line (value)")
        reason = None
        if "error" in rec:
            reason = f"error record: {str(rec['error'])[:80]}"
        elif not isinstance(rec.get("value"), (int, float)) \
                or rec.get("value", 0) <= 0:
            reason = "no positive measurement value"
        entries.append({"path": path, "seq": seq, "order": order,
                        "record": None if reason else rec,
                        "skip_reason": reason})
    # input position breaks seq ties: a fresh raw bench line appended
    # after N committed wrappers must sort NEWEST, not lose a path-name
    # tiebreak and silently become "history"
    entries.sort(key=lambda e: (e["seq"], e["order"]))
    return entries


def _comparable(newest: dict, rec: dict) -> bool:
    # codec and fleet size are part of a record's identity: a binary-wire
    # loadgen number must never gate against JSON-wire history, and a
    # 4-worker fleet RPS must never gate against single-server history
    # (the codec / worker count IS the variable under test); records
    # without the tags compare as before. The model-scale device records
    # additionally key on (dim, p_shards, d_shards, pallas): a dim-1e8
    # sharded+streamed number must never gate against single-chip
    # history, a different mesh topology, or the other kernel lane.
    # The framework is part of it too: the port's torch records and the
    # JAX package's (untagged: "jax") records share metric strings and
    # platforms, and must never gate against each other.
    return (rec.get("platform") == newest.get("platform")
            and rec.get("metric") == newest.get("metric")
            and rec.get("framework", "jax") == newest.get("framework", "jax")
            and rec.get("codec") == newest.get("codec")
            and rec.get("fleet_nodes") == newest.get("fleet_nodes")
            and rec.get("dim") == newest.get("dim")
            and rec.get("p_shards") == newest.get("p_shards")
            and rec.get("d_shards") == newest.get("d_shards")
            and rec.get("pallas") == newest.get("pallas"))


def chain_rel_uncertainty(rec: dict) -> float:
    """Per-record relative resolution of the marginal-timing method: the
    un-cancelled fixed overhead spread over the differenced chain,
    relative to the marginal itself (0 when diagnostics are absent)."""
    chain = rec.get("chain")
    per = rec.get("round_seconds_marginal")
    if not (isinstance(chain, dict) and isinstance(per, (int, float)) and per):
        return 0.0
    try:
        span = (chain["r2"] - chain["r1"]) * per
        overhead = float(rec.get("fixed_overhead_s", 0.0))
        return overhead / span if span > 0 else 0.0
    except (KeyError, TypeError, ZeroDivisionError):
        return 0.0


def _window_stats(values: List[float]) -> Tuple[float, float]:
    mean = sum(values) / len(values)
    if len(values) < 2 or mean == 0:
        return mean, 0.0
    var = sum((v - mean) ** 2 for v in values) / (len(values) - 1)
    return mean, math.sqrt(var) / abs(mean)


def check(entries: List[dict], window: int = DEFAULT_WINDOW,
          floor: float = DEFAULT_FLOOR,
          zscore: float = DEFAULT_ZSCORE) -> dict:
    """Compare the newest real record against its trailing window.

    Returns ``{"checked", "newest", "skipped", "rows", "regressions"}``;
    ``rows`` is the per-metric verdict table. ``checked`` is False when
    fewer than 1 newest + 2 comparable trailing records exist (nothing to
    gate — that is a pass, not an error).
    """
    skipped = [{"path": e["path"], "reason": e["skip_reason"]}
               for e in entries if e["record"] is None]
    real = [e for e in entries if e["record"] is not None]
    base = {"skipped": skipped, "rows": [], "regressions": [],
            "checked": False}
    if not real:
        base["note"] = "no measurable records"
        return base
    newest = real[-1]
    trailing = [e for e in real[:-1] if _comparable(newest["record"],
                                                    e["record"])]
    trailing = trailing[-window:]
    base["newest"] = newest["path"]
    base["window"] = [e["path"] for e in trailing]
    if len(trailing) < 2:
        base["note"] = (f"insufficient comparable history "
                        f"({len(trailing)} record(s)) — nothing to gate")
        return base
    base["checked"] = True
    chain_rel = max([chain_rel_uncertainty(e["record"])
                     for e in trailing + [newest]] or [0.0])
    for key, direction, gates in METRICS:
        if key == "value":
            # record-carried direction: comparability already pins the
            # metric string, so every record in the window shares the tag
            tagged = newest["record"].get("direction")
            if tagged in ("higher", "lower"):
                direction = tagged
        new_val = newest["record"].get(key)
        hist = [e["record"][key] for e in trailing
                if isinstance(e["record"].get(key), (int, float))]
        if not isinstance(new_val, (int, float)) or len(hist) < 2:
            continue
        mean, rel_std = _window_stats(hist)
        threshold = max(floor, zscore * rel_std, zscore * chain_rel)
        if mean == 0:
            continue
        if direction == "higher":
            delta = new_val / mean - 1.0  # negative == slower
            regressed = delta < -threshold
        else:
            delta = new_val / mean - 1.0  # positive == slower
            regressed = delta > threshold
        verdict = "REGRESSION" if regressed else (
            "pass (exceeds window noise, within threshold)"
            if abs(delta) > rel_std else "pass")
        row = {
            "metric": key,
            "direction": direction,
            "newest": new_val,
            "window_mean": round(mean, 6),
            "window_rel_std": round(rel_std, 4),
            "delta": round(delta, 4),
            "threshold": round(threshold, 4),
            "gates": gates,
            "verdict": verdict,
        }
        base["rows"].append(row)
        if regressed and gates:
            base["regressions"].append(key)
    return base


def format_table(result: dict) -> str:
    lines = []
    for entry in result.get("skipped", []):
        lines.append(f"skip  {entry['path']}: {entry['reason']}")
    if not result.get("checked"):
        lines.append(f"nothing to gate: {result.get('note', '')}")
        return "\n".join(lines)
    lines.append(f"newest: {result['newest']}  "
                 f"window: {len(result['window'])} record(s)")
    header = (f"{'metric':<26} {'newest':>14} {'window-mean':>14} "
              f"{'delta':>8} {'threshold':>10}  verdict")
    lines.append(header)
    lines.append("-" * len(header))
    for row in result["rows"]:
        sign = "-" if row["direction"] == "higher" else "+"
        lines.append(
            f"{row['metric']:<26} {row['newest']:>14.6g} "
            f"{row['window_mean']:>14.6g} {row['delta']:>+7.1%} "
            f"{sign}{row['threshold']:>8.1%}  {row['verdict']}"
            + ("" if row["gates"] else " [advisory]"))
    return "\n".join(lines)


def default_paths() -> List[str]:
    return sorted(glob.glob(os.path.join(repo_root(), "BENCH_r*.json")))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m sda_tpu_torch.obs.regress",
        description="bench regression gate over committed BENCH records")
    parser.add_argument("paths", nargs="*",
                        help="bench record files, oldest to newest "
                             "(default: the repo's BENCH_r*.json)")
    parser.add_argument("--window", type=int, default=DEFAULT_WINDOW,
                        help="trailing records to compare against")
    parser.add_argument("--floor", type=float, default=DEFAULT_FLOOR,
                        help="minimum relative regression threshold")
    parser.add_argument("--zscore", type=float, default=DEFAULT_ZSCORE,
                        help="noise multiplier over the window's rel-std "
                             "and the marginal-chain uncertainty")
    parser.add_argument("--advisory", action="store_true",
                        help="report regressions but exit 0 (CPU rungs in "
                             "CI are not gated); malformed records still "
                             "exit 2")
    parser.add_argument("--json", action="store_true",
                        help="print the verdict as one JSON line instead "
                             "of the table")
    return parser


def run(args) -> int:
    """Execute the gate for an already-parsed namespace (shared by this
    module's CLI and ``sda-bench`` — one implementation, two spellings)."""
    paths = args.paths or default_paths()
    if not paths:
        print("no bench records found", file=sys.stderr)
        return 2
    try:
        entries = load_records(paths)
        result = check(entries, window=args.window, floor=args.floor,
                       zscore=args.zscore)
    except MalformedRecord as e:
        print(f"malformed bench record: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(result))
    else:
        print(format_table(result))
    if result["regressions"] and not args.advisory:
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
