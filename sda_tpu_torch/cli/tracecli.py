"""`sda-trace` — round forensics and SLO evaluation over flight-recorder
spools.

Reads the JSONL segment directory a fleet left behind (every process
spools when ``SDA_FLIGHT_RECORDER=DIR`` is set — see
docs/observability.md) and answers the operator questions *after* every
process is dead:

- ``sda-trace segments`` — what is in the spool (segments, processes,
  record/torn-line counts, known aggregation ids);
- ``sda-trace explain AGG_ID`` — the causal story of one round
  (participations, retries, sheds, lease reissues, injected faults,
  clerk durations, reveal digest), joined across every worker's
  segments on trace id + aggregation id, clocks normalized;
- ``sda-trace timeline [AGG_ID]`` — merged Chrome/Perfetto trace JSON,
  one pid lane per recording process;
- ``sda-trace slo`` — per-tenant availability/latency SLOs with
  multi-window burn-rate alerts over the spooled round ledger.

The spool directory comes from ``--spool DIR`` or the same
``SDA_FLIGHT_RECORDER`` variable the recorder uses, so the drill that
wrote the spool and the forensics pass that reads it share one knob.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..obs import forensics, recorder, slo as slomod


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sda-trace",
        description="round forensics over flight-recorder spools")
    parser.add_argument(
        "--spool", metavar="DIR",
        default=os.environ.get(recorder.RECORDER_DIR_ENV, ""),
        help="spool directory (default: $%s)" % recorder.RECORDER_DIR_ENV)
    parser.add_argument("--json", action="store_true",
                        help="emit machine-readable JSON instead of text")
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("segments",
                   help="list spool segments, processes, aggregations")

    p_explain = sub.add_parser(
        "explain", help="reconstruct one round's causal story")
    p_explain.add_argument(
        "aggregation", metavar="AGG_ID",
        help="aggregation id (any unique prefix)")

    p_tl = sub.add_parser(
        "timeline",
        help="merged clock-normalized Chrome trace JSON (stdout)")
    p_tl.add_argument("aggregation", metavar="AGG_ID", nargs="?",
                      help="restrict to one round (default: whole spool)")

    p_slo = sub.add_parser(
        "slo", help="per-tenant SLO burn-rate evaluation")
    p_slo.add_argument("--availability", type=float, default=0.99,
                       metavar="FRAC",
                       help="availability target (default 0.99)")
    p_slo.add_argument("--latency", type=float, default=None,
                       metavar="SECONDS",
                       help="reveal-latency target; slow-but-revealed "
                            "rounds then spend error budget too")
    return parser


def _segments_report(spool_dir: str, spool) -> dict:
    segs = recorder.list_segments(spool_dir)
    return {
        "spool": spool_dir,
        "segments": len(segs),
        "bytes": sum(s["bytes"] for s in segs),
        "sealed": sum(1 for s in segs if s["sealed"]),
        "active": sum(1 for s in segs if not s["sealed"]),
        "processes": sorted(
            f"{node or 'proc'}[{pid}]" for node, pid in spool.procs),
        "spans": len(spool.spans),
        "rounds": len({r.get("aggregation") for r in spool.rounds}),
        "faults": len(spool.faults),
        "torn_lines": spool.torn,
        "aggregations": spool.aggregation_ids(),
    }


def _format_segments(rep: dict) -> str:
    lines = [
        f"spool {rep['spool']}: {rep['segments']} segment(s),"
        f" {rep['bytes']} bytes"
        f" ({rep['sealed']} sealed, {rep['active']} active)",
        f"  processes: {', '.join(rep['processes']) or 'none'}",
        f"  spans: {rep['spans']}   rounds: {rep['rounds']}"
        f"   faults: {rep['faults']}   torn lines: {rep['torn_lines']}",
    ]
    if rep["aggregations"]:
        lines.append("  aggregations (oldest first):")
        for agg in rep["aggregations"]:
            lines.append(f"    {agg}")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    spool_dir = (args.spool or "").strip()
    if not spool_dir:
        print("sda-trace: no spool directory (--spool DIR or "
              f"${recorder.RECORDER_DIR_ENV})", file=sys.stderr)
        return 2
    if not os.path.isdir(spool_dir):
        print(f"sda-trace: not a directory: {spool_dir}", file=sys.stderr)
        return 2
    spool = forensics.load_spool(spool_dir)

    if args.cmd == "segments":
        rep = _segments_report(spool_dir, spool)
        print(json.dumps(rep, indent=2) if args.json
              else _format_segments(rep))
        return 0

    if args.cmd == "explain":
        try:
            rep = forensics.explain(spool, args.aggregation)
        except KeyError as exc:
            print(f"sda-trace: {exc.args[0]}", file=sys.stderr)
            return 1
        print(json.dumps(rep, indent=2) if args.json
              else forensics.format_explain(rep))
        return 0

    if args.cmd == "timeline":
        try:
            trace = forensics.chrome_trace(spool, args.aggregation)
        except KeyError as exc:
            print(f"sda-trace: {exc.args[0]}", file=sys.stderr)
            return 1
        json.dump(trace, sys.stdout)
        print()
        return 0

    if args.cmd == "slo":
        policy = slomod.SloPolicy(
            availability_target=args.availability,
            latency_target_s=args.latency)
        rounds = slomod.rounds_from_spool(spool)
        rep = slomod.evaluate(rounds, policy)
        print(json.dumps(rep, indent=2) if args.json
              else slomod.format_slo(rep))
        # exit 1 when paging — scripts can gate on it
        return 1 if rep["alerts"] else 0

    return 2  # pragma: no cover - argparse enforces the subcommands


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
