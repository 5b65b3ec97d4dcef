"""`sda-fleet` — run N stateless `sdad` workers over one shared store.

The operator face of the fleet plane (``sda_tpu_torch/server/fleet.py``): spawn
N worker processes against a shared sqlite file / jsonfs directory /
MongoDB URI, print one JSON line describing the fleet (node ids,
addresses, consistent-hash sample spread), then babysit the processes
until SIGINT/SIGTERM, at which point every worker drains gracefully
(finish in-flight requests, hand held clerking-job leases back to the
shared store) and the per-worker drain summaries are printed. Exit is
nonzero if any worker leaked a request or died early.

    sda-fleet -n 4 --sqlite /var/sda/fleet.db --job-lease 30 --metrics
    sda-fleet -n 2 --jfs ./fleet-store --base-port 8800

Any worker can serve any request; point clients at any address (or all of
them — docs/scaling.md describes the advisory consistent-hash routing).
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sda-fleet",
        description="N stateless sdad workers over one shared store")
    parser.add_argument("-n", "--workers", type=int, default=2, metavar="N",
                        help="worker process count (default 2)")
    backend = parser.add_mutually_exclusive_group(required=True)
    backend.add_argument("--sqlite", metavar="PATH",
                        help="shared SQLite database file (WAL mode, "
                             "cross-process)")
    backend.add_argument("--jfs", metavar="DIR",
                        help="shared JSON-file store root")
    backend.add_argument("--mongo", metavar="URI",
                        help="shared MongoDB URI (needs pymongo)")
    parser.add_argument("--mongo-dbname", default="sda")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind host for every worker")
    parser.add_argument("--base-port", type=int, default=0, metavar="P",
                        help="worker i binds P+i; 0 (default) binds "
                             "ephemeral ports, reported in the fleet line")
    parser.add_argument("--node-prefix", default="w",
                        help="node ids are <prefix>0..<prefix>N-1")
    parser.add_argument("--job-lease", type=float, metavar="SECONDS",
                        default=30.0,
                        help="clerking-job lease per worker (fleet default "
                             "30: leases are what let a peer reissue a "
                             "dead worker's jobs; 0 disables)")
    parser.add_argument("--drain-grace", type=float, metavar="SECONDS",
                        default=10.0,
                        help="per-worker in-flight grace on shutdown")
    parser.add_argument("--heartbeat", type=float, metavar="SECONDS",
                        default=1.0,
                        help="fleet health: every worker writes its "
                             "heartbeat row to the shared store this "
                             "often (0 disables the health plane)")
    parser.add_argument("--dead-after", type=float, metavar="SECONDS",
                        default=None,
                        help="declare a worker DEAD (and recall its held "
                             "clerking-job leases) after SECONDS without "
                             "a heartbeat; default 4x the heartbeat "
                             "interval")
    parser.add_argument("--suspect-after", type=float, metavar="SECONDS",
                        default=None,
                        help="declare a worker SUSPECT after SECONDS "
                             "without a heartbeat; default half of "
                             "--dead-after")
    parser.add_argument("--round-sweep", type=float, metavar="SECONDS",
                        default=1.0,
                        help="per-worker sweeper cadence (runs the round "
                             "lifecycle supervisor AND the fleet failure "
                             "detector; 0 disables)")
    parser.add_argument("--hedge", action="store_true",
                        help="straggler hedging: peers speculatively "
                             "re-execute jobs held by SUSPECT workers "
                             "(single-winner commit keeps it bit-exact)")
    parser.add_argument("--store-breaker", action="store_true",
                        help="per-worker store circuit breaker: shed "
                             "503 + Retry-After fast while the shared "
                             "backend browns out")
    parser.add_argument("--metrics", action="store_true",
                        help="serve /metrics on every worker (samples carry "
                             "the worker's node_id label)")
    parser.add_argument("--statusz", action="store_true",
                        help="serve /statusz on every worker")
    parser.add_argument("--max-inflight", type=int, metavar="N", default=None)
    parser.add_argument("--rate-limit", type=float, metavar="RPS", default=None)
    parser.add_argument("--rate-burst", type=float, metavar="N", default=None)
    parser.add_argument("-v", "--verbose", action="count", default=0)
    return parser


def worker_extra_args(args) -> list:
    """The per-worker `sdad` flags implied by the fleet flags (shared with
    nothing — `sda-fleet` is the only caller — but kept separate so the
    mapping is testable without spawning processes)."""
    extra = ["--drain-grace", str(args.drain_grace)]
    if args.job_lease:
        extra += ["--job-lease", str(args.job_lease)]
    if args.heartbeat:
        dead_after = (args.dead_after if args.dead_after is not None
                      else 4 * args.heartbeat)
        extra += ["--heartbeat", str(args.heartbeat),
                  "--dead-after", str(dead_after)]
        if args.suspect_after is not None:
            extra += ["--suspect-after", str(args.suspect_after)]
        if args.hedge:
            extra.append("--hedge")
    if args.round_sweep:
        extra += ["--round-sweep", str(args.round_sweep)]
    if args.store_breaker:
        extra.append("--store-breaker")
    if args.metrics:
        extra.append("--metrics")
    if args.statusz:
        extra.append("--statusz")
    if args.max_inflight is not None:
        extra += ["--max-inflight", str(args.max_inflight)]
    if args.rate_limit is not None:
        extra += ["--rate-limit", str(args.rate_limit)]
    if args.rate_burst is not None:
        extra += ["--rate-burst", str(args.rate_burst)]
    if args.mongo:
        extra += ["--mongo-dbname", args.mongo_dbname]
    extra += ["-v"] * args.verbose
    return extra


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils import configure_logging

    configure_logging(args.verbose)
    from ..server.fleet import Fleet

    if args.sqlite:
        backend = ["--sqlite", args.sqlite]
    elif args.jfs:
        backend = ["--jfs", args.jfs]
    else:
        backend = ["--mongo", args.mongo]

    fleet = Fleet(
        args.workers, backend,
        extra_args=worker_extra_args(args),
        node_prefix=args.node_prefix,
        host=args.host, base_port=args.base_port,
    )
    try:
        fleet.start()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    ring = fleet.ring()
    # sample spread: how 1000 hypothetical aggregation ids would route —
    # the operator's balance eyeball before real traffic arrives
    spread = ring.spread([f"sample-{i}" for i in range(1000)])
    print(json.dumps({
        "fleet": fleet.to_obj()["workers"],
        "store": backend[0].lstrip("-"),
        "ring_sample_spread": spread,
    }), flush=True)

    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    # a worker dying early must end the babysit too, not hang it
    def _watch():
        while not stop.is_set():
            for worker in fleet.workers:
                if worker.process is not None \
                        and worker.process.poll() is not None:
                    stop.set()
                    return
            stop.wait(0.5)

    watcher = threading.Thread(target=_watch, daemon=True)
    watcher.start()
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    # final health snapshot BEFORE the drain: which workers the fleet
    # believed alive/suspect/dead at shutdown (scraped off any live
    # worker — the table lives in the SHARED store)
    health_table = None
    if args.statusz and args.heartbeat:
        import requests

        for address in fleet.addresses.values():
            try:
                health_table = requests.get(
                    address + "/statusz", timeout=5.0
                ).json().get("fleet_health")
                break
            except Exception:
                continue
    summaries = fleet.stop()
    out = {"drained": summaries}
    if health_table is not None:
        out["fleet_health"] = health_table
    print(json.dumps(out), flush=True)
    leaked = sum(int(s.get("leaked", 0) or 0) for s in summaries)
    killed = any(s.get("killed") for s in summaries)
    died = any((w.returncode or 0) != 0 for w in fleet.workers)
    return 0 if not (leaked or killed or died) else 1


if __name__ == "__main__":
    sys.exit(main())
