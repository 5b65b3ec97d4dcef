"""`sdad` — the server daemon CLI.

Reference: server-cli (sdad --jfs|--mongo httpd, bind 127.0.0.1:8888).
Backends here: durable JSON files (--jfs DIR), single-file SQLite database
(--sqlite PATH), MongoDB (--mongo URI, reference parity, needs pymongo),
or in-memory (--memory). ``--device`` (``cuda``, or ``cpu`` for the host)
is the device of the Paillier premix (``--premix-paillier`` with
``SDA_PREMIX_DEVICE=1``).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="sdad", description="SDA server daemon")
    backend = parser.add_mutually_exclusive_group()
    backend.add_argument("--jfs", metavar="DIR", help="JSON-file store root")
    backend.add_argument("--sqlite", metavar="PATH", help="SQLite database file")
    backend.add_argument("--mongo", metavar="URI", help="MongoDB URI (needs pymongo)")
    parser.add_argument("--mongo-dbname", default="sda")
    backend.add_argument("--memory", action="store_true", help="in-memory store")
    parser.add_argument("--async", dest="async_http", action="store_true",
                        help="serve on the asyncio event-loop HTTP plane "
                             "(SdaAsyncHttpServer) instead of the "
                             "thread-per-connection plane: idle keep-alive "
                             "connections and parked long-polls "
                             "(GET /v1/clerking-jobs?wait=S) hold no "
                             "threads, so one worker sustains 10k+ open "
                             "connections; wire behavior is identical "
                             "(docs/scaling.md)")
    parser.add_argument("--premix-paillier", action="store_true",
                        help="homomorphically combine clerk columns at "
                             "snapshot time for PackedPaillier aggregations")
    parser.add_argument("--job-lease", type=float, metavar="SECONDS",
                        default=None,
                        help="lease polled clerking jobs for SECONDS: held "
                             "jobs are invisible to the clerk's other "
                             "workers and reissued after expiry (default: "
                             "reference visible-poll semantics)")
    parser.add_argument("--metrics", action="store_true",
                        help="serve Prometheus text exposition (counters + "
                             "latency histogram buckets) at GET /metrics "
                             "(off by default)")
    parser.add_argument("--statusz", action="store_true",
                        help="serve the JSON debug page at GET /statusz "
                             "(uptime, store backend, in-flight/peak "
                             "gauges, job-lease stats, devprof compile "
                             "totals; off by default)")
    parser.add_argument("--trace", action="store_true",
                        help="log one INFO line per finished request span "
                             "(trace id, route, status, X-Request-Id); "
                             "combine with SDA_LOG_FORMAT=json for "
                             "trace-correlated structured logs")
    parser.add_argument("--max-inflight", type=int, metavar="N", default=None,
                        help="admission control: shed requests with 503 + "
                             "Retry-After beyond N concurrently in flight "
                             "(default: unbounded)")
    parser.add_argument("--rate-limit", type=float, metavar="RPS", default=None,
                        help="admission control: per-agent token-bucket "
                             "rate; overflow sheds 429 + Retry-After "
                             "before any crypto or store work "
                             "(default: unlimited)")
    parser.add_argument("--rate-burst", type=float, metavar="N", default=8.0,
                        help="token-bucket burst capacity per agent")
    parser.add_argument("--tenant-rate", type=float, metavar="RPS",
                        default=None,
                        help="multi-tenant fairness: per-recipient budget "
                             "bucket keyed by the X-SDA-Tenant header — a "
                             "hot tenant sheds 429 against its OWN budget "
                             "before touching the shared in-flight cap "
                             "(default: no tenant budgets; docs/service.md)")
    parser.add_argument("--tenant-burst", type=float, metavar="N",
                        default=32.0,
                        help="per-tenant budget burst capacity "
                             "(--tenant-rate)")
    parser.add_argument("--node-id", metavar="NAME", default=None,
                        help="fleet worker identity (sda-fleet): rides "
                             "every response as X-SDA-Node, labels /metrics "
                             "samples and /statusz, and lands on server "
                             "spans so round timelines attribute hops to "
                             "workers")
    parser.add_argument("--fleet-peers", type=int, metavar="N", default=None,
                        help="fleet size this worker belongs to (recorded "
                             "as the fleet.peers gauge)")
    parser.add_argument("--drain-grace", type=float, metavar="SECONDS",
                        default=10.0,
                        help="graceful-drain budget on SIGTERM/SIGINT: stop "
                             "accepting, wait up to SECONDS for in-flight "
                             "requests, release held clerking-job leases "
                             "back to the shared store, then exit")
    parser.add_argument("--round-sweep", type=float, metavar="SECONDS",
                        default=None,
                        help="run the round lifecycle sweeper every "
                             "SECONDS in this worker: expires rounds past "
                             "their phase deadlines and diagnoses dead "
                             "clerks (degraded/failed). Store-arbitrated: "
                             "in a fleet every worker may sweep, exactly "
                             "one wins each transition (docs/robustness.md)")
    parser.add_argument("--round-collect-deadline", type=float,
                        metavar="SECONDS", default=None,
                        help="round lifecycle: an aggregation with no "
                             "snapshot after SECONDS expires (terminal "
                             "'expired' state; needs --round-sweep)")
    parser.add_argument("--round-clerk-deadline", type=float,
                        metavar="SECONDS", default=None,
                        help="round lifecycle: past SECONDS after job "
                             "fan-out, undone jobs with no active lease "
                             "mark their clerks dead — Shamir rounds "
                             "degrade to the surviving quorum, additive "
                             "rounds fail with a diagnosis (needs "
                             "--round-sweep)")
    parser.add_argument("--retain-revealed", type=float, metavar="SECONDS",
                        default=None,
                        help="retention: a revealed round older than "
                             "SECONDS transitions to terminal 'expired' "
                             "and is cascade-purged from every store "
                             "backend — aggregation, round doc, "
                             "participations + owner markers, clerking "
                             "jobs/results, snapshot mask chunks — so a "
                             "long-running service stays flat in store "
                             "size (needs --round-sweep; docs/service.md)")
    parser.add_argument("--retain-failed", type=float, metavar="SECONDS",
                        default=None,
                        help="retention: failed/expired rounds older than "
                             "SECONDS are cascade-purged (kept a while "
                             "for diagnosis; needs --round-sweep)")
    parser.add_argument("--schedule", metavar="SPECS.json", default=None,
                        help="run the recurring-round scheduler in this "
                             "worker against the spec file (a JSON list "
                             "of ScheduleSpec objects, or {'schedules': "
                             "[...]}): per tenant and per schedule, epoch "
                             "R+1's aggregation is minted while epoch R "
                             "clerks. Store-arbitrated: in a fleet every "
                             "worker may schedule, exactly one wins each "
                             "epoch mint (docs/service.md)")
    parser.add_argument("--schedule-tick", type=float, metavar="SECONDS",
                        default=1.0,
                        help="scheduler tick cadence (--schedule)")
    parser.add_argument("--heartbeat", type=float, metavar="SECONDS",
                        default=None,
                        help="fleet health: write this worker's heartbeat "
                             "row to the shared store every SECONDS "
                             "(needs --node-id; the failure detector and "
                             "straggler hedging read the table — "
                             "docs/robustness.md gray-failure matrix)")
    parser.add_argument("--suspect-after", type=float, metavar="SECONDS",
                        default=None,
                        help="fleet health: a peer whose heartbeat is "
                             "staler than SECONDS is declared SUSPECT "
                             "(single-winner CAS; hedging may shadow its "
                             "held jobs). Default: half of --dead-after")
    parser.add_argument("--dead-after", type=float, metavar="SECONDS",
                        default=None,
                        help="fleet health: a peer whose heartbeat is "
                             "staler than SECONDS is declared DEAD and "
                             "its held clerking-job leases are recalled "
                             "so any worker's next poll reissues them "
                             "immediately (needs --round-sweep to run "
                             "the detector)")
    parser.add_argument("--hedge", action="store_true",
                        help="straggler hedging: an empty job poll may "
                             "speculatively re-lease a job held by a "
                             "SUSPECT peer; result commit stays "
                             "single-winner, so duplicate partial sums "
                             "are impossible (needs --heartbeat config)")
    parser.add_argument("--store-breaker", action="store_true",
                        help="wrap the store backend in a circuit "
                             "breaker + retry budget: a browning-out "
                             "store trips OPEN and requests shed fast "
                             "with 503 + Retry-After instead of queueing "
                             "behind a slow dependency; probes half-open "
                             "it back (docs/robustness.md)")
    parser.add_argument("--breaker-threshold", type=int, metavar="N",
                        default=5,
                        help="consecutive store failures that trip the "
                             "breaker (--store-breaker)")
    parser.add_argument("--breaker-recovery", type=float, metavar="SECONDS",
                        default=1.0,
                        help="open-state hold before a half-open probe "
                             "(--store-breaker)")
    parser.add_argument("--breaker-budget", type=float, metavar="RPS",
                        default=2.0,
                        help="shared store-retry budget refill rate, "
                             "tokens/sec (--store-breaker)")
    parser.add_argument("--chaos-spec", action="append", default=None,
                        metavar="SPEC",
                        help="arm failpoints in THIS worker process, e.g. "
                             "'http.server.request=error,rate=0.05' or "
                             "'store.poll_clerking_job=brownout:0.02,"
                             "rate=0.7,for=5'. Repeatable — brownout + "
                             "kill + partition drills compose in one "
                             "invocation; arming one failpoint from two "
                             "specs is rejected with a clear error (see "
                             "sda_tpu_torch.chaos.configure_from_specs)")
    parser.add_argument("--chaos-seed", type=int, default=0,
                        help="failpoint schedule seed (--chaos-spec)")
    parser.add_argument("--flight-recorder", metavar="DIR", default=None,
                        help="spool finished spans, round-ledger entries "
                             "and periodic metric snapshots into bounded "
                             "JSONL segments under DIR (crash-safe; "
                             "sda-trace reads them post-mortem). "
                             "Equivalent to SDA_FLIGHT_RECORDER=DIR; "
                             "changes no protocol bytes")
    parser.add_argument("--device", default="cuda",
                        help="device of the Paillier premix (--premix-paillier "
                             "with SDA_PREMIX_DEVICE=1): cuda, or cpu for the "
                             "host")
    parser.add_argument("-v", "--verbose", action="count", default=0)
    sub = parser.add_subparsers(dest="command", required=True)
    httpd = sub.add_parser("httpd")
    httpd.add_argument("--bind", default="127.0.0.1:8888")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils import configure_logging

    configure_logging(args.verbose)
    from ..obs import recorder as flight_recorder

    if args.flight_recorder:
        # the flag is sugar for the env knob, so a fleet parent that
        # passes --flight-recorder still propagates it to spawned peers
        import os as _os

        _os.environ[flight_recorder.RECORDER_DIR_ENV] = args.flight_recorder
    flight_recorder.maybe_install_from_env(node_id=args.node_id)
    from ..http import server_class
    from ..server import (
        new_jsonfs_server,
        new_memory_server,
        new_mongo_server,
        new_sqlite_server,
    )

    if args.memory:
        service = new_memory_server()
    elif args.sqlite:
        service = new_sqlite_server(args.sqlite)
    elif args.mongo:
        service = new_mongo_server(args.mongo, args.mongo_dbname)
    else:
        service = new_jsonfs_server(args.jfs or "./sdad-store")

    if args.premix_paillier:
        service.server.premix_paillier = True
    from ..crypto import encryption

    encryption.PREMIX_DEVICE = args.device
    if args.job_lease is not None:
        service.server.clerking_lease_seconds = args.job_lease
    if args.store_breaker:
        # wrap BEFORE anything touches the stores so every code path —
        # HTTP handlers, sweeper, heartbeat writer — rides the breaker
        from ..server.breaker import CircuitBreaker, wrap_server_stores

        wrap_server_stores(service.server, CircuitBreaker(
            threshold=args.breaker_threshold,
            recovery_s=args.breaker_recovery,
            budget_rate=args.breaker_budget,
        ))
    suspect_after = args.suspect_after
    if suspect_after is None and args.dead_after is not None:
        suspect_after = args.dead_after / 2
    if args.hedge:
        if suspect_after is None:
            parser_error = "--hedge needs --suspect-after or --dead-after"
            print(f"error: {parser_error}", file=sys.stderr)
            return 2
        service.server.hedge_suspect_after_s = suspect_after
    sweeper = None
    if args.round_collect_deadline is not None \
            or args.round_clerk_deadline is not None:
        from ..server import lifecycle

        service.server.round_deadlines = lifecycle.RoundDeadlines(
            collecting_s=args.round_collect_deadline,
            clerking_s=args.round_clerk_deadline,
        )
    if args.retain_revealed is not None or args.retain_failed is not None:
        from ..service.retention import RetentionPolicy

        service.server.retention_policy = RetentionPolicy(
            revealed_ttl_s=args.retain_revealed,
            failed_ttl_s=args.retain_failed,
        )
    if args.round_sweep is not None:
        from ..server import lifecycle

        sweeper = lifecycle.RoundSweeper(
            service.server, interval_s=args.round_sweep,
            heartbeat_suspect_s=suspect_after,
            heartbeat_dead_s=args.dead_after).start()
    scheduler = None
    if args.schedule:
        from ..service.scheduler import RoundScheduler, load_specs

        try:
            specs = load_specs(args.schedule)
        except (OSError, ValueError, KeyError) as e:
            print(f"error: cannot load schedule specs from "
                  f"{args.schedule}: {e}", file=sys.stderr)
            return 2
        scheduler = RoundScheduler(
            service.server, specs, interval_s=args.schedule_tick).start()
    heartbeat = None
    if args.heartbeat is not None:
        if not args.node_id:
            print("error: --heartbeat needs --node-id (the heartbeat row "
                  "is keyed by worker identity)", file=sys.stderr)
            return 2
        from ..server.health import HeartbeatWriter

        heartbeat = HeartbeatWriter(
            service.server.clerking_job_store, args.node_id,
            interval_s=args.heartbeat).start()
    if args.chaos_spec:
        from .. import chaos

        chaos.set_identity(args.node_id)
        chaos.configure_from_specs(args.chaos_spec, seed=args.chaos_seed)

    server = server_class(args.async_http)(
        service, bind=args.bind,
        max_inflight=args.max_inflight,
        rate_limit=args.rate_limit,
        rate_burst=args.rate_burst,
        tenant_rate=args.tenant_rate,
        tenant_burst=args.tenant_burst,
        metrics_endpoint=args.metrics,
        statusz_endpoint=args.statusz,
        trace_log=args.trace,
        node_id=args.node_id,
        fleet_peers=args.fleet_peers,
    )
    if args.trace:
        # the span lines ride logging.INFO on their own child logger; make
        # exactly them visible even without -v (the access log stays muted)
        import logging

        from ..http.server import trace_log

        trace_log.setLevel(logging.INFO)
    print(f"sdad listening on {server.address}", flush=True)

    # graceful drain on SIGTERM/SIGINT (the fleet contract): stop
    # accepting, finish in-flight requests, hand held clerking-job leases
    # back to the shared store so a peer reissues them immediately, and
    # report the drain summary as the final stdout line — `sda-fleet` and
    # the loadgen fleet mode parse it and assert leaked == 0
    import json
    import signal
    import threading

    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    server.start_background()
    try:
        stop.wait()
    except KeyboardInterrupt:  # SIGINT delivered before the handler landed
        pass
    if scheduler is not None:
        # stop minting BEFORE the drain: a fresh epoch minted mid-drain
        # would enqueue work this worker can no longer serve (peers pick
        # the schedule up — the state is store-arbitrated)
        scheduler.stop()
    if sweeper is not None:
        # stop sweeping BEFORE the drain releases leases: a sweep racing
        # the lease handback could read a transiently unleased job as dead
        sweeper.stop()
    if heartbeat is not None:
        # stop BEATING now, but the terminal 'drained' row only lands
        # AFTER the drain below hands the held leases back: a worker
        # killed mid-drain must look stale-alive (diagnosable -> leases
        # recalled), never prematurely 'drained' (terminal, skipped by
        # the failure detector) while it still holds work
        heartbeat.stop(drained=False)
    summary = server.drain(grace_s=args.drain_grace)
    if heartbeat is not None:
        # leases are handed back: NOW peers never need to diagnose us
        heartbeat.stop(drained=True)
    print(f"sdad drained {json.dumps(summary)}", flush=True)
    return 0 if summary["leaked"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
