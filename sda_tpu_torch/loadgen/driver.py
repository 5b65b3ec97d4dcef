"""The load drill: N simulated participants hammer the real HTTP stack.

Where ``chaos/drill.py`` proves the system survives *faults*, this driver
proves it survives *traffic* — and measures the shape of that survival.
It stands up a real ``SdaHttpServer`` on a store backend, runs the full
secure-aggregation round (committee election, participations, clerking,
reveal), and drives the participant phase with one of two classic
workload models:

- **open-loop** (default): participant arrivals are a seeded Poisson
  process at ``target_rps`` — arrivals don't wait for completions, so a
  saturated server sees a growing backlog instead of the flattering
  self-throttling a closed loop gives (the open- vs closed-loop pitfall
  from the Tail-at-Scale literature). Scheduling lag is recorded in the
  ``load.lag`` histogram so coordinated omission is visible.
- **closed-loop**: exactly ``concurrency`` workers issue
  request-after-request — the saturation probe.

Every HTTP request lands in the server's per-route
``http.latency.<route>`` histograms; the driver's own phases ride
``load.phase.register`` / ``load.phase.participate``. The returned
capacity report (BENCH-style JSON via ``sda-sim --load``) carries
sustained RPS, p50/p95/p99 per route, shed/retry/error rates, and the
end-to-end verdict: the revealed sum must still be bit-exact, and every
*admitted* participation must be present — load shedding may slow the
round, never corrupt it.

Tracing: the whole run is one ``round`` trace (``sda_tpu_torch.obs``); each
simulated participant is a ``load.participant`` span parented to it, so
the report can name the slowest participants and the exact span chain
(retry attempts, server handling, store ops) that made them slow — the
``trace_exemplars`` table. Export the full timeline with
``sda-sim --load --trace-out trace.json``.

Overload is a profile, not an accident: arm the server's admission layer
(``rate_limit`` / ``max_inflight``) and the swarm gets 429+``Retry-After``
sheds that the retrying transport converges through — zero 5xx, zero lost
participations. ``chaos_rate`` arms the fault registry on top for the
combined load+chaos drill.
"""

from __future__ import annotations

import concurrent.futures
import random
import tempfile
import threading
import time
from dataclasses import dataclass, replace
from typing import List, Optional

from .. import chaos, obs
from ..client.journal import ParticipationJournal
from ..utils import metrics


@dataclass
class LoadProfile:
    """Everything one load run needs; defaults match the acceptance drill
    (200 participants, open-loop, memory store, admission off)."""

    participants: int = 200
    dim: int = 8
    arrivals: str = "open"              # "open" (Poisson) | "closed"
    target_rps: float = 100.0            # open-loop participant arrival rate
    concurrency: int = 32                # worker pool (closed-loop: exact)
    seed: int = 0
    store: str = "memory"                # memory | sqlite | jsonfs
    store_path: Optional[str] = None
    # admission knobs, armed AFTER round setup (None = off)
    max_inflight: Optional[int] = None
    rate_limit: Optional[float] = None   # per-agent tokens/sec
    rate_burst: float = 4.0
    # per-tenant fairness budget (http/admission.py): the swarm stamps
    # the aggregation's recipient as X-SDA-Tenant, so a hot tenant sheds
    # against its own budget before touching the shared caps
    tenant_rate: Optional[float] = None
    tenant_burst: float = 32.0
    # combined load+chaos drill: fraction of requests to 500 (0 = off)
    chaos_rate: float = 0.0
    # device churn under load (chaos.churn_schedule): this seeded fraction
    # of participants crashes mid-participation — sealed bundle journaled,
    # upload possibly already durable with the ack lost — and rejoins as a
    # fresh client resuming from the journal; the report's ``churn`` block
    # carries the resume/replay counters (docs/load.md)
    churn: float = 0.0
    lease_seconds: float = 2.0
    timeout_s: float = 300.0
    # wire codec for every client in the swarm: "auto" (upgrade on the
    # server's advert), "json" (legacy wire pinned), "bin" (forced binary)
    codec: str = "auto"
    # fleet mode: 0 = the classic in-process server; N >= 1 spawns N real
    # `sdad` OS processes over ONE shared store (sqlite/jsonfs only —
    # memory cannot be shared across processes) and drives all of them,
    # routing participants over the consistent-hash ring and the control
    # plane (snapshot/status/clerk polls) to the aggregation's affinity
    # node (docs/scaling.md)
    fleet: int = 0
    # fleet health plane (server/health.py): when set, every worker
    # heartbeats this often and runs the failure detector (dead after 4
    # intervals) — the report's fleet_health table shows the live verdict
    heartbeat_s: Optional[float] = None
    # serve on the asyncio event-loop plane (http/aserver.py) instead of
    # thread-per-connection; fleet mode passes `sdad --async`. The wire
    # contract is identical — ci.sh pins fixed-seed A/B bit-exactness
    async_http: bool = False
    device: Optional[str] = None  # the clients' device: CUDA unless "cpu"


def _percentiles_ms(summary: dict) -> dict:
    """One histogram summary, seconds -> milliseconds, rounded for JSON."""
    return {
        "count": int(summary["count"]),
        "p50_ms": round(summary["p50"] * 1e3, 3),
        "p95_ms": round(summary["p95"] * 1e3, 3),
        "p99_ms": round(summary["p99"] * 1e3, 3),
        "max_ms": round(summary["max"] * 1e3, 3),
        "mean_ms": round(summary["sum"] / summary["count"] * 1e3, 3)
        if summary["count"] else 0.0,
    }


def latency_report_ms(prefix: str = "http.latency.") -> dict:
    """Per-route latency table (ms) from the live histogram registry —
    shared by the load and chaos drill reports."""
    return {
        name[len(prefix):]: _percentiles_ms(summary)
        for name, summary in metrics.histogram_report(prefix).items()
    }


def run_load(profile: LoadProfile) -> dict:
    """Run one full aggregation round under generated load; return the
    capacity report. Requires libsodium (real participant crypto)."""
    import numpy as np

    from ..client import RecipientOutput, SdaClient, output_digest
    from ..crypto import MemoryKeystore, sodium
    from ..http import SdaHttpClient, SdaHttpServer
    from ..protocol import (
        Aggregation,
        AggregationId,
        FullMasking,
        SodiumEncryption,
    )
    from ..server import new_jsonfs_server, new_memory_server, new_sqlite_server

    if not sodium.available():
        raise RuntimeError("the load drill needs libsodium (real crypto round)")
    if profile.arrivals not in ("open", "closed"):
        raise ValueError(f"unknown arrivals model {profile.arrivals!r}")

    # the golden 8-clerk packed-Shamir committee (ONE definition shared
    # with the chaos and tree drills): crypto real, parameters small —
    # the object under test is the transport/store plane, not the field
    # arithmetic
    from ..chaos.drill import golden_packed_scheme

    scheme = golden_packed_scheme()

    obs.reset_all()
    chaos.reset()

    fleet = None
    ring = None

    def _scrape_statusz(address: str) -> dict:
        import requests

        return requests.get(address + "/statusz", timeout=10.0).json()

    def _fleet_scrapes() -> dict:
        """One ``/statusz`` document per worker — the fleet's served
        requests, lease/snapshot counters, and fired failpoints live in
        the worker processes, not in this one."""
        return {
            node: _scrape_statusz(addr)
            for node, addr in fleet.addresses.items()
        }

    def _fleet_request_totals(scrapes: dict) -> dict:
        """Per-node served-request totals from each worker's /statusz
        (the fleet analog of the in-process ``status_counts`` sum)."""
        return {
            node: sum(doc["requests"].values())
            for node, doc in scrapes.items()
        }

    if profile.fleet:
        from ..server.fleet import Fleet

        if profile.store not in ("sqlite", "jsonfs"):
            raise ValueError(
                "fleet mode needs a cross-process store "
                "(store='sqlite' or 'jsonfs'), not "
                f"{profile.store!r}")
        if not profile.store_path:
            raise ValueError("fleet mode needs store_path (the shared "
                             "database file / directory)")
        backend = (["--sqlite", profile.store_path]
                   if profile.store == "sqlite"
                   else ["--jfs", profile.store_path])
        # workers are configured up front (flags, not runtime retuning):
        # lease arbitration + /statusz for per-node tallies always on;
        # admission and chaos only when the profile asks. The in-process
        # path arms admission/chaos AFTER setup — fleet setup traffic is
        # tiny, so whole-run arming keeps the workers stateless.
        extra = ["--job-lease", str(profile.lease_seconds), "--statusz"]
        if profile.async_http:
            extra += ["--async"]
        if profile.heartbeat_s is not None:
            # the gray-failure plane: heartbeats + the failure detector
            # riding each worker's sweeper (suspect at 2 intervals, dead
            # at 4 — the conventional heartbeat multiples)
            extra += ["--heartbeat", str(profile.heartbeat_s),
                      "--dead-after", str(4 * profile.heartbeat_s),
                      "--round-sweep", str(profile.heartbeat_s)]
        if profile.rate_limit is not None:
            extra += ["--rate-limit", str(profile.rate_limit),
                      "--rate-burst", str(profile.rate_burst)]
        if profile.tenant_rate is not None:
            extra += ["--tenant-rate", str(profile.tenant_rate),
                      "--tenant-burst", str(profile.tenant_burst)]
        if profile.max_inflight is not None:
            extra += ["--max-inflight", str(profile.max_inflight)]
        if profile.chaos_rate > 0.0:
            extra += ["--chaos-spec",
                      f"http.server.request=error,rate={profile.chaos_rate}",
                      "--chaos-seed", str(profile.seed)]
        fleet = Fleet(profile.fleet, backend, extra_args=extra,
                      node_prefix="fleet-w")
        fleet.start()
        ring = fleet.ring()
        http_server = None
    else:
        if profile.store == "memory":
            service_impl = new_memory_server()
        elif profile.store == "sqlite":
            service_impl = new_sqlite_server(profile.store_path or ":memory:")
        elif profile.store == "jsonfs":
            if profile.store_path is None:
                raise ValueError("store='jsonfs' needs store_path")
            service_impl = new_jsonfs_server(profile.store_path)
        else:
            raise ValueError(f"unknown store {profile.store!r}")
        service_impl.server.clerking_lease_seconds = profile.lease_seconds

        from ..http import server_class

        http_server = server_class(profile.async_http)(
            service_impl, bind="127.0.0.1:0")
        http_server.start_background()
    # churned devices journal to a real directory — resume reads it as a
    # fresh process would (exactly-once participation, docs/robustness.md)
    journal_dir = tempfile.TemporaryDirectory(prefix="sda-load-journal-")
    failures: List[str] = []
    failures_lock = threading.Lock()
    try:
        with obs.span("round", attributes={"profile": "load",
                                           "participants": profile.participants,
                                           "arrivals": profile.arrivals,
                                           "seed": profile.seed}) as round_span:
            # worker threads have no thread-local context: pass the round
            # context explicitly so every participant span joins the trace
            round_ctx = round_span.context

            def _new_proxy(address: str) -> SdaHttpClient:
                return SdaHttpClient(
                    address,
                    token="load-drill-token",
                    # generous retry budget: under the overload profile
                    # EVERY participant is expected to be shed at least
                    # once and must converge through Retry-After hints
                    # within the deadline
                    max_retries=16, backoff_base=0.01, backoff_cap=0.25,
                    deadline=profile.timeout_s,
                    codec=profile.codec,
                )

            if fleet is not None:
                # one transport per worker; the ring maps any stable key
                # (agent id, aggregation id) to its affinity node — purely
                # advisory, every worker serves every route correctly
                node_proxies = {node: _new_proxy(addr)
                                for node, addr in fleet.addresses.items()}

                def _proxy_for(key) -> SdaHttpClient:
                    return node_proxies[ring.node_for(str(key))]
            else:
                single_proxy = _new_proxy(http_server.address)

                def _proxy_for(key) -> SdaHttpClient:
                    return single_proxy

            def new_client():
                keystore = MemoryKeystore()
                agent = SdaClient.new_agent(keystore)
                # agents ride their own affinity node: participants spread
                # over the whole fleet, each clerk's job polling
                # concentrates where its leases live (docs/scaling.md)
                return SdaClient(agent, keystore, _proxy_for(agent.id),
                                 device=profile.device)

            # -- setup (unthrottled: admission armed after) ---------------
            recipient = new_client()
            recipient.upload_agent()
            recipient_key = recipient.new_encryption_key()
            recipient.upload_encryption_key(recipient_key)

            candidates = {recipient.agent.id: recipient}
            for _ in range(scheme.share_count):
                clerk = new_client()
                clerk.upload_agent()
                clerk.upload_encryption_key(clerk.new_encryption_key())
                candidates[clerk.agent.id] = clerk

            agg = Aggregation(
                id=AggregationId.random(),
                title="load-drill",
                vector_dimension=profile.dim,
                modulus=scheme.prime_modulus,
                recipient=recipient.agent.id,
                recipient_key=recipient_key,
                masking_scheme=FullMasking(scheme.prime_modulus),
                committee_sharing_scheme=scheme,
                recipient_encryption_scheme=SodiumEncryption(),
                committee_encryption_scheme=SodiumEncryption(),
            )
            if fleet is not None:
                # the round's control plane (snapshot POST, status polls,
                # reveal) rides the aggregation's affinity node from here
                recipient.service = _proxy_for(agg.id)
            # the whole swarm belongs to ONE tenant — the aggregation's
            # recipient; stamping it arms the per-tenant budget bucket
            # when tenant_rate is set (and is harmless otherwise)
            if fleet is not None:
                for proxy in node_proxies.values():
                    proxy.tenant = str(recipient.agent.id)
            else:
                single_proxy.tenant = str(recipient.agent.id)
            recipient.upload_aggregation(agg)
            recipient.begin_aggregation(agg.id)
            committee = recipient.service.get_committee(recipient.agent, agg.id)
            clerks = [candidates[cid] for cid, _ in committee.clerks_and_keys]

            # -- arm admission + chaos, then open the floodgates ----------
            # (fleet workers were armed at spawn via CLI flags — admission
            # and failpoints live in THEIR processes, not this one)
            if fleet is None:
                http_server.configure_admission(
                    max_inflight=profile.max_inflight,
                    rate_limit=profile.rate_limit,
                    rate_burst=profile.rate_burst,
                    tenant_rate=profile.tenant_rate,
                    tenant_burst=profile.tenant_burst,
                )
                if profile.chaos_rate > 0.0:
                    chaos.configure("http.server.request", error=True,
                                    rate=profile.chaos_rate, seed=profile.seed)

            rng = np.random.default_rng(profile.seed)
            inputs = rng.integers(0, scheme.prime_modulus,
                                  size=(profile.participants, profile.dim),
                                  dtype=np.int64)

            churn_plan = (chaos.churn_schedule(profile.participants,
                                               profile.churn,
                                               seed=profile.seed)
                          if profile.churn else None)
            journal = (ParticipationJournal(journal_dir.name)
                       if profile.churn else None)
            churn_stats = {"churned": 0, "resumed": 0}
            churn_lock = threading.Lock()

            def churned_participate(participant, index: int) -> None:
                """The sporadic device under load: seal + journal, crash
                at the seeded point (pre-upload, or mid-upload with the
                ack lost), then rejoin as a fresh client resuming the
                journaled bytes — exactly-once ingestion makes the replay
                idempotent, so the round's sum is unchanged."""
                from ..client import SdaClient
                from ..crypto import MemoryKeystore

                plan = churn_plan[index]
                participation = participant.new_participation(
                    [int(x) for x in inputs[index]], agg.id)
                journal.record(participation)
                if plan["phase"] == "mid-upload":
                    participant.upload_participation(participation)
                # the rejoin: resume needs only the agent identity and
                # the journal — the sealed bytes never get recomputed
                rejoined = SdaClient(participant.agent, MemoryKeystore(),
                                     _proxy_for(participant.agent.id),
                                     device=profile.device)
                resumed = rejoined.resume(journal)
                with churn_lock:
                    churn_stats["churned"] += 1
                    churn_stats["resumed"] += resumed

            def participant_task(index: int, scheduled: float, t_open: float):
                start = time.perf_counter()
                if profile.arrivals == "open":
                    metrics.observe("load.lag",
                                    max(0.0, (start - t_open) - scheduled))
                with obs.span("load.participant", parent=round_ctx,
                              attributes={"index": index}) as pspan:
                    try:
                        t0 = time.perf_counter()
                        participant = new_client()
                        participant.upload_agent()
                        metrics.observe("load.phase.register",
                                        time.perf_counter() - t0)
                        t1 = time.perf_counter()
                        if churn_plan and churn_plan[index]["departs"]:
                            churned_participate(participant, index)
                        else:
                            participant.participate(
                                [int(x) for x in inputs[index]], agg.id
                            )
                        metrics.observe("load.phase.participate",
                                        time.perf_counter() - t1)
                        return True
                    except Exception as e:
                        # tallied, not fatal: the report decides. Mark the
                        # span by hand — the swallowed exception never
                        # escapes the span context, and failed participants
                        # are exactly the exemplars the trace report must
                        # flag
                        pspan.status = "error"
                        pspan.set_attribute(
                            "error", f"{type(e).__name__}: {e}")
                        with failures_lock:
                            failures.append(f"participant {index}: "
                                            f"{type(e).__name__}: {e}")
                        return False

            arrival_rng = random.Random(profile.seed)
            # ONE scrape round per measurement boundary: the per-status
            # merge and the per-node totals read the same documents
            if fleet is not None:
                scrapes = _fleet_scrapes()
                per_node_setup = _fleet_request_totals(scrapes)
                setup_requests = sum(per_node_setup.values())
            else:
                setup_requests = sum(http_server.status_counts.values())
                per_node_setup = None
            t_load0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(
                max_workers=max(1, profile.concurrency)
            ) as pool:
                futures = []
                if profile.arrivals == "open":
                    # seeded Poisson arrivals: submit at the scheduled
                    # instant whether or not earlier work finished (open
                    # loop); the bounded pool then queues — the backlog
                    # shows up in load.lag, not in a silently stretched
                    # schedule
                    t_arrival = 0.0
                    for i in range(profile.participants):
                        t_arrival += arrival_rng.expovariate(profile.target_rps)
                        delay = t_arrival - (time.perf_counter() - t_load0)
                        if delay > 0:
                            time.sleep(delay)
                        futures.append(
                            pool.submit(participant_task, i, t_arrival, t_load0)
                        )
                else:
                    for i in range(profile.participants):
                        futures.append(
                            pool.submit(participant_task, i, 0.0, t_load0))
                completed = sum(bool(f.result()) for f in futures)
            load_elapsed = time.perf_counter() - t_load0
            # the headline RPS covers ONLY the participant window: snapshot
            # before the close phase adds clerk polling traffic
            per_node_load = None
            if fleet is not None:
                scrapes = _fleet_scrapes()
                # each worker served exactly ONE /statusz inside the
                # window — the setup-boundary scrape (a scrape's own
                # request is only counted after its document is built,
                # so the end scrape isn't in its own doc). Subtract it:
                # the tallies must be about real load traffic
                per_node_load = {
                    node: max(0, total - per_node_setup.get(node, 0) - 1)
                    for node, total in _fleet_request_totals(scrapes).items()
                }
                load_requests = sum(per_node_load.values())
            else:
                load_requests = (sum(http_server.status_counts.values())
                                 - setup_requests)

            # -- close the round: snapshot, clerking, reveal --------------
            recipient.end_aggregation(agg.id)
            deadline = time.monotonic() + profile.timeout_s
            ready = False
            status = None
            while time.monotonic() < deadline:
                for clerk in clerks:
                    clerk.run_chores(-1)
                status = recipient.service.get_aggregation_status(
                    recipient.agent, agg.id
                )
                if (
                    status is not None
                    and status.snapshots
                    and status.snapshots[0].number_of_clerking_results
                    >= scheme.share_count
                ):
                    ready = True
                    break
                time.sleep(0.05)

            exact = False
            expected_digest = None
            admitted_participations = None
            if status is not None:
                admitted_participations = status.number_of_participations
            # zero lost participations among admitted requests: every
            # participant whose upload was ACKed must be in the round, and
            # with all of them in, the revealed sum must be bit-exact (a
            # failed participant MAY still have landed server-side — lost
            # final ack — so exactness is only decidable at zero failures)
            if ready and completed == profile.participants:
                output = recipient.reveal_aggregation(agg.id)
                expected = inputs.sum(axis=0) % scheme.prime_modulus
                exact = bool((output.positive().values == expected).all())
                # the oracle's digest, computed the same canonical way the
                # reveal span stamps output.sha256: a forensics pass over
                # the spools alone can then assert the recorded reveal was
                # bit-exact (ci.sh forensics drill)
                expected_digest = output_digest(
                    RecipientOutput(scheme.prime_modulus, expected))
    finally:
        failpoint_report = chaos.report()
        chaos.reset()
        total_elapsed = time.perf_counter() - t_load0 \
            if "t_load0" in locals() else 0.0
        if fleet is not None:
            # last scrape BEFORE the drain: the workers' served-request,
            # lease, snapshot, and failpoint state dies with them
            try:
                final_scrapes = _fleet_scrapes()
            except Exception:
                final_scrapes = {}
            status_counts = {}
            for doc in final_scrapes.values():
                for code, count in doc["requests"].items():
                    code = int(code)
                    status_counts[code] = status_counts.get(code, 0) + count
            worker_failpoints = {
                node: doc.get("failpoints") or {}
                for node, doc in final_scrapes.items()
                if doc.get("failpoints")
            }
            if worker_failpoints:
                failpoint_report = worker_failpoints
            drain_summaries = fleet.stop()
        else:
            status_counts = http_server.status_counts
            http_server.shutdown()
        journal_dir.cleanup()

    counters = metrics.counter_report()
    codec_counters = metrics.counter_report("http.codec.") or None
    if fleet is not None:
        # the codec counters are stamped server-side, i.e. in the worker
        # processes: merge their final scrapes so the negotiated-wire
        # field below names what the fleet actually spoke
        from ..server.fleet import merge_statusz_block

        codec_counters = merge_statusz_block(
            final_scrapes.values(), "codec_counters") or None
    # exactly-once ingestion tallies are stamped server-side: in-process
    # runs read the live counters, fleet runs merge the workers' /statusz
    # participation blocks (the counters live in THEIR processes)
    if fleet is not None:
        participation_counters = merge_statusz_block(
            final_scrapes.values(), "participation")
    else:
        participation_counters = metrics.counter_report(
            "server.participation.") or {}
    lag_summary = metrics.histogram_report("load.lag").get("load.lag")
    clerk_job_summary = metrics.histogram_report("clerk.job.").get(
        "clerk.job.seconds")
    # enqueue->lease latency (server.job.pickup): stamped in the server
    # process — live metrics in-process, per-node statusz blocks in fleet
    # mode (the long-poll plane's headline; docs/load.md)
    if fleet is not None:
        pickup_ms = {
            node: (doc.get("lease") or {}).get("pickup_ms")
            for node, doc in final_scrapes.items()
            if (doc.get("lease") or {}).get("pickup_ms")
        } or None
    else:
        pickup_summary = metrics.histogram_report("server.job.pickup").get(
            "server.job.pickup")
        pickup_ms = (_percentiles_ms(pickup_summary)
                     if pickup_summary else None)
    requests_total = sum(status_counts.values())
    shed = sum(v for k, v in status_counts.items() if k == 429)
    errors_5xx = sum(v for k, v in status_counts.items() if k >= 500)
    # round lifecycle verdicts (server/lifecycle.py): a healthy load run
    # must never degrade or fail a round — ci.sh asserts both stay 0.
    # In-process runs read the transition counters; fleet runs read ONE
    # worker's /statusz rounds table (the store is shared, every worker
    # sees the same rounds — summing scrapes would double-count)
    if fleet is not None:
        _any_scrape = next(iter(final_scrapes.values()), {})
        _rounds_by_state = (_any_scrape.get("rounds") or {}).get(
            "by_state") or {}
        rounds_degraded = _rounds_by_state.get("degraded", 0)
        rounds_failed = (_rounds_by_state.get("failed", 0)
                         + _rounds_by_state.get("expired", 0))
    else:
        rounds_degraded = counters.get("server.round.state.degraded", 0)
        rounds_failed = (counters.get("server.round.state.failed", 0)
                         + counters.get("server.round.state.expired", 0))
    report = {
        "mode": (f"loadgen {profile.arrivals}-loop "
                 f"({profile.store} store"
                 + (f", fleet x{profile.fleet}" if profile.fleet else "")
                 + (", overload profile" if profile.rate_limit is not None
                    or profile.max_inflight is not None else "")
                 + (f", chaos rate {profile.chaos_rate}"
                    if profile.chaos_rate else "")
                 + ")"),
        "participants": profile.participants,
        "dim": profile.dim,
        "clerks": scheme.share_count,
        # which serving transport handled the run (docs/scaling.md)
        "http_plane": "async" if profile.async_http else "threaded",
        # the wire the swarm actually spoke (an "auto" run that upgraded
        # records "bin"): the regression gate keys comparability on this,
        # so it must name the negotiated outcome, not the requested mode
        "codec": ("bin" if (codec_counters or {}).get("http.codec.bin.in")
                  or (codec_counters or {}).get("http.codec.bin.out")
                  else "json"),
        "codec_mode": profile.codec,
        "codec_counters": codec_counters,
        "arrivals": profile.arrivals,
        "target_rps": profile.target_rps if profile.arrivals == "open" else None,
        "concurrency": profile.concurrency,
        "seed": profile.seed,
        "admission": {
            "max_inflight": profile.max_inflight,
            "rate_limit": profile.rate_limit,
            "rate_burst": profile.rate_burst,
            "tenant_rate": profile.tenant_rate,
            "tenant_burst": (profile.tenant_burst
                             if profile.tenant_rate is not None else None),
        },
        "completed": completed,
        "client_failures": len(failures),
        "failure_samples": failures[:5] or None,
        "admitted_participations": admitted_participations,
        "ready": ready,
        "exact": exact,
        # join keys for post-mortem forensics: sda-trace explain takes the
        # aggregation id, and the oracle digest must match the reveal
        # span's spooled output.sha256 attribute
        "aggregation": str(agg.id),
        "output_sha256": expected_digest,
        "load_seconds": round(load_elapsed, 4),
        "round_seconds": round(total_elapsed, 4),
        "sustained_rps": round(load_requests / load_elapsed, 1)
        if load_elapsed else 0.0,
        "load_requests": load_requests,
        "requests": requests_total,
        "shed_429": shed,
        "errors_5xx": errors_5xx,
        "rounds_degraded": rounds_degraded,
        "rounds_failed": rounds_failed,
        "status_counts": {str(k): v for k, v in sorted(status_counts.items())},
        "throttled": metrics.counter_report("http.throttled.") or None,
        "retries": metrics.counter_report("http.retry.") or None,
        "inflight_peak": metrics.gauge_report("http.inflight.peak").get(
            "http.inflight.peak"
        ),
        "latency_ms": latency_report_ms(),
        "phases_ms": {
            name[len("load.phase."):]: _percentiles_ms(summary)
            for name, summary in
            metrics.histogram_report("load.phase.").items()
        },
        # clerk-job wall time (decrypt pipeline + combine + re-encrypt +
        # result upload): the host-hot-path headline the batched clerk
        # pipeline moves
        "clerk_job_ms": (_percentiles_ms(clerk_job_summary)
                         if clerk_job_summary else None),
        # enqueue->lease latency: the polling-vs-long-poll BENCH headline
        "job_pickup_ms": pickup_ms,
        "lag_ms": _percentiles_ms(lag_summary) if lag_summary else None,
        # device-churn block (LoadProfile.churn): how many participants
        # crashed + rejoined, and the server's exactly-once verdict on
        # their replays — created vs replayed vs rejected equivocations
        "churn": ({
            "rate": profile.churn,
            "participants_churned": churn_stats["churned"],
            "participants_resumed": churn_stats["resumed"],
            "participations_replayed": participation_counters.get(
                "server.participation.replayed", 0),
            "equivocations": participation_counters.get(
                "server.participation.equivocation", 0),
        } if profile.churn else None),
        # the three slowest participants with the span chain that made them
        # slow (retry attempts, server handling, store ops) — tail
        # ATTRIBUTION, where the latency histograms only show tail SIZE
        "trace_exemplars": obs.slowest_spans("load.participant", n=3) or None,
        "failpoints": failpoint_report or None,
        "counters": {
            k: v for k, v in counters.items()
            if k.startswith(("chaos.", "server.job.", "server.snapshot.",
                             "server.participation."))
        } or None,
    }
    if fleet is not None:
        report["fleet_nodes"] = profile.fleet
        report["fleet"] = {
            # per-worker view, scraped from each /statusz just before the
            # drain: served requests (whole run + load window), job-lease
            # and snapshot-contention counters, admission peaks
            "nodes": {
                node: {
                    "address": fleet.addresses.get(node),
                    "requests": sum(
                        (final_scrapes.get(node, {}).get("requests") or {})
                        .values()),
                    "load_requests": (per_node_load or {}).get(node),
                    "load_rps": round(
                        (per_node_load or {}).get(node, 0) / load_elapsed, 1)
                    if load_elapsed else 0.0,
                    "inflight_peak": final_scrapes.get(node, {})
                    .get("inflight_peak"),
                    "jobs": (final_scrapes.get(node, {}).get("lease") or {})
                    .get("counters"),
                    "snapshot": final_scrapes.get(node, {}).get("snapshot"),
                }
                for node in fleet.node_ids
            },
            "drain": drain_summaries,
            "leaked": sum(int(s.get("leaked", 0) or 0)
                          for s in drain_summaries),
            "released_leases": sum(int(s.get("released_leases", 0) or 0)
                                   for s in drain_summaries),
            # the fleet's own health verdict at the end of the run (any
            # scrape shows the whole shared-store table): a healthy drill
            # must end with every worker alive
            "health": next(
                (doc.get("fleet_health") for doc in final_scrapes.values()
                 if doc.get("fleet_health")), None),
        }
    return report


def run_fleet_scaling(profile: LoadProfile, nodes: int,
                      baseline_nodes: int = 1) -> dict:
    """The scaling drill: the SAME fixed-seed load twice — once against
    ``baseline_nodes`` worker process(es), once against ``nodes`` — each
    over a FRESH copy of the shared store, reported as one BENCH-style
    record the regression gate understands (``sda-bench --check``:
    ``fleet_nodes`` joins the comparability key, ``scaling_efficiency``
    rides as an advisory metric).

    ``scaling_efficiency`` is measured speedup over ideal speedup:
    ``(rps_N / rps_baseline) / (N / baseline)`` — 1.0 is perfectly linear.
    The record carries ``host_cores`` because the ceiling is physical:
    N Python worker processes cannot scale past the cores that exist
    (docs/scaling.md discusses reading the number honestly).
    """
    import os
    import tempfile

    if profile.store not in ("sqlite", "jsonfs"):
        raise ValueError("the scaling drill needs a cross-process store "
                         "(store='sqlite' or 'jsonfs')")
    if nodes < 1 or baseline_nodes < 1 or nodes < baseline_nodes:
        raise ValueError("need nodes >= baseline_nodes >= 1")

    reports = {}
    for n in dict.fromkeys((baseline_nodes, nodes)):
        with tempfile.TemporaryDirectory() as tmp:
            reports[n] = run_load(replace(
                profile, fleet=n, store_path=os.path.join(tmp, "store")))
    base, top = reports[baseline_nodes], reports[nodes]
    speedup = (top["sustained_rps"] / base["sustained_rps"]
               if base["sustained_rps"] else 0.0)
    ideal = nodes / baseline_nodes
    record = {
        "metric": (f"fleet sustained RPS ({profile.arrivals}-loop, "
                   f"{profile.participants} participants, dim "
                   f"{profile.dim}, {profile.store} store)"),
        "value": top["sustained_rps"],
        "unit": "requests/sec",
        "platform": "cpu",  # the serving plane is a host-tier workload
        "host_cores": os.cpu_count(),
        "http_plane": top["http_plane"],
        "codec": top["codec"],
        "seed": profile.seed,
        "chaos_rate": profile.chaos_rate,
        "fleet_nodes": nodes,
        "baseline_nodes": baseline_nodes,
        "baseline_rps": base["sustained_rps"],
        "speedup": round(speedup, 3),
        "ideal_speedup": round(ideal, 3),
        "scaling_efficiency": round(speedup / ideal, 3) if ideal else 0.0,
        "per_node_load_rps": {
            node: stats["load_rps"]
            for node, stats in top["fleet"]["nodes"].items()
        },
        # the verdict is conjunctive: BOTH rungs must close the round
        # bit-exactly with zero leaked requests and zero lost admitted
        # participations — scaling that corrupts is not scaling
        "exact": bool(base["exact"] and top["exact"]),
        "ready": bool(base["ready"] and top["ready"]),
        "client_failures": base["client_failures"] + top["client_failures"],
        "leaked": base["fleet"]["leaked"] + top["fleet"]["leaked"],
        # forensics join keys of the TOP rung (the fleet round the drill
        # is named for): sda-trace explain takes the aggregation id, and
        # the oracle digest is asserted against the spooled reveal span
        "aggregation": top.get("aggregation"),
        "output_sha256": top.get("output_sha256"),
        "admitted_participations": top.get("admitted_participations"),
        "rungs": {
            str(n): {
                key: rep.get(key)
                for key in ("sustained_rps", "load_seconds", "round_seconds",
                            "load_requests", "requests", "completed",
                            "shed_429", "errors_5xx", "exact", "ready",
                            "aggregation")
            }
            for n, rep in reports.items()
        },
    }
    return record
