"""The chaos drill: one full federated round over real HTTP under fault
injection — the executable proof behind ``sda-sim --chaos``.

Everything hostile is injected deterministically through the failpoint
registry (``sda_tpu_torch.chaos``):

- the HTTP dispatch 500s a seeded fraction of all requests
  (``http.server.request``);
- one response is dropped AFTER the server processed it
  (``http.server.response``) — the lost-ack case create-once retries must
  absorb;
- the store rejects the first participation create
  (``store.create_participation``);
- one clerk dies right after pulling its job (``clerk.abandon_job``);
  job leasing (``SdaServer.clerking_lease_seconds``) reissues the
  abandoned job to the clerk's next live poll.

The round must still reveal the bit-exact sum; the returned report carries
every ``chaos.*`` / ``http.retry.*`` / ``server.job.*`` counter so the
injection schedule is auditable — plus the round's trace timeline
(``sda_tpu_torch.obs``): the whole drill runs under one ``round`` span, every
failpoint trigger lands as a span event, and the report's critical path
shows which injected fault lengthened the round.
"""

from __future__ import annotations

import tempfile
import time
from typing import List

from .. import chaos, obs
from ..utils import metrics


def golden_packed_scheme():
    """THE drill committee: 8-clerk packed Shamir, threshold 7-of-8,
    p=433, omega=354/150 (tests/test_fault_tolerance's golden config).
    One definition — the chaos drill, the load drill and the tree drill
    all compare bit-exactness against rounds built from this exact
    scheme, so it must never drift between them."""
    from ..protocol import PackedShamirSharing

    return PackedShamirSharing(
        secret_count=3, share_count=8, privacy_threshold=4,
        prime_modulus=433, omega_secrets=354, omega_shares=150,
    )


def run_chaos_drill(
    participants: int = 6,
    dim: int = 4,
    *,
    rate: float = 0.15,
    seed: int = 0,
    lease_seconds: float = 0.75,
    timeout_s: float = 60.0,
    store: str = "memory",
    store_path=None,
    extra_spec=None,
    dead_clerks: int = 0,
    dead_participants: int = 0,
    sharing: str = "packed",
    clerking_deadline_s: float = 1.5,
    sweep_interval_s: float = 0.2,
    brownout_s: float = 0.0,
    churn_rate: float = 0.0,
    async_http: bool = False,
    device=None,
) -> dict:
    """Run one full aggregation round over HTTP under injected faults.

    ``dead_clerks`` / ``dead_participants`` arm the PERMANENT-death
    failpoints (``clerk.dies`` / ``participant.dies``, kind ``kill``):
    unlike every transient failpoint above, the first K agents to hit the
    point latch dead for the rest of the drill. With dead clerks the
    round lifecycle supervisor (``server/lifecycle.py``) is armed — a
    clerking deadline plus an in-process sweeper — and the drill asserts
    the protocol's terminal verdict instead of hanging: packed Shamir
    degrades to the surviving quorum and still reveals bit-exactly;
    additive sharing (``sharing="additive"``) reaches ``failed`` with a
    machine-readable reason, surfaced through the typed
    ``RoundFailed`` raised by ``SdaClient.await_result``.

    ``brownout_s`` arms the GRAY-failure recovery drill: mid-clerking,
    the store's job-poll and result-write paths brown out (seeded
    elevated error rate + latency, ``chaos brownout`` kind) for that many
    seconds, behind a store circuit breaker (``server/breaker.py``) that
    must trip OPEN — shedding 503 + Retry-After instead of queueing —
    half-open on probes, and CLOSE once the window heals. The round must
    still reveal bit-exactly, and the report's ``breaker`` block records
    ``time_to_recover_s`` (MTTR: first trip -> final recovery), the
    fixed-seed record ci.sh feeds the bench regression gate.

    ``churn_rate`` arms the DEVICE-churn drill (the participant-plane
    mirror of the gray-failure drills): a seeded fraction of participants
    departs mid-round per :func:`sda_tpu_torch.chaos.churn_schedule` — sealing
    and journaling their participation
    (``client/journal.ParticipationJournal``), then crashing either
    before the upload or in the lost-ack window right after the server
    stored it — and every departure later REJOINS as a fresh client
    process resuming from the journal. Exactly-once ingestion must make
    the round reveal bit-exactly with ZERO double-counted participations:
    pre-upload crashes land on resume as first arrivals, mid-upload
    crashes as byte-identical replays (``server.participation.replayed``).
    The drill also runs one deliberate equivocation probe (the first
    churned agent re-participates with fresh randomness): the server must
    reject it with ``ParticipationConflict``
    (``server.participation.equivocation``), and
    ``equivocations_undetected`` must stay 0.

    ``extra_spec`` is one spec string or a list of them (the repeatable
    ``--chaos-spec`` flag), merged with conflict rejection.

    ``async_http`` serves the drill on the asyncio event-loop plane
    (``http/aserver.py``) instead of thread-per-connection — the SAME
    fixed seed must produce a bit-exact reveal and identical
    ``server.participation.*`` counters on both planes (the ci.sh A/B
    step pins it; docs/scaling.md).

    Returns the report dict (``exact``, ``injected_ratio``, the round's
    lifecycle history, counters...). Requires libsodium (real sealed-box
    crypto, as in production rounds). ``device`` is the clients' device
    (CUDA unless ``"cpu"``).
    """
    import numpy as np

    from ..client import SdaClient
    from ..client.journal import ParticipationJournal
    from ..crypto import MemoryKeystore, sodium
    from ..http import SdaHttpClient, server_class
    from ..protocol import (
        AdditiveSharing,
        Aggregation,
        AggregationId,
        FullMasking,
        PackedShamirSharing,
        ParticipationConflict,
        RoundFailed,
        ServerError,
        SodiumEncryption,
    )
    from ..server import new_jsonfs_server, new_memory_server, new_sqlite_server
    from ..server import lifecycle

    if not sodium.available():
        raise RuntimeError("the chaos drill needs libsodium (real crypto round)")

    if sharing == "additive":
        # n-of-n additive sharing: computationally cheap, zero tolerance
        # for clerk loss — the scheme the failed-round path exists for
        scheme = AdditiveSharing(share_count=8, modulus=433)
        modulus = scheme.modulus
    elif sharing == "packed":
        # the golden committee (module-level golden_packed_scheme):
        # threshold 7 of 8, so the abandoned job is LIVENESS-critical
        # only via reissue when every other result is present — and
        # exactly one PERMANENTLY dead clerk still leaves a
        # reconstructing quorum
        scheme = golden_packed_scheme()
        modulus = scheme.prime_modulus
    else:
        raise ValueError(f"unknown sharing {sharing!r}")

    obs.reset_all()
    chaos.reset()

    if store == "memory":
        service_impl = new_memory_server()
    elif store == "sqlite":
        service_impl = new_sqlite_server(store_path or ":memory:")
    elif store == "jsonfs":
        if store_path is None:
            raise ValueError("store='jsonfs' needs store_path")
        service_impl = new_jsonfs_server(store_path)
    else:
        raise ValueError(f"unknown store {store!r}")
    service_impl.server.clerking_lease_seconds = lease_seconds

    breaker = None
    if brownout_s:
        # the brownout-survival plane under test: a shared breaker over
        # the whole backend, tuned to trip within a handful of failed
        # store ops and probe on a sub-second cadence (the drill's
        # brownout windows are short)
        from ..server.breaker import CircuitBreaker, wrap_server_stores

        breaker = wrap_server_stores(service_impl.server, CircuitBreaker(
            threshold=3, recovery_s=0.25, budget_rate=4.0))

    sweeper = None
    if dead_clerks:
        # the supervisor plane: a clerking deadline so dead-clerk
        # detection has a clock, and a sweeper to run the diagnosis
        service_impl.server.round_deadlines = lifecycle.RoundDeadlines(
            clerking_s=clerking_deadline_s)
        sweeper = lifecycle.RoundSweeper(
            service_impl.server, interval_s=sweep_interval_s).start()

    # the churned devices' journal: a real directory, because the whole
    # point is surviving process death — rejoined clients read it cold
    journal_dir = tempfile.TemporaryDirectory(prefix="sda-churn-journal-")

    http_server = server_class(async_http)(service_impl, bind="127.0.0.1:0")
    http_server.start_background()
    try:
        # ONE round span ties every role together: participant uploads,
        # server handling (joined via traceparent), clerk jobs (joined via
        # the enqueue-time job link), and the recipient reveal
        with obs.span("round", attributes={"profile": "chaos",
                                           "participants": participants,
                                           "seed": seed}):
            def new_proxy():
                return SdaHttpClient(
                    http_server.address,
                    token="chaos-drill-token",
                    # fast, deterministic-budget retries: the drill injects a
                    # bounded failure schedule, so a handful of quick attempts
                    # always clears it. A brownout window is a SUSTAINED
                    # outage, so that mode gets the budget to ride it out
                    # (Retry-After hints from the open breaker pace the
                    # attempts)
                    max_retries=24 if brownout_s else 8,
                    backoff_base=0.01,
                    backoff_cap=0.25 if brownout_s else 0.1,
                )

            def new_client():
                keystore = MemoryKeystore()
                agent = SdaClient.new_agent(keystore)
                return SdaClient(agent, keystore, new_proxy(),
                                 device=device)

            # -- clean setup (no injection yet: the drill targets the round)
            recipient = new_client()
            recipient.upload_agent()
            recipient_key = recipient.new_encryption_key()
            recipient.upload_encryption_key(recipient_key)

            # the recipient owns a key too, so it is a committee candidate —
            # track every key-holding client by id and let the election decide
            candidates = {recipient.agent.id: recipient}
            for _ in range(scheme.share_count):
                clerk = new_client()
                clerk.upload_agent()
                clerk.upload_encryption_key(clerk.new_encryption_key())
                candidates[clerk.agent.id] = clerk

            agg = Aggregation(
                id=AggregationId.random(),
                title="chaos-drill",
                vector_dimension=dim,
                modulus=modulus,
                recipient=recipient.agent.id,
                recipient_key=recipient_key,
                masking_scheme=FullMasking(modulus),
                committee_sharing_scheme=scheme,
                recipient_encryption_scheme=SodiumEncryption(),
                committee_encryption_scheme=SodiumEncryption(),
            )
            recipient.upload_aggregation(agg)
            recipient.begin_aggregation(agg.id)
            committee = recipient.service.get_committee(recipient.agent, agg.id)
            clerks: List[SdaClient] = [
                candidates[cid] for cid, _ in committee.clerks_and_keys
            ]

            # -- arm the failpoints, then run the whole round under fire --
            chaos.configure("http.server.request", error=True, rate=rate,
                            seed=seed)
            chaos.configure("http.server.response", drop=True, times=1,
                            seed=seed)
            chaos.configure("store.create_participation", error=True, times=1,
                            seed=seed)
            chaos.configure("clerk.abandon_job", drop=True, times=1, seed=seed)
            if dead_clerks:
                # permanent death: the first K clerks to poll latch dead —
                # their jobs are never worked, only diagnosed (lifecycle)
                chaos.configure("clerk.dies", kill=True, times=dead_clerks,
                                seed=seed)
            if dead_participants:
                chaos.configure("participant.dies", kill=True,
                                times=dead_participants, seed=seed)
            if extra_spec:
                specs = ([extra_spec] if isinstance(extra_spec, str)
                         else list(extra_spec))
                chaos.configure_from_specs(specs, seed=seed)

            rng = np.random.default_rng(seed)
            inputs = rng.integers(0, modulus,
                                  size=(participants, dim), dtype=np.int64)
            churn_plan = (chaos.churn_schedule(participants, churn_rate,
                                               seed=seed)
                          if churn_rate else None)
            journal = (ParticipationJournal(journal_dir.name)
                       if churn_rate else None)
            # a dead participant never contributes: the healthy-reference
            # sum covers exactly the rows that actually reached the round
            alive_rows = []
            departed = []  # (agent, row): crashed devices awaiting rejoin
            for i, row in enumerate(inputs):
                participant = new_client()
                participant.upload_agent()
                plan = churn_plan[i] if churn_plan else None
                if plan and plan["departs"]:
                    # the sporadic device: seal + journal, then crash at
                    # the scheduled point — BEFORE any upload, or in the
                    # lost-ack window right after the server stored the
                    # bundle (the device never learns it landed)
                    participation = participant.new_participation(
                        [int(x) for x in row], agg.id)
                    journal.record(participation)
                    if plan["phase"] == "mid-upload":
                        participant.upload_participation(participation)
                    metrics.count("participant.departed")
                    departed.append((participant.agent, row))
                    # the departure WILL land: every plan entry rejoins,
                    # and resume re-uploads the journaled bytes below
                    alive_rows.append(row)
                    continue
                participant.participate([int(x) for x in row], agg.id,
                                        journal=journal)
                if not participant._dead:
                    alive_rows.append(row)

            # -- rejoin: each departed device comes back as a FRESH client
            # process (new transport, empty keystore — resume needs only
            # the journaled bytes and the agent identity) and re-uploads
            # verbatim: pre-upload crashes arrive for the first time,
            # mid-upload crashes replay byte-identically
            resumed = 0
            equivocations_undetected = 0
            resume_started = time.perf_counter()
            for agent, _row in departed:
                rejoined = SdaClient(agent, MemoryKeystore(), new_proxy(),
                                     device=device)
                resumed += rejoined.resume(journal)
            time_to_resume_s = time.perf_counter() - resume_started
            if departed:
                # the equivocation probe: the first churned agent tries to
                # participate AGAIN with fresh randomness and a different
                # input — exactly the double-count the exactly-once plane
                # exists to stop. Detection = typed ParticipationConflict.
                agent, row = departed[0]
                probe = SdaClient(agent, MemoryKeystore(), new_proxy(),
                                  device=device)
                try:
                    # upload directly (not participate()): the probe is an
                    # upload-level attack and must reach the server even
                    # when a leftover participant.dies kill budget would
                    # silently swallow a participate() call
                    probe.upload_participation(probe.new_participation(
                        [int(x + 1) % modulus for x in row], agg.id))
                except ParticipationConflict:
                    pass  # detected: counted server-side as equivocation
                else:
                    equivocations_undetected += 1
            recipient.end_aggregation(agg.id)  # snapshot + job fan-out

            brownout_started = None
            if brownout_s:
                # the store browns out MID-CLERKING: fan-out is durable,
                # the committee is about to hammer the job-poll and
                # result-write paths — elevated error rate + latency for
                # the seeded window, breaker in front
                brownout_started = time.monotonic()
                chaos.configure("store.poll_clerking_job", brownout=0.01,
                                rate=0.85, window=brownout_s, seed=seed)
                chaos.configure("store.create_clerking_result",
                                brownout=0.01, rate=0.85,
                                window=brownout_s, seed=seed)

            def round_state():
                try:
                    return recipient.service.get_round_status(
                        recipient.agent, agg.id)
                except Exception:  # chaos'd poll: state is best-effort
                    return None

            # clerks keep polling until the round's completion condition:
            # with NO dead clerks, EVERY job has a result — waiting for
            # the full committee (not just reconstruction_threshold) is
            # what forces the abandoned job through the lease-expiry
            # reissue path. With dead clerks, the supervisor's verdict is
            # the exit: degraded + a reconstructing quorum, or terminal
            # failed (additive) — deterministically, instead of hanging.
            threshold = scheme.reconstruction_threshold
            deadline = time.monotonic() + timeout_s
            ready = False
            final_round = None
            while time.monotonic() < deadline:
                for clerk in clerks:
                    try:
                        clerk.run_chores(-1)
                    except ServerError:
                        # a brownout window can outlast even the padded
                        # transport retry budget: the clerk is fine, the
                        # dependency is not — come back next pass
                        metrics.count("clerk.chores.transient")
                try:
                    status = recipient.service.get_aggregation_status(
                        recipient.agent, agg.id
                    )
                except ServerError:
                    metrics.count("recipient.status.transient")
                    status = None
                results = (status.snapshots[0].number_of_clerking_results
                           if status is not None and status.snapshots else 0)
                if not dead_clerks and results >= scheme.share_count:
                    ready = True
                    break
                if dead_clerks:
                    final_round = round_state()
                    if final_round is not None:
                        if final_round.state == "failed":
                            break
                        if (final_round.state == "degraded"
                                and results >= threshold):
                            ready = True
                            break
                time.sleep(min(0.1, lease_seconds / 4))

            exact = False
            failure = None
            if ready:
                # the lifecycle-aware blocking reveal: returns the output,
                # or raises the typed verdict with the server's diagnosis
                output = recipient.await_result(
                    agg.id, deadline=max(1.0, deadline - time.monotonic()))
                expected = (np.stack(alive_rows).sum(axis=0) % modulus
                            if alive_rows else np.zeros(dim, dtype=np.int64))
                exact = bool((output.positive().values == expected).all())
            elif dead_clerks:
                try:
                    recipient.await_result(agg.id, deadline=1.0,
                                           poll_interval=0.05)
                except RoundFailed as e:  # RoundExpired is a subclass
                    failure = {
                        "type": type(e).__name__,
                        "state": e.state,
                        "reason": e.reason,
                        "dead_clerks": [str(c) for c in e.dead_clerks],
                    }
            final_round = round_state() or final_round
            # zero-double-count audit: the aggregation-wide admitted count
            # must equal the unique devices that ever landed — a surplus
            # is a double count, the exact failure exactly-once ingestion
            # exists to make impossible
            admitted = None
            try:
                final_status = recipient.service.get_aggregation_status(
                    recipient.agent, agg.id)
                if final_status is not None:
                    admitted = final_status.number_of_participations
            except Exception:  # chaos'd poll: the audit is best-effort
                pass
    finally:
        # snapshot the schedule, then disarm BEFORE shutdown so teardown
        # requests aren't chaos'd
        failpoint_report = chaos.report()
        chaos.reset()
        if sweeper is not None:
            sweeper.stop()
        http_server.shutdown()
        journal_dir.cleanup()

    from ..loadgen import latency_report_ms as _latency_report_ms

    counters = metrics.counter_report()
    injected = sum(v for k, v in counters.items() if k.startswith("chaos."))
    # request-level failure accounting: dispatch 500s and store faults are
    # already inside http.request (they produce a counted 500 reply);
    # dropped responses bail out before the counter, so add them back
    failed_requests = sum(
        v for k, v in counters.items()
        if k.startswith(("chaos.http.server.", "chaos.store."))
    )
    dropped = counters.get("chaos.http.server.response", 0)
    requests_total = counters.get("http.request", 0) + dropped
    # the round timeline: slowest-first, so [0] is the drill's round trace
    # (every span shares its trace id); chaos_events names each injection
    # and the span it hit, critical_path the chain that set round duration
    timelines = obs.round_timelines()

    def _phase_gap(history, start_state, end_state):
        """Server-stamped seconds between two lifecycle transitions."""
        stamps = {state: ts for state, ts in (history or [])}
        if start_state in stamps and end_state in stamps:
            return round(stamps[end_state] - stamps[start_state], 4)
        return None

    round_history = (final_round.history
                     if dead_clerks and final_round is not None else None)
    breaker_report = breaker.report() if breaker is not None else None
    pickup_summary = metrics.histogram_report("server.job.pickup").get(
        "server.job.pickup")
    report = {
        "mode": (f"chaos drill over HTTP ({store} store, "
                 f"{'async' if async_http else 'threaded'} plane)"),
        "http_plane": "async" if async_http else "threaded",
        "participants": participants,
        "dim": dim,
        "clerks": scheme.share_count,
        "sharing": sharing,
        "dead_clerks": dead_clerks,
        "dead_participants": dead_participants,
        "rate": rate,
        "seed": seed,
        "lease_seconds": lease_seconds,
        "ready": ready,
        "exact": exact,
        # round lifecycle verdict (server/lifecycle.py): terminal state,
        # transition history with server-side stamps, and the diagnosis —
        # plus the BENCH-style detection latencies the regress gate
        # tracks advisory (ci.sh dead-clerk drill)
        "round_state": (final_round.state
                        if final_round is not None else None),
        "round_reason": (final_round.reason
                         if final_round is not None else None),
        "round_dead_clerks": ([str(c) for c in final_round.dead_clerks]
                              if final_round is not None else None),
        "round_history": round_history,
        "time_to_degraded_s": _phase_gap(round_history, "clerking",
                                         "degraded"),
        "time_to_failed_s": _phase_gap(round_history, "clerking", "failed"),
        # brownout-recovery verdict (server/breaker.py): how long the
        # store was effectively down from the breaker's point of view —
        # first trip to final recovery, the MTTR headline ci.sh records
        "brownout_s": brownout_s or None,
        "breaker": breaker_report,
        "time_to_recover_s": (breaker_report or {}).get("time_to_recover_s"),
        # device-churn verdict (exactly-once participation plane): every
        # departure rejoined and landed exactly once — mid-upload crashes
        # as byte-identical replays, the equivocation probe rejected, and
        # the admitted count exactly the unique-device count
        "churn_rate": churn_rate or None,
        "participants_churned": len(departed),
        "participants_resumed": resumed,
        "participations_replayed": counters.get(
            "server.participation.replayed", 0),
        "equivocations_detected": counters.get(
            "server.participation.equivocation", 0),
        "equivocations_undetected": equivocations_undetected,
        "admitted_participations": admitted,
        "double_counted": (None if admitted is None
                           else admitted - len(alive_rows)),
        "time_to_resume_s": (round(time_to_resume_s, 4)
                             if churn_rate else None),
        "failure": failure,
        "injected_faults": injected,
        "failed_requests": failed_requests,
        "injected_ratio": round(failed_requests / max(1, requests_total), 4),
        "failpoints": failpoint_report or None,
        "counters": {
            k: v for k, v in counters.items()
            if k.startswith(("chaos.", "http.retry.", "http.status.",
                             "server.job.", "server.snapshot.",
                             "server.participation.", "participant.",
                             "server.store.breaker.", "server.fleet."))
        },
        # per-route server latency under fire: the tail the retry budget
        # has to ride out (loadgen measures the same table under load)
        "latency_ms": _latency_report_ms(),
        # enqueue->lease latency (server.job.pickup): the long-poll
        # plane's headline metric, surfaced here so the chaos drill's
        # fixed-seed A/B carries it too (docs/load.md)
        "job_pickup_ms": ({
            "count": int(pickup_summary["count"]),
            "p50_ms": round(pickup_summary["p50"] * 1e3, 3),
            "p99_ms": round(pickup_summary["p99"] * 1e3, 3),
        } if pickup_summary else None),
        "trace": timelines[0] if timelines else None,
    }
    return report
