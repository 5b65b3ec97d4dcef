"""The soak drill: T tenants x R pipelined epochs, forever-shaped.

Where ``loadgen`` proves one round survives traffic and ``chaos/drill``
proves one round survives faults, this drill proves the SERVICE survives
time: a fleet serving several tenants' recurring rounds back to back —
pipelined collection (epoch R+1 collecting while epoch R clerks), churn
and chaos armed, retention purging revealed rounds as it goes — without
corruption, cross-tenant or cross-epoch leakage, or growth in store size
and worker memory. The report is BENCH-style; the headline metric is
sustained ``rounds_per_hour`` plus a per-tenant capacity table.

Verdicts asserted by ``sda-sim --soak`` (and the ci.sh soak step):

- **bit-exact per epoch**: every tenant's every epoch reveals exactly
  the sum of that tenant-epoch's inputs;
- **pipelined collection**: epoch *e*'s round enters ``collecting``
  BEFORE epoch *e-1* reveals (read from the server-stamped round-state
  history), and one participation per tenant is accepted into epoch
  *e+1* while epoch *e* is still clerking;
- **zero cross-epoch/cross-tenant leakage**: a byte-identical replay of
  an epoch *e-1* participation during epoch *e* can only land in epoch
  *e-1* (or vanish with it once retention purged it) — epoch *e*'s
  admitted count stays exactly the device population; and every tenant's
  sum is its own (deterministic distinct inputs per tenant);
- **flat store + RSS**: after retention, total store rows and worker RSS
  between epoch 2 and epoch R stay within +-10%.

Epoch pacing is completion-driven: the drill ticks the scheduler when a
population's uploads land, so ``period_s`` acts as a floor, not a clock.
Two scheduler handles tick CONCURRENTLY every epoch — the single-winner
CAS mint is exercised on every epoch of every run, not just in tests.
"""

from __future__ import annotations

import gc
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from .. import chaos, obs
from ..client.journal import ParticipationJournal
from ..server import lifecycle
from ..utils import metrics
from .retention import RetentionPolicy, live_sqlite_rows_total, store_rows_total
from .scheduler import RoundScheduler, ScheduleSpec, epoch_aggregation_id


@dataclass
class SoakProfile:
    """Everything one soak run needs; defaults match the tier-1 smoke
    (2 tenants x 2 epochs over an in-process memory store)."""

    tenants: int = 2
    epochs: int = 2
    participants: int = 4               # devices per tenant (>= 3)
    dim: int = 4
    seed: int = 0
    store: str = "memory"               # memory | sqlite | jsonfs
    store_path: Optional[str] = None
    fleet: int = 0                      # N sdad workers over the shared store
    chaos_rate: float = 0.0             # fraction of requests to 500
    churn: float = 0.0                  # seeded device churn per epoch
    period_s: float = 0.01              # schedule cadence FLOOR (see module doc)
    max_pipelined: int = 2
    retain_revealed_s: float = 0.0      # revealed-round TTL (purge after)
    tenant_rate: Optional[float] = None  # per-tenant admission budget
    tenant_burst: float = 32.0
    lease_seconds: float = 2.0
    timeout_s: float = 600.0
    device: Optional[str] = None  # the clients' device: CUDA unless "cpu"


def _rss_bytes(pid=None) -> Optional[int]:
    """Resident set size from /proc (None off-Linux)."""
    try:
        with open(f"/proc/{pid or 'self'}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        return None
    return None


def _flat(baseline: Optional[int], final: Optional[int],
          tolerance: float = 0.10) -> Optional[bool]:
    """Whether ``final`` stayed within +-tolerance of ``baseline``."""
    if not baseline or final is None:
        return None
    return abs(final - baseline) <= tolerance * baseline


def run_soak(profile: SoakProfile) -> dict:
    """Run the soak drill; returns the BENCH-style report. Requires
    libsodium (real participant crypto, like every serving drill)."""
    import numpy as np

    from ..chaos.drill import golden_packed_scheme
    from ..client import SdaClient
    from ..crypto import MemoryKeystore, sodium
    from ..http import SdaHttpClient, SdaHttpServer
    from ..protocol import (
        Aggregation,
        AggregationId,
        FullMasking,
        NotFound,
        SodiumEncryption,
    )
    from ..server import new_jsonfs_server, new_memory_server, new_sqlite_server
    from ..server.core import SdaServer

    if not sodium.available():
        raise RuntimeError("the soak drill needs libsodium (real crypto rounds)")
    if profile.participants < 3:
        raise ValueError("the soak drill needs >= 3 devices per tenant "
                         "(pipelining + replay probes reserve two)")
    if profile.epochs < 2:
        raise ValueError("a soak needs >= 2 epochs (the verdicts compare "
                         "consecutive epochs)")

    scheme = golden_packed_scheme()
    modulus = scheme.prime_modulus

    obs.reset_all()
    chaos.reset()

    fleet = None
    ring = None
    http_server = None
    if profile.fleet:
        from ..server.fleet import Fleet

        if profile.store not in ("sqlite", "jsonfs"):
            raise ValueError("fleet mode needs a cross-process store "
                             "(store='sqlite' or 'jsonfs')")
        if not profile.store_path:
            raise ValueError("fleet mode needs store_path")
        backend = (["--sqlite", profile.store_path]
                   if profile.store == "sqlite"
                   else ["--jfs", profile.store_path])
        extra = ["--job-lease", str(profile.lease_seconds), "--statusz"]
        if profile.tenant_rate is not None:
            extra += ["--tenant-rate", str(profile.tenant_rate),
                      "--tenant-burst", str(profile.tenant_burst)]
        if profile.chaos_rate > 0.0:
            extra += ["--chaos-spec",
                      f"http.server.request=error,rate={profile.chaos_rate}",
                      "--chaos-seed", str(profile.seed)]
        fleet = Fleet(profile.fleet, backend, extra_args=extra,
                      node_prefix="soak-w")
        fleet.start()
        ring = fleet.ring()

        def _new_handle():
            return (new_sqlite_server(profile.store_path)
                    if profile.store == "sqlite"
                    else new_jsonfs_server(profile.store_path)).server
        server_a, server_b = _new_handle(), _new_handle()
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
        http_server = SdaHttpServer(
            service_impl, bind="127.0.0.1:0",
            rate_limit=None, tenant_rate=profile.tenant_rate,
            tenant_burst=profile.tenant_burst)
        http_server.start_background()
        server_a = service_impl.server
        # a second in-process handle over the SAME stores: the raced
        # scheduler ticks below exercise real store arbitration
        server_b = SdaServer(
            agents_store=server_a.agents_store,
            auth_tokens_store=server_a.auth_tokens_store,
            aggregation_store=server_a.aggregation_store,
            clerking_job_store=server_a.clerking_job_store,
        )

    # retention rides the sweeper on handle A (fleet: a drill-side handle
    # over the shared store — workers could equally run it)
    server_a.retention_policy = RetentionPolicy(
        revealed_ttl_s=profile.retain_revealed_s)
    sweeper = lifecycle.RoundSweeper(server_a)

    journal_dir = tempfile.TemporaryDirectory(prefix="sda-soak-journal-")
    journal = ParticipationJournal(journal_dir.name) if profile.churn else None

    deadline = time.monotonic() + profile.timeout_s

    def _remaining() -> float:
        return max(1.0, deadline - time.monotonic())

    proxies: Dict[tuple, SdaHttpClient] = {}

    def _proxy(agent_key, tenant: Optional[str]) -> SdaHttpClient:
        node = ring.node_for(str(agent_key)) if ring is not None else None
        key = (node, tenant)
        proxy = proxies.get(key)
        if proxy is None:
            address = (fleet.addresses[node] if fleet is not None
                       else http_server.address)
            proxy = SdaHttpClient(
                address, token="soak-drill-token",
                max_retries=16, backoff_base=0.01, backoff_cap=0.25,
                deadline=profile.timeout_s)
            proxy.tenant = tenant
            proxies[key] = proxy
        return proxy

    def new_client(tenant: Optional[str], key=None):
        keystore = MemoryKeystore()
        agent = SdaClient.new_agent(keystore)
        return SdaClient(agent, keystore,
                         _proxy(key if key is not None else agent.id, tenant),
                         device=profile.device)

    failures: List[str] = []
    report: dict = {}
    try:
        with obs.span("soak", attributes={"tenants": profile.tenants,
                                          "epochs": profile.epochs,
                                          "seed": profile.seed}):
            # -- setup: shared clerk pool + per-tenant recipients ---------
            clerks = []
            for _ in range(scheme.share_count):
                clerk = new_client(None)
                clerk.upload_agent()
                key_id = clerk.new_encryption_key()
                clerk.upload_encryption_key(key_id)
                clerks.append((clerk, key_id))
            committee_policy = [[str(clerk.agent.id), str(key_id)]
                                for clerk, key_id in clerks]

            tenants: List[dict] = []
            for t in range(profile.tenants):
                recipient = new_client(None)
                recipient.upload_agent()
                recipient_key = recipient.new_encryption_key()
                recipient.upload_encryption_key(recipient_key)
                tenant_id = str(recipient.agent.id)
                # the recipient's own traffic rides its tenant budget too
                recipient.service = _proxy(recipient.agent.id, tenant_id)
                template = Aggregation(
                    id=AggregationId.random(),  # replaced per epoch
                    title="soak", vector_dimension=profile.dim,
                    modulus=modulus,
                    recipient=recipient.agent.id,
                    recipient_key=recipient_key,
                    masking_scheme=FullMasking(modulus),
                    committee_sharing_scheme=scheme,
                    recipient_encryption_scheme=SodiumEncryption(),
                    committee_encryption_scheme=SodiumEncryption(),
                ).to_obj()
                spec = ScheduleSpec(
                    name=f"soak-tenant-{t}",
                    period_s=profile.period_s,
                    template=template,
                    committee=committee_policy,
                    max_pipelined=profile.max_pipelined,
                )
                devices = []
                for _ in range(profile.participants):
                    device = new_client(tenant_id)
                    device.upload_agent()
                    devices.append(device)
                tenants.append({
                    "t": t, "id": tenant_id, "recipient": recipient,
                    "spec": spec, "devices": devices,
                    "exact": 0, "epoch_walls": [], "admitted": [],
                })

            # two scheduler handles over one store: every epoch's mint is
            # a real race, single-winner by the store CAS
            specs = [tenant["spec"] for tenant in tenants]
            schedulers = [RoundScheduler(server_a, specs),
                          RoundScheduler(server_b, specs)]

            def tick_all() -> List[dict]:
                results: List[Optional[dict]] = [None, None]

                def run(ix):
                    results[ix] = schedulers[ix].tick_once()

                threads = [threading.Thread(target=run, args=(ix,))
                           for ix in (0, 1)]
                for thread in threads:
                    thread.start()
                for thread in threads:
                    thread.join()
                return [action for r in results for action in r["actions"]]

            # install epoch 0 for every schedule
            tick_all()

            # -- arm chaos only now: setup ran clean, the SERVICE runs
            # under fire (fleet workers were armed at spawn via flags)
            if fleet is None and profile.chaos_rate > 0.0:
                chaos.configure("http.server.request", error=True,
                                rate=profile.chaos_rate, seed=profile.seed)

            def inputs_for(t: int, epoch: int):
                rng = np.random.default_rng(
                    (profile.seed, t, epoch))
                return rng.integers(0, modulus,
                                    size=(profile.participants, profile.dim),
                                    dtype=np.int64)

            def churn_plan_for(t: int, epoch: int):
                if not profile.churn:
                    return None
                return chaos.churn_schedule(
                    profile.participants, profile.churn,
                    seed=profile.seed * 7919 + t * 101 + epoch)

            histories: Dict[tuple, dict] = {}
            probe_bundles: Dict[int, object] = {}  # tenant -> prev epoch bundle
            replay_probes = {"replayed": 0, "purged": 0}
            churn_stats = {"churned": 0, "resumed": 0}
            leaks = 0
            rows_baseline = rss_baseline = None
            rows_final = rss_final = None
            purged_rounds = 0

            def measure():
                gc.collect()
                if profile.store == "memory":
                    rows = store_rows_total("memory", server=server_a)
                elif profile.store == "sqlite" and not profile.store_path:
                    # ":memory:" databases are per-connection: count
                    # through the live handle instead of a side one
                    rows = live_sqlite_rows_total(
                        server_a.aggregation_store.db)
                else:
                    rows = store_rows_total(profile.store,
                                            path=profile.store_path)
                if fleet is not None:
                    rss_values = [
                        _rss_bytes(worker.process.pid)
                        for worker in fleet.workers if worker.process]
                    rss_values = [v for v in rss_values if v]
                    rss = max(rss_values) if rss_values else None
                else:
                    rss = _rss_bytes()
                return rows, rss

            t_soak0 = time.perf_counter()
            for epoch in range(profile.epochs):
                for tenant in tenants:
                    t = tenant["t"]
                    spec: ScheduleSpec = tenant["spec"]
                    aggregation_id = epoch_aggregation_id(spec.name, epoch)
                    inputs = inputs_for(t, epoch)
                    plan = churn_plan_for(t, epoch)
                    epoch_t0 = time.perf_counter()
                    # cross-epoch replay probe: re-upload the PREVIOUS
                    # epoch's byte-identical bundle while this epoch is
                    # open — it may only land in its own (old) epoch, or
                    # 404 once retention purged it; never here
                    if epoch > 0 and t in probe_bundles:
                        probe = probe_bundles.pop(t)
                        device = tenant["devices"][1]
                        try:
                            device.upload_participation(probe)
                            replay_probes["replayed"] += 1
                        except NotFound:
                            replay_probes["purged"] += 1
                    for index, device in enumerate(tenant["devices"]):
                        row = [int(x) for x in inputs[index]]
                        if index == 0 and epoch > 0:
                            continue  # uploaded early, last iteration
                        if index == 1:
                            # the replay-probe device uploads by hand so
                            # the drill keeps its sealed bundle verbatim
                            bundle = device.new_participation(
                                row, aggregation_id)
                            device.upload_participation(bundle)
                            probe_bundles[t] = bundle
                            continue
                        if (plan is not None and index >= 2
                                and plan[index]["departs"]):
                            # the sporadic device: seal + journal, crash
                            # at the seeded point, rejoin via resume —
                            # exactly-once ingestion absorbs the replay
                            bundle = device.new_participation(
                                row, aggregation_id)
                            journal.record(bundle)
                            if plan[index]["phase"] == "mid-upload":
                                device.upload_participation(bundle)
                            rejoined = SdaClient(
                                device.agent, MemoryKeystore(),
                                _proxy(device.agent.id, tenant["id"]),
                                device=profile.device)
                            churn_stats["churned"] += 1
                            churn_stats["resumed"] += rejoined.resume(journal)
                            continue
                        device.participate(row, aggregation_id)
                    tenant["_inputs"] = inputs
                    tenant["_epoch_t0"] = epoch_t0

                # mint epoch e+1 / close epoch e — BOTH scheduler handles
                # race; the CAS admits one winner per schedule
                tick_all()

                # pipelined collection probe: one device's participation
                # is ACCEPTED into epoch e+1 while epoch e still clerks
                for tenant in tenants:
                    t = tenant["t"]
                    next_id = epoch_aggregation_id(
                        tenant["spec"].name, epoch + 1)
                    early_row = [int(x) for x in inputs_for(t, epoch + 1)[0]]
                    tenant["devices"][0].participate(early_row, next_id)

                # clerk + reveal epoch e for every tenant
                pending = list(tenants)
                while pending and time.monotonic() < deadline:
                    for clerk, _ in clerks:
                        try:
                            clerk.run_chores(-1)
                        except Exception:
                            metrics.count("soak.clerk.transient")
                    still = []
                    for tenant in pending:
                        recipient = tenant["recipient"]
                        aggregation_id = epoch_aggregation_id(
                            tenant["spec"].name, epoch)
                        try:
                            status = recipient.service.get_aggregation_status(
                                recipient.agent, aggregation_id)
                        except Exception:
                            metrics.count("soak.status.transient")
                            still.append(tenant)
                            continue
                        if (status is None or not status.snapshots
                                or status.snapshots[0].number_of_clerking_results
                                < scheme.share_count):
                            still.append(tenant)
                            continue
                        output = recipient.await_result(
                            aggregation_id, deadline=_remaining())
                        expected = (tenant["_inputs"].sum(axis=0) % modulus)
                        exact = bool(
                            (output.positive().values == expected).all())
                        tenant["exact"] += int(exact)
                        if not exact:
                            failures.append(
                                f"tenant {tenant['t']} epoch {epoch}: "
                                f"inexact reveal")
                        admitted = status.number_of_participations
                        tenant["admitted"].append(admitted)
                        if admitted != profile.participants:
                            leaks += 1
                            failures.append(
                                f"tenant {tenant['t']} epoch {epoch}: "
                                f"{admitted} admitted participations "
                                f"(expected {profile.participants})")
                        round_status = recipient.service.get_round_status(
                            recipient.agent, aggregation_id)
                        if round_status is not None:
                            histories[(tenant["t"], epoch)] = {
                                state: ts
                                for state, ts in round_status.history}
                        tenant["epoch_walls"].append(
                            time.perf_counter() - tenant["_epoch_t0"])
                    pending = still
                    if pending:
                        time.sleep(0.02)
                if pending:
                    for tenant in pending:
                        failures.append(
                            f"tenant {tenant['t']} epoch {epoch}: timed out")
                    break

                # retention: revealed epochs past TTL expire + purge
                swept = sweeper.sweep_once()
                purged_rounds += sum(
                    1 for action in swept["actions"]
                    if action.get("to") == "purged")

                if epoch == 1:
                    rows_baseline, rss_baseline = measure()
                if epoch == profile.epochs - 1:
                    rows_final, rss_final = measure()
            soak_wall = time.perf_counter() - t_soak0

            # pipelined-collection verdict, from server-stamped history:
            # epoch e entered collecting BEFORE epoch e-1 revealed
            pipelined_pairs = 0
            pipelined_total = 0
            for tenant in tenants:
                for epoch in range(1, profile.epochs):
                    previous = histories.get((tenant["t"], epoch - 1))
                    current = histories.get((tenant["t"], epoch))
                    if not previous or not current:
                        continue
                    if "collecting" not in current \
                            or "revealed" not in previous:
                        continue
                    pipelined_total += 1
                    if current["collecting"] < previous["revealed"]:
                        pipelined_pairs += 1
            pipelined = bool(pipelined_total) \
                and pipelined_pairs == pipelined_total
    finally:
        failpoint_report = chaos.report()
        chaos.reset()
        drain_summaries = None
        participation_counters: dict = {}
        if fleet is not None:
            # exactly-once tallies are stamped server-side, i.e. in the
            # worker processes: scrape each /statusz BEFORE the drain
            # (the counters die with the workers)
            from ..server.fleet import merge_statusz_block

            participation_counters = merge_statusz_block(
                fleet.scrape_statusz().values(), "participation")
            drain_summaries = fleet.stop()
        if http_server is not None:
            http_server.shutdown()
        for proxy in proxies.values():
            proxy.close()
        journal_dir.cleanup()

    counters = metrics.counter_report()
    if not participation_counters:
        participation_counters = metrics.counter_report(
            "server.participation.") or {}
    rounds_done = sum(tenant["exact"] for tenant in tenants)
    rounds_expected = profile.tenants * profile.epochs
    rounds_per_hour = (rounds_done / soak_wall * 3600.0) if soak_wall else 0.0
    rows_flat = _flat(rows_baseline, rows_final)
    rss_flat = _flat(rss_baseline, rss_final)
    report = {
        "metric": (f"sustained rounds/hour (soak: {profile.tenants} tenants "
                   f"x {profile.epochs} epochs, {profile.participants} "
                   f"devices, dim {profile.dim}, {profile.store} store"
                   + (f", fleet x{profile.fleet}" if profile.fleet else "")
                   + ")"),
        "value": round(rounds_per_hour, 1),
        "unit": "rounds/hour",
        "platform": "cpu",
        "seed": profile.seed,
        "mode": (f"soak ({profile.store} store"
                 + (f", fleet x{profile.fleet}" if profile.fleet else "")
                 + (f", chaos rate {profile.chaos_rate}"
                    if profile.chaos_rate else "")
                 + (f", churn {profile.churn}" if profile.churn else "")
                 + ")"),
        "tenants": profile.tenants,
        "epochs": profile.epochs,
        "participants": profile.participants,
        "dim": profile.dim,
        "chaos_rate": profile.chaos_rate,
        "churn_rate": profile.churn or None,
        "rounds": rounds_expected,
        "rounds_exact": rounds_done,
        "exact": rounds_done == rounds_expected and not failures,
        "soak_seconds": round(soak_wall, 4),
        "pipelined": pipelined,
        "pipelined_pairs": f"{pipelined_pairs}/{pipelined_total}",
        "leaks": leaks,
        "replay_probes": replay_probes,
        "churn": ({
            "rate": profile.churn,
            "participants_churned": churn_stats["churned"],
            "participants_resumed": churn_stats["resumed"],
            "participations_replayed": participation_counters.get(
                "server.participation.replayed", 0),
            "equivocations": participation_counters.get(
                "server.participation.equivocation", 0),
        } if profile.churn else None),
        "retention": {
            "revealed_ttl_s": profile.retain_revealed_s,
            "purged_rounds": purged_rounds,
            "store_rows_epoch2": rows_baseline,
            "store_rows_final": rows_final,
            "store_rows_flat": rows_flat,
            "rss_epoch2_bytes": rss_baseline,
            "rss_final_bytes": rss_final,
            "rss_flat": rss_flat,
        },
        "scheduler": {
            "installed": counters.get("service.schedule.installed", 0),
            "epochs_minted": counters.get(
                "service.schedule.epoch_minted", 0),
            "epochs_closed": counters.get(
                "service.schedule.epoch_closed", 0),
            "contended": counters.get("service.schedule.contended", 0),
            "pipeline_full": counters.get(
                "service.schedule.pipeline_full", 0),
        },
        "admission": {
            "tenant_rate": profile.tenant_rate,
            "throttled": metrics.counter_report("http.throttled.") or None,
        },
        "per_tenant": {
            tenant["spec"].name: {
                "tenant": tenant["id"],
                "epochs": profile.epochs,
                "epochs_exact": tenant["exact"],
                "admitted": tenant["admitted"],
                "mean_epoch_s": (round(
                    sum(tenant["epoch_walls"]) / len(tenant["epoch_walls"]),
                    4) if tenant["epoch_walls"] else None),
                "rounds_per_hour": (round(
                    len(tenant["epoch_walls"])
                    / max(soak_wall, 1e-9) * 3600.0, 1)),
            }
            for tenant in tenants
        },
        "client_failures": len(failures),
        "failure_samples": failures[:5] or None,
        "failpoints": failpoint_report or None,
        "counters": {
            k: v for k, v in counters.items()
            if k.startswith(("service.schedule.", "server.round.",
                             "server.purge.", "server.participation.",
                             "http.throttled.", "chaos."))
        } or None,
    }
    if fleet is not None:
        report["fleet_nodes"] = profile.fleet
        report["fleet"] = {
            "drain": drain_summaries,
            "leaked": sum(int(s.get("leaked", 0) or 0)
                          for s in drain_summaries or []),
        }
    return report
