"""The analytics scenario driver: multi-tenant secure analytics over the
real stack — the executable proof behind ``sda-sim --analytics``.

One run gives each requested encoder kind its own TENANT — its own
recipient, device population and recurring :class:`ScheduleSpec` — all
sharing one server plane (in-process store, single HTTP server, or a
real ``sda-fleet`` of ``sdad`` OS processes over one shared store) and
one clerk committee. Epochs are minted/closed by the round scheduler
exactly like the FL and soak drills; the ONLY new code in the loop is
the encoder in front of ``participate`` and the decoder behind
``await_result``.

Per epoch per tenant the drill asserts, against seeded ground truth it
generated itself:

- **bit-exact reveal**: the revealed sum equals the plaintext encoded
  sum of exactly the frozen participant set (mod m) — inherited from
  the substrate, asserted anyway, every epoch;
- **decoder error within the declared contract** (docs/analytics.md):
  exact for histogram and A/B, ε–δ for the sketches (overestimate-only
  for count-min; two-sided ``sqrt(3 F2 / width)`` for count-sketch,
  each with a binomial allowance for the δ failure budget over the
  query set), one grid step for quantiles;
- **zero cross-tenant leakage**: every tenant's every epoch admits
  exactly its own device population, and decodes to ITS seeded data
  (tenant datasets are deterministic and distinct by construction).

The report is BENCH-style: the headline is **values_per_sec** (private
values securely aggregated per second of drill wall time) plus a
per-encoder error table, scheduler counters and spans/devprof totals.
"""

from __future__ import annotations

import hashlib
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .. import obs
from ..utils import metrics
from .encoders import (
    ABMetricEncoder,
    AnalyticsEncoder,
    CountMinEncoder,
    CountSketchEncoder,
    HistogramEncoder,
    QuantileEncoder,
)

__all__ = ["AnalyticsProfile", "expand_kinds", "run_analytics"]

#: the encoder kinds a profile may request, in canonical tenant order
KINDS = ("histogram", "countmin", "countsketch", "quantile", "ab")

#: CLI profile aliases (``sda-sim --analytics heavy``)
ALIASES = {
    "heavy": ("countmin", "countsketch"),
    "all": KINDS,
}


def expand_kinds(spec: str) -> List[str]:
    """Parse a ``--analytics`` profile string: a comma list of kinds
    and/or aliases, order-preserving. Typed error on unknown names."""
    kinds: List[str] = []
    for token in (t.strip() for t in str(spec).split(",")):
        if not token:
            continue
        expansion = ALIASES.get(token, (token,))
        for kind in expansion:
            if kind not in KINDS:
                raise ValueError(
                    f"unknown analytics profile {token!r} (kinds: "
                    f"{', '.join(KINDS)}; aliases: "
                    f"{', '.join(sorted(ALIASES))})")
            if kind not in kinds:
                kinds.append(kind)
    if not kinds:
        raise ValueError("--analytics needs at least one encoder kind")
    return kinds


@dataclass
class AnalyticsProfile:
    """Everything one analytics run needs; defaults match the tier-1
    smoke (histogram + count-min tenants over an in-process store)."""

    kinds: List[str] = field(
        default_factory=lambda: ["histogram", "countmin"])
    tenants: Optional[int] = None   # default: one per requested kind
    participants: int = 4           # devices per tenant (>= 2)
    epochs: int = 2                 # recurring rounds per tenant
    values_per_device: int = 8      # samples/items per device per epoch
    domain_size: int = 24           # sketch item universe (heavy hitters)
    bins: int = 32                  # histogram/quantile grid
    width: int = 64                 # sketch width  (eps = e/width)
    depth: int = 4                  # sketch depth  (delta = e^-depth)
    arms: int = 2                   # A/B arms
    hh_threshold: float = 0.05      # heavy-hitter frequency threshold
    seed: int = 0
    store: str = "memory"           # memory | sqlite | jsonfs
    store_path: Optional[str] = None
    http: bool = False              # single real HTTP server
    fleet: int = 0                  # N sdad workers over the shared store
    modulus_bits: int = 28          # packed-Shamir prime size
    period_s: float = 0.01          # schedule cadence floor
    lease_seconds: float = 2.0
    timeout_s: float = 600.0
    device: Optional[str] = None  # the clients' device: CUDA unless "cpu"


def _sketch_seed(run_seed: int, schedule: str) -> int:
    """The shared hash-family seed: both sides of a sketch aggregation
    derive it from the run seed + the schedule name (which every epoch's
    deterministic aggregation id already encodes), so recipient and
    devices agree by construction — no extra distribution channel."""
    digest = hashlib.blake2b(
        f"analytics:{int(run_seed)}:{schedule}".encode(),
        digest_size=8).digest()
    return int.from_bytes(digest, "little")


def _delta_allowance(queries: int, delta: float) -> int:
    """How many per-query δ failures the drill tolerates over a query
    set: the δ budget mean plus six binomial standard deviations plus
    one — a fixed-seed run past this is a real contract breach, not an
    unlucky draw."""
    mean = queries * delta
    return int(math.ceil(mean + 6.0 * math.sqrt(max(mean * (1.0 - delta),
                                                    1e-12)) + 1.0))


def _make_tenant_encoder(kind: str, profile: AnalyticsProfile,
                         schedule: str) -> AnalyticsEncoder:
    if kind == "histogram":
        return HistogramEncoder(
            0.0, 1.0, bins=profile.bins,
            samples_per_device=profile.values_per_device)
    if kind == "quantile":
        return QuantileEncoder(
            0.0, 1.0, bins=profile.bins,
            samples_per_device=profile.values_per_device)
    if kind == "countmin":
        return CountMinEncoder(
            width=profile.width, depth=profile.depth,
            seed=_sketch_seed(profile.seed, schedule),
            items_per_device=profile.values_per_device)
    if kind == "countsketch":
        return CountSketchEncoder(
            width=profile.width, depth=profile.depth,
            seed=_sketch_seed(profile.seed, schedule),
            items_per_device=profile.values_per_device)
    if kind == "ab":
        return ABMetricEncoder(arms=profile.arms, lo=0.0, hi=1.0,
                               fractional_bits=6)
    raise ValueError(f"unknown analytics kind {kind!r}")


# ---------------------------------------------------------------------------
# seeded device populations (ground truth the verdicts check against)


def _epoch_rng(profile: AnalyticsProfile, tenant_ix: int, epoch: int):
    return np.random.default_rng(
        [int(profile.seed), 0xA11, int(tenant_ix), int(epoch)])


def _epoch_data(kind: str, profile: AnalyticsProfile, tenant_ix: int,
                epoch: int) -> list:
    """Per-device private values for one tenant-epoch — deterministic
    and tenant-distinct (the rng key carries the tenant index), which is
    what makes the cross-tenant verdict meaningful."""
    rng = _epoch_rng(profile, tenant_ix, epoch)
    n, vpd = profile.participants, profile.values_per_device
    if kind in ("histogram", "quantile"):
        # a tenant-shifted bell within [0, 1]: clamping stays rare but
        # the edge-clamp path is not unreachable
        center = 0.35 + 0.06 * (tenant_ix % 5)
        return list(rng.normal(center, 0.15, size=(n, vpd)))
    if kind in ("countmin", "countsketch"):
        # zipf-skewed items over a small universe: natural heavy hitters
        raw = rng.zipf(1.6, size=(n, vpd))
        idx = np.minimum(raw - 1, profile.domain_size - 1)
        return [[f"item{int(i):03d}" for i in row] for row in idx]
    if kind == "ab":
        arms = rng.integers(0, profile.arms, size=n)
        lift = arms / max(1, profile.arms - 1)
        metrics_ = np.clip(rng.normal(0.35 + 0.25 * lift, 0.1), 0.0, 1.0)
        return [(int(a), float(m)) for a, m in zip(arms, metrics_)]
    raise ValueError(f"unknown analytics kind {kind!r}")


def _sketch_truth(values: list) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for row in values:
        for item in row:
            counts[item] = counts.get(item, 0) + 1
    return counts


# ---------------------------------------------------------------------------
# per-kind decoder verdicts


def _check_decode(kind: str, encoder: AnalyticsEncoder, revealed,
                  values: list, profile: AnalyticsProfile) -> dict:
    """Decode the revealed sum and compare against the seeded ground
    truth under the encoder's declared contract. Returns
    ``{"ok", "error", "bound", ...}`` — ``error <= bound`` is the
    verdict (both 0.0 for the exact encoders)."""
    if kind == "histogram":
        block = encoder.decode(revealed, len(values))
        expected = np.zeros(encoder.dim, dtype=np.int64)
        for row in values:
            expected += encoder.contribution(row)
        error = float(np.abs(block["counts"] - expected).max())
        return {"ok": error == 0.0, "error": error, "bound": 0.0,
                "total": block["total"], "contract": "exact"}

    if kind == "quantile":
        qs = (0.1, 0.25, 0.5, 0.75, 0.9)
        decoded = encoder.decode_quantiles(revealed, qs)
        flat = np.sort(np.concatenate(
            [np.clip(np.asarray(row, np.float64), encoder.lo, encoder.hi)
             for row in values]))
        total = flat.size
        worst = 0.0
        for q, est in zip(qs, decoded):
            # ground truth under the decoder's own rank convention
            # (value at rank ceil(qN)): the one-grid-step bound is then
            # a theorem, not a hope — see docs/analytics.md
            rank = min(total - 1, max(0, int(math.ceil(q * total)) - 1))
            worst = max(worst, abs(float(est) - float(flat[rank])))
        bound = encoder.grid_step
        return {"ok": worst <= bound + 1e-12, "error": worst,
                "bound": bound, "contract": "grid",
                "quantiles": {f"p{int(round(q * 100))}": round(float(v), 6)
                              for q, v in zip(qs, decoded)}}

    if kind in ("countmin", "countsketch"):
        truth = _sketch_truth(values)
        total = sum(truth.values())
        f2 = float(sum(c * c for c in truth.values()))
        candidates = [f"item{i:03d}" for i in range(profile.domain_size)]
        if kind == "countmin":
            bound = encoder.error_bound(total)
        else:
            bound = encoder.error_bound(f2)
        underestimates = 0
        violations = 0
        worst = 0.0
        for item in candidates:
            true = truth.get(item, 0)
            est = encoder.estimate(revealed, item)
            err = float(est) - float(true)
            worst = max(worst, abs(err))
            if kind == "countmin":
                if err < 0:
                    underestimates += 1  # breaks overestimate-only: hard fail
                if err > bound:
                    violations += 1
            elif abs(err) > bound:
                violations += 1
        allowed = _delta_allowance(len(candidates), encoder.delta)
        # heavy hitters: every item heavy ENOUGH that the error bound
        # cannot hide it must be extracted (no false negatives)
        hits = encoder.heavy_hitters(revealed, candidates,
                                     profile.hh_threshold, total)
        hit_items = {item for item, _ in hits}
        must_find = [item for item, c in truth.items()
                     if c >= profile.hh_threshold * total + bound]
        missed = [item for item in must_find if item not in hit_items]
        ok = (underestimates == 0 and violations <= allowed
              and not missed)
        return {"ok": ok, "error": worst, "bound": bound,
                "contract": "eps-delta",
                "eps_violations": violations, "delta_allowance": allowed,
                "underestimates": (underestimates
                                   if kind == "countmin" else None),
                "stream_total": total, "f2": f2,
                "heavy_hitters": [[item, round(float(est), 2)]
                                  for item, est in hits[:8]],
                "heavy_missed": missed or None}

    if kind == "ab":
        block = encoder.decode(revealed, len(values))
        worst = 0.0
        ok = True
        for arm in range(encoder.arms):
            mine = [m for a, m in values if a == arm]
            decoded = block["arms"][f"arm{arm}"]
            if decoded["count"] != len(mine):
                ok = False
                continue
            if not mine:
                continue
            q = np.array([encoder.quantize(m) for m in mine], np.float64)
            expect_mean = q.mean() / encoder.scale
            expect_var = max(0.0, float(np.mean(q * q) - q.mean() ** 2)) \
                / (encoder.scale ** 2)
            worst = max(worst,
                        abs(decoded["mean"] - expect_mean),
                        abs(decoded["variance"] - expect_var))
        # exact in the quantized domain: only float roundoff remains
        bound = 1e-9
        return {"ok": ok and worst <= bound, "error": worst,
                "bound": bound, "contract": "exact",
                "arms": block["arms"]}

    raise ValueError(f"unknown analytics kind {kind!r}")


# ---------------------------------------------------------------------------
# the drill


def run_analytics(profile: AnalyticsProfile) -> dict:
    """Run the analytics scenario; returns the BENCH-style report.
    Requires libsodium (real participant crypto, like every serving
    drill)."""
    from ..client import SdaClient
    from ..crypto import MemoryKeystore, sodium
    from ..fields import numtheory
    from ..http import SdaHttpClient, SdaHttpServer
    from ..protocol import (
        Aggregation,
        AggregationId,
        FullMasking,
        PackedShamirSharing,
        ServerError,
        SodiumEncryption,
    )
    from ..server import new_jsonfs_server, new_memory_server, \
        new_sqlite_server
    from ..service.scheduler import (
        RoundScheduler,
        ScheduleSpec,
        epoch_aggregation_id,
    )

    if not sodium.available():
        raise RuntimeError("the analytics drill needs libsodium "
                           "(real-crypto rounds)")
    if profile.participants < 2:
        raise ValueError("the analytics drill needs >= 2 devices "
                         "per tenant")
    if profile.epochs < 1:
        raise ValueError("epochs must be >= 1")
    kinds = list(profile.kinds)
    for kind in kinds:
        if kind not in KINDS:
            raise ValueError(f"unknown analytics kind {kind!r} "
                             f"(kinds: {', '.join(KINDS)})")
    tenant_count = profile.tenants if profile.tenants is not None \
        else len(kinds)
    if tenant_count < 1:
        raise ValueError("tenants must be >= 1")

    obs.reset_all()
    from ..obs import devprof

    devprof.install_monitoring()  # no-op without jax: a no-JAX drill

    # -- field sizing: the FL discipline (participants * m < p), then
    # every tenant's encoder is BOUND through the shared headroom rule —
    # a sketch or A/B lane that cannot fit is a FieldSizingError here,
    # before any service spins up
    t, p, w2, w3 = numtheory.generate_packed_params(
        3, 8, profile.modulus_bits)
    scheme = PackedShamirSharing(3, 8, t, p, w2, w3)
    m_bits = min(24, (p // max(2, profile.participants)).bit_length() - 1)
    if m_bits < 8:
        raise ValueError(
            f"{profile.participants} participants leave no modulus "
            f"headroom under the {profile.modulus_bits}-bit sharing "
            "prime; raise --analytics-modulus-bits")
    modulus = 1 << m_bits

    tenant_kinds = [kinds[i % len(kinds)] for i in range(tenant_count)]
    encoders: List[AnalyticsEncoder] = []
    for tenant_ix, kind in enumerate(tenant_kinds):
        schedule = f"analytics-{kind}-{tenant_ix}"
        encoder = _make_tenant_encoder(kind, profile, schedule)
        encoder.bind(modulus, profile.participants)
        encoders.append(encoder)

    # -- service plane (the FL/soak spelling) ------------------------------
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
        fleet = Fleet(profile.fleet, backend,
                      extra_args=["--job-lease", str(profile.lease_seconds),
                                  "--statusz"],
                      node_prefix="ana-w")
        fleet.start()
        ring = fleet.ring()
        server = (new_sqlite_server(profile.store_path)
                  if profile.store == "sqlite"
                  else new_jsonfs_server(profile.store_path)).server
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
        server = service_impl.server
        if profile.http:
            http_server = SdaHttpServer(service_impl, bind="127.0.0.1:0")
            http_server.start_background()

    proxies: Dict[object, object] = {}

    def client_service(agent_key):
        if fleet is None and http_server is None:
            return service_impl
        node = ring.node_for(str(agent_key)) if ring is not None else None
        proxy = proxies.get(node)
        if proxy is None:
            address = (fleet.addresses[node] if fleet is not None
                       else http_server.address)
            proxy = SdaHttpClient(address, token="analytics-drill-token",
                                  max_retries=16, backoff_base=0.01,
                                  backoff_cap=0.25,
                                  deadline=profile.timeout_s)
            proxies[node] = proxy
        return proxy

    def new_client():
        keystore = MemoryKeystore()
        agent = SdaClient.new_agent(keystore)
        client = SdaClient(agent, keystore, client_service(agent.id),
                           device=profile.device)
        client.upload_agent()
        return client

    deadline = time.monotonic() + profile.timeout_s

    def remaining() -> float:
        return max(1.0, deadline - time.monotonic())

    failures: List[str] = []
    leaks = 0
    exact_rounds = 0
    bounds_ok_rounds = 0
    rounds_run = 0
    drill_wall = 0.0

    try:
        with obs.span("analytics.run", attributes={
                "kinds": ",".join(tenant_kinds),
                "tenants": tenant_count,
                "participants": profile.participants,
                "epochs": profile.epochs, "seed": profile.seed}):
            # -- shared clerk pool + per-tenant recipients/devices --------
            clerks = []
            committee_policy = []
            for _ in range(scheme.share_count):
                clerk = new_client()
                key_id = clerk.new_encryption_key()
                clerk.upload_encryption_key(key_id)
                clerks.append(clerk)
                committee_policy.append([str(clerk.agent.id), str(key_id)])

            tenants: List[dict] = []
            for tenant_ix, kind in enumerate(tenant_kinds):
                encoder = encoders[tenant_ix]
                recipient = new_client()
                recipient_key = recipient.new_encryption_key()
                recipient.upload_encryption_key(recipient_key)
                template = Aggregation(
                    id=AggregationId.random(),  # replaced per epoch
                    title="analytics", vector_dimension=encoder.dim,
                    modulus=modulus,
                    recipient=recipient.agent.id,
                    recipient_key=recipient_key,
                    masking_scheme=FullMasking(modulus),
                    committee_sharing_scheme=scheme,
                    recipient_encryption_scheme=SodiumEncryption(),
                    committee_encryption_scheme=SodiumEncryption(),
                ).to_obj()
                spec = ScheduleSpec(
                    name=f"analytics-{kind}-{tenant_ix}",
                    period_s=profile.period_s,
                    template=template, committee=committee_policy,
                    max_pipelined=2)
                devices = [new_client()
                           for _ in range(profile.participants)]
                tenants.append({
                    "ix": tenant_ix, "kind": kind, "encoder": encoder,
                    "recipient": recipient, "spec": spec,
                    "devices": devices, "exact": 0, "bounds": 0,
                    "admitted": [], "checks": [],
                    "encode_s": 0.0, "decode_s": 0.0,
                })

            scheduler = RoundScheduler(server,
                                       [tenant["spec"]
                                        for tenant in tenants])
            scheduler.tick_once()  # install epoch 0 for every schedule

            t_drill0 = time.perf_counter()
            for epoch in range(profile.epochs):
                rounds_run_this = 0
                with obs.span("analytics.epoch",
                              attributes={"epoch": epoch}):
                    # -- encode + upload: the ONLY analytics-specific
                    # client-side act in the round
                    for tenant in tenants:
                        encoder = tenant["encoder"]
                        aggregation_id = epoch_aggregation_id(
                            tenant["spec"].name, epoch)
                        values = _epoch_data(tenant["kind"], profile,
                                             tenant["ix"], epoch)
                        expected = np.zeros(encoder.dim, dtype=np.int64)
                        t0 = time.perf_counter()
                        uploads = []
                        for value in values:
                            expected += encoder.contribution(value)
                            uploads.append(encoder.encode(value))
                        tenant["encode_s"] += time.perf_counter() - t0
                        for device, upload in zip(tenant["devices"],
                                                  uploads):
                            try:
                                device.participate(upload, aggregation_id)
                            except ServerError as e:
                                failures.append(
                                    f"{tenant['spec'].name} epoch {epoch}: "
                                    f"upload failed: {e}")
                        tenant["_values"] = values
                        tenant["_expected"] = expected

                    # -- close the epoch: mint e+1 (freezing e) via the
                    # cadence-gated tick; the final epoch closes without
                    # minting a dangling successor
                    if epoch + 1 < profile.epochs:
                        scheduler.tick_once()
                        while time.monotonic() < deadline:
                            still = [
                                tenant for tenant in tenants
                                if (server.aggregation_store.get_round_state(
                                    epoch_aggregation_id(
                                        tenant["spec"].name, epoch))
                                    or {}).get("state") == "collecting"]
                            if not still:
                                break
                            time.sleep(profile.period_s)
                            scheduler.tick_once()
                    else:
                        for tenant in tenants:
                            scheduler.close_epoch(tenant["spec"], epoch)

                    # -- clerk pump + reveal + verdicts -------------------
                    pending = list(tenants)
                    while pending and time.monotonic() < deadline:
                        for clerk in clerks:
                            try:
                                clerk.run_chores(-1)
                            except ServerError:
                                metrics.count("analytics.clerk.transient")
                        still = []
                        for tenant in pending:
                            recipient = tenant["recipient"]
                            aggregation_id = epoch_aggregation_id(
                                tenant["spec"].name, epoch)
                            try:
                                status = (recipient.service
                                          .get_aggregation_status(
                                              recipient.agent,
                                              aggregation_id))
                            except ServerError:
                                metrics.count("analytics.status.transient")
                                still.append(tenant)
                                continue
                            if (status is None or not status.snapshots
                                    or status.snapshots[0]
                                    .number_of_clerking_results
                                    < scheme.share_count):
                                still.append(tenant)
                                continue
                            output = recipient.await_result(
                                aggregation_id, deadline=remaining())
                            revealed = output.positive().values
                            expected_mod = np.mod(tenant["_expected"],
                                                  modulus)
                            exact = bool((revealed == expected_mod).all())
                            tenant["exact"] += int(exact)
                            exact_rounds += int(exact)
                            if not exact:
                                failures.append(
                                    f"{tenant['spec'].name} epoch {epoch}: "
                                    "inexact reveal")
                            admitted = status.number_of_participations
                            tenant["admitted"].append(admitted)
                            if admitted != profile.participants:
                                leaks += 1
                                failures.append(
                                    f"{tenant['spec'].name} epoch {epoch}: "
                                    f"{admitted} admitted participations "
                                    f"(expected {profile.participants})")
                            t0 = time.perf_counter()
                            check = _check_decode(
                                tenant["kind"], tenant["encoder"],
                                revealed, tenant["_values"], profile)
                            tenant["decode_s"] += time.perf_counter() - t0
                            tenant["bounds"] += int(check["ok"])
                            bounds_ok_rounds += int(check["ok"])
                            if not check["ok"]:
                                failures.append(
                                    f"{tenant['spec'].name} epoch {epoch}: "
                                    f"decoder error {check['error']:.6g} "
                                    f"breaks the {check['contract']} "
                                    f"contract (bound {check['bound']:.6g})")
                            tenant["checks"].append(
                                {"epoch": epoch, **{
                                    k: v for k, v in check.items()
                                    if k != "arms"}})
                            rounds_run_this += 1
                        pending = still
                        if pending:
                            time.sleep(0.02)
                    if pending:
                        for tenant in pending:
                            failures.append(
                                f"{tenant['spec'].name} epoch {epoch}: "
                                "timed out")
                        rounds_run += rounds_run_this
                        break
                rounds_run += rounds_run_this
            drill_wall = time.perf_counter() - t_drill0
    finally:
        drain_summaries = None
        if fleet is not None:
            drain_summaries = fleet.stop()
        if http_server is not None:
            http_server.shutdown()
        for proxy in proxies.values():
            proxy.close()

    counters = metrics.counter_report()
    rounds_expected = tenant_count * profile.epochs
    total_values = sum(
        len(tenant["checks"]) * profile.participants
        * tenant["encoder"].values_per_device
        for tenant in tenants)
    values_per_sec = total_values / drill_wall if drill_wall else 0.0
    report = {
        "metric": (f"secure analytics throughput ({tenant_count} tenants: "
                   f"{'+'.join(tenant_kinds)}, {profile.participants} "
                   f"devices, {profile.epochs} epochs, {profile.store} "
                   "store"
                   + (", HTTP" if http_server is not None else "")
                   + (f", fleet x{profile.fleet}" if profile.fleet else "")
                   + ")"),
        "value": round(values_per_sec, 1),
        "unit": "values/s",
        "platform": "cpu",
        "seed": profile.seed,
        "mode": ("analytics over "
                 + (f"fleet x{profile.fleet}" if fleet is not None
                    else "HTTP" if http_server is not None
                    else "in-process")
                 + f" ({profile.store} store)"),
        "kinds": tenant_kinds,
        "tenants": tenant_count,
        "participants": profile.participants,
        "epochs": profile.epochs,
        "values_per_device": profile.values_per_device,
        "values_total": total_values,
        "modulus": modulus,
        "sharing": "packed-shamir 8",
        "drill_seconds": round(drill_wall, 4),
        "rounds": rounds_expected,
        "rounds_run": rounds_run,
        "rounds_exact": exact_rounds,
        "exact": (exact_rounds == rounds_expected
                  and rounds_run == rounds_expected and not leaks),
        "rounds_within_bounds": bounds_ok_rounds,
        "bounds_ok": bounds_ok_rounds == rounds_expected,
        "leaks": leaks,
        "per_tenant": {
            tenant["spec"].name: {
                "kind": tenant["kind"],
                "encoder": repr(tenant["encoder"]),
                "contract": tenant["encoder"].error_contract,
                "dim": tenant["encoder"].dim,
                "max_abs": tenant["encoder"].max_abs,
                "headroom_margin": tenant["encoder"].headroom_margin,
                "epochs_exact": tenant["exact"],
                "epochs_within_bounds": tenant["bounds"],
                "admitted": tenant["admitted"],
                "encode_s": round(tenant["encode_s"], 4),
                "decode_s": round(tenant["decode_s"], 4),
                "checks": tenant["checks"],
            }
            for tenant in tenants
        },
        "scheduler": {
            "installed": counters.get("service.schedule.installed", 0),
            "epochs_minted": counters.get(
                "service.schedule.epoch_minted", 0),
            "epochs_closed": counters.get(
                "service.schedule.epoch_closed", 0),
        },
        "client_failures": len(failures),
        "failure_samples": failures[:5] or None,
        "counters": {
            k: v for k, v in counters.items()
            if k.startswith(("analytics.", "service.schedule.",
                             "server.round.", "server.participation."))
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
