"""Transport-neutral core shared by BOTH HTTP planes.

The serving plane has two transports — the thread-per-connection
``SdaHttpServer`` (``http/server.py``) and the asyncio event-loop
``SdaAsyncHttpServer`` (``http/aserver.py``) — that must stay
*semantically identical*: same route table, same error mapping, same
admission ordering, same chaos failpoint names, same long-poll contract,
same ``/statusz`` document. Everything that could drift between them
lives here exactly once:

- the route-template registry and ``route_label`` (latency-histogram
  cardinality bound),
- ``dispatch``: the whole route table, auth, hot-body codec negotiation
  and the exception->status mapping, operating on a small transport
  adapter (``rx``) and returning a :class:`Reply` for the transport to
  write,
- the long-poll clerking contract (``GET /v1/clerking-jobs?wait=S``):
  wait clamping, the park marker, the blocking park loop the threaded
  plane uses, and the shared empty/job reply shapes,
- the ``/statusz`` document builder and the drain summary, so
  fleet-mode counter aggregation reads the same fields off either plane.

A transport adapter (``rx``) provides: ``method``, ``path``, ``query``
(parse_qs dict), ``header(name)``, ``json_body()``,
``hot_body(expect_tag, from_obj)``, ``accepts_bin()``,
``credentials()``, ``agent_key()``.
"""

from __future__ import annotations

import base64
import logging
import re
import time
from typing import Optional

from .. import chaos, obs
from ..protocol import (
    Agent,
    AgentId,
    Aggregation,
    AggregationId,
    ClerkingResult,
    Committee,
    EncryptionKeyId,
    InvalidCredentials,
    InvalidRequest,
    NotFound,
    Participation,
    ParticipationConflict,
    PermissionDenied,
    Profile,
    SdaError,
    Snapshot,
    SnapshotId,
    StoreUnavailable,
    signed_encryption_key_from_obj,
)
from ..protocol import bincodec
from ..server import auth_token
from ..utils import metrics

log = logging.getLogger(__name__)

_ID = r"[0-9a-fA-F-]{36}"

#: Every route template the dispatcher matches, ids collapsed to ``{id}``.
#: Latency histograms are keyed by template (low cardinality by
#: construction); anything else becomes ``unmatched`` so a scanner probing
#: random paths cannot grow the histogram registry without bound.
ROUTE_TEMPLATES = frozenset({
    "/v1/ping",
    "/v1/agents/me",
    "/v1/agents/{id}",
    "/v1/agents/me/profile",
    "/v1/agents/{id}/profile",
    "/v1/agents/me/keys",
    "/v1/agents/any/keys/{id}",
    "/v1/aggregations",
    "/v1/aggregations/{id}",
    "/v1/aggregations/{id}/committee/suggestions",
    "/v1/aggregations/implied/committee",
    "/v1/aggregations/{id}/committee",
    "/v1/aggregations/participations",
    "/v1/aggregations/{id}/status",
    "/v1/aggregations/{id}/round",
    "/v1/aggregations/implied/snapshot",
    "/v1/aggregations/any/jobs",
    "/v1/clerking-jobs",
    "/v1/aggregations/implied/jobs/{id}/result",
    "/v1/aggregations/{id}/snapshots/{id}/result",
    "/metrics",
    "/statusz",
})
_ID_RE = re.compile(_ID)
#: Charset a client-supplied X-Request-Id / X-SDA-Tenant must satisfy to
#: be used (response-header injection hygiene, bucket-key hygiene).
REQUEST_ID_RE = re.compile(r"[A-Za-z0-9._-]+")


def route_label(method: str, path: str) -> str:
    """``GET /v1/agents/3f2a... -> "GET:/v1/agents/{id}"`` — the
    per-route key under ``http.latency.<route>``."""
    template = _ID_RE.sub("{id}", path)
    if template not in ROUTE_TEMPLATES:
        return f"{method}:unmatched"
    return f"{method}:{template}"


# ---------------------------------------------------------------------------
# Long-poll contract knobs — server-layer policy (they bound the
# in-process ``await_clerking_job`` seam too), re-exported here for the
# transports. See server/wakeup.py.

from ..server.wakeup import (  # noqa: E402
    LONGPOLL_MAX_S,
    LONGPOLL_TICK_S,
    clamp_wait,
    longpoll_tick,
)


# ---------------------------------------------------------------------------
# Request-identity hygiene — shared by both transport adapters so the
# planes' admission keys and echoed headers cannot drift.

def parse_basic_auth(header_value) -> Optional[tuple]:
    """``Authorization: Basic ...`` -> ``(AgentId, token)``, or None for
    anything missing or malformed (the dispatcher decides the 401)."""
    header = header_value or ""
    if not header.startswith("Basic "):
        return None
    try:
        decoded = base64.b64decode(header[6:]).decode("utf-8")
        agent_id, _, token = decoded.partition(":")
        return AgentId(agent_id), token
    except (ValueError, UnicodeDecodeError):
        return None


def tenant_key(header_value) -> Optional[str]:
    """Per-tenant admission key from the CLAIMED ``X-SDA-Tenant`` header
    (unverified, same trust model as the agent key): token charset +
    bounded length so a hostile value cannot grow the bucket dict with
    junk or smuggle bytes."""
    claimed = header_value or ""
    if claimed and len(claimed) <= 64 and REQUEST_ID_RE.fullmatch(claimed):
        return claimed
    return None


def parse_content_length(header_value) -> int:
    """``Content-Length`` -> byte count, or -1 for anything unusable
    (garbage, negative). One parser for every call site on both planes:
    a negative length fed to a blocking read means read-to-EOF, the
    thread-pinning stall class each caller must refuse in its own way
    (400 pre-dispatch, sever on the drain path)."""
    try:
        length = int(header_value or 0)
    except (TypeError, ValueError):
        return -1
    return length if length >= 0 else -1


def request_id(header_value) -> str:
    """Correlation id: reuse the client's ``X-Request-Id``, mint one
    else. The value is echoed into a response header, so a hostile one
    must not smuggle CRLFs or unbounded bytes: token charset, capped
    length."""
    claimed = header_value or ""
    if claimed and len(claimed) <= 64 and REQUEST_ID_RE.fullmatch(claimed):
        return claimed
    return obs.new_request_id()


# ---------------------------------------------------------------------------
# Replies

class Reply:
    """A fully-decided response for the transport to write."""

    __slots__ = ("status", "obj", "raw", "content_type", "headers",
                 "resource_not_found", "retry_after", "close", "drop",
                 "park", "span_attrs")

    def __init__(self, status: int = 200, obj=None, *, raw=None,
                 content_type: str = "application/json", headers=None,
                 resource_not_found: bool = False, retry_after=None,
                 close: bool = False, drop: bool = False, park=None,
                 span_attrs=None):
        self.status = status
        self.obj = obj
        self.raw = raw
        self.content_type = content_type
        self.headers = headers
        self.resource_not_found = resource_not_found
        self.retry_after = retry_after
        #: ask the transport to close the connection after replying
        self.close = close
        #: chaos "drop": sever the connection WITHOUT any response bytes
        self.drop = drop
        #: long-poll park marker (ParkForJob): the transport must wait
        #: and re-poll instead of writing this reply
        self.park = park
        self.span_attrs = span_attrs


class ParkForJob:
    """A long-poll that found no job on the immediate check: park until
    wakeup/tick/drain/deadline, re-polling through the service seam."""

    __slots__ = ("caller", "accepts_bin", "give_up_at")

    def __init__(self, caller: Agent, accepts_bin: bool, give_up_at: float):
        self.caller = caller
        self.accepts_bin = accepts_bin
        self.give_up_at = give_up_at


def option_reply(obj, headers=None) -> Reply:
    if obj is None:
        return Reply(404, {"error": "resource not found"},
                     resource_not_found=True)
    return Reply(200, obj.to_obj(), headers=headers)


def job_reply(job, accepts_bin: bool) -> Reply:
    """The clerking-job poll response, shared by the legacy immediate
    route and the long-poll route on both planes: empty-queue answers the
    ``X-Resource-Not-Found`` 404 (client maps it to None), a job rides
    the negotiated codec plus the ``X-Trace-Context`` link the round's
    snapshot recorded at enqueue time."""
    headers = None
    if job is not None:
        link = obs.job_link(str(job.id))
        if link is not None:
            headers = {obs.TRACE_CONTEXT_HEADER: obs.format_traceparent(link)}
    if job is not None and accepts_bin:
        metrics.count("http.codec.bin.out")
        return Reply(200, raw=bincodec.encode_clerking_job(job),
                     content_type=bincodec.CONTENT_TYPE, headers=headers)
    return option_reply(job, headers=headers)


def draining_reply() -> Reply:
    """503 + ``Connection: close``: what a draining worker answers — both
    to fresh requests on established keep-alive connections and to
    parked long-polls it wakes (docs/scaling.md drain contract)."""
    return Reply(503, {"error": "draining"}, retry_after=1.0, close=True,
                 headers={"Connection": "close"})


def error_reply(e: BaseException) -> Reply:
    """The exception -> status mapping, shared by the dispatch table and
    the park re-poll loops (which run outside dispatch's try block)."""
    if isinstance(e, InvalidCredentials):
        return Reply(401, {"error": str(e)})
    if isinstance(e, PermissionDenied):
        return Reply(403, {"error": str(e)})
    if isinstance(e, (InvalidRequest, ValueError, KeyError, TypeError)):
        return Reply(400, {"error": f"{type(e).__name__}: {e}"})
    if isinstance(e, NotFound):
        return Reply(404, {"error": str(e)}, resource_not_found=True)
    if isinstance(e, ParticipationConflict):
        # exactly-once ingestion rejected an equivocating upload: 409
        # is TERMINAL for the retrying transport (re-sending the same
        # conflicting bytes can never succeed), unlike the transient
        # 5xx/429 family. No stack trace — detection is the feature
        # working, and a buggy device would flood the log.
        return Reply(409, {"error": str(e)})
    if isinstance(e, StoreUnavailable):
        # breaker-open shed (server/breaker.py): the store was never
        # touched — 503 + Retry-After, same contract as admission
        # sheds, so the retrying transport backs off and resubmits.
        # No stack trace: an open breaker shedding is WORKING, and a
        # brownout would otherwise flood the log at request rate.
        metrics.count("http.store_unavailable")
        return Reply(503, {"error": str(e)}, retry_after=e.retry_after,
                     span_attrs={"store_unavailable": True})
    if isinstance(e, SdaError):
        log.exception("server error")
        return Reply(500, {"error": str(e)})
    log.exception("unexpected server error")
    return Reply(500, {"error": f"{type(e).__name__}: {e}"})


def preroute_reply(server, method: str, path: str) -> Optional[Reply]:
    """The pre-dispatch decisions both planes must make identically:
    a draining worker turns every fresh request away before any
    auth/store work, and the observability endpoints (``/metrics``,
    ``/statusz``) answer exempt from admission and tracing (scrapes must
    land during the exact overload they diagnose; a scrape loop would
    churn the span ring buffer). Returns None for ordinary requests.
    ``server`` is the plane object (``SdaHttpServer`` /
    ``SdaAsyncHttpServer``): same attribute names on both."""
    if getattr(server, "draining", False):
        metrics.count("http.drain.rejected")
        return draining_reply()
    if method == "GET" and path == "/metrics":
        if not getattr(server, "metrics_enabled", False):
            return Reply(404, {"error": "metrics endpoint disabled "
                                        "(sdad --metrics)"})
        node_id = getattr(server, "node_id", None)
        return Reply(
            200, raw=metrics.prometheus_text(
                labels={"node_id": node_id} if node_id else None
            ).encode("utf-8"),
            content_type="text/plain; version=0.0.4; charset=utf-8")
    if method == "GET" and path == "/statusz":
        statusz = getattr(server, "statusz_fn", None)
        if statusz is None:
            return Reply(404, {"error": "statusz endpoint disabled "
                                        "(sdad --statusz)"})
        return Reply(200, statusz())
    return None


# ---------------------------------------------------------------------------
# Dispatch — the single route table

def dispatch(service, rx) -> Reply:
    """Route one request through the service seam; never raises for
    request-level trouble (the mapping above decides the status)."""
    try:
        return _dispatch_inner(service, rx)
    except Exception as e:  # mapped, connection survives; KeyboardInterrupt
        # and SystemExit propagate so shutdown isn't answered as a 500
        return error_reply(e)


def _authenticate(service, rx) -> Agent:
    creds = rx.credentials()
    if creds is None:
        raise InvalidCredentials("missing Basic auth")
    return service.server.check_auth_token(auth_token(*creds))


def _create_agent(service, rx) -> Reply:
    """Agent self-registration also records the presented token
    (lib.rs:192-201)."""
    creds = rx.credentials()
    if creds is None:
        raise InvalidCredentials("agent creation requires Basic auth")
    agent_id, token = creds
    if not token:
        raise InvalidCredentials("empty token")
    agent = Agent.from_obj(rx.json_body())
    if agent.id != agent_id:
        raise PermissionDenied("auth username must match agent id")
    # record-or-verify the token before the ACL'd create
    try:
        known = service.server.check_auth_token(auth_token(agent_id, token))
    except InvalidCredentials:
        if service.server.auth_tokens_store.get_auth_token(agent_id) \
                is not None:
            raise  # token exists but differs: reject
        known = None
    if known is None:
        service.server.upsert_auth_token(auth_token(agent_id, token))
    service.create_agent(agent, agent)
    return Reply(201)


def _dispatch_inner(service, rx) -> Reply:
    method, path, query = rx.method, rx.path, rx.query

    def m(pattern):
        return re.fullmatch(pattern, path)

    # failpoint: transient transport trouble BEFORE any service work —
    # injected 500s, response delays, or hard connection drops. The
    # claimed agent id rides the ctx so a `partition` spec can sever
    # exactly one agent<->server pair (agent=<id>)
    action = chaos.evaluate(
        "http.server.request",
        ctx={"agent": rx.agent_key()} if chaos.registry.active() else None)
    if action is not None:
        if action.kind == "error":
            return Reply(500, {"error": str(action.exc)})
        if action.kind == "drop":
            return Reply(drop=True)
        time.sleep(action.delay_s)  # "delay": proceed after the stall

    if method == "GET" and path == "/v1/ping":
        return Reply(200, service.ping().to_obj())

    if method == "POST" and path == "/v1/agents/me":
        return _create_agent(service, rx)

    caller = _authenticate(service, rx)

    if r := m(rf"/v1/agents/({_ID})/profile"):
        if method == "GET":
            return option_reply(
                service.get_profile(caller, AgentId(r.group(1))))
    if method == "POST" and path == "/v1/agents/me/profile":
        profile = Profile.from_obj(rx.json_body())
        service.upsert_profile(caller, profile)
        return Reply(200)
    if r := m(rf"/v1/agents/any/keys/({_ID})"):
        if method == "GET":
            return option_reply(
                service.get_encryption_key(
                    caller, EncryptionKeyId(r.group(1))))
    if method == "POST" and path == "/v1/agents/me/keys":
        key = signed_encryption_key_from_obj(rx.json_body())
        service.create_encryption_key(caller, key)
        return Reply(201)
    if r := m(rf"/v1/agents/({_ID})"):
        if method == "GET":
            return option_reply(
                service.get_agent(caller, AgentId(r.group(1))))

    if path == "/v1/aggregations" and method == "GET":
        title = query.get("title", [None])[0]
        recipient = query.get("recipient", [None])[0]
        ids = service.list_aggregations(
            caller,
            filter=title,
            recipient=None if recipient is None else AgentId(recipient),
        )
        return Reply(200, [str(i) for i in ids])
    if path == "/v1/aggregations" and method == "POST":
        agg = Aggregation.from_obj(rx.json_body())
        service.create_aggregation(caller, agg)
        return Reply(201)
    if r := m(rf"/v1/aggregations/({_ID})/committee/suggestions"):
        if method == "GET":
            candidates = service.suggest_committee(
                caller, AggregationId(r.group(1)))
            return Reply(200, [c.to_obj() for c in candidates])
    if path == "/v1/aggregations/implied/committee" and method == "POST":
        committee = Committee.from_obj(rx.json_body())
        service.create_committee(caller, committee)
        return Reply(201)
    if r := m(rf"/v1/aggregations/({_ID})/committee"):
        if method == "GET":
            return option_reply(
                service.get_committee(caller, AggregationId(r.group(1))))
    if path == "/v1/aggregations/participations" and method == "POST":
        participation = rx.hot_body(
            bincodec.TAG_PARTICIPATION, Participation.from_obj)
        service.create_participation(caller, participation)
        return Reply(201)
    if r := m(rf"/v1/aggregations/({_ID})/status"):
        if method == "GET":
            return option_reply(
                service.get_aggregation_status(
                    caller, AggregationId(r.group(1))))
    if r := m(rf"/v1/aggregations/({_ID})/round"):
        if method == "GET":
            # round lifecycle state (server/lifecycle.py): what a
            # blocking client polls instead of result_ready alone —
            # terminal failed/expired states carry the diagnosis
            return option_reply(
                service.get_round_status(caller, AggregationId(r.group(1))))
    if path == "/v1/aggregations/implied/snapshot" and method == "POST":
        snap = Snapshot.from_obj(rx.json_body())
        service.create_snapshot(caller, snap)
        return Reply(201)
    if path == "/v1/aggregations/any/jobs" and method == "GET":
        # the legacy immediate-return poll: old peers and clerk_once
        job = service.get_clerking_job(caller, caller.id)
        return job_reply(job, rx.accepts_bin())
    if path == "/v1/clerking-jobs" and method == "GET":
        # long-poll job delivery (docs/http.md): try once; empty + a
        # positive wait parks the request on the in-process job wakeup
        # (the transport decides HOW to park — a blocked thread on the
        # threaded plane, a coroutine await on the async plane)
        raw_wait = query.get("wait", ["0"])[0]
        try:
            wait_s = clamp_wait(float(raw_wait))
        except (TypeError, ValueError):
            raise InvalidRequest(f"malformed wait={raw_wait!r}")
        job = service.get_clerking_job(caller, caller.id)
        if job is not None or wait_s <= 0:
            return job_reply(job, rx.accepts_bin())
        return Reply(park=ParkForJob(
            caller, rx.accepts_bin(), time.monotonic() + wait_s))
    if r := m(rf"/v1/aggregations/implied/jobs/({_ID})/result"):
        if method == "POST":
            result = rx.hot_body(
                bincodec.TAG_CLERKING_RESULT, ClerkingResult.from_obj)
            if str(result.job) != r.group(1).lower():
                raise InvalidRequest("result job id does not match route")
            service.create_clerking_result(caller, result)
            return Reply(201)
    if r := m(rf"/v1/aggregations/({_ID})/snapshots/({_ID})/result"):
        if method == "GET":
            return option_reply(
                service.get_snapshot_result(
                    caller, AggregationId(r.group(1)),
                    SnapshotId(r.group(2))))
    if r := m(rf"/v1/aggregations/({_ID})"):
        if method == "GET":
            return option_reply(
                service.get_aggregation(caller, AggregationId(r.group(1))))
        if method == "DELETE":
            service.delete_aggregation(caller, AggregationId(r.group(1)))
            return Reply(200)

    return Reply(404, {"error": "no such route"})


# ---------------------------------------------------------------------------
# Park loops

def poll_parked_job(service, park: ParkForJob) -> Optional[Reply]:
    """One re-poll of a parked long-poll: the final reply, or None to
    keep waiting. Exceptions map exactly like dispatch-time ones."""
    try:
        job = service.get_clerking_job(park.caller, park.caller.id)
    except Exception as e:
        return error_reply(e)
    if job is not None:
        return job_reply(job, park.accepts_bin)
    if time.monotonic() >= park.give_up_at:
        return job_reply(None, park.accepts_bin)
    return None


def park_tick(service, fleet_peers) -> Optional[float]:
    """How often a parked long-poll must re-check the store, or None for
    a pure event wait. The tick exists to cover arrivals the in-process
    wakeup cannot see: a fleet peer's fan-out (notifies ITS process) and
    lease expiry (time-based, no event). A single-worker deployment with
    leasing off has neither — its parks can sleep on the subscription
    alone, so 10k parked clerks cost zero store re-scans instead of
    re-polling at the tick."""
    single_worker = fleet_peers is None or fleet_peers <= 1
    if single_worker and not getattr(
            getattr(service, "server", None), "clerking_lease_seconds", 0):
        return None
    return longpoll_tick()


def blocking_park(service, park: ParkForJob, draining,
                  fleet_peers=None) -> Reply:
    """The threaded plane's park: block THIS request thread on the job
    wakeup (re-checking on the tick for cross-worker/lease-expiry
    arrivals) until a job lands, the wait expires, or the worker starts
    draining — a draining worker wakes parked clerks with
    503 + ``Connection: close`` instead of holding them to timeout."""
    wakeup = getattr(getattr(service, "server", None), "job_wakeup", None)
    tick = park_tick(service, fleet_peers)
    if wakeup is None:
        tick = longpoll_tick()  # no wakeup to park on: tick IS the poll
    key = str(park.caller.id)
    while True:
        if draining():
            metrics.count("http.drain.longpoll_woken")
            return draining_reply()
        sub = wakeup.subscribe(key) if wakeup is not None else None
        try:
            reply = poll_parked_job(service, park)
            if reply is not None:
                return reply
            remaining = max(0.0, park.give_up_at - time.monotonic())
            timeout = remaining if tick is None else min(tick, remaining)
            if sub is not None:
                sub.wait(timeout)
            else:
                time.sleep(timeout)
        finally:
            if sub is not None:
                wakeup.unsubscribe(sub)


# ---------------------------------------------------------------------------
# Shared /statusz + drain summary (satellite: extract, don't duplicate —
# fleet-mode counter aggregation reads these fields off either plane)

def build_statusz(service, *, node_id, admission, started_at, status_counts,
                  plane: str) -> dict:
    """The ``GET /statusz`` payload: liveness + capacity + device-perf
    state in one scrape (served only when the endpoint is enabled —
    like ``/metrics`` it reveals traffic shape). ``plane`` names the
    serving transport ("threaded" / "async")."""
    from ..obs import devprof
    from ..server import health as _health
    from ..server import lifecycle as _lifecycle

    gauges = metrics.gauge_report("http.inflight")
    # unwrap a breaker proxy: the page names the BACKEND, not the wrap
    agents_store = getattr(service.server.agents_store, "_inner",
                           service.server.agents_store)
    wakeup = getattr(service.server, "job_wakeup", None)
    pickup = metrics.histogram_report("server.job.pickup").get(
        "server.job.pickup")
    return {
        "node_id": node_id,
        "plane": plane,
        "fleet": {
            "peers": metrics.gauge_report("fleet.peers").get(
                "fleet.peers", 1 if node_id else 0),
        },
        "uptime_s": round(time.time() - started_at, 3),
        # backend module name ("memory"/"sqlite"/"jsonfs"/"mongo")
        "store": type(agents_store).__module__.rsplit(".", 1)[-1],
        "inflight": gauges.get("http.inflight", 0),
        "inflight_peak": gauges.get("http.inflight.peak", 0),
        "admission_enabled": admission.enabled,
        # multi-tenant fairness verdicts (http/admission.py): which
        # tenants were admitted/shed against their own budgets —
        # present only when the per-tenant layer is armed
        "admission": (admission.tenants_report()
                      if admission.tenant_rate is not None else None),
        "requests": status_counts,
        # which wire the peers actually spoke (fleet loadgen reads
        # the negotiated outcome from here — the counters live in
        # THIS process, not the driver's)
        "codec_counters": metrics.counter_report("http.codec.") or {},
        "lease": {
            "lease_seconds": service.server.clerking_lease_seconds,
            # live (unlapsed) leases this worker holds right now — the
            # shared granted-lease sweep keeps the figure honest on
            # both planes (server/core.py sweep_granted_leases)
            "held": service.server.held_lease_count(),
            "counters": metrics.counter_report("server.job."),
            # enqueue->lease latency (ms): the long-poll headline
            "pickup_ms": ({
                "count": int(pickup["count"]),
                "p50_ms": round(pickup["p50"] * 1e3, 3),
                "p99_ms": round(pickup["p99"] * 1e3, 3),
            } if pickup else None),
        },
        # long-poll plane: how many clerk requests are parked on the
        # in-process wakeup right now (server/wakeup.py)
        "longpoll": {
            "parked": wakeup.parked() if wakeup is not None else 0,
            "max_wait_s": clamp_wait(float("inf")),
            "tick_s": longpoll_tick(),
        },
        # contended-idempotency visibility: how often this worker's
        # snapshot pipeline won, lost, or converged on a peer's freeze
        "snapshot": metrics.counter_report("server.snapshot.") or {},
        # adversarial-input visibility: out-of-field share detections
        # (clerk.share.out_of_range) live in the CLERK's process — the
        # server proper never sees plaintext shares, so these counters
        # appear here only where clerks share the scraped process
        # (in-process drills, co-located clerks); fleet mode sums them
        # across scrapes like the codec counters above
        "clerk": metrics.counter_report("clerk.share.") or {},
        # exactly-once ingestion visibility: created vs byte-identical
        # replays vs rejected equivocations (fleet loadgen sums these
        # across scrapes — the counters live in THIS process)
        "participation": metrics.counter_report(
            "server.participation.") or {},
        # round lifecycle table (server/lifecycle.py): per-state and
        # per-tenant tallies + the most recently updated LIVE rounds
        # (terminal history only pads the remainder) — the fleet's
        # shared-store view, so any worker's scrape shows every round
        "rounds": _lifecycle.rounds_report(service.server),
        # recurring-round schedules (service/scheduler.py): every
        # installed schedule's tenant, current epoch and cadence —
        # also the shared-store view
        "schedules": _schedules_report(service.server),
        # live fleet health table (server/health.py): every worker's
        # heartbeat state and age, read from the shared store — any
        # worker's scrape shows the whole fleet
        "fleet_health": _health.fleet_health_report(
            service.server.clerking_job_store),
        # store circuit breaker (server/breaker.py): present only
        # when armed (sdad --store-breaker)
        "breaker": (service.server.store_breaker.report()
                    if getattr(service.server, "store_breaker", None)
                    is not None else None),
        # fleet drills arm failpoints per worker (sdad --chaos-spec);
        # the scrape proves the faults actually fired in THIS process
        "failpoints": chaos.report() or {},
        "devprof": devprof.compile_totals(),
        "hbm": metrics.gauge_report("device.hbm."),
    }


def _schedules_report(server) -> Optional[dict]:
    """The ``/statusz`` schedules block (lazy import: the service plane
    only loads when a scrape actually asks for it)."""
    from ..service.scheduler import schedules_report

    try:
        return schedules_report(server)
    except Exception:  # a third-party store without schedule support
        return None


def drain_summary(service, *, node_id, stranded: int) -> dict:
    """The tail of a graceful drain, identical on both planes: hand every
    held clerking-job lease back to the shared store, count stranded
    in-flight requests as the leak the fleet contract gates on, and
    return the summary line ``sdad``/``sda-fleet`` parse."""
    released = service.server.release_held_leases()
    if stranded:
        # a handler still running past the grace window is an
        # abandoned request — the process exits right after and
        # kills its daemon thread mid-flight. That IS the leak the
        # fleet contract gates on.
        metrics.count("http.shutdown.leaked", stranded)
    summary = {
        "node_id": node_id,
        "released_leases": released,
        "stranded_requests": stranded,
        "leaked": stranded,
    }
    log.info("drained: %s", summary)
    return summary
