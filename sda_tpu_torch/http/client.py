"""REST client: an SdaService re-assembled over HTTP.

Reference: client-http/src/client.rs — the proxy implements the same service
interface the in-process server does, so SdaClient code is transport-blind.
The ``caller`` argument is carried by HTTP Basic auth: username = agent id,
password = a locally minted 32-char token persisted in the client store
(client-http/src/tokenstore.rs:8-23). A 404 bearing ``X-Resource-Not-Found``
maps to ``None``; a bare 404 is a routing error (client.rs:65-72).
"""

from __future__ import annotations

import logging
import os as _os
import random as _random
import re as _re
import time as _time
import secrets as _secrets
import threading as _threading
from typing import List, Optional

import requests

from .. import obs
from ..utils import metrics
from ..protocol import (
    Agent,
    AgentId,
    Aggregation,
    AggregationId,
    AggregationStatus,
    ClerkCandidate,
    ClerkingJob,
    Committee,
    InvalidCredentials,
    InvalidRequest,
    NotFound,
    Participation,
    ParticipationConflict,
    PermissionDenied,
    Pong,
    RoundStatus,
    SdaService,
    ServerError,
    SnapshotResult,
    signed_encryption_key_from_obj,
)
from ..protocol import bincodec
from .admission import TENANT_HEADER
from ..utils.env import env_float as _env_float

TOKEN_ALIAS = "auth-token"

#: Wire codec modes: "json" pins the legacy JSON wire, "bin" forces the
#: binary codec from the first request (peer known to support it), "auto"
#: starts JSON and upgrades the hot routes once the server's
#: ``X-SDA-Codecs: bin`` advert is seen — old JSON-only servers therefore
#: keep speaking JSON transparently.
WIRE_CODECS = ("auto", "json", "bin")

log = logging.getLogger(__name__)

#: Statuses treated as transient server trouble — worth retrying.
RETRYABLE_STATUSES = frozenset({500, 502, 503, 504})

#: Admission-control shed (429 Too Many Requests): the server refused the
#: request BEFORE doing any work, so retrying is always safe regardless of
#: idempotence; the Retry-After hint says when.
THROTTLED_STATUS = 429

#: Resource ids inside request paths, collapsed to ``{id}`` in span names.
_PATH_ID_RE = _re.compile(r"[0-9a-fA-F-]{36}")


def _retry_after_seconds(response) -> Optional[float]:
    """Parse a ``Retry-After`` header: delta-seconds (our server emits
    fractional seconds) or an HTTP-date. ``None`` when absent/garbled."""
    raw = response.headers.get("Retry-After")
    if raw is None:
        return None
    raw = raw.strip()
    try:
        return max(0.0, float(raw))
    except ValueError:
        pass
    try:
        from email.utils import parsedate_to_datetime
        import datetime as _dt

        when = parsedate_to_datetime(raw)
        now = _dt.datetime.now(when.tzinfo or _dt.timezone.utc)
        return max(0.0, (when - now).total_seconds())
    except (TypeError, ValueError):
        log.debug("ignoring unparseable Retry-After=%r", raw)
        return None

#: Every mutating route this client issues. All are POSTs whose server-side
#: handlers are create-once / idempotent upserts keyed by a client-minted id
#: (participations dedupe by participation id, results by (snapshot, job),
#: snapshots by snapshot id with deterministic job ids, everything else is a
#: plain upsert), so a retried POST after a lost response cannot duplicate a
#: side effect. ``_post`` asserts membership: adding a non-idempotent route
#: without reclassifying it here must fail loudly, not silently retry.
_IDEMPOTENT_POST_ROUTES = tuple(
    _re.compile(p)
    for p in (
        r"/v1/agents/me",
        r"/v1/agents/me/profile",
        r"/v1/agents/me/keys",
        r"/v1/aggregations",
        r"/v1/aggregations/implied/committee",
        r"/v1/aggregations/implied/snapshot",
        r"/v1/aggregations/participations",
        r"/v1/aggregations/implied/jobs/[0-9a-fA-F-]{36}/result",
    )
)


def _load_or_mint_token(store, agent_id: AgentId) -> str:
    """Persisted per-identity token, minted on first use (tokenstore.rs:8-23)."""
    record = store.get(f"token-{agent_id}")
    if record is not None:
        return record["token"]
    token = _secrets.token_urlsafe(24)[:32]
    store.put(f"token-{agent_id}", {"token": token})
    return token


class SdaHttpClient(SdaService):
    """REST proxy implementing the full SdaService seam.

    Thread-safe: one proxy can serve many agents from many threads (the
    in-process tests drive concurrent clerks through one instance).
    ``requests.Session`` connection reuse is NOT safe across threads —
    interleaved request/response framing deadlocks both ends — so each
    thread gets its own session; the token cache is lock-guarded.
    """

    def __init__(
        self,
        base_url: str,
        store=None,
        token: Optional[str] = None,
        *,
        timeout: Optional[float] = None,
        max_retries: Optional[int] = None,
        backoff_base: Optional[float] = None,
        backoff_cap: Optional[float] = None,
        deadline: Optional[float] = None,
        codec: Optional[str] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.store = store
        self._fixed_token = token
        #: wire codec mode; constructor beats SDA_WIRE_CODEC beats "auto"
        self.codec = (codec if codec is not None
                      else _os.environ.get("SDA_WIRE_CODEC") or "auto")
        if self.codec not in WIRE_CODECS:
            raise ValueError(f"unknown wire codec {self.codec!r} "
                             f"(expected one of {WIRE_CODECS})")
        #: set once any response carries the server's bin-codec advert
        self._peer_bin = False
        #: cleared once a long-poll gets the old-server bare 404 — the
        #: proxy then degrades to immediate-return polling permanently
        self._peer_longpoll = True
        #: multi-tenant fairness (http/admission.py): when set to the
        #: recipient id this proxy's traffic belongs to, every request
        #: carries it as X-SDA-Tenant so the server's per-tenant budget
        #: bucket sees it — a device swarm that names its tenant sheds
        #: against that tenant's own budget, not the fleet's
        self.tenant: Optional[str] = None
        #: per-request socket timeout; constructor beats SDA_HTTP_TIMEOUT
        #: beats the historical 60 s default
        self.timeout = (
            timeout if timeout is not None else _env_float("SDA_HTTP_TIMEOUT", 60.0)
        )
        #: transient failures absorbed per operation before giving up
        self.max_retries = int(
            max_retries if max_retries is not None
            else _env_float("SDA_HTTP_RETRIES", 4)
        )
        # exponential backoff with full jitter: sleep in
        # [0, min(cap, base * 2^attempt)] — decorrelates retry storms from
        # many sporadic clients hitting one recovering server
        self.backoff_base = (
            backoff_base if backoff_base is not None
            else _env_float("SDA_HTTP_BACKOFF", 0.1)
        )
        self.backoff_cap = backoff_cap if backoff_cap is not None else 5.0
        #: per-operation wall-clock budget across all attempts (sleeps
        #: included); None derives it from timeout and retry count
        self.deadline = (
            deadline if deadline is not None
            else _env_float(
                "SDA_HTTP_DEADLINE",
                (self.timeout + self.backoff_cap) * (self.max_retries + 1),
            )
        )
        self._tokens = {}  # per-caller cache; one proxy can serve many agents
        self._tokens_lock = _threading.Lock()
        self._local = _threading.local()
        self._sessions = []  # every created session, for close()

    @property
    def session(self) -> requests.Session:
        s = getattr(self._local, "session", None)
        if s is None:
            s = self._local.session = requests.Session()
            with self._tokens_lock:
                self._sessions.append(s)
        return s

    def close(self) -> None:
        """Release pooled keep-alive sockets of every thread's session."""
        with self._tokens_lock:
            sessions, self._sessions = self._sessions, []
        for s in sessions:
            s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _auth(self, caller: Agent):
        if self._fixed_token is not None:
            return (str(caller.id), self._fixed_token)
        with self._tokens_lock:
            token = self._tokens.get(caller.id)
            if token is None:
                if self.store is None:
                    raise InvalidCredentials("no token store configured")
                token = _load_or_mint_token(self.store, caller.id)
                self._tokens[caller.id] = token
        return (str(caller.id), token)

    def _check(self, response: requests.Response):
        if response.status_code in (200, 201):
            return response
        if response.status_code == 404:
            if response.headers.get("X-Resource-Not-Found"):
                return None
            raise NotFound(f"no such route: {response.url}")
        body = response.text[:200]
        if response.status_code == 401:
            raise InvalidCredentials(body)
        if response.status_code == 403:
            raise PermissionDenied(body)
        if response.status_code == 400:
            raise InvalidRequest(body)
        if response.status_code == 409:
            # exactly-once ingestion refused the upload: TERMINAL by
            # construction (the server already holds a different bundle
            # under this key — replaying the same bytes can never turn a
            # conflict into a success), so it is deliberately not in
            # RETRYABLE_STATUSES and surfaces typed after ONE attempt
            metrics.count("http.participation.conflict")
            raise ParticipationConflict(body)
        error = ServerError(f"HTTP {response.status_code}: {body}")
        # a terminal 5xx/429 that exhausted the transport's own retries
        # may still carry the server's Retry-After (breaker-open and
        # admission sheds do): stamp it so HIGHER-level pollers —
        # await_result's round-status loop — back off on the server's
        # schedule instead of their fixed cadence
        error.retry_after = _retry_after_seconds(response)
        raise error

    def _use_bin(self) -> bool:
        """Whether the hot routes should speak binary right now."""
        return self.codec == "bin" or (self.codec == "auto" and self._peer_bin)

    def _request(self, method: str, path: str, *, params=None, json=None,
                 data=None, headers=None, auth=None, stream=False,
                 timeout_s=None):
        """One logical operation: exponential-backoff retries around the
        raw HTTP exchange, bounded by ``max_retries`` AND the
        per-operation ``deadline``. Connection errors, timeouts, 5xx
        responses, and 429 admission sheds are transient (a server
        ``Retry-After`` hint overrides the jittered backoff, still capped
        at the deadline); everything else returns immediately for
        ``_check`` to interpret.

        Tracing: the whole operation is one client span; every attempt is
        a child span tagged with its attempt number, status/error cause,
        and any ``Retry-After`` hint, and the attempt span's context rides
        the W3C ``traceparent`` header so server-side handling joins this
        trace."""
        url = self.base_url + path
        give_up_at = _time.monotonic() + self.deadline
        attempt = 0
        # span NAMES collapse resource ids (bounded cardinality, mirrors the
        # server's route_label); the raw path rides the http.target attribute
        with obs.span(
            f"http.client {method} {_PATH_ID_RE.sub('{id}', path)}",
            kind="client",
            attributes={"http.method": method, "http.target": path},
        ) as op_span:
            while True:
                cause, error, retry_after = None, None, None
                # the deadline is a wall-clock budget: each attempt's socket
                # timeout is clamped to what remains (floored so the first
                # attempt always gets a chance even under a tiny deadline)
                remaining = give_up_at - _time.monotonic()
                with obs.span(
                    "http.attempt", kind="client",
                    attributes={"attempt": attempt},
                ) as att_span:
                    send_headers = dict(headers or {})
                    send_headers[obs.TRACEPARENT_HEADER] = (
                        obs.format_traceparent(att_span.context))
                    if self.tenant:
                        send_headers[TENANT_HEADER] = str(self.tenant)
                    try:
                        response = self.session.request(
                            method, url, params=params, json=json, data=data,
                            auth=auth, headers=send_headers, stream=stream,
                            # timeout_s widens the socket timeout for ops
                            # that legitimately idle server-side (a parked
                            # long-poll); the op deadline still caps it
                            timeout=min(timeout_s or self.timeout,
                                        max(0.05, remaining)),
                        )
                    except requests.Timeout as e:
                        cause, error = "timeout", e
                    except requests.ConnectionError as e:
                        cause, error = "connection", e
                    else:
                        if not self._peer_bin and "bin" in response.headers.get(
                                bincodec.CODECS_HEADER, ""):
                            # codec advert: every later hot-route request
                            # from this proxy may upgrade to binary
                            self._peer_bin = True
                        att_span.set_attribute(
                            "http.status", response.status_code)
                        request_id = response.headers.get(
                            obs.REQUEST_ID_HEADER)
                        if request_id:
                            att_span.set_attribute("request_id", request_id)
                        if response.status_code == THROTTLED_STATUS:
                            # admission shed: nothing executed server-side
                            cause = "status_429"
                            retry_after = _retry_after_seconds(response)
                        elif response.status_code in RETRYABLE_STATUSES:
                            cause = "status_5xx"
                            retry_after = _retry_after_seconds(response)
                        else:
                            if attempt:
                                metrics.count("http.retry.recovered")
                                op_span.set_attribute("retries", attempt)
                            if stream:
                                # one bulk read instead of requests' 10 KB
                                # chunk loop — matters at multi-MB clerk-job
                                # payloads; ``.content`` then serves callers
                                # from this buffer
                                response._content = response.raw.read(
                                    decode_content=True)
                                response._content_consumed = True
                            return response
                    if error is not None:
                        att_span.set_attribute("error", cause)
                    elif stream:
                        # unread streamed body of a retryable response:
                        # drop the connection rather than poison keep-alive
                        response.close()
                    if retry_after is not None:
                        att_span.set_attribute("retry_after_s", retry_after)
                attempt += 1
                if attempt > self.max_retries or _time.monotonic() >= give_up_at:
                    metrics.count("http.retry.exhausted")
                    op_span.set_attribute("retries", attempt)
                    op_span.set_attribute("exhausted", True)
                    if error is not None:
                        raise error
                    return response  # terminal 5xx: let _check raise ServerError
                metrics.count("http.retry.attempt")
                metrics.count(f"http.retry.{cause}")
                jitter = _random.uniform(
                    0.0,
                    min(self.backoff_cap, self.backoff_base * (2 ** (attempt - 1))),
                )
                if retry_after is not None:
                    # the server told us when to come back: honor the hint,
                    # PLUS the growing jitter — early retries follow the hint
                    # closely (fast token-bucket convergence), persistent
                    # shedding still decays into exponential backoff instead
                    # of a cohort hammering at a constant hinted rate
                    metrics.count("http.retry.after_hint")
                    sleep = retry_after + jitter
                else:
                    sleep = jitter
                sleep = min(sleep, max(0.0, give_up_at - _time.monotonic()))
                log.debug(
                    "%s %s transient failure (%s), retry %d/%d in %.3fs",
                    method, path, cause, attempt, self.max_retries, sleep,
                )
                if sleep:
                    _time.sleep(sleep)

    def _get(self, caller: Agent, path: str, params=None):
        return self._check(
            self._request("GET", path, params=params, auth=self._auth(caller))
        )

    def _post(self, caller: Agent, path: str, obj, resource=None):
        # POSTs are only retry-safe because every mutating route is a
        # create-once/idempotent upsert server-side — enforce the claim
        # (explicit raise, not `assert`: must survive python -O)
        if not any(r.fullmatch(path) for r in _IDEMPOTENT_POST_ROUTES):
            raise AssertionError(
                f"POST {path} is not classified retry-safe; add it to "
                "_IDEMPOTENT_POST_ROUTES only if its handler is idempotent"
            )
        if resource is not None and self._use_bin():
            # negotiated hot-route body: one binary frame instead of
            # base64-inside-JSON; the raw bytes re-send identically on
            # retries, so retry semantics are unchanged
            return self._check(self._request(
                "POST", path, data=bincodec.encode(resource),
                headers={"Content-Type": bincodec.CONTENT_TYPE},
                auth=self._auth(caller),
            ))
        # ``obj`` may be a thunk so hot callers skip building the (large)
        # JSON tree when the binary path was taken
        return self._check(
            self._request("POST", path, json=obj() if callable(obj) else obj,
                          auth=self._auth(caller))
        )

    def _delete(self, caller: Agent, path: str) -> None:
        self._check(self._request("DELETE", path, auth=self._auth(caller)))

    @staticmethod
    def _option(response, codec):
        return None if response is None else codec(response.json())

    # -- service implementation --------------------------------------------
    def ping(self) -> Pong:
        response = self._request("GET", "/v1/ping")
        self._check(response)
        return Pong.from_obj(response.json())

    def create_agent(self, caller, agent):
        self._post(caller, "/v1/agents/me", agent.to_obj())

    def get_agent(self, caller, agent):
        return self._option(
            self._get(caller, f"/v1/agents/{agent}"), Agent.from_obj
        )

    def upsert_profile(self, caller, profile):
        self._post(caller, "/v1/agents/me/profile", profile.to_obj())

    def get_profile(self, caller, owner):
        from ..protocol import Profile

        return self._option(
            self._get(caller, f"/v1/agents/{owner}/profile"), Profile.from_obj
        )

    def create_encryption_key(self, caller, key):
        self._post(caller, "/v1/agents/me/keys", key.to_obj())

    def get_encryption_key(self, caller, key):
        return self._option(
            self._get(caller, f"/v1/agents/any/keys/{key}"),
            signed_encryption_key_from_obj,
        )

    def list_aggregations(self, caller, filter=None, recipient=None) -> List[AggregationId]:
        params = {}
        if filter is not None:
            params["title"] = filter
        if recipient is not None:
            params["recipient"] = str(recipient)
        response = self._get(caller, "/v1/aggregations", params=params)
        return [AggregationId(i) for i in response.json()]

    def get_aggregation(self, caller, aggregation):
        return self._option(
            self._get(caller, f"/v1/aggregations/{aggregation}"), Aggregation.from_obj
        )

    def get_committee(self, caller, aggregation):
        return self._option(
            self._get(caller, f"/v1/aggregations/{aggregation}/committee"),
            Committee.from_obj,
        )

    def create_aggregation(self, caller, aggregation):
        self._post(caller, "/v1/aggregations", aggregation.to_obj())

    def delete_aggregation(self, caller, aggregation):
        self._delete(caller, f"/v1/aggregations/{aggregation}")

    def suggest_committee(self, caller, aggregation):
        response = self._get(
            caller, f"/v1/aggregations/{aggregation}/committee/suggestions"
        )
        if response is None:
            raise NotFound("no aggregation found")
        return [ClerkCandidate.from_obj(c) for c in response.json()]

    def create_committee(self, caller, committee):
        self._post(caller, "/v1/aggregations/implied/committee", committee.to_obj())

    def get_aggregation_status(self, caller, aggregation):
        return self._option(
            self._get(caller, f"/v1/aggregations/{aggregation}/status"),
            AggregationStatus.from_obj,
        )

    def get_round_status(self, caller, aggregation):
        try:
            response = self._get(
                caller, f"/v1/aggregations/{aggregation}/round")
        except NotFound:
            # bare 404 (no X-Resource-Not-Found): an old server without
            # the round-lifecycle route — report "not tracked", exactly
            # like the in-process default, so await_result degrades to
            # plain result_ready polling against pre-supervisor peers
            return None
        return self._option(response, RoundStatus.from_obj)

    def create_snapshot(self, caller, snapshot):
        self._post(caller, "/v1/aggregations/implied/snapshot", snapshot.to_obj())

    def get_snapshot_result(self, caller, aggregation, snapshot):
        return self._option(
            self._get(
                caller, f"/v1/aggregations/{aggregation}/snapshots/{snapshot}/result"
            ),
            SnapshotResult.from_obj,
        )

    def create_participation(self, caller, participation):
        # tree-relay participations (forwarded leaf-mask ciphertexts in
        # band) ride the JSON wire: the v1 binary frame has no slot for
        # them and bincodec.encode_participation refuses to drop them
        resource = (None if participation.forwarded_masks is not None
                    else participation)
        if self._post(caller, "/v1/aggregations/participations",
                      participation.to_obj, resource=resource) is None:
            # X-Resource-Not-Found 404: the aggregation is gone. The
            # in-process seam raises here, and resume() relies on the
            # distinction to reap orphaned journal entries instead of
            # miscounting them as resumed — mirror it.
            raise NotFound(
                f"unknown aggregation {participation.aggregation}")

    def _job_headers(self):
        if self.codec == "json":
            return None
        # offer the binary codec for the bulkiest download of a round;
        # an old server ignores the Accept header and answers JSON
        return {"Accept": f"{bincodec.CONTENT_TYPE}, application/json"}

    def _decode_job(self, response):
        """Shared decode of a clerking-job response (immediate poll and
        long-poll): negotiated codec + the X-Trace-Context job link."""
        if response is None:
            return None
        ctype = (response.headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype == bincodec.CONTENT_TYPE:
            job = bincodec.decode_clerking_job(response.content)
        else:
            job = ClerkingJob.from_obj(response.json())
        # the server hands back the trace context the job was enqueued
        # under (X-Trace-Context); mirror it locally so processing — even
        # of a lease-REISSUED job — parents to the original round trace
        ctx = obs.parse_traceparent(
            response.headers.get(obs.TRACE_CONTEXT_HEADER))
        if ctx is not None:
            obs.link_job(str(job.id), ctx)
        return job

    def get_clerking_job(self, caller, clerk):
        return self._decode_job(self._check(self._request(
            "GET", "/v1/aggregations/any/jobs", headers=self._job_headers(),
            auth=self._auth(caller), stream=True,
        )))

    def longpoll_supported(self) -> bool:
        """Whether this peer still takes parked long-polls — False once
        a bare 404 revealed an old server, at which point callers like
        ``run_clerk`` must supply their own polling cadence (the
        immediate-return fallback no longer sleeps server-side)."""
        return bool(getattr(self, "_peer_longpoll", True))

    def await_clerking_job(self, caller, clerk, wait_s: float = 0.0):
        """Long-poll job delivery (``GET /v1/clerking-jobs?wait=S``,
        docs/http.md): the server parks the request until a job exists
        for this clerk, the wait expires (empty answer -> None), or the
        worker drains (503 -> the retrying transport re-issues against a
        live peer). Old servers without the route answer a bare 404: we
        remember that (``http.longpoll.unsupported``) and fall back to
        the immediate-return poll transparently, so mixed-version fleets
        keep working. The socket timeout is widened past ``wait_s`` so a
        healthy parked request is never reaped client-side."""
        if not self.longpoll_supported():
            return self.get_clerking_job(caller, clerk)
        wait_s = max(0.0, float(wait_s))
        try:
            response = self._check(self._request(
                "GET", "/v1/clerking-jobs", params={"wait": f"{wait_s:.3f}"},
                headers=self._job_headers(), auth=self._auth(caller),
                stream=True, timeout_s=wait_s + max(5.0, self.timeout),
            ))
        except NotFound:
            # bare 404 (no X-Resource-Not-Found): an old server without
            # the long-poll route — degrade to the classic poll for the
            # rest of this proxy's life
            self._peer_longpoll = False
            metrics.count("http.longpoll.unsupported")
            return self.get_clerking_job(caller, clerk)
        return self._decode_job(response)

    def create_clerking_result(self, caller, result):
        self._post(
            caller, f"/v1/aggregations/implied/jobs/{result.job}/result",
            result.to_obj, resource=result,
        )
