"""REST server: the SdaService exposed over HTTP/JSON.

Route map mirrors the reference's endpoint scheme (server-http/src/lib.rs
doc table :19-60):

    GET    /v1/ping
    POST   /v1/agents/me
    GET    /v1/agents/{AgentId}
    POST   /v1/agents/me/profile
    GET    /v1/agents/{AgentId}/profile
    POST   /v1/agents/me/keys
    GET    /v1/agents/any/keys/{EncryptionKeyId}
    POST   /v1/aggregations
    GET    /v1/aggregations?title=&recipient=
    GET    /v1/aggregations/{AggregationId}
    DELETE /v1/aggregations/{AggregationId}
    GET    /v1/aggregations/{AggregationId}/committee/suggestions
    POST   /v1/aggregations/implied/committee
    GET    /v1/aggregations/{AggregationId}/committee
    POST   /v1/aggregations/participations
    GET    /v1/aggregations/{AggregationId}/status
    POST   /v1/aggregations/implied/snapshot
    GET    /v1/aggregations/any/jobs
    POST   /v1/aggregations/implied/jobs/{ClerkingJobId}/result
    GET    /v1/aggregations/{AggregationId}/snapshots/{SnapshotId}/result

Authentication is HTTP Basic: username = agent id, password = a
client-minted token. The token presented on the agent-creation POST is
recorded and must be reused on subsequent requests (lib.rs:192-201).
Missing resources answer 404 with an ``X-Resource-Not-Found`` header so
clients can distinguish a missing resource from a missing route
(lib.rs:338-343); errors map to 401/403/400/500 (lib.rs:105-122).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..protocol import AgentId, InvalidRequest
from ..protocol import bincodec
from ..server import SdaServerService
from ..server.routing import NODE_HEADER
from ..utils import metrics
from .. import chaos, obs
from . import base
from .admission import AdmissionControl, TENANT_HEADER
#: Re-exports: the route table and label live in ``http/base.py`` now,
#: shared with the async plane; existing importers keep working.
from .base import REQUEST_ID_RE as _REQUEST_ID_RE  # noqa: F401
from .base import ROUTE_TEMPLATES as _ROUTE_TEMPLATES  # noqa: F401
from .base import route_label  # noqa: F401

log = logging.getLogger(__name__)
#: Dedicated child logger for the per-span trace lines, so ``sdad --trace``
#: can unmute EXACTLY them without also unmuting the access log.
trace_log = logging.getLogger(__name__ + ".trace")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "sda-tpu"

    # silence default stderr spam; route through logging instead
    def log_message(self, fmt, *args):
        log.debug("%s %s", self.address_string(), fmt % args)

    # -- helpers -----------------------------------------------------------
    @property
    def service(self) -> SdaServerService:
        return self.server.sda_service  # type: ignore[attr-defined]

    def _credentials(self) -> Optional[Tuple[AgentId, str]]:
        return base.parse_basic_auth(self.headers.get("Authorization"))

    def _content_length(self) -> int:
        """Negative (or garbage) Content-Length must 400, not turn
        ``rfile.read`` into a blocking read-to-EOF that pins this
        handler thread until the client hangs up."""
        length = base.parse_content_length(
            self.headers.get("Content-Length"))
        if length < 0:
            raise InvalidRequest("bad Content-Length")
        return length

    def _raw_body(self) -> bytes:
        length = self._content_length()
        raw = self.rfile.read(length) if length else b""
        self._body_consumed = True
        return raw

    def _json_body(self):
        raw = self._raw_body()
        if not raw:
            return None
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise InvalidRequest(f"malformed JSON body: {e}")

    # -- binary wire codec (application/x-sda-bin) -------------------------
    def _bin_enabled(self) -> bool:
        return getattr(self.server, "bin_codec", True)

    def _body_is_bin(self) -> bool:
        ctype = (self.headers.get("Content-Type") or "")
        return (self._bin_enabled()
                and ctype.split(";")[0].strip().lower() == bincodec.CONTENT_TYPE)

    def _accepts_bin(self) -> bool:
        return (self._bin_enabled()
                and bincodec.CONTENT_TYPE in (self.headers.get("Accept") or ""))

    def _hot_body(self, expect_tag, from_obj):
        """Decode a hot-route POST body by its content type: negotiated
        binary frame or the JSON fallback (old peers). Codec decode
        errors raise ValueError -> 400, exactly like malformed JSON.

        Binary bodies STREAM through the incremental decoder
        (``bincodec.FeedDecoder``): chunks feed straight into the resource
        under construction, so per-request memory is bounded by the
        largest single field frame, not the whole dim-1e8 upload."""
        if self._body_is_bin():
            metrics.count("http.codec.bin.in")
            length = self._content_length()
            self._body_consumed = True  # we own the body bytes from here
            decoder = bincodec.FeedDecoder(expect_tag)
            remaining = length
            try:
                while remaining:
                    chunk = self.rfile.read(min(65536, remaining))
                    if not chunk:
                        self.close_connection = True
                        raise ValueError("truncated x-sda-bin body")
                    remaining -= len(chunk)
                    decoder.feed(chunk)
                return decoder.finish()
            except ValueError:
                # drain what's left so keep-alive framing survives the
                # 400 — bounded, like _reply's drain: a client that
                # advertised bytes and stalls forfeits the connection
                # instead of pinning this thread
                try:
                    previous = self.connection.gettimeout()
                    self.connection.settimeout(5.0)
                    try:
                        while remaining:
                            chunk = self.rfile.read(min(65536, remaining))
                            if not chunk:
                                self.close_connection = True
                                break
                            remaining -= len(chunk)
                    finally:
                        self.connection.settimeout(previous)
                except OSError:  # includes socket.timeout: framing lost
                    self.close_connection = True
                raise
        metrics.count("http.codec.json.in")
        return from_obj(self._json_body())

    def _reply(self, status: int, obj=None, resource_not_found=False,
               retry_after=None, raw=None, content_type="application/json",
               extra_headers=None):
        if raw is not None:
            body = raw
        else:
            body = b"" if obj is None else json.dumps(obj).encode("utf-8")
        # failpoint: the service call already happened — dropping HERE
        # simulates a lost response (side effect durable, client in the
        # dark), the exact hazard create-once retry semantics must absorb;
        # delay stalls the ack instead
        action = chaos.evaluate("http.server.response", kinds=("drop", "delay"))
        if action is not None:
            if action.kind == "drop":
                log.info("%s %s -> chaos-dropped response", self.command, self.path)
                self.close_connection = True
                return
            time.sleep(action.delay_s)
        # replying before the handler consumed the request body (auth
        # failures, injected 500s, malformed-route errors on POSTs) would
        # leave the body bytes in the keep-alive stream, where they get
        # parsed as the next request line — drain them first, but bounded:
        # a client that advertised a body and never sends it must not pin
        # this thread, so a stalled drain forfeits the connection instead
        length = base.parse_content_length(self.headers.get("Content-Length"))
        if length < 0:
            # garbage framing: nothing sane to drain, sever instead
            length = 0
            self.close_connection = True
        if length and not self._body_consumed:
            self._body_consumed = True
            try:
                previous = self.connection.gettimeout()
                self.connection.settimeout(5.0)
                try:
                    self.rfile.read(length)
                finally:
                    self.connection.settimeout(previous)
            except OSError:  # includes socket.timeout: framing is lost
                self.close_connection = True
        # per-request status line + counters (reference: the rouille wrapper
        # logs method/path/status per request, server-http/src/lib.rs:105-122).
        # Counted BEFORE the body write: once a client has the response, the
        # counters must already reflect it (no read-after-response race).
        dt_ms = (time.perf_counter() - self._t0) * 1e3 if self._t0 else 0.0
        if status >= 400:
            # correlate error replies with the echoed X-Request-Id so a
            # client-side failure report can be grepped straight to the
            # server-side record (and its trace)
            log.info("%s %s -> %d (%.1fms) request_id=%s",
                     self.command, self.path, status, dt_ms, self._request_id)
        else:
            log.info("%s %s -> %d (%.1fms)", self.command, self.path, status,
                     dt_ms)
        span = self._span
        if span is not None and "http.status" not in span.attributes:
            # first write wins: a failed body write re-enters _reply with a
            # 500, but the status the CLIENT saw is the one already recorded
            span.set_attribute("http.status", status)
        if not self._counted:  # a failed write re-enters _reply via the
            self._counted = True  # _route catch-all: count the request once
            counts = getattr(self.server, "status_counts", None)
            if counts is not None:
                with self.server.stats_lock:  # type: ignore[attr-defined]
                    counts[status] = counts.get(status, 0) + 1
            metrics.count("http.request")
            metrics.count(f"http.status.{status}")
            if self._shed:
                # an admission rejection is not a service latency: folding
                # sub-ms sheds into the route histogram would collapse the
                # reported tails exactly when overload makes them matter
                metrics.observe("http.latency.shed", dt_ms / 1e3)
            else:
                label = route_label(
                    self.command, getattr(self, "_route_path", None) or "/"
                )
                metrics.observe(f"http.latency.{label}", dt_ms / 1e3)
        self.send_response(status)
        if self._request_id:
            # echo the correlation id on EVERY response (reused from the
            # request when the client sent one, minted server-side else)
            self.send_header(obs.REQUEST_ID_HEADER, self._request_id)
        node_id = getattr(self.server, "node_id", None)
        if node_id:
            # fleet plane: name the worker that actually served this
            # request, so clients/loadgen can verify (advisory) routing
            # and per-node tallies without scraping anything
            self.send_header(NODE_HEADER, node_id)
        if self._bin_enabled():
            # codec advert: clients in "auto" mode upgrade the hot routes
            # to application/x-sda-bin after seeing this on ANY response
            self.send_header(bincodec.CODECS_HEADER, "bin")
        if extra_headers:
            for key, value in extra_headers.items():
                self.send_header(key, value)
        if resource_not_found:
            self.send_header("X-Resource-Not-Found", "true")
        if retry_after is not None:
            # fractional seconds: RFC 9110 says integers, but both ends of
            # this wire are ours and sub-second hints are what make the
            # token-bucket convergence fast; foreign clients that int-parse
            # still get a sane 0/1
            self.send_header("Retry-After", f"{max(0.0, retry_after):.3f}")
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    _t0 = 0.0
    _counted = False
    _body_consumed = False
    _route_path = None
    _shed = False
    _span = None
    _request_id = None

    def _agent_key(self) -> str:
        """Admission key: the CLAIMED agent id (token unverified — rate
        limiting must not pay the auth lookup it protects), else the
        client address for unauthenticated requests."""
        creds = self._credentials()
        if creds is not None:
            return str(creds[0])
        return str(self.client_address[0])

    def _tenant_key(self) -> Optional[str]:
        return base.tenant_key(self.headers.get(TENANT_HEADER))

    # -- dispatch ----------------------------------------------------------
    def _route(self, method: str):
        self._t0 = time.perf_counter()
        self._counted = False  # per-request (connections are reused)
        self._body_consumed = False
        self._shed = False
        self._span = None
        # active-REQUEST census (not connections: an idle keep-alive socket
        # parked in readline is not in-flight work) — what graceful drain
        # waits on before releasing leases and closing
        with self.server.stats_lock:  # type: ignore[attr-defined]
            self.server.active_requests += 1  # type: ignore[attr-defined]
        try:
            self._route_inner(method)
        finally:
            with self.server.stats_lock:  # type: ignore[attr-defined]
                self.server.active_requests -= 1  # type: ignore[attr-defined]

    def _route_inner(self, method: str):
        url = urlparse(self.path)
        path = url.path.rstrip("/")
        query = parse_qs(url.query)
        self._route_path = path or "/"
        self._request_id = base.request_id(
            self.headers.get(obs.REQUEST_ID_HEADER))
        # draining (a keep-alive connection can still deliver a NEW
        # request after the accept loop stopped — turn it away before
        # any auth/store work) + the admission/tracing-exempt
        # observability endpoints, shared with the async plane
        pre = base.preroute_reply(self.server, method, path)
        if pre is not None:
            return self._send_reply(pre)
        # protocol garbage pre-dispatch, matching the async plane's
        # header-parse-time rejection: a negative Content-Length would
        # otherwise turn body reads/drains into read-to-EOF stalls
        if base.parse_content_length(self.headers.get("Content-Length")) < 0:
            self.close_connection = True
            return self._reply(400, {"error": "bad Content-Length"})

        # server span: joins the caller's trace when the request carries a
        # W3C traceparent header, else roots a fresh trace. Everything the
        # handler does — admission verdicts, service calls, store ops,
        # snapshot phases — lands as descendants of this span.
        label = route_label(method, self._route_path)
        parent = obs.parse_traceparent(
            self.headers.get(obs.TRACEPARENT_HEADER))
        span_attributes = {"http.method": method, "http.route": label,
                           "request_id": self._request_id}
        node_id = getattr(self.server, "node_id", None)
        if node_id:
            # round timelines show which fleet worker served each hop
            span_attributes["node_id"] = node_id
        with obs.span(
            f"http.server {label}", parent=parent, kind="server",
            attributes=span_attributes,
        ) as server_span:
            self._span = server_span
            try:
                # admission control: shed BEFORE auth/crypto/store work. A
                # rejected request costs one header parse; Retry-After tells
                # the retrying transport exactly when the token bucket
                # refills.
                admission = getattr(self.server, "admission", None)
                if admission is not None and admission.enabled:
                    shed = admission.admit(self._agent_key(),
                                           tenant_key=self._tenant_key())
                    if shed is not None:
                        log.debug("%s %s -> %d shed (%s, retry in %.3fs)",
                                  method, path, shed.status, shed.reason,
                                  shed.retry_after)
                        self._shed = True
                        server_span.set_attribute("shed", shed.reason)
                        return self._reply(
                            shed.status,
                            {"error": f"throttled: {shed.reason}"},
                            retry_after=shed.retry_after,
                        )
                    try:
                        return self._dispatch(method, path, query)
                    finally:
                        admission.release()
                return self._dispatch(method, path, query)
            finally:
                if getattr(self.server, "trace_log", False):
                    trace_log.info(
                        "trace %s %s %s status=%s request_id=%s",
                        server_span.trace_id, method, self._route_path,
                        server_span.attributes.get("http.status"),
                        self._request_id,
                    )

    def _dispatch(self, method: str, path: str, query):
        """One request through the shared route table (``http/base.py``):
        build the transport adapter, dispatch, park long-polls on this
        request thread, then write the decided reply."""
        rx = _HandlerExchange(self, method, path, query)
        reply = base.dispatch(self.service, rx)
        if reply.park is not None:
            # long-poll: block THIS request thread (the threaded plane's
            # park) until a job lands, the wait expires, or drain wakes
            # us — the admission slot and the active-request census both
            # cover the parked time, which is what drain waits on
            if self._span is not None:
                self._span.set_attribute("longpoll.parked", True)
            reply = base.blocking_park(
                self.service, reply.park,
                draining=lambda: getattr(self.server, "draining", False),
                fleet_peers=getattr(self.server, "fleet_peers", None))
        self._send_reply(reply)

    def _send_reply(self, reply) -> None:
        if reply.drop:
            # chaos "drop": sever without response bytes
            log.info("%s %s -> chaos-dropped connection",
                     self.command, self.path)
            self.close_connection = True
            return
        if reply.span_attrs and self._span is not None:
            for key, value in reply.span_attrs.items():
                self._span.set_attribute(key, value)
        if reply.close:
            self.close_connection = True
        self._reply(
            reply.status, reply.obj, raw=reply.raw,
            content_type=reply.content_type,
            resource_not_found=reply.resource_not_found,
            retry_after=reply.retry_after, extra_headers=reply.headers,
        )

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_DELETE(self):
        self._route("DELETE")


class _HandlerExchange:
    """The threaded plane's transport adapter for ``base.dispatch``:
    thin delegation onto the live ``BaseHTTPRequestHandler``."""

    __slots__ = ("_h", "method", "path", "query")

    def __init__(self, handler: _Handler, method: str, path: str, query):
        self._h = handler
        self.method = method
        self.path = path
        self.query = query

    def header(self, name: str):
        return self._h.headers.get(name)

    def json_body(self):
        return self._h._json_body()

    def hot_body(self, expect_tag, from_obj):
        return self._h._hot_body(expect_tag, from_obj)

    def accepts_bin(self) -> bool:
        return self._h._accepts_bin()

    def credentials(self):
        return self._h._credentials()

    def agent_key(self) -> str:
        return self._h._agent_key()


class SdaHttpServer:
    """Threaded HTTP server wrapping an SdaServerService.

    ``max_inflight`` / ``rate_limit`` / ``rate_burst`` arm the admission
    layer (both default off — zero overhead and bit-compatible behavior
    with the pre-admission server); ``metrics_endpoint`` enables the
    plaintext Prometheus exposition at ``GET /metrics`` (off by default:
    it reveals traffic shape, opt in via ``sdad --metrics``);
    ``statusz_endpoint`` enables the ``GET /statusz`` JSON debug page
    (uptime, store backend, in-flight/peak gauges, lease stats, devprof
    compile totals — same opt-in reasoning, ``sdad --statusz``);
    ``trace_log`` logs one INFO line per finished server span (trace id,
    route, status, request id — ``sdad --trace``);
    ``bin_codec=False`` turns the binary wire codec off (no advert, no
    ``application/x-sda-bin`` parsing) — the old-JSON-server posture the
    mixed-version tests pin.

    ``node_id`` names this worker in a fleet (``sda-fleet``,
    docs/scaling.md): it rides every response as ``X-SDA-Node``, labels
    ``/metrics`` samples and ``/statusz``, and lands on every server span
    so round timelines attribute hops to workers. ``fleet_peers`` records
    the fleet size as the ``fleet.peers`` gauge.
    """

    def __init__(
        self,
        service: SdaServerService,
        bind: str = "127.0.0.1:8888",
        *,
        max_inflight: Optional[int] = None,
        rate_limit: Optional[float] = None,
        rate_burst: float = 8.0,
        tenant_rate: Optional[float] = None,
        tenant_burst: float = 32.0,
        metrics_endpoint: bool = False,
        statusz_endpoint: bool = False,
        trace_log: bool = False,
        bin_codec: bool = True,
        node_id: Optional[str] = None,
        fleet_peers: Optional[int] = None,
    ):
        host, _, port = bind.partition(":")
        self.httpd = ThreadingHTTPServer((host, int(port or 8888)), _Handler)
        self.httpd.bin_codec = bin_codec  # type: ignore[attr-defined]
        self.httpd.sda_service = service  # type: ignore[attr-defined]
        self.httpd.status_counts = {}  # type: ignore[attr-defined]
        self.httpd.stats_lock = threading.Lock()  # type: ignore[attr-defined]
        self.httpd.active_requests = 0  # type: ignore[attr-defined]
        self.httpd.draining = False  # type: ignore[attr-defined]
        self.node_id = node_id
        self.fleet_peers = fleet_peers
        self.httpd.node_id = node_id  # type: ignore[attr-defined]
        service.server.node_id = node_id
        if fleet_peers is not None:
            metrics.gauge_set("fleet.peers", fleet_peers)
        self.admission = AdmissionControl(
            max_inflight=max_inflight, rate=rate_limit, burst=rate_burst,
            tenant_rate=tenant_rate, tenant_burst=tenant_burst,
        )
        self.httpd.admission = self.admission  # type: ignore[attr-defined]
        self.httpd.metrics_enabled = metrics_endpoint  # type: ignore[attr-defined]
        self.httpd.statusz_fn = (  # type: ignore[attr-defined]
            self.statusz if statusz_endpoint else None)
        self.httpd.trace_log = trace_log  # type: ignore[attr-defined]
        self._started_at = time.time()
        self._thread: Optional[threading.Thread] = None

    def statusz(self) -> dict:
        """The ``GET /statusz`` payload, built by the shared
        ``base.build_statusz`` so fleet-mode counter aggregation reads
        identical fields off either HTTP plane."""
        return base.build_statusz(
            self.httpd.sda_service,  # type: ignore[attr-defined]
            node_id=self.node_id, admission=self.admission,
            started_at=self._started_at, status_counts=self.status_counts,
            plane="threaded",
        )

    def configure_admission(
        self,
        max_inflight: Optional[int] = None,
        rate_limit: Optional[float] = None,
        rate_burst: Optional[float] = None,
        tenant_rate: Optional[float] = None,
        tenant_burst: Optional[float] = None,
    ) -> None:
        """Retune (or disable, with all-``None``) admission at runtime —
        the loadgen driver arms overload profiles only after round setup."""
        self.admission.configure(
            max_inflight=max_inflight, rate=rate_limit, burst=rate_burst,
            tenant_rate=tenant_rate, tenant_burst=tenant_burst,
        )

    @property
    def sda_service(self) -> SdaServerService:
        """The wrapped service — uniform across both planes (the async
        plane exposes the same attribute), so drivers and tests can
        reach ``server.sda_service.server`` without knowing the plane."""
        return self.httpd.sda_service  # type: ignore[attr-defined]

    @property
    def status_counts(self) -> dict:
        """Requests served, keyed by HTTP status (observability floor)."""
        with self.httpd.stats_lock:  # type: ignore[attr-defined]
            return dict(self.httpd.status_counts)  # type: ignore[attr-defined]

    @property
    def active_requests(self) -> int:
        """Requests currently being handled (idle keep-alive connections
        excluded — their threads are parked in readline, not working)."""
        with self.httpd.stats_lock:  # type: ignore[attr-defined]
            return self.httpd.active_requests  # type: ignore[attr-defined]

    def drain(self, grace_s: float = 10.0) -> dict:
        """Graceful shutdown (the fleet worker's SIGTERM path): stop
        accepting, let in-flight requests finish (bounded by ``grace_s``),
        hand every clerking-job lease this worker still holds back to the
        shared store so a fleet peer's next poll reissues the work
        immediately (no visibility-timeout wait), then close. Returns the
        drain summary — ``leaked`` must be 0 for a clean exit
        (docs/scaling.md)."""
        # reject-then-stop: established keep-alive connections can still
        # deliver new requests after the accept loop stops, so flip the
        # draining flag FIRST (handlers answer 503 + Connection: close
        # from here on), then stop the accept/serve loop and wait out the
        # requests that were already in flight
        self.httpd.draining = True  # type: ignore[attr-defined]
        service = self.httpd.sda_service  # type: ignore[attr-defined]
        # wake every parked long-poll NOW: a parked clerk must get its
        # 503 + Connection: close immediately (and count as finished
        # in-flight work below), not hold the drain to its wait timeout
        wakeup = getattr(service.server, "job_wakeup", None)
        if wakeup is not None:
            wakeup.notify_all()
        self.httpd.shutdown()  # blocks until the serve loop exits
        deadline = time.monotonic() + grace_s
        while self.active_requests and time.monotonic() < deadline:
            time.sleep(0.02)
        stranded = self.active_requests
        summary = base.drain_summary(service, node_id=self.node_id,
                                     stranded=stranded)
        self.shutdown()  # joins the (already finished) serve-loop thread
        return summary

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start_background(self) -> "SdaHttpServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # a wedged handler (stuck client socket, runaway store op)
                # survives shutdown(); don't hang the caller forever, but
                # don't hide the leak either
                log.warning(
                    "HTTP server thread did not stop within 5s; "
                    "leaking daemon thread %s", self._thread.name,
                )
                metrics.count("http.shutdown.leaked")
        self.httpd.server_close()
