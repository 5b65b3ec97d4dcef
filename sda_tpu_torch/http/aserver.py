"""Async event-loop HTTP plane — ``SdaAsyncHttpServer``.

The thread-per-connection plane (``http/server.py``) pays one OS thread
per *connection*; at the paper's deployment scale (millions of sporadic
devices against one broker, PAPER.md) that is tens of thousands of idle
stacks parked in ``readline``. This plane puts connections on an asyncio
event loop instead:

- **idle costs nothing**: a keep-alive socket between requests, or a
  clerk parked on a long-poll (``GET /v1/clerking-jobs?wait=S``), holds a
  coroutine — no thread, no stack;
- **handling is unchanged**: each request's auth/admission/service work
  runs on a bounded executor through the exact same shared dispatch core
  (``http/base.py``) the threaded plane uses — same route table, same
  admission ordering (tenant budget -> in-flight cap -> per-agent
  bucket), same chaos failpoint names, same span/`X-Request-Id`
  semantics, same drain contract. Fixed-seed drills are bit-exact across
  planes (ci.sh A/B step);
- **bodies stream**: request bodies are pulled by the handler on demand
  (admission sheds before a byte of body is read, exactly like the
  threaded plane) and hot-route binary uploads feed the incremental
  ``bincodec.FeedDecoder`` chunk by chunk — per-connection memory is
  O(frame), not O(body), for dim-1e8 uploads;
- **long-polls park on the loop**: a clerk waiting for work costs one
  subscription on the in-process job wakeup (``server/wakeup.py``) and
  one parked coroutine. Snapshot fan-out / lease handback / lease recall
  wake it immediately; cross-worker events degrade to the re-check tick.

Select with ``sdad --async``. Public surface mirrors ``SdaHttpServer``
(``address``/``start_background``/``serve_forever``/``drain``/
``shutdown``/``statusz``/``configure_admission``/``status_counts``/
``active_requests``) so every driver — fleet, loadgen, drills — can swap
planes with one flag. See docs/scaling.md (capacity table) and
docs/http.md (long-poll contract).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import logging
import os
import socket
import threading
import time
from http.client import responses as _STATUS_REASONS
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..protocol import AgentId, InvalidRequest
from ..protocol import bincodec
from ..server import SdaServerService
from ..server.routing import NODE_HEADER
from ..utils import metrics
from ..utils.env import env_float
from .. import chaos, obs
from ..obs import recorder
from . import base
from .admission import AdmissionControl, TENANT_HEADER
from .server import trace_log

log = logging.getLogger(__name__)

#: Bound on a request line / single header line (StreamReader limit).
_MAX_LINE = 65536
_MAX_HEADERS = 100
#: Streaming body chunk (matches the threaded plane's rfile reads).
_BODY_CHUNK = 65536
#: Per-chunk body read budget. Body reads run on the bounded executor
#: (handler threads); without a bound, one client advertising a
#: Content-Length and never sending the bytes pins an executor thread
#: forever — enough such sockets freeze the whole plane. Per-64KiB-chunk,
#: so any client sustaining > ~2 KiB/s is unaffected.
_BODY_READ_TIMEOUT = 30.0
#: Whole-body budget floor rate: the per-chunk bound alone still lets a
#: client TRICKLE a huge advertised body and pin an executor thread for
#: hours (executor-cap connections freeze the plane). The total read
#: budget is ``_BODY_READ_TIMEOUT + content_length / _BODY_MIN_RATE`` —
#: a dim-1e8 upload gets proportional time, a troller's 100 MB
#: Content-Length caps its occupancy at ~2 minutes.
_BODY_MIN_RATE = 1024 * 1024  # bytes/s


def _worker_count() -> int:
    configured = int(env_float("SDA_ASYNC_WORKERS", 0))
    if configured > 0:
        return configured
    return min(32, (os.cpu_count() or 2) * 8)


class _Headers:
    """Case-insensitive header view (first value wins, like the threaded
    plane's ``email.message`` headers for our routes)."""

    __slots__ = ("_d",)

    def __init__(self):
        self._d = {}

    def add(self, name: str, value: str) -> None:
        self._d.setdefault(name.lower(), value)

    def get(self, name: str, default=None):
        return self._d.get(name.lower(), default)


class _AsyncExchange:
    """Transport adapter for ``base.dispatch`` on the event-loop plane.

    Handler code runs on an executor thread; body bytes are pulled from
    the connection's StreamReader on demand via
    ``run_coroutine_threadsafe`` — so admission sheds before any body
    read, and streamed binary uploads never materialize whole."""

    __slots__ = ("server", "loop", "reader", "client_ip", "method", "path",
                 "query", "headers", "remaining", "t0", "request_id", "span",
                 "shed", "route_path", "counted", "close_connection",
                 "admitted", "_body_deadline")

    def __init__(self, server, loop, reader, client_ip, method, path, query,
                 headers, content_length):
        self.server = server
        self.loop = loop
        self.reader = reader
        self.client_ip = client_ip
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.remaining = content_length
        self.t0 = time.perf_counter()
        self.request_id = None
        self.span = None
        self.shed = False
        self.route_path = path or "/"
        self.counted = False
        self.close_connection = False
        self.admitted = False
        self._body_deadline = None

    # -- body (pulled from the loop, consumed on the executor) ----------
    def _read_chunk(self, n: int) -> bytes:
        # total-body budget: per-chunk alone lets a trickler pin this
        # executor thread for hours (see _BODY_MIN_RATE)
        if self._body_deadline is None:
            self._body_deadline = (time.monotonic() + _BODY_READ_TIMEOUT
                                   + self.remaining / _BODY_MIN_RATE)
        budget = min(_BODY_READ_TIMEOUT,
                     self._body_deadline - time.monotonic())
        if budget <= 0:
            self.close_connection = True
            raise InvalidRequest("request body read timed out")
        future = asyncio.run_coroutine_threadsafe(
            self.reader.readexactly(n), self.loop)
        try:
            return future.result(timeout=budget)
        except concurrent.futures.TimeoutError as e:
            future.cancel()
            self.close_connection = True
            raise InvalidRequest("request body read timed out") from e
        except (asyncio.IncompleteReadError, ConnectionError,
                RuntimeError) as e:  # RuntimeError: loop torn down mid-read
            self.close_connection = True
            raise InvalidRequest("truncated request body") from e

    def raw_body(self) -> bytes:
        out = []
        while self.remaining:
            n = min(_BODY_CHUNK, self.remaining)
            chunk = self._read_chunk(n)
            self.remaining -= len(chunk)
            out.append(chunk)
        return b"".join(out)

    def json_body(self):
        raw = self.raw_body()
        if not raw:
            return None
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise InvalidRequest(f"malformed JSON body: {e}")

    def hot_body(self, expect_tag, from_obj):
        """Same contract as the threaded ``_hot_body``: negotiated binary
        streams through the incremental decoder, JSON falls back to the
        buffered parse; decode errors -> 400 after the body is consumed
        (keep-alive framing survives)."""
        ctype = (self.headers.get("Content-Type") or "")
        is_bin = (self.server.bin_codec and
                  ctype.split(";")[0].strip().lower() == bincodec.CONTENT_TYPE)
        if not is_bin:
            metrics.count("http.codec.json.in")
            return from_obj(self.json_body())
        metrics.count("http.codec.bin.in")
        decoder = bincodec.FeedDecoder(expect_tag)
        try:
            while self.remaining:
                chunk = self._read_chunk(min(_BODY_CHUNK, self.remaining))
                self.remaining -= len(chunk)
                decoder.feed(chunk)
            return decoder.finish()
        except ValueError:
            # leave self.remaining for the writer's bounded drain
            raise

    # -- identity -------------------------------------------------------
    def header(self, name: str):
        return self.headers.get(name)

    def credentials(self) -> Optional[Tuple[AgentId, str]]:
        return base.parse_basic_auth(self.headers.get("Authorization"))

    def agent_key(self) -> str:
        creds = self.credentials()
        if creds is not None:
            return str(creds[0])
        return self.client_ip

    def tenant_key(self) -> Optional[str]:
        return base.tenant_key(self.headers.get(TENANT_HEADER))

    def accepts_bin(self) -> bool:
        return (self.server.bin_codec
                and bincodec.CONTENT_TYPE in (self.headers.get("Accept") or ""))


class SdaAsyncHttpServer:
    """Event-loop HTTP server over an SdaServerService — the asyncio twin
    of :class:`~sda_tpu_torch.http.server.SdaHttpServer` (same constructor, same
    public surface, same wire behavior; ``sdad --async``)."""

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
        # bind synchronously so .address is valid before the loop spins up
        # (every driver reads it right after construction)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port or 8888)))
        self._sock.listen(1024)
        self.sda_service = service
        self.bin_codec = bin_codec
        self.metrics_enabled = metrics_endpoint
        self.trace_log = trace_log
        self.node_id = node_id
        self.fleet_peers = fleet_peers
        service.server.node_id = node_id
        if fleet_peers is not None:
            metrics.gauge_set("fleet.peers", fleet_peers)
        self.admission = AdmissionControl(
            max_inflight=max_inflight, rate=rate_limit, burst=rate_burst,
            tenant_rate=tenant_rate, tenant_burst=tenant_burst,
        )
        self.statusz_fn = self.statusz if statusz_endpoint else None
        self.draining = False
        self.stats_lock = threading.Lock()
        self._status_counts: dict = {}
        self._active_requests = 0
        self._started_at = time.time()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._aserver: Optional[asyncio.AbstractServer] = None
        self._writers: set = set()
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=_worker_count(),
            thread_name_prefix="sda-async-http")
        self._stopped = threading.Event()
        self._shut_down = False

    # -- public surface (mirrors SdaHttpServer) -------------------------
    @property
    def address(self) -> str:
        host, port = self._sock.getsockname()[:2]
        return f"http://{host}:{port}"

    @property
    def status_counts(self) -> dict:
        with self.stats_lock:
            return dict(self._status_counts)

    @property
    def active_requests(self) -> int:
        with self.stats_lock:
            return self._active_requests

    def configure_admission(self, max_inflight=None, rate_limit=None,
                            rate_burst=None, tenant_rate=None,
                            tenant_burst=None) -> None:
        self.admission.configure(
            max_inflight=max_inflight, rate=rate_limit, burst=rate_burst,
            tenant_rate=tenant_rate, tenant_burst=tenant_burst,
        )

    def statusz(self) -> dict:
        return base.build_statusz(
            self.sda_service, node_id=self.node_id, admission=self.admission,
            started_at=self._started_at, status_counts=self.status_counts,
            plane="async",
        )

    def start_background(self) -> "SdaAsyncHttpServer":
        loop = asyncio.new_event_loop()
        self._loop = loop
        started = threading.Event()

        async def _start():
            self._aserver = await asyncio.start_server(
                self._serve_conn, sock=self._sock, limit=_MAX_LINE)
            started.set()

        def _run():
            asyncio.set_event_loop(loop)
            loop.create_task(_start())
            try:
                loop.run_forever()
            finally:
                # drain pending callbacks, then close for real
                try:
                    pending = asyncio.all_tasks(loop)
                    for task in pending:
                        task.cancel()
                    if pending:
                        loop.run_until_complete(asyncio.gather(
                            *pending, return_exceptions=True))
                finally:
                    loop.close()

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="sda-async-http-loop")
        self._thread.start()
        if not started.wait(timeout=10):
            raise RuntimeError("async HTTP server failed to start")
        return self

    def serve_forever(self):
        self.start_background()
        self._stopped.wait()

    def drain(self, grace_s: float = 10.0) -> dict:
        """Same drain contract as the threaded plane (docs/scaling.md):
        flip draining FIRST (fresh requests on live connections answer
        503 + ``Connection: close``), wake every parked long-poll so it
        finishes immediately, stop accepting, wait out in-flight work,
        hand held leases back, close. ``leaked`` must be 0."""
        self.draining = True
        wakeup = getattr(self.sda_service.server, "job_wakeup", None)
        if wakeup is not None:
            wakeup.notify_all()
        if self._loop is not None and self._aserver is not None:
            def _stop_accepting():
                if self._aserver is not None:
                    self._aserver.close()
            self._loop.call_soon_threadsafe(_stop_accepting)
        deadline = time.monotonic() + grace_s
        while self.active_requests and time.monotonic() < deadline:
            time.sleep(0.02)
        stranded = self.active_requests
        summary = base.drain_summary(self.sda_service, node_id=self.node_id,
                                     stranded=stranded)
        self.shutdown()
        return summary

    def shutdown(self):
        if self._shut_down:
            return
        self._shut_down = True
        loop = self._loop
        if loop is not None and loop.is_running():
            def _close_all():
                if self._aserver is not None:
                    self._aserver.close()
                for writer in list(self._writers):
                    try:
                        writer.close()
                    except Exception:
                        pass
                loop.stop()
            loop.call_soon_threadsafe(_close_all)
        if self._thread is not None:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                log.warning("async HTTP loop did not stop within 5s; "
                            "leaking daemon thread %s", self._thread.name)
                metrics.count("http.shutdown.leaked")
        self._executor.shutdown(wait=False)
        try:
            self._sock.close()
        except OSError:
            pass
        self._stopped.set()

    # -- connection handling --------------------------------------------
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter):
        self._writers.add(writer)
        peer = writer.get_extra_info("peername") or ("?",)
        client_ip = str(peer[0])
        try:
            while True:
                try:
                    line = await reader.readline()
                except (ValueError, asyncio.LimitOverrunError):
                    # oversized request line: answer like the threaded
                    # plane (BaseHTTPRequestHandler's 414), so a typed
                    # client fails fast instead of retrying a severed
                    # connection to its deadline
                    return await self._bail(writer, 414,
                                            "request line too long")
                except ConnectionError:
                    return
                if not line or line in (b"\r\n", b"\n"):
                    if not line:
                        return  # clean EOF between requests
                    continue
                try:
                    request = line.decode("latin-1").rstrip("\r\n")
                    method, raw_path, version = request.split(" ", 2)
                except ValueError:
                    return await self._bail(writer, 400, "malformed request line")
                if not version.startswith("HTTP/1."):
                    return await self._bail(writer, 505, "unsupported version")
                headers = _Headers()
                for _ in range(_MAX_HEADERS):
                    try:
                        hline = await reader.readline()
                    except (ValueError, asyncio.LimitOverrunError):
                        # oversized header line: threaded plane's 431
                        return await self._bail(
                            writer, 431, "header line too long")
                    except ConnectionError:
                        return
                    if hline in (b"\r\n", b"\n", b""):
                        break
                    name, sep, value = hline.decode("latin-1").partition(":")
                    if sep:
                        headers.add(name.strip(), value.strip())
                else:
                    return await self._bail(writer, 400, "too many headers")
                content_length = base.parse_content_length(
                    headers.get("Content-Length"))
                if content_length < 0:
                    return await self._bail(writer, 400, "bad Content-Length")
                if "chunked" in (headers.get("Transfer-Encoding") or "").lower():
                    return await self._bail(writer, 400,
                                            "chunked bodies unsupported")
                url = urlparse(raw_path)
                rx = _AsyncExchange(
                    self, asyncio.get_running_loop(), reader, client_ip,
                    method.upper(), url.path.rstrip("/"),
                    parse_qs(url.query), headers, content_length)
                with self.stats_lock:
                    self._active_requests += 1
                try:
                    close = await self._handle_request(rx, writer)
                finally:
                    with self.stats_lock:
                        self._active_requests -= 1
                want_close = (close or rx.close_connection
                              or version == "HTTP/1.0"
                              or (headers.get("Connection") or "")
                              .lower() == "close")
                if want_close:
                    return
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._writers.discard(writer)
            try:
                writer.close()
            except Exception:
                pass

    async def _bail(self, writer, status: int, reason: str):
        """Protocol-level garbage: answer once and sever (no keep-alive —
        framing can no longer be trusted)."""
        body = json.dumps({"error": reason}).encode()
        head = (f"HTTP/1.1 {status} "
                f"{_STATUS_REASONS.get(status, 'Error')}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n")
        try:
            writer.write(head.encode("latin-1") + body)
            await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass

    async def _handle_request(self, rx: _AsyncExchange, writer) -> bool:
        """One request: sync pipeline (span/admission/dispatch, via the
        shared core) on the executor, long-poll parks on the loop, reply
        written here. Returns True when the connection must close."""
        loop = asyncio.get_running_loop()
        parked = False
        try:
            reply = await loop.run_in_executor(
                self._executor, self._pipeline_sync, rx)
            if reply.park is not None:
                parked = True
                try:
                    reply = await self._park(rx, reply.park)
                finally:
                    # the admission in-flight slot covers the parked time
                    # (same as the threaded plane, where blocking_park runs
                    # inside the admission finally): a parked clerk IS
                    # in-flight work that max_inflight must bound
                    if rx.admitted:
                        self.admission.release()
        except asyncio.CancelledError:
            raise
        except Exception as e:  # pipeline crash outside dispatch's mapping
            log.exception("unexpected async-plane error")
            reply = base.Reply(500, {"error": f"{type(e).__name__}: {e}"},
                               close=True)
        close = await self._write_reply(rx, writer, reply)
        span = rx.span
        if span is not None:
            if parked:
                # the span object closed when the sync pipeline returned,
                # before the park — stretch its duration over the parked
                # time so cross-plane trace timelines agree (the threaded
                # plane holds its span open through blocking_park)
                span.duration_s = time.perf_counter() - rx.t0
                # the flight recorder already spooled the short pre-park
                # span at close; re-spool the amended one — forensics
                # dedupes by span id keeping the longest duration
                recorder.amend_span(span)
            if self.trace_log:
                trace_log.info(
                    "trace %s %s %s status=%s request_id=%s",
                    span.trace_id, rx.method, rx.route_path,
                    span.attributes.get("http.status"), rx.request_id)
        return close

    def _pipeline_sync(self, rx: _AsyncExchange):
        """The executor half — a faithful mirror of the threaded plane's
        ``_route_inner``: draining check, observability endpoints,
        request-id hygiene, server span, admission ordering, dispatch."""
        method, path = rx.method, rx.path
        rx.request_id = base.request_id(rx.headers.get(obs.REQUEST_ID_HEADER))
        # draining + the admission/tracing-exempt observability
        # endpoints, shared with the threaded plane
        pre = base.preroute_reply(self, method, path)
        if pre is not None:
            return pre

        label = base.route_label(method, rx.route_path)
        parent = obs.parse_traceparent(rx.headers.get(obs.TRACEPARENT_HEADER))
        span_attributes = {"http.method": method, "http.route": label,
                           "request_id": rx.request_id}
        if self.node_id:
            span_attributes["node_id"] = self.node_id
        # the trace_log line is emitted by _handle_request AFTER the
        # reply is written (and any park resolved) so it carries the
        # final http.status, exactly like the threaded plane's
        with obs.span(
            f"http.server {label}", parent=parent, kind="server",
            attributes=span_attributes,
        ) as server_span:
            rx.span = server_span
            if self.admission.enabled:
                shed = self.admission.admit(rx.agent_key(),
                                            tenant_key=rx.tenant_key())
                if shed is not None:
                    rx.shed = True
                    server_span.set_attribute("shed", shed.reason)
                    return base.Reply(
                        shed.status,
                        {"error": f"throttled: {shed.reason}"},
                        retry_after=shed.retry_after)
                try:
                    reply = base.dispatch(self.sda_service, rx)
                    if reply.park is not None:
                        # long-poll park: keep the slot held across
                        # the park; _handle_request releases it when
                        # the park resolves
                        rx.admitted = True
                    return reply
                finally:
                    if not rx.admitted:
                        self.admission.release()
            return base.dispatch(self.sda_service, rx)

    async def _park(self, rx: _AsyncExchange, park) -> base.Reply:
        """The event-loop park: one wakeup subscription + one waiting
        coroutine per parked long-poll — NO thread. Re-polls ride the
        executor; the tick covers cross-worker arrivals and lease expiry;
        drain wakes everyone with 503 + Connection: close."""
        loop = asyncio.get_running_loop()
        wakeup = getattr(self.sda_service.server, "job_wakeup", None)
        tick = base.park_tick(self.sda_service, self.fleet_peers)
        if wakeup is None:
            tick = base.longpoll_tick()  # no wakeup: tick IS the poll
        if rx.span is not None:
            rx.span.set_attribute("longpoll.parked", True)
        while True:
            if self.draining:
                metrics.count("http.drain.longpoll_woken")
                return base.draining_reply()
            event = asyncio.Event()
            sub = None
            if wakeup is not None:
                sub = wakeup.subscribe(
                    str(park.caller.id),
                    callback=lambda: loop.call_soon_threadsafe(event.set))
            try:
                reply = await loop.run_in_executor(
                    self._executor, base.poll_parked_job,
                    self.sda_service, park)
                if reply is not None:
                    return reply
                remaining = max(0.0, park.give_up_at - time.monotonic())
                timeout = remaining if tick is None else min(tick, remaining)
                try:
                    await asyncio.wait_for(event.wait(), timeout)
                except asyncio.TimeoutError:
                    pass
            finally:
                if sub is not None:
                    wakeup.unsubscribe(sub)

    async def _write_reply(self, rx: _AsyncExchange, writer,
                           reply: base.Reply) -> bool:
        """The async mirror of the threaded ``_reply``: response chaos
        failpoint, bounded unread-body drain, per-request counters and
        latency histograms, then the wire bytes. Returns close verdict."""
        if reply.span_attrs and rx.span is not None:
            for key, value in reply.span_attrs.items():
                rx.span.set_attribute(key, value)
        # failpoint: the service call already happened — dropping HERE
        # simulates a lost response; delay stalls the ack instead
        action = chaos.evaluate("http.server.response",
                                kinds=("drop", "delay"))
        if action is not None:
            if action.kind == "drop":
                log.info("%s %s -> chaos-dropped response",
                         rx.method, rx.path)
                return True
            await asyncio.sleep(action.delay_s)
        if reply.drop:
            log.info("%s %s -> chaos-dropped connection", rx.method, rx.path)
            return True
        # unread body bytes would be parsed as the next request line on
        # this keep-alive connection: drain them, bounded — a client that
        # advertised a body and never sends it forfeits the connection
        if rx.remaining:
            try:
                await asyncio.wait_for(self._discard_body(rx), timeout=5.0)
            except (asyncio.TimeoutError, ConnectionError,
                    asyncio.IncompleteReadError):
                rx.close_connection = True
        status = reply.status
        if reply.raw is not None:
            body = reply.raw
        else:
            body = (b"" if reply.obj is None
                    else json.dumps(reply.obj).encode("utf-8"))
        dt_ms = (time.perf_counter() - rx.t0) * 1e3
        if status >= 400:
            log.info("%s %s -> %d (%.1fms) request_id=%s",
                     rx.method, rx.path, status, dt_ms, rx.request_id)
        else:
            log.info("%s %s -> %d (%.1fms)", rx.method, rx.path, status,
                     dt_ms)
        span = rx.span
        if span is not None and "http.status" not in span.attributes:
            span.set_attribute("http.status", status)
        if not rx.counted:
            rx.counted = True
            with self.stats_lock:
                self._status_counts[status] = \
                    self._status_counts.get(status, 0) + 1
            metrics.count("http.request")
            metrics.count(f"http.status.{status}")
            if rx.shed:
                metrics.observe("http.latency.shed", dt_ms / 1e3)
            else:
                label = base.route_label(rx.method, rx.route_path)
                metrics.observe(f"http.latency.{label}", dt_ms / 1e3)
        close = reply.close or rx.close_connection
        head = [f"HTTP/1.1 {status} {_STATUS_REASONS.get(status, 'OK')}"]
        if rx.request_id:
            head.append(f"{obs.REQUEST_ID_HEADER}: {rx.request_id}")
        if self.node_id:
            head.append(f"{NODE_HEADER}: {self.node_id}")
        if self.bin_codec:
            head.append(f"{bincodec.CODECS_HEADER}: bin")
        if reply.headers:
            for key, value in reply.headers.items():
                head.append(f"{key}: {value}")
        if reply.resource_not_found:
            head.append("X-Resource-Not-Found: true")
        if reply.retry_after is not None:
            head.append(f"Retry-After: {max(0.0, reply.retry_after):.3f}")
        if close and not (reply.headers or {}).get("Connection"):
            head.append("Connection: close")
        head.append(f"Content-Type: {reply.content_type}")
        head.append(f"Content-Length: {len(body)}")
        payload = ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body
        try:
            writer.write(payload)
            await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            return True
        return close

    async def _discard_body(self, rx: _AsyncExchange):
        while rx.remaining:
            chunk = await rx.reader.read(min(_BODY_CHUNK, rx.remaining))
            if not chunk:
                rx.close_connection = True
                return
            rx.remaining -= len(chunk)
