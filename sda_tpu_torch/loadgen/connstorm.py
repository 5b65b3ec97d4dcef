"""Connection-storm drill: N concurrent open connections on ONE worker.

The async plane's scaling claim is not requests/sec — it's *connections
held*: millions of sporadic phones mostly sit on idle keep-alive sockets
or parked long-polls, and the thread-per-connection plane pays an OS
thread for every one of them. This drill opens ``connections`` real TCP
connections against a single ``sdad`` worker process (spawned as a
subprocess so the driver's and the server's fd budgets don't share one
rlimit), sends one request per connection per wave while HOLDING every
socket open, and verifies:

- zero 5xx — admission may shed (429/503 + Retry-After), exhaustion may
  not error;
- the worker still answers promptly on a late wave with N-1 idle
  connections parked (the event loop does not degrade with idle fds);
- worker RSS stays under a fixed bound (``rss_limit_mb``) — per-
  connection state is buffers + a coroutine, not a thread stack;
- SIGTERM still drains clean (``leaked == 0``) with every connection
  open.

``sda-sim --connstorm N`` prints the BENCH-style record; ci.sh runs the
10k-connection smoke and gates the record advisory (docs/scaling.md).
"""

from __future__ import annotations

import asyncio
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class ConnstormProfile:
    connections: int = 10000
    #: request waves over the held connections (wave 1 proves admission
    #: under the connect flood, the last wave proves liveness with every
    #: other connection idle)
    waves: int = 2
    #: concurrent connect/request pipelining bound (driver side)
    concurrency: int = 512
    async_http: bool = True
    #: worker RSS ceiling (MiB) with every connection open. The worker's
    #: import baseline alone is ~350 MiB (jax/numpy); the drill also
    #: reports per-connection growth, which is the number that must stay
    #: O(10 KiB) for the plane's scaling story
    rss_limit_mb: float = 1024.0
    request_timeout_s: float = 60.0
    timeout_s: float = 600.0
    seed: int = 0


def _raise_nofile(need: int) -> int:
    """Best-effort: lift RLIMIT_NOFILE's soft limit toward the hard one;
    returns the resulting soft limit."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = need + 256
    if soft < want:
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE,
                               (min(want, hard), hard))
        except (ValueError, OSError):
            pass
        soft, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
    return soft


def _rss_mb(pid: int) -> Optional[float]:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except (OSError, ValueError, IndexError):
        return None
    return None


class _Conn:
    __slots__ = ("reader", "writer")

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer


async def _request(conn: _Conn, host: str, timeout: float) -> int:
    """One keep-alive GET /v1/ping on an open connection; returns the
    status code (negative for transport failure)."""
    try:
        conn.writer.write(
            (f"GET /v1/ping HTTP/1.1\r\nHost: {host}\r\n"
             f"Connection: keep-alive\r\n\r\n").encode())
        await asyncio.wait_for(conn.writer.drain(), timeout)
        status_line = await asyncio.wait_for(conn.reader.readline(), timeout)
        parts = status_line.decode("latin-1", "replace").split(" ", 2)
        status = int(parts[1])
        content_length = 0
        while True:
            line = await asyncio.wait_for(conn.reader.readline(), timeout)
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.decode("latin-1", "replace").partition(":")
            if name.strip().lower() == "content-length":
                content_length = int(value.strip() or 0)
        if content_length:
            await asyncio.wait_for(
                conn.reader.readexactly(content_length), timeout)
        return status
    except (asyncio.TimeoutError, asyncio.IncompleteReadError,
            ConnectionError, ValueError, IndexError, OSError):
        return -1


async def _storm(profile: ConnstormProfile, host: str, port: int,
                 proc) -> dict:
    server_pid = proc.pid
    sem = asyncio.Semaphore(profile.concurrency)
    conns: List[Optional[_Conn]] = [None] * profile.connections
    connect_failures = 0

    async def _open(ix: int):
        nonlocal connect_failures
        async with sem:
            for attempt in range(3):
                try:
                    reader, writer = await asyncio.wait_for(
                        asyncio.open_connection(host, port),
                        profile.request_timeout_s)
                    conns[ix] = _Conn(reader, writer)
                    return
                except (OSError, asyncio.TimeoutError):
                    await asyncio.sleep(0.05 * (attempt + 1))
            connect_failures += 1

    t0 = time.perf_counter()
    await asyncio.gather(*(_open(i) for i in range(profile.connections)))
    connect_s = time.perf_counter() - t0
    open_conns = [c for c in conns if c is not None]

    waves = []
    statuses: dict = {}
    for wave in range(profile.waves):
        latencies: List[float] = []

        async def _wave_req(conn: _Conn):
            async with sem:
                w0 = time.perf_counter()
                status = await _request(conn, host,
                                        profile.request_timeout_s)
                latencies.append(time.perf_counter() - w0)
                statuses[status] = statuses.get(status, 0) + 1

        w_start = time.perf_counter()
        await asyncio.gather(*(_wave_req(c) for c in open_conns))
        wall = time.perf_counter() - w_start
        latencies.sort()
        waves.append({
            "requests": len(open_conns),
            "wall_s": round(wall, 3),
            "rps": round(len(open_conns) / wall, 1) if wall else 0.0,
            "p50_ms": round(latencies[len(latencies) // 2] * 1e3, 1)
            if latencies else None,
            "p99_ms": round(
                latencies[min(len(latencies) - 1,
                              int(len(latencies) * 0.99))] * 1e3, 1)
            if latencies else None,
            "rss_mb": _rss_mb(server_pid),
        })
        if wave + 1 < profile.waves:
            await asyncio.sleep(0.5)  # let the fleet of sockets idle

    rss_final = _rss_mb(server_pid)
    # SIGTERM lands NOW, with every socket still open: drain-with-held-
    # connections is the risky case this drill exists to gate — closing
    # first would hand the worker a trivially easier drain
    d0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    loop = asyncio.get_running_loop()
    drain_timed_out = False
    try:
        await asyncio.wait_for(loop.run_in_executor(None, proc.wait), 30)
    except asyncio.TimeoutError:
        drain_timed_out = True
    drain_wall_s = time.perf_counter() - d0
    for conn in open_conns:
        try:
            conn.writer.close()
        except Exception:
            pass
    return {
        "open_connections": len(open_conns),
        "connect_failures": connect_failures,
        "connect_s": round(connect_s, 2),
        "statuses": {str(k): v for k, v in sorted(statuses.items())},
        "waves": waves,
        "rss_mb": rss_final,
        "drained_with_open_connections": len(open_conns),
        "drain_wall_s": round(drain_wall_s, 2),
        "drain_timed_out": drain_timed_out,
    }


def run_connstorm(profile: Optional[ConnstormProfile] = None) -> dict:
    """Spawn one ``sdad`` worker (async plane by default), hold
    ``connections`` open sockets against it, ping in waves, check RSS,
    then SIGTERM-drain it. Returns the BENCH-style record."""
    profile = profile or ConnstormProfile()
    requested = profile.connections
    soft_limit = _raise_nofile(profile.connections)
    achievable = max(64, min(profile.connections, soft_limit - 256))
    clamped = achievable < profile.connections
    if clamped:
        profile = ConnstormProfile(**{**profile.__dict__,
                                      "connections": achievable})

    argv = [sys.executable, "-m", "sda_tpu_torch.cli.serverd", "--memory"]
    if profile.async_http:
        argv.append("--async")
    argv += ["--statusz", "httpd", "--bind", "127.0.0.1:0"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, env=env)
    try:
        line = proc.stdout.readline()
        if "listening on" not in line:
            raise RuntimeError(f"sdad failed to start: {line!r}")
        address = line.rsplit(" ", 1)[-1].strip()
        host, port = address.split("//", 1)[1].rsplit(":", 1)
        rss_baseline = _rss_mb(proc.pid)
        # _storm itself SIGTERMs and waits out the worker while every
        # socket is still open; this finally is only the crash backstop
        result = asyncio.run(_storm(profile, host, int(port), proc))
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    drain = None
    for out_line in (proc.stdout.read() or "").splitlines():
        if out_line.startswith("sdad drained "):
            import json as _json

            drain = _json.loads(out_line[len("sdad drained "):])
    errors_5xx = sum(v for k, v in result["statuses"].items()
                     if k.isdigit() and int(k) >= 500 and int(k) != 503)
    shed = sum(v for k, v in result["statuses"].items() if k in ("429",
                                                                 "503"))
    transport_failures = result["statuses"].get("-1", 0)
    rss = result["rss_mb"]
    record = {
        "metric": (f"concurrent open connections on one "
                   f"{'async' if profile.async_http else 'threaded'}-plane "
                   f"worker ({profile.waves} ping waves, held sockets)"),
        "value": result["open_connections"],
        "unit": "connections",
        "platform": "cpu",
        "host_cores": os.cpu_count(),
        "seed": profile.seed,
        "http_plane": "async" if profile.async_http else "threaded",
        "requested_connections": requested,
        "fd_soft_limit": soft_limit,
        "clamped_by_fd_limit": clamped,
        "connect_failures": result["connect_failures"],
        "transport_failures": transport_failures,
        "connect_s": result["connect_s"],
        "waves": result["waves"],
        "statuses": result["statuses"],
        "errors_5xx": errors_5xx,
        "shed": shed,
        "rss_mb": rss,
        "rss_baseline_mb": rss_baseline,
        "rss_growth_mb": (round(rss - rss_baseline, 1)
                          if rss is not None and rss_baseline is not None
                          else None),
        "per_connection_kb": (round(
            (rss - rss_baseline) * 1024.0 / result["open_connections"], 1)
            if rss is not None and rss_baseline is not None
            and result["open_connections"] else None),
        "rss_limit_mb": profile.rss_limit_mb,
        "rss_bounded": (rss <= profile.rss_limit_mb
                        if rss is not None else None),
        "drain": drain,
        "leaked": (drain or {}).get("leaked"),
        "drained_with_open_connections":
            result["drained_with_open_connections"],
        "drain_wall_s": result["drain_wall_s"],
        # the drill verdict ci.sh asserts: every connection served every
        # wave with zero exhaustion errors, memory bounded, and the
        # worker drained clean WHILE every socket was still open
        "ok": bool(
            result["open_connections"] >= min(profile.connections,
                                              achievable)
            and errors_5xx == 0
            and transport_failures == 0
            and result["connect_failures"] == 0
            and (rss is None or rss <= profile.rss_limit_mb)
            and (drain or {}).get("leaked") == 0
            and not result["drain_timed_out"]
        ),
    }
    return record
