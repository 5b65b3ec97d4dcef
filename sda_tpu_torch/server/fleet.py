"""Fleet launcher: N stateless ``sdad`` worker processes, one shared store.

The SDA server is an untrusted broker + job scheduler over durable stores
(PAPER.md: ``server/src/snapshot.rs`` merely transposes participations
into per-clerk jobs), so nothing in the protocol requires a single
process. This module turns that property into an operational shape: spawn
N real OS processes, each a full ``sdad`` (``sda_tpu_torch/cli/serverd.py``),
all pointed at ONE shared backend — a WAL-mode sqlite file, a jsonfs
directory, or a MongoDB URI. Correctness under contention does not live
here: it lives in the store layer's contended-idempotency contract
(``stores.py``: single-winner ``create_snapshot`` /
``snapshot_participations``, lease-arbitrated job pickup), which this
launcher merely exercises. Any worker can serve any request; the
consistent-hash ring (``routing.py``) only concentrates affinity.

Lifecycle contract with the worker CLI:

- startup: the worker prints ``sdad listening on http://host:port`` as its
  first stdout line; the launcher parses it for the bound address (port 0
  binds are ephemeral, so the line is the only source of truth).
- shutdown: the launcher sends SIGTERM; the worker drains (stop accepting,
  finish in-flight, release held clerking-job leases back to the shared
  store) and prints ``sdad drained {json}`` as its last stdout line. The
  summary's ``leaked`` must be 0 — a leaked handler thread means a request
  was abandoned mid-flight.

This is also the engine under ``sda-fleet`` (the operator CLI) and the
loadgen driver's ``--fleet N`` mode (docs/scaling.md).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .routing import DEFAULT_REPLICAS, HashRing

log = logging.getLogger(__name__)

LISTEN_PREFIX = "sdad listening on "
DRAIN_PREFIX = "sdad drained "

#: Stdout/stderr lines retained per worker for post-mortems.
_LOG_LINES = 200


def merge_statusz_block(docs, block: str) -> Dict[str, int]:
    """Sum one counter block (``"participation"``, ``"codec_counters"``,
    ...) across worker ``/statusz`` documents. Counters are per-process,
    so the fleet-wide tally is the sum of the workers' — the shared merge
    under every drill's exactly-once and codec verdicts."""
    merged: Dict[str, int] = {}
    for doc in docs:
        for name, count in ((doc or {}).get(block) or {}).items():
            merged[name] = merged.get(name, 0) + count
    return merged


@dataclass
class FleetWorker:
    """One spawned ``sdad`` process and what the launcher learned about it."""

    node_id: str
    command: List[str]
    process: Optional[subprocess.Popen] = None
    address: Optional[str] = None
    drain_summary: Optional[dict] = None
    returncode: Optional[int] = None
    log: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=_LOG_LINES))
    _ready: threading.Event = field(default_factory=threading.Event)
    _pump: Optional[threading.Thread] = None

    def to_obj(self) -> dict:
        return {
            "node_id": self.node_id,
            "address": self.address,
            "pid": self.process.pid if self.process else None,
        }


class Fleet:
    """Spawn, address, and drain N ``sdad`` workers over one backend.

    ``backend_args`` selects the SHARED store exactly as on the ``sdad``
    command line (``["--sqlite", path]`` / ``["--jfs", dir]`` /
    ``["--mongo", uri]``); ``extra_args`` is appended verbatim to every
    worker (lease, admission, chaos, observability flags). ``base_port``
    0 gives every worker an ephemeral port (the default — the listen line
    reports it); a nonzero base gives worker *i* ``base_port + i``.

    Context-manager friendly: ``with Fleet(...) as fleet:`` starts the
    workers and drains them on exit.
    """

    def __init__(
        self,
        n: int,
        backend_args: Sequence[str],
        *,
        extra_args: Sequence[str] = (),
        node_prefix: str = "w",
        host: str = "127.0.0.1",
        base_port: int = 0,
        replicas: int = DEFAULT_REPLICAS,
        env: Optional[dict] = None,
    ):
        if n < 1:
            raise ValueError("a fleet needs at least one worker")
        if "--memory" in backend_args:
            raise ValueError(
                "--memory cannot back a fleet: each process would get its "
                "own isolated store; use --sqlite/--jfs/--mongo")
        self.replicas = replicas
        self.env = env
        self.workers: List[FleetWorker] = []
        for i in range(n):
            node_id = f"{node_prefix}{i}"
            port = 0 if base_port == 0 else base_port + i
            command = [
                sys.executable, "-m", "sda_tpu_torch.cli.serverd",
                *backend_args,
                "--node-id", node_id,
                "--fleet-peers", str(n),
                *extra_args,
                "httpd", "--bind", f"{host}:{port}",
            ]
            self.workers.append(FleetWorker(node_id=node_id, command=command))

    # -- lifecycle ---------------------------------------------------------
    def _pump_output(self, worker: FleetWorker) -> None:
        """Reader thread: parse the two protocol lines (listen, drain),
        retain the rest for post-mortems, never let the pipe fill."""
        assert worker.process is not None and worker.process.stdout is not None
        for line in worker.process.stdout:
            line = line.rstrip("\n")
            worker.log.append(line)
            if worker.address is None and line.startswith(LISTEN_PREFIX):
                worker.address = line[len(LISTEN_PREFIX):].strip()
                worker._ready.set()
            elif line.startswith(DRAIN_PREFIX):
                try:
                    worker.drain_summary = json.loads(line[len(DRAIN_PREFIX):])
                except ValueError:
                    log.warning("%s: unparseable drain line: %s",
                                worker.node_id, line)
        worker._ready.set()  # EOF: unblock start() so it can report death

    def start(self, timeout_s: float = 60.0) -> "Fleet":
        """Spawn every worker and wait until all report their address."""
        env = dict(os.environ if self.env is None else self.env)
        # workers must import sda_tpu_torch exactly as this process does, even
        # when the package is run from a source tree instead of installed
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        # the fleet plane measures the transport/store tier; keep worker
        # startup light and deterministic on any host
        env.setdefault("JAX_PLATFORMS", "cpu")
        for worker in self.workers:
            # stderr folded into stdout: worker tracebacks land in the
            # retained log instead of interleaving on the launcher's tty
            worker.process = subprocess.Popen(
                worker.command, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, env=env,
            )
            worker._pump = threading.Thread(
                target=self._pump_output, args=(worker,), daemon=True)
            worker._pump.start()
        deadline = time.monotonic() + timeout_s
        for worker in self.workers:
            worker._ready.wait(max(0.0, deadline - time.monotonic()))
            if worker.address is None:
                tail = "\n".join(list(worker.log)[-20:])
                self.stop(timeout_s=5.0)
                raise RuntimeError(
                    f"fleet worker {worker.node_id} did not report an "
                    f"address within {timeout_s}s; last output:\n{tail}")
        log.info("fleet up: %s",
                 {w.node_id: w.address for w in self.workers})
        return self

    def kill(self, node_id: str) -> FleetWorker:
        """SIGKILL one worker — no drain, no lease handback, no drained
        line: the ungraceful death the gray-failure plane exists for.
        The worker's heartbeat goes stale, a peer's failure detector
        declares it dead and recalls its held leases
        (``server/health.py``); this method only delivers the blow."""
        worker = next((w for w in self.workers if w.node_id == node_id),
                      None)
        if worker is None:
            raise ValueError(f"no fleet worker named {node_id!r}")
        if worker.process is not None and worker.process.poll() is None:
            worker.process.kill()
            worker.process.wait()
        if worker._pump is not None:
            worker._pump.join(timeout=5.0)
        worker.returncode = (worker.process.returncode
                             if worker.process is not None else None)
        log.warning("fleet worker %s SIGKILLed (no drain)", node_id)
        return worker

    def stop(self, timeout_s: float = 30.0) -> List[dict]:
        """SIGTERM every worker (graceful drain), reap, return the drain
        summaries. Stragglers past the timeout are SIGKILLed and reported
        with ``{"killed": True}`` — a killed worker never drained, so its
        leases ride out the visibility timeout instead."""
        for worker in self.workers:
            if worker.process is not None and worker.process.poll() is None:
                try:
                    worker.process.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + timeout_s
        summaries = []
        for worker in self.workers:
            if worker.process is None:
                continue
            try:
                worker.process.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                log.warning("%s: did not drain in time; killing",
                            worker.node_id)
                worker.process.kill()
                worker.process.wait()
            if worker._pump is not None:
                worker._pump.join(timeout=5.0)
            worker.returncode = worker.process.returncode
            summaries.append(worker.drain_summary
                             or {"node_id": worker.node_id, "killed": True})
        return summaries

    def __enter__(self) -> "Fleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- topology ----------------------------------------------------------
    @property
    def node_ids(self) -> List[str]:
        return [w.node_id for w in self.workers]

    @property
    def addresses(self) -> Dict[str, str]:
        """``{node_id: http://host:port}`` for every started worker."""
        return {w.node_id: w.address for w in self.workers
                if w.address is not None}

    def ring(self) -> HashRing:
        """The fleet's consistent-hash ring — every client/worker/launcher
        computes the same mapping from the same node list, so routing
        needs no coordination service (routing.py)."""
        return HashRing(self.node_ids, replicas=self.replicas)

    def scrape_statusz(self, timeout_s: float = 10.0) -> Dict[str, dict]:
        """Best-effort ``/statusz`` scrape of every addressable worker —
        ``{node_id: doc}``, unreachable workers silently omitted. Worker
        counters (exactly-once ingestion tallies, codec traffic, armed
        failpoints) live in THEIR processes and die on drain, so drills
        must scrape before ``stop()``; this is the one implementation the
        load/soak/FL drills share."""
        import requests

        docs: Dict[str, dict] = {}
        for node, address in self.addresses.items():
            try:
                docs[node] = requests.get(address + "/statusz",
                                          timeout=timeout_s).json()
            except Exception:
                continue
        return docs

    def to_obj(self) -> dict:
        return {"workers": [w.to_obj() for w in self.workers]}
