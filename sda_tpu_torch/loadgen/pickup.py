"""Job-pickup A/B bench: long-poll clerking vs the polling baseline.

The long-poll plane's whole point is one number: how long a freshly
fanned-out clerking job waits before a clerk picks it up. Under polling
that latency IS the polling interval (a clerk that just found the queue
empty sleeps through the enqueue); under long-poll it collapses to the
in-process wakeup hop. This bench measures exactly that, as the
server-stamped ``server.job.pickup`` histogram (enqueue -> lease), on
the SAME fixed-seed round driven twice:

- **polling**: every committee clerk runs ``SdaClient.run_clerk`` with
  ``wait_s=0`` — the classic jittered sleep loop at ``poll_interval``;
- **longpoll**: the same clerks run with ``wait_s>0`` — each empty poll
  parks on ``GET /v1/clerking-jobs?wait=S`` until snapshot fan-out wakes
  it.

Both modes serve from the same HTTP plane (``async_http`` selects) so
the delta isolates the *delivery mechanism*, not the transport. The
returned BENCH record's headline is the long-poll p99 (direction:
lower), with the polling baseline and the speedup alongside — ci.sh
gates the ≥10x win (docs/load.md, docs/http.md).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Optional

from .. import chaos, obs
from ..utils import metrics


@dataclass
class PickupProfile:
    participants: int = 6
    dim: int = 4
    #: snapshots per mode: each fans out one job per committee clerk, so
    #: samples = snapshots * 8 (golden committee)
    snapshots: int = 6
    #: the polling baseline's sleep between empty polls — the latency a
    #: polling clerk pays on pickup (0.5 s is a conservative device
    #: cadence; production phones poll far slower)
    poll_interval: float = 0.5
    #: long-poll park budget per request
    wait_s: float = 10.0
    seed: int = 0
    async_http: bool = True
    timeout_s: float = 120.0
    device: Optional[str] = None  # the clients' device: CUDA unless "cpu"


def _run_mode(profile: PickupProfile, wait_s: float) -> dict:
    """One fixed-seed multi-snapshot round; returns the pickup summary
    (+ bit-exactness verdict of the final reveal)."""
    import numpy as np

    from ..chaos.drill import golden_packed_scheme
    from ..client import SdaClient
    from ..crypto import MemoryKeystore
    from ..http import SdaHttpClient, server_class
    from ..protocol import (
        Aggregation,
        AggregationId,
        FullMasking,
        SodiumEncryption,
    )
    from ..server import new_memory_server

    scheme = golden_packed_scheme()
    obs.reset_all()
    chaos.reset()
    service = new_memory_server()
    service.server.clerking_lease_seconds = 30.0
    http_server = server_class(profile.async_http)(service,
                                                   bind="127.0.0.1:0")
    http_server.start_background()
    stop = threading.Event()
    threads = []
    try:
        def new_client():
            keystore = MemoryKeystore()
            agent = SdaClient.new_agent(keystore)
            return SdaClient(agent, keystore,
                             SdaHttpClient(http_server.address, token="t"),
                             device=profile.device)

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
            id=AggregationId.random(), title="pickup-bench",
            vector_dimension=profile.dim, modulus=scheme.prime_modulus,
            recipient=recipient.agent.id, recipient_key=recipient_key,
            masking_scheme=FullMasking(scheme.prime_modulus),
            committee_sharing_scheme=scheme,
            recipient_encryption_scheme=SodiumEncryption(),
            committee_encryption_scheme=SodiumEncryption(),
        )
        recipient.upload_aggregation(agg)
        recipient.begin_aggregation(agg.id)
        committee = recipient.service.get_committee(recipient.agent, agg.id)
        clerks = [candidates[cid] for cid, _ in committee.clerks_and_keys]

        rng = np.random.default_rng(profile.seed)
        inputs = rng.integers(0, scheme.prime_modulus,
                              size=(profile.participants, profile.dim),
                              dtype=np.int64)
        for row in inputs:
            participant = new_client()
            participant.upload_agent()
            participant.participate([int(x) for x in row], agg.id)

        # the committee goes live BEFORE any snapshot exists: polling
        # clerks settle into their sleep cadence, long-poll clerks park —
        # so every fan-out below lands on a steady-state committee
        for clerk in clerks:
            t = threading.Thread(
                target=clerk.run_clerk,
                kwargs=dict(wait_s=wait_s,
                            poll_interval=profile.poll_interval,
                            stop=stop, deadline=profile.timeout_s),
                daemon=True)
            t.start()
            threads.append(t)
        time.sleep(min(1.0, profile.poll_interval))

        stagger = random.Random(profile.seed)
        deadline = time.monotonic() + profile.timeout_s
        done_snapshots = 0
        snapshot_ids = []
        for _ in range(profile.snapshots):
            # decorrelate fan-out from the polling phase: without the
            # seeded stagger, snapshot N+1's timing would be locked to
            # the committee's wake-up from snapshot N
            time.sleep(stagger.uniform(0.1, 1.0) * profile.poll_interval)
            snapshot_ids.append(recipient.snapshot_aggregation(agg.id))
            while time.monotonic() < deadline:
                status = recipient.service.get_aggregation_status(
                    recipient.agent, agg.id)
                counts = {s.id: s.number_of_clerking_results
                          for s in status.snapshots}
                if counts.get(snapshot_ids[-1], 0) >= scheme.share_count:
                    done_snapshots += 1
                    break
                time.sleep(0.02)
        output = recipient.reveal_aggregation(agg.id, snapshot_ids[0])
        expected = inputs.sum(axis=0) % scheme.prime_modulus
        exact = bool((output.positive().values == expected).all())
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        http_server.shutdown()
    summary = metrics.histogram_report("server.job.pickup").get(
        "server.job.pickup")
    longpoll_counters = metrics.counter_report("http.longpoll.") or None
    return {
        "pickup": summary,
        "exact": exact,
        "snapshots_done": done_snapshots,
        "longpoll_counters": longpoll_counters,
    }


def run_pickup_bench(profile: Optional[PickupProfile] = None) -> dict:
    """The A/B: same fixed-seed round, polling then long-poll; returns
    the BENCH record (headline: long-poll pickup p99, direction lower)."""
    profile = profile or PickupProfile()
    from ..crypto import sodium

    if not sodium.available():
        raise RuntimeError("the pickup bench needs libsodium "
                           "(real crypto round)")
    polling = _run_mode(profile, wait_s=0.0)
    longpoll = _run_mode(profile, wait_s=profile.wait_s)

    def _ms(summary, key):
        return round(summary[key] * 1e3, 3) if summary else None

    poll_p99 = _ms(polling["pickup"], "p99")
    lp_p99 = _ms(longpoll["pickup"], "p99")
    return {
        "metric": (f"clerk job-pickup p99 under long-poll "
                   f"(8-clerk committee, {profile.snapshots} snapshots, "
                   f"vs {profile.poll_interval}s polling)"),
        "value": lp_p99,
        "unit": "ms",
        "direction": "lower",
        "platform": "cpu",
        "seed": profile.seed,
        "http_plane": "async" if profile.async_http else "threaded",
        "poll_interval_s": profile.poll_interval,
        "wait_s": profile.wait_s,
        "exact": bool(polling["exact"] and longpoll["exact"]),
        "snapshots": profile.snapshots,
        "samples": int((longpoll["pickup"] or {}).get("count", 0)),
        "longpoll": {
            "p50_ms": _ms(longpoll["pickup"], "p50"),
            "p99_ms": lp_p99,
            "max_ms": _ms(longpoll["pickup"], "max"),
        },
        "polling": {
            "p50_ms": _ms(polling["pickup"], "p50"),
            "p99_ms": poll_p99,
            "max_ms": _ms(polling["pickup"], "max"),
        },
        # the headline ratio ci.sh gates: >= 10x is the acceptance bar
        "speedup_p99": (round(poll_p99 / lp_p99, 2)
                        if poll_p99 and lp_p99 else None),
    }
