"""Server-side admission control: shed load *before* doing work.

SDA's broker faces "many weak, sporadic devices" (PAPER.md) — the overload
failure mode is a retry storm from thousands of participants that drives a
saturated server into collapse. Following the Tail-at-Scale playbook, the
cheapest correct response is early rejection with an explicit come-back
hint: a rejected request costs one header parse, an admitted one proceeds
to auth/crypto/store work.

Three independent guards, each optional (``None`` disables):

- **per-tenant budget bucket** (``tenant_rate`` tokens/sec,
  ``tenant_burst`` capacity), keyed by the ``X-SDA-Tenant`` request
  header — the RECIPIENT the request's traffic belongs to. This is the
  multi-tenant fairness layer (the continuous service plane,
  ``sda_tpu_torch/service``): one hot tenant's device swarm sheds ``429``
  against its OWN budget before it can exhaust the shared in-flight cap
  or crowd out other tenants' agents. Checked FIRST, before the shared
  limits, by design. Like the agent key, the header is deliberately
  unverified (rate limiting must not pay the auth lookup it protects);
  requests without the header simply skip this guard.
- **per-agent token bucket** (``rate`` tokens/sec, ``burst`` capacity),
  keyed by the Basic-auth username (the agent id) or, for unauthenticated
  requests, the client address. Overflow sheds ``429`` with a
  ``Retry-After`` hint computed from the bucket's actual refill time, so
  a well-behaved client converges instead of hammering.
- **bounded in-flight limiter** (``max_inflight`` concurrently handled
  requests, process-wide). Overflow sheds ``503`` + a short ``Retry-After``
  — the server is saturated regardless of who is asking.

Decisions are counted under ``http.throttled.rate`` /
``http.throttled.tenant`` / ``http.throttled.inflight``; the current and
peak concurrency ride the ``http.inflight`` / ``http.inflight.peak``
gauges (the queue-depth signal capacity reports key on), and the
per-tenant verdicts are summarized by :meth:`AdmissionControl.tenants_report`
(``/statusz.admission``).

The handler MUST pair every admitted request with ``release()``
(try/finally in ``_Handler._route``), or the in-flight counter leaks.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from ..utils import metrics

#: Prune idle per-agent buckets past this population (DoS hygiene: a churn
#: of one-shot agent ids must not grow the dict without bound).
_MAX_BUCKETS = 8192
_BUCKET_IDLE_S = 300.0

#: The request header naming the tenant (recipient) a request's traffic
#: belongs to — the per-tenant budget key. Clients stamp it on every
#: request of an aggregation's round (``SdaHttpClient.tenant``).
TENANT_HEADER = "X-SDA-Tenant"


class TokenBucket:
    """Classic token bucket; mutated under the owning controller's lock."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        # a burst below one token could never admit anything yet would
        # keep emitting finite Retry-After hints — clamp the config
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self.stamp = now

    def try_take(self, now: float) -> float:
        """Take one token. Returns 0.0 on success, else the seconds until
        a token will have accrued (the ``Retry-After`` hint)."""
        elapsed = max(0.0, now - self.stamp)
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        self.stamp = now
        # epsilon: a client that honors the hint to the letter must not be
        # re-shed over float rounding in the refill product
        if self.tokens >= 1.0 - 1e-9:
            self.tokens = max(0.0, self.tokens - 1.0)
            return 0.0
        return (1.0 - self.tokens) / self.rate


class ShedDecision:
    """Why a request was rejected, and when to come back."""

    __slots__ = ("status", "retry_after", "reason")

    def __init__(self, status: int, retry_after: float, reason: str):
        self.status = status
        self.retry_after = retry_after
        self.reason = reason


class AdmissionControl:
    """Combined rate-limit + concurrency guard for ``SdaHttpServer``.

    Thread-safe; all knobs may be retuned at runtime via ``configure``
    (the loadgen driver arms overload profiles after round setup).
    """

    def __init__(
        self,
        max_inflight: Optional[int] = None,
        rate: Optional[float] = None,
        burst: float = 8.0,
        tenant_rate: Optional[float] = None,
        tenant_burst: float = 32.0,
    ):
        self._lock = threading.Lock()
        self.max_inflight = max_inflight
        self.rate = rate
        self.burst = burst
        self.tenant_rate = tenant_rate
        self.tenant_burst = tenant_burst
        self._buckets: Dict[str, TokenBucket] = {}
        self._tenant_buckets: Dict[str, TokenBucket] = {}
        # per-tenant verdict tallies [admitted, shed] for /statusz and
        # the soak report; bounded alongside the bucket dicts
        self._tenant_stats: Dict[str, list] = {}
        # one prune stamp PER bucket dict: a sweep triggered by tenant
        # churn must not suppress the agent dict's sweep (or vice versa),
        # which would force O(1) eviction of possibly-active entries
        self._last_prune: Dict[int, float] = {}
        self._inflight = 0

    def configure(
        self,
        max_inflight: Optional[int] = None,
        rate: Optional[float] = None,
        burst: Optional[float] = None,
        tenant_rate: Optional[float] = None,
        tenant_burst: Optional[float] = None,
    ) -> None:
        """REPLACE the whole admission config: each guard is set exactly
        as passed (``None`` disables it; ``burst=None`` restores the
        default) — no field survives a retune implicitly."""
        with self._lock:
            self.max_inflight = max_inflight
            self.rate = rate
            self.burst = 8.0 if burst is None else burst
            self.tenant_rate = tenant_rate
            self.tenant_burst = 32.0 if tenant_burst is None else tenant_burst
            self._buckets.clear()
            self._tenant_buckets.clear()
            self._tenant_stats.clear()

    @property
    def enabled(self) -> bool:
        return (self.max_inflight is not None or self.rate is not None
                or self.tenant_rate is not None)

    def _bucket(self, buckets: Dict[str, TokenBucket], key: str,
                rate: float, burst: float, now: float) -> TokenBucket:
        """Get-or-create under the held lock, with the bounded-population
        eviction discipline: the key is an UNVERIFIED header/username, so
        a churn of fresh keys must cycle the dict, never grow it —
        stale-sweep at most every few seconds, otherwise evict the
        oldest-created entry O(1)."""
        bucket = buckets.get(key)
        if bucket is None:
            if len(buckets) >= _MAX_BUCKETS:
                if now - self._last_prune.get(id(buckets), 0.0) > 5.0:
                    self._last_prune[id(buckets)] = now
                    cutoff = now - _BUCKET_IDLE_S
                    for stale in [k for k, b in buckets.items()
                                  if b.stamp < cutoff]:
                        del buckets[stale]
                if len(buckets) >= _MAX_BUCKETS:
                    del buckets[next(iter(buckets))]
            bucket = buckets[key] = TokenBucket(rate, burst, now)
        return bucket

    def _tenant_note(self, tenant_key: str, shed: bool) -> None:
        stats = self._tenant_stats.get(tenant_key)
        if stats is None:
            if len(self._tenant_stats) >= _MAX_BUCKETS:
                self._tenant_stats.pop(next(iter(self._tenant_stats)))
            stats = self._tenant_stats[tenant_key] = [0, 0]
        stats[1 if shed else 0] += 1

    def admit(self, agent_key: str,
              tenant_key: Optional[str] = None) -> Optional[ShedDecision]:
        """Admit or shed one request. ``None`` = admitted (in-flight slot
        taken; the caller owes a ``release()``); else the shed decision."""
        now = time.monotonic()
        with self._lock:
            # tenant budget FIRST: a hot tenant must shed against its own
            # budget BEFORE it can touch the shared in-flight cap — that
            # ordering IS the fairness property (one tenant's burst can
            # starve itself, never the fleet). The admitted-then-503'd
            # case burns a tenant token: the request did arrive on the
            # tenant's account.
            if self.tenant_rate is not None and tenant_key:
                if self.tenant_rate <= 0.0:
                    metrics.count("http.throttled.tenant")
                    self._tenant_note(tenant_key, shed=True)
                    return ShedDecision(429, 1.0, "per-tenant budget")
                tenant_bucket = self._bucket(
                    self._tenant_buckets, tenant_key,
                    self.tenant_rate, self.tenant_burst, now)
                wait = tenant_bucket.try_take(now)
                if wait > 0.0:
                    metrics.count("http.throttled.tenant")
                    self._tenant_note(tenant_key, shed=True)
                    return ShedDecision(429, wait, "per-tenant budget")
                self._tenant_note(tenant_key, shed=False)
            # concurrency next: an in-flight shed must not burn the
            # agent's rate token (the retry would then need two)
            if (
                self.max_inflight is not None
                and self._inflight >= self.max_inflight
            ):
                metrics.count("http.throttled.inflight")
                # no queue to estimate from: hint one "typical request" out
                return ShedDecision(503, 0.05, "server at max in-flight")
            if self.rate is not None:
                if self.rate <= 0.0:
                    # "block everything" config: shed without a bucket
                    # (a zero-rate bucket could never hand out a hint)
                    metrics.count("http.throttled.rate")
                    return ShedDecision(429, 1.0, "per-agent rate limit")
                bucket = self._bucket(self._buckets, agent_key, self.rate,
                                      self.burst, now)
                wait = bucket.try_take(now)
                if wait > 0.0:
                    metrics.count("http.throttled.rate")
                    return ShedDecision(429, wait, "per-agent rate limit")
            self._inflight += 1
            depth = self._inflight
        metrics.gauge_set("http.inflight", depth)
        metrics.gauge_max("http.inflight.peak", depth)
        return None

    def tenants_report(self, limit: int = 16) -> dict:
        """Per-tenant admission verdicts for ``/statusz`` and the soak
        report — busiest tenants first, bounded to ``limit``."""
        with self._lock:
            rows = sorted(
                self._tenant_stats.items(),
                key=lambda kv: (-(kv[1][0] + kv[1][1]), kv[0]))
            return {
                "tenant_rate": self.tenant_rate,
                "tenant_burst": self.tenant_burst,
                "tenants": {
                    tenant: {
                        "admitted": admitted,
                        "shed": shed,
                        "tokens": (round(
                            self._tenant_buckets[tenant].tokens, 3)
                            if tenant in self._tenant_buckets else None),
                    }
                    for tenant, (admitted, shed) in rows[:limit]
                },
                "tenants_omitted": max(0, len(rows) - limit),
            }

    def release(self) -> None:
        with self._lock:
            self._inflight -= 1
            depth = self._inflight
        metrics.gauge_set("http.inflight", depth)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight
