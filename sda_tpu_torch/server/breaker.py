"""Store circuit breaker + retry budget: brownout survival for the
serving plane.

A browning-out backend (elevated latency + elevated error rate — the
``brownout``/``flap`` chaos kinds, and the dominant production failure
mode per "The Tail at Scale", Dean & Barroso, CACM 2013) is worse than a
dead one: every request still pays the full latency *and* fails, threads
pile up behind the slow dependency, and the retrying clients multiply the
load exactly when the store can least afford it. The classic remedy is a
circuit breaker (Nygard, *Release It!*) plus a bounded retry budget:

- **closed** (healthy): operations pass through; a failed operation may
  be retried once immediately IF the shared retry-budget token bucket has
  a token (bounds the fleet-wide retry amplification to ``budget_rate``
  extra store calls/sec no matter how hard the backend is failing);
  ``threshold`` failures within the rolling ``failure_window_s`` trip the
  breaker. Windowed, not consecutive, on purpose: a browning-out store
  FAILS GRAY — some ops keep succeeding between the failures — and a
  consecutive counter would never fire exactly when the breaker matters
  most.
- **open**: every operation is shed instantly with
  :class:`~sda_tpu_torch.protocol.StoreUnavailable` carrying ``retry_after`` =
  the time until the next probe — the HTTP seam maps it to
  ``503 + Retry-After``, so clients back off instead of queueing, and
  reads keep flowing from the client-side immutable-document cache.
- **half-open** (after ``recovery_s``): exactly ONE probe operation is
  let through; success closes the breaker, failure re-opens it for
  another ``recovery_s``.

Wiring is opt-in (``sdad --store-breaker``): :func:`wrap_server_stores`
replaces a server's four store handles with :class:`BreakerStore`
proxies sharing ONE breaker (one backend, one health verdict). Semantic
errors — NotFound, InvalidRequest, auth failures — pass through
uncounted: they are answers, not infrastructure failures.

Observability: ``server.store.breaker.state`` gauge (0 closed, 1
half-open, 2 open), ``server.store.breaker.{open,close,reopen,shed,
failure,retry,probe}`` counters, and a span event per transition so
round timelines show exactly when the breaker tripped. ``report()``
feeds the chaos drill's ``time_to_recover_s`` MTTR record (ci.sh
brownout step, gated advisory by ``sda-bench --check``).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .. import obs
from ..utils import metrics
from ..protocol import (
    InvalidCredentials,
    InvalidRequest,
    NotFound,
    ParticipationConflict,
    PermissionDenied,
    StoreUnavailable,
)

#: Exception types that are protocol ANSWERS, not store failures — they
#: pass through the breaker uncounted and unretried (a rejected
#: equivocation is detection WORKING; a flood of equivocators must not
#: trip the breaker).
SEMANTIC_ERRORS = (NotFound, InvalidRequest, ParticipationConflict,
                   PermissionDenied, InvalidCredentials, StoreUnavailable)

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Shared breaker state for one storage backend (thread-safe)."""

    def __init__(self, *, threshold: int = 5, recovery_s: float = 1.0,
                 failure_window_s: float = 10.0,
                 budget_rate: float = 2.0, budget_cap: float = 4.0):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = int(threshold)
        self.recovery_s = float(recovery_s)
        self.failure_window_s = float(failure_window_s)
        self.budget_rate = float(budget_rate)
        self.budget_cap = float(budget_cap)
        self._lock = threading.Lock()
        self.state = CLOSED
        self._failures: list = []   # failure instants inside the window
        self._opened_at: Optional[float] = None
        self._probe_inflight = False
        self._probe_started_at = 0.0
        # retry budget: token bucket shared by every wrapped store op
        self._tokens = float(budget_cap)
        self._tokens_at = time.monotonic()
        # MTTR bookkeeping for the drill record
        self.first_opened_at: Optional[float] = None
        self.last_closed_at: Optional[float] = None
        self.times_opened = 0
        metrics.gauge_set("server.store.breaker.state", 0)

    # -- state transitions (caller holds the lock) --------------------------
    def _to(self, state: str, counter: str) -> None:
        self.state = state
        metrics.gauge_set("server.store.breaker.state", _STATE_GAUGE[state])
        metrics.count(f"server.store.breaker.{counter}")
        obs.add_event(f"store.breaker.{counter}", state=state)

    def _open(self, now: float, counter: str) -> None:
        self._opened_at = now
        self._probe_inflight = False
        if self.first_opened_at is None:
            self.first_opened_at = now
        self.times_opened += 1
        self._to(OPEN, counter)

    # -- the wrap-side API --------------------------------------------------
    def admit(self, op: str) -> bool:
        """Gate one store operation. Returns True when the call is the
        half-open PROBE (its outcome decides the breaker), raises
        ``StoreUnavailable`` when shed, False for a plain closed-state
        pass-through."""
        now = time.monotonic()
        with self._lock:
            if self.state == CLOSED:
                return False
            if self.state == OPEN:
                remaining = self._opened_at + self.recovery_s - now
                if remaining > 0:
                    metrics.count("server.store.breaker.shed")
                    raise StoreUnavailable(
                        f"store breaker open ({op} shed); retrying in "
                        f"{remaining:.3f}s", retry_after=max(0.01, remaining))
                self._to(HALF_OPEN, "half_open")
            # half-open: exactly one probe at a time; everyone else sheds
            # with a hint sized to the probe's likely round trip. A probe
            # stuck longer than a recovery period (hung flock, NFS stall —
            # elevated latency IS the failure mode in play) forfeits its
            # slot, or the breaker would wedge shedding forever
            probe_patience = max(self.recovery_s, 5.0)
            if self._probe_inflight \
                    and now - self._probe_started_at < probe_patience:
                metrics.count("server.store.breaker.shed")
                raise StoreUnavailable(
                    f"store breaker half-open ({op} shed while probing)",
                    retry_after=max(0.01, self.recovery_s / 4))
            self._probe_inflight = True
            self._probe_started_at = now
            metrics.count("server.store.breaker.probe")
            return True

    def record_success(self, probe: bool) -> None:
        with self._lock:
            if probe and self.state == HALF_OPEN:
                self._probe_inflight = False
                self._failures.clear()
                self.last_closed_at = time.monotonic()
                self._to(CLOSED, "close")

    def record_failure(self, probe: bool) -> None:
        now = time.monotonic()
        with self._lock:
            metrics.count("server.store.breaker.failure")
            if probe and self.state == HALF_OPEN:
                self._open(now, "reopen")  # the probe failed: back off again
                return
            if self.state != CLOSED:
                return
            # rolling window, NOT a consecutive counter: a gray store
            # keeps succeeding between failures, and those successes must
            # not launder the failure rate
            cutoff = now - self.failure_window_s
            self._failures = [t for t in self._failures if t > cutoff]
            self._failures.append(now)
            if len(self._failures) >= self.threshold:
                self._failures.clear()
                self._open(now, "open")

    def try_spend_retry(self) -> bool:
        """One token from the shared retry budget, or False — the bound on
        fleet-wide retry amplification while the backend struggles."""
        now = time.monotonic()
        with self._lock:
            self._tokens = min(
                self.budget_cap,
                self._tokens + (now - self._tokens_at) * self.budget_rate)
            self._tokens_at = now
            if self._tokens < 1.0:
                return False
            self._tokens -= 1.0
            return True

    def report(self) -> dict:
        """Drill/statusz snapshot; ``time_to_recover_s`` is the wall time
        from the FIRST trip to the LAST recovery — the MTTR headline the
        brownout drill records."""
        with self._lock:
            recover = None
            if self.first_opened_at is not None \
                    and self.last_closed_at is not None \
                    and self.last_closed_at > self.first_opened_at:
                recover = round(self.last_closed_at - self.first_opened_at, 4)
            return {
                "state": self.state,
                "threshold": self.threshold,
                "recovery_s": self.recovery_s,
                "times_opened": self.times_opened,
                "time_to_recover_s": recover,
            }


class BreakerStore:
    """Proxy one store handle through a shared :class:`CircuitBreaker`.

    Every public method call is gated by ``admit`` (shed fast while
    open), counted into the breaker on infrastructure failure, and — in
    the closed state — retried once when the shared retry budget allows
    (safe: every store operation in this codebase is an idempotent upsert
    / conditional insert by the retry contract in docs/robustness.md).
    """

    def __init__(self, inner, breaker: CircuitBreaker):
        # object.__setattr__: __getattr__ below must never recurse
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_breaker", breaker)
        object.__setattr__(self, "_wrapped", {})

    def __getattr__(self, name):
        if name.startswith("_"):
            return getattr(self._inner, name)
        cached = self._wrapped.get(name)
        if cached is not None:
            return cached
        attr = getattr(self._inner, name)
        if not callable(attr):
            return attr
        breaker = self._breaker

        def guarded(*args, **kwargs):
            probe = breaker.admit(name)  # raises StoreUnavailable when open
            try:
                result = attr(*args, **kwargs)
            except SEMANTIC_ERRORS:
                # a protocol answer, not a store failure: the probe (if
                # any) reached the backend and got a coherent reply
                breaker.record_success(probe)
                raise
            except Exception:
                if not probe and breaker.try_spend_retry():
                    metrics.count("server.store.breaker.retry")
                    try:
                        result = attr(*args, **kwargs)
                    except SEMANTIC_ERRORS:
                        breaker.record_success(probe)
                        raise
                    except Exception:
                        breaker.record_failure(probe)
                        raise
                    breaker.record_success(probe)
                    return result
                breaker.record_failure(probe)
                raise
            except BaseException:
                # KeyboardInterrupt/SystemExit tearing through a probe
                # must still release the probe slot — count it failed
                # (conservative: the breaker reopens) rather than wedge
                breaker.record_failure(probe)
                raise
            breaker.record_success(probe)
            return result

        self._wrapped[name] = guarded
        return guarded


def wrap_server_stores(server, breaker: Optional[CircuitBreaker] = None
                       ) -> CircuitBreaker:
    """Route all four of ``server``'s store handles through one shared
    breaker (they are one backend — one sqlite file, one jsonfs root, one
    Mongo database — so they share one health verdict). Returns the
    breaker for drills/statusz to read."""
    breaker = breaker or CircuitBreaker()
    server.agents_store = BreakerStore(server.agents_store, breaker)
    server.auth_tokens_store = BreakerStore(server.auth_tokens_store, breaker)
    server.aggregation_store = BreakerStore(server.aggregation_store, breaker)
    server.clerking_job_store = BreakerStore(server.clerking_job_store,
                                             breaker)
    server.store_breaker = breaker
    return breaker
