"""In-process job-wakeup registry — the push half of long-poll clerking.

The polling storm the async HTTP plane exists to kill has two parts:
idle connections (solved by the event loop) and the *store* being
re-scanned by every clerk on a fixed cadence. This registry removes the
second: a long-poll request parks on a per-clerk subscription, and the
events that can make a job appear — snapshot fan-out
(``server/snapshot.py``), a drain handing leases back
(``SdaServer.release_held_leases``), a failure detector recalling a dead
worker's leases (``server/health.py``) — notify exactly the clerks that
might now have work. Job-pickup latency collapses from the polling
interval to the notify-to-poll hop.

Fleet caveat: the registry is per-process. A peer worker's fan-out
notifies *its* subscribers, not ours, so a parked long-poll also
re-checks the shared store on a short tick (``SDA_LONGPOLL_TICK``) —
cross-worker wakeups degrade to that tick, same-worker wakeups are
immediate. Lease *expiry* (a time-based reissue with no event) is
covered by the same tick.

Two waiter flavors share one subscription type: the threaded HTTP plane
blocks its request thread on ``Subscription.wait``; the asyncio plane
registers a callback that ``loop.call_soon_threadsafe``-sets an
``asyncio.Event``, so a parked long-poll holds no thread at all.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional

from ..utils.env import env_float

__all__ = ["JobWakeup", "Subscription", "LONGPOLL_MAX_S", "LONGPOLL_TICK_S",
           "clamp_wait", "longpoll_tick"]


# ---------------------------------------------------------------------------
# Long-poll contract knobs. They live HERE, next to the wakeup registry,
# because "how long may a wait park" is a server-layer policy shared by
# every long-poll flavor — the HTTP route, the in-process
# ``await_clerking_job`` seam — not an HTTP detail (``http/base.py``
# re-exports them for the transports).

#: Hard ceiling on ``wait=`` (docs/http.md): long enough to kill the
#: polling storm, short enough that proxies/timeouts never reap a healthy
#: parked request. Clients re-issue on empty.
LONGPOLL_MAX_S = 55.0
#: Parked re-check cadence: the cross-worker degradation path (a fleet
#: peer's fan-out notifies ITS process, not ours) and the lease-expiry
#: reissue path (time-based, no event) are both bounded by this.
LONGPOLL_TICK_S = 0.5


def clamp_wait(wait_s: float) -> float:
    """Clamp a requested long-poll wait to [0, SDA_LONGPOLL_MAX]."""
    ceiling = env_float("SDA_LONGPOLL_MAX", LONGPOLL_MAX_S)
    return max(0.0, min(float(wait_s), ceiling))


def longpoll_tick() -> float:
    return max(0.01, env_float("SDA_LONGPOLL_TICK", LONGPOLL_TICK_S))


class Subscription:
    """One parked waiter for one clerk key. ``wait`` serves sync waiters;
    ``callback`` (invoked at most once, from the notifier's thread) serves
    event-loop waiters. Always ``unsubscribe`` in a ``finally``."""

    __slots__ = ("key", "_event", "_callback", "_fired")

    def __init__(self, key: str, callback: Optional[Callable[[], None]]):
        self.key = key
        self._event = threading.Event()
        self._callback = callback
        self._fired = False

    def fire(self) -> None:
        self._event.set()
        cb, self._callback = self._callback, None
        if cb is not None:
            try:
                cb()
            except Exception:
                pass  # a dying event loop must not break the notifier

    def wait(self, timeout: Optional[float]) -> bool:
        """Block until notified (or ``timeout``); True when notified."""
        return self._event.wait(timeout)

    def clear(self) -> None:
        """Re-arm a sync subscription for another wait round."""
        self._event.clear()


class JobWakeup:
    """Condition-variable fan-out keyed by clerk id (as ``str``).

    ``notify(keys)`` wakes every subscription under those keys;
    ``notify()`` / ``notify_all()`` wakes everyone — the drain path uses
    that so parked long-polls answer 503 immediately instead of holding
    their timeout. Notifying a key nobody is parked on is free.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._waiters: dict = {}  # key -> list[Subscription]

    def subscribe(self, key, callback: Optional[Callable[[], None]] = None
                  ) -> Subscription:
        sub = Subscription(str(key), callback)
        with self._lock:
            self._waiters.setdefault(sub.key, []).append(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            subs = self._waiters.get(sub.key)
            if subs is not None:
                try:
                    subs.remove(sub)
                except ValueError:
                    pass
                if not subs:
                    self._waiters.pop(sub.key, None)

    def parked(self) -> int:
        """How many subscriptions are currently parked (statusz)."""
        with self._lock:
            return sum(len(subs) for subs in self._waiters.values())

    def notify(self, keys: Optional[Iterable] = None) -> int:
        """Wake the waiters parked under ``keys`` (every waiter when
        ``keys`` is None); returns how many subscriptions fired."""
        with self._lock:
            if keys is None:
                fired = [s for subs in self._waiters.values() for s in subs]
            else:
                fired = []
                for key in {str(k) for k in keys}:
                    fired.extend(self._waiters.get(key, ()))
        for sub in fired:
            sub.fire()
        return len(fired)

    def notify_all(self) -> int:
        return self.notify(None)
