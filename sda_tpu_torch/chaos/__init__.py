"""Deterministic chaos layer: seedable failpoint injection.

SDA's premise is surviving weak, sporadic devices (PAPER.md), so the
failure modes themselves must be first-class and *reproducible*. This
package is the injection side of that story: a process-global registry of
named failpoints, each with a deterministic trigger schedule, hooked into
the store backends (``store.*``), the HTTP dispatch (``http.server.*``)
and the clerk loop (``clerk.*``). The recovery side lives in
``http/client.py`` (retrying transport) and ``server/core.py`` +
the store backends (clerking-job lease/reissue); ``docs/robustness.md``
has the full catalog.

Design follows the classic failpoint idiom (FreeBSD ``fail(9)``, Rust's
``fail-rs``): production code calls ``chaos.fail("name")`` at a choke
point; the call is a near-free no-op until a test or the ``sda-sim
--chaos`` profile configures that name with an action:

    chaos.configure("store.create_participation", error=True, times=2)
    chaos.configure("http.server.request", error=True, rate=0.15, seed=7)
    chaos.configure("http.server.request", delay=0.05, every=3)
    chaos.configure("http.server.response", drop=True, times=1)

Beyond the crisp single-shot kinds (error/delay/drop/kill), three GRAY
failure kinds model the degradation that dominates production fleets
("The Tail at Scale", Dean & Barroso, CACM 2013) — a dependency that is
slow-but-alive, browning out, or reachable from some peers only:

    # elevated latency + elevated error rate for a bounded window
    chaos.configure("store.poll_clerking_job", brownout=0.02, rate=0.7,
                    window=5.0, seed=7)
    # repeating brownout cycles: `window` seconds down, `up` seconds fine
    chaos.configure("store.poll_clerking_job", flap=0.02, rate=0.7,
                    window=1.0, up=2.0, seed=7)
    # scoped connectivity loss: only the process whose chaos identity is
    # "w0" (chaos.set_identity) sees its store ops fail, healing after 3 s
    chaos.configure("store.create_clerking_result", partition=True,
                    node="w0", window=3.0)

Brownout/flap hits inside the down window raise the injected error with
probability ``rate`` and stall ``delay`` seconds otherwise; outside the
window they are clean no-ops (and do not consume triggers). A partition
raises on every in-window hit whose scope matches: ``node=`` matches the
process-global identity (``set_identity``, set by ``sdad --node-id``),
``agent=`` matches the caller id the call site passes via
``evaluate(..., ctx={"agent": ...})``.

Determinism: each failpoint owns a ``random.Random`` seeded from
``(seed, name)`` and all trigger decisions are functions of the hit index
only, taken under one lock — the same hit sequence always produces the
same injection schedule, so a failing chaos run replays exactly. The
gray kinds keep that discipline for the per-hit error/delay choice; only
the window boundary itself is wall-clock (anchored at arming time).

Every trigger is counted under ``chaos.<name>`` in ``utils/metrics.py``;
``report()`` additionally returns per-point hit/trigger tallies.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional

from ..protocol import ServerError
from ..utils import metrics


class InjectedFault(ServerError):
    """The default injected error: an ``SdaError`` so the HTTP seam maps it
    to a 500 (a transient server-side failure, exactly what the retrying
    transport must absorb)."""


class PartitionedFault(InjectedFault):
    """A partition-kind injection: the scoped peer cannot reach the seam.
    Still a ``ServerError`` (HTTP 500 / retried) — a partitioned client
    cannot tell a dead dependency from an unreachable one."""


class Action:
    """What a triggered failpoint asks the call site to do.

    ``kind`` is one of ``"error"`` (raise ``exc``), ``"delay"`` (sleep
    ``delay_s`` then proceed), ``"drop"`` (transport-level: abort the
    connection / abandon the unit of work — only meaningful at call sites
    that know how, e.g. the HTTP handler or the clerk loop), or
    ``"kill"`` (permanent death: the agent whose loop hit the failpoint
    latches dead for the rest of the drill — unlike every other kind,
    which is transient, the call site never retries or recovers; see
    ``SdaClient.clerk_once`` / ``participate``), or ``"taint"``
    (adversarial-input corruption: the call site perturbs the data it
    was about to emit — e.g. ``participant.taint_shares`` lifts share
    vectors out of the field — instead of failing; only call sites that
    know how to corrupt express it).
    """

    __slots__ = ("kind", "exc", "delay_s")

    def __init__(self, kind: str, exc: Optional[BaseException] = None,
                 delay_s: float = 0.0):
        self.kind = kind
        self.exc = exc
        self.delay_s = delay_s

    def __repr__(self):
        return f"Action({self.kind!r})"


#: What primitive action kinds each gray (composite) kind realizes into.
_COMPOSITE_KINDS = {
    "brownout": ("error", "delay"),
    "flap": ("error", "delay"),
    "partition": ("error",),
}


class _Failpoint:
    def __init__(self, name: str, *, error=None, delay=None, drop=False,
                 kill=False, taint=False, brownout=None, flap=None,
                 partition=False,
                 rate: Optional[float] = None, times: Optional[int] = None,
                 every: Optional[int] = None, after: int = 0, seed: int = 0,
                 window: Optional[float] = None, up: Optional[float] = None,
                 node: Optional[str] = None, agent: Optional[str] = None):
        if sum(x is not None and x is not False
               for x in (error, delay, brownout, flap)) \
                + bool(drop) + bool(kill) + bool(taint) \
                + bool(partition) != 1:
            raise ValueError(f"failpoint {name!r}: exactly one of error/"
                             "delay/drop/kill/taint/brownout/flap/partition "
                             "must be set")
        if every is not None and every < 1:
            raise ValueError(f"failpoint {name!r}: every must be >= 1")
        self.name = name
        if kill:
            self.kind = "kill"
        elif taint:
            self.kind = "taint"
        elif drop:
            self.kind = "drop"
        elif partition:
            self.kind = "partition"
        elif flap is not None:
            self.kind = "flap"
        elif brownout is not None:
            self.kind = "brownout"
        elif delay is not None:
            self.kind = "delay"
        else:
            self.kind = "error"
        # error=True means "use the default injected fault"
        self.exc_factory = (
            (error if callable(error) else (lambda: error))
            if error is not None and error is not True
            else (lambda: PartitionedFault(
                f"chaos: partitioned at {name}"))
            if self.kind == "partition"
            else (lambda: InjectedFault(f"chaos: injected failure at {name}"))
        )
        self.delay_s = float(delay or brownout or flap or 0.0)
        # gray-kind rate is the ERROR fraction inside the down window (the
        # rest of the hits stall instead); default 0.5 keeps both symptoms
        # visible. Classic kinds keep the historical always-trigger default.
        if rate is None:
            rate = 0.5 if self.kind in ("brownout", "flap") else 1.0
        self.rate = float(rate)
        self.times = times
        self.every = every
        self.after = int(after)
        if self.kind == "flap" and (not window or up is None):
            raise ValueError(f"failpoint {name!r}: flap needs window= "
                             "(down seconds) and up= (healthy seconds)")
        if self.kind == "brownout" and not window:
            raise ValueError(f"failpoint {name!r}: brownout needs window= "
                             "(down seconds)")
        self.window_s = None if window is None else float(window)
        self.up_s = None if up is None else float(up)
        #: partition scope: restrict triggering to the process whose chaos
        #: identity is ``node`` and/or to call sites whose ctx carries
        #: ``agent`` — None matches everything
        self.node = node
        self.agent = agent
        #: window anchor: gray kinds degrade from the moment they are armed
        self.armed_at = time.time()
        # per-point RNG keyed on (seed, name): schedules are independent
        # across failpoints and reproducible for a given hit order
        self.rng = random.Random(f"{seed}:{name}")
        self.hits = 0
        self.triggers = 0

    def expressible(self, kinds) -> bool:
        """Whether a call site restricted to ``kinds`` can perform this
        point's action at all (composite kinds need every primitive they
        may realize into, so the seeded schedule stays site-independent)."""
        if kinds is None:
            return True
        needed = _COMPOSITE_KINDS.get(self.kind, (self.kind,))
        return all(k in kinds for k in needed)

    def _in_window(self, now: float) -> bool:
        """Whether a gray kind is currently in its DOWN phase."""
        elapsed = now - self.armed_at
        if self.kind == "flap":
            return elapsed % (self.window_s + self.up_s) < self.window_s
        if self.window_s is None:
            return True  # unbounded (partition without window=): heals
            # only on clear()
        return elapsed < self.window_s

    def _scope_matches(self, ctx, identity) -> bool:
        if self.node is not None and self.node != identity:
            return False
        if self.agent is not None:
            return str((ctx or {}).get("agent")) == self.agent
        return True

    def should_trigger(self) -> bool:
        """Decide for the current hit; caller holds the registry lock."""
        hit = self.hits
        self.hits += 1
        if hit < self.after:
            return False
        if self.times is not None and self.triggers >= self.times:
            return False
        if self.every is not None and (hit - self.after) % self.every != 0:
            return False
        if self.rate < 1.0 and self.rng.random() >= self.rate:
            return False
        self.triggers += 1
        return True

    def action(self) -> Action:
        if self.kind in ("error", "partition"):
            return Action("error", exc=self.exc_factory())
        if self.kind == "delay":
            return Action("delay", delay_s=self.delay_s)
        return Action(self.kind)  # "drop"/"kill"/"taint": no payload

    def realize(self, now: float, ctx, identity) -> Optional[Action]:
        """The full per-hit decision (caller holds the registry lock):
        classic kinds keep the historic should_trigger/action split; gray
        kinds additionally gate on the window and scope — an out-of-window
        or out-of-scope hit is a clean no-op that consumes NOTHING, so the
        seeded schedule describes only the degraded phase."""
        if self.kind in ("brownout", "flap"):
            if not self._in_window(now):
                return None
            hit = self.hits
            self.hits += 1
            if hit < self.after:
                return None
            if self.times is not None and self.triggers >= self.times:
                return None
            if self.every is not None and (hit - self.after) % self.every:
                return None
            self.triggers += 1
            # seeded per-hit split: error with probability `rate`, stall
            # otherwise — both symptoms of one browning-out dependency
            if self.rng.random() < self.rate:
                return Action("error", exc=self.exc_factory())
            return Action("delay", delay_s=self.delay_s)
        if self.kind == "partition":
            if not self._scope_matches(ctx, identity) \
                    or not self._in_window(now):
                return None
            if not self.should_trigger():
                return None
            return Action("error", exc=self.exc_factory())
        if not self.should_trigger():
            return None
        return self.action()


class FailpointRegistry:
    """Thread-safe named-failpoint store. One process-global instance
    (module-level ``configure``/``fail``/... below) serves both sides of
    an in-process round; tests may build private registries."""

    def __init__(self):
        self._lock = threading.Lock()
        self._points: Dict[str, _Failpoint] = {}
        #: process identity for partition scoping (``sdad --node-id``)
        self._identity: Optional[str] = None

    def set_identity(self, node_id: Optional[str]) -> None:
        """Name this process for ``partition`` scoping: a spec with
        ``node=w0`` triggers only in the process whose identity is w0 —
        how one fleet-wide spec partitions exactly one worker from the
        shared store."""
        self._identity = node_id

    def configure(self, name: str, **kwargs) -> None:
        """(Re)arm a failpoint; see module docstring for the knobs."""
        point = _Failpoint(name, **kwargs)
        with self._lock:
            self._points[name] = point

    def clear(self, name: Optional[str] = None) -> None:
        """Disarm one failpoint, or all of them."""
        with self._lock:
            if name is None:
                self._points.clear()
            else:
                self._points.pop(name, None)

    def active(self) -> bool:
        return bool(self._points)

    def evaluate(self, name: str, kinds=None, ctx=None) -> Optional[Action]:
        """Return the action if ``name`` is armed and triggers this hit,
        else None. Counts ``chaos.<name>`` on trigger. The un-armed path
        is one dict lookup — cheap enough for hot paths.

        ``kinds`` restricts the action kinds the call site can express
        (e.g. the clerk loop only understands ``drop``); an armed
        failpoint of another kind is ignored WITHOUT consuming a hit or
        trigger, so the schedule and counters never claim an injection
        that could not happen. ``ctx`` carries call-site scope facts
        (currently ``{"agent": id}``) that ``partition`` specs match."""
        point = self._points.get(name)
        if point is None:
            return None
        if not point.expressible(kinds):
            return None
        now = time.time()
        with self._lock:
            # re-check: a concurrent clear() may have raced the lookup
            if self._points.get(name) is not point:
                return None
            action = point.realize(now, ctx, self._identity)
            if action is None:
                return None
        metrics.count(f"chaos.{name}")
        # stamp the injection on the active span (no-op without one): a
        # trace timeline then shows WHICH injected fault hit WHICH round.
        # fault.kind/fault.site are the structured tags sda-trace explain
        # joins on; the bare "kind" attr stays for older consumers.
        from .. import obs
        from ..obs import recorder, trace

        obs.add_event(f"chaos.{name}", kind=action.kind,
                      **{"fault.kind": action.kind, "fault.site": name})
        ctx_span = trace.current_span()
        recorder.record({
            "t": "fault",
            "site": name,
            "kind": action.kind,
            "node": self._identity,
            "trace": ctx_span.trace_id if ctx_span else None,
            "span": ctx_span.span_id if ctx_span else None,
        })
        return action

    def fail(self, name: str) -> Optional[Action]:
        """The standard injection hook: raise on ``error``, sleep on
        ``delay``. ``drop`` is transport-level and inexpressible here, so
        a drop-armed point is ignored unconsumed (use ``evaluate`` with
        ``kinds`` at call sites that can drop)."""
        action = self.evaluate(name, kinds=("error", "delay"))
        if action is None:
            return None
        if action.kind == "error":
            raise action.exc
        time.sleep(action.delay_s)
        return action

    def report(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {
                name: {"hits": p.hits, "triggers": p.triggers}
                for name, p in sorted(self._points.items())
            }


#: The process-global registry every built-in hook consults.
registry = FailpointRegistry()

configure = registry.configure
clear = registry.clear
evaluate = registry.evaluate
fail = registry.fail
report = registry.report
set_identity = registry.set_identity


def reset() -> None:
    """Disarm everything — test-teardown hygiene (the identity is config,
    not schedule state: it survives)."""
    registry.clear()


def churn_schedule(agents: int, rate: float, seed: int = 0,
                   epoch: Optional[int] = None) -> list:
    """Seeded per-agent device-churn plan — the sporadic-device model
    (PAPER.md's weak phones) made deterministic, the same ``(seed, name)``
    RNG discipline every failpoint keeps.

    Each of ``agents`` entries decides whether that agent DEPARTS during
    its participation (probability ``rate``) and, for departures, at
    which crash point — alternating deterministically by departure
    ordinal so any plan with at least one departure exercises both:

    - ``"mid-upload"`` (first, third, ... departure): the crash lands
      AFTER the server durably stored the bundle but BEFORE the device
      learned of it — the lost-ack window, the ``kill`` analog of the
      ``http.server.response`` drop. The rejoin's journal resume is a
      byte-identical replay (``server.participation.replayed``).
    - ``"pre-upload"`` (second, fourth, ...): the crash lands after
      sealing + journaling but before any upload; the rejoin's resume is
      the bundle's FIRST arrival.

    Every departure rejoins (``"rejoins": True``) — permanent death
    already has its own failpoint (``participant.dies``, kind ``kill``)
    and composes freely with this plan. Drills iterate the plan; the
    drill, not this schedule, performs the crash/rejoin, which keeps the
    plan reusable by both ``sda-sim --chaos --churn`` and the loadgen
    churn knob (docs/robustness.md).

    ``epoch`` folds a round/epoch index into the RNG key, so a recurring
    workload (the FL scenario's R rounds, a soak's epochs) gets an
    independent-but-reproducible availability plan per round from ONE
    seed — who is offline in round 3 does not depend on who was offline
    in round 2, but both replay exactly."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"churn rate {rate} outside [0, 1]")
    key = f"{seed}:churn" if epoch is None else f"{seed}:churn:{int(epoch)}"
    rng = random.Random(key)
    plan = []
    departures = 0
    for index in range(agents):
        departs = rng.random() < rate
        phase = None
        if departs:
            phase = "mid-upload" if departures % 2 == 0 else "pre-upload"
            departures += 1
        plan.append({"index": index, "departs": departs, "phase": phase,
                     "rejoins": departs})
    return plan


# adversarial-input poisoning (seeded attacker populations) shares the
# chaos namespace: same determinism discipline, different threat model
from .poison import (POISON_KINDS, corrupt_delta,  # noqa: E402,F401
                     parse_poison_kind, poison_schedule)

#: spec keys -> coercion; None means "keep the string"
_SPEC_KEYS = {
    "rate": float, "times": int, "every": int, "after": int,
    "for": float, "up": float, "node": None, "agent": None,
}


def parse_spec(spec: str, seed: int = 0) -> Dict[str, dict]:
    """Parse a compact failpoint spec into ``{name: configure-kwargs}``
    WITHOUT arming anything (CLI / env friendly):

        "http.server.request=error,rate=0.15;clerk.dies=kill,times=1"
        "store.poll_clerking_job,store.create_clerking_result=\
brownout:0.02,rate=0.7,for=5"
        "store.create_participation=partition,node=w0,for=3"

    Each ``;``-separated entry is ``names=kind[,key=value...]`` where
    ``names`` may be several comma-separated failpoint names sharing one
    action (the ``,`` before the first ``=`` separates targets; after it,
    keys). Kinds: error | delay:SECONDS | drop | kill | taint |
    brownout:SECONDS | flap:SECONDS | partition. Keys:
    rate/times/every/after plus the
    gray-kind window ``for=SECONDS``, flap's healthy phase ``up=SECONDS``,
    and partition scope ``node=``/``agent=``.

    Naming the same failpoint twice IN ONE parse is a conflict and raises
    — two actions cannot share one choke point; ``configure_from_specs``
    extends that check across multiple ``--chaos-spec`` flags."""
    out: Dict[str, dict] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        names, _, rest = entry.partition("=")
        if not rest:
            raise ValueError(f"chaos spec entry {entry!r}: expected name=kind[,...]")
        parts = rest.split(",")
        kind = parts[0].strip()
        kwargs: dict = {"seed": seed}
        if kind == "error":
            kwargs["error"] = True
        elif kind == "drop":
            kwargs["drop"] = True
        elif kind == "kill":
            kwargs["kill"] = True
        elif kind == "taint":
            kwargs["taint"] = True
        elif kind == "partition":
            kwargs["partition"] = True
        elif kind.startswith("delay:"):
            kwargs["delay"] = float(kind.split(":", 1)[1])
        elif kind.startswith("brownout:"):
            kwargs["brownout"] = float(kind.split(":", 1)[1])
        elif kind.startswith("flap:"):
            kwargs["flap"] = float(kind.split(":", 1)[1])
        else:
            raise ValueError(f"chaos spec entry {entry!r}: unknown kind {kind!r}")
        for part in parts[1:]:
            key, _, value = part.strip().partition("=")
            coerce = _SPEC_KEYS.get(key, ...)
            if coerce is ...:
                raise ValueError(f"chaos spec entry {entry!r}: unknown key {key!r}")
            # "for" is the spec spelling of the window (python keyword)
            kwargs["window" if key == "for" else key] = (
                value if coerce is None else coerce(value))
        for name in names.split(","):
            name = name.strip()
            if not name:
                raise ValueError(f"chaos spec entry {entry!r}: empty "
                                 "failpoint name")
            if name in out:
                raise ValueError(
                    f"chaos spec conflict: failpoint {name!r} armed twice "
                    f"(second action {kind!r}) — one choke point takes "
                    "exactly one action; merge or drop one entry")
            out[name] = kwargs
    return out


def configure_from_spec(spec: str, seed: int = 0) -> None:
    """Parse ``spec`` (see :func:`parse_spec`) and arm every entry."""
    for name, kwargs in parse_spec(spec, seed=seed).items():
        configure(name, **kwargs)


def configure_from_specs(specs, seed: int = 0) -> None:
    """Arm several spec strings (repeated ``--chaos-spec`` flags) as one
    composed drill — brownout + kill + partition in one invocation —
    rejecting any failpoint named by more than one spec with a clear
    error that says WHICH flag collided."""
    seen: Dict[str, int] = {}
    parsed = []
    for ix, spec in enumerate(specs):
        entries = parse_spec(spec, seed=seed)
        for name in entries:
            if name in seen:
                raise ValueError(
                    f"chaos spec conflict: failpoint {name!r} is armed by "
                    f"--chaos-spec #{seen[name] + 1} and #{ix + 1}; one "
                    "choke point takes exactly one action")
            seen[name] = ix
        parsed.append(entries)
    for entries in parsed:
        for name, kwargs in entries.items():
            configure(name, **kwargs)
