"""L5: the continuous multi-tenant aggregation service.

Everything below this package runs ONE round of ONE aggregation to
completion. Production is many recipients (tenants) running recurring
rounds forever against sporadic device populations — the service plane
that turns the one-shot substrate into a long-running system:

- ``scheduler.py`` — store-arbitrated recurring-round scheduler: per
  tenant and per :class:`ScheduleSpec`, epoch R+1's aggregation is minted
  while epoch R is still clerking (pipelined collection), with
  single-winner CAS minting so a fleet of ``sdad --schedule`` workers
  runs each schedule exactly once and deterministic ``uuid5`` epoch ids
  so device journals and replays stay exactly-once across epochs;
- ``retention.py`` — terminal rounds past their TTL transition to
  ``expired`` via the lifecycle CAS and are cascade-purged from all four
  store backends, keeping store size and fleet memory flat over hundreds
  of rounds;
- ``soak.py`` — the long-haul drill behind ``sda-sim --soak``: T tenants
  x R pipelined epochs of real-crypto rounds with churn and chaos armed,
  asserting bit-exact reveals, zero cross-epoch/cross-tenant leakage,
  and flat store size + RSS after retention; the headline BENCH metric
  is sustained ``rounds_per_hour``.

Tenant fairness lives in the admission plane (``http/admission.py``):
per-recipient budget buckets layered over the per-agent buckets, keyed
by the ``X-SDA-Tenant`` request header.
"""

from __future__ import annotations

from .retention import RetentionPolicy, expire_round, purge_round, sweep_retention
from .scheduler import (
    RoundScheduler,
    ScheduleSpec,
    epoch_aggregation_id,
    epoch_snapshot_id,
    schedules_report,
)
from .soak import SoakProfile, run_soak

__all__ = [
    "RetentionPolicy",
    "RoundScheduler",
    "ScheduleSpec",
    "SoakProfile",
    "epoch_aggregation_id",
    "epoch_snapshot_id",
    "expire_round",
    "purge_round",
    "run_soak",
    "schedules_report",
    "sweep_retention",
]
