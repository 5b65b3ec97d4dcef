"""The SDA service seam — one interface, many transports.

Mirrors reference: protocol/src/methods.rs. The same interface is implemented
by the real server (``sda_tpu_torch.server.SdaServerService``), by the HTTP proxy
(``sda_tpu_torch.http.SdaHttpClient``), and consumed identically by the client —
so the whole distributed system can run in one process for tests, over REST
in production, or on a device mesh in simulated-pod mode (the key seam noted
in SURVEY.md §1).

Python note: the reference splits this across six Rust traits
(SdaBaseService/Agent/Aggregation/Participation/Clerking/Recipient,
methods.rs:13-112); here they are ABC mixins combined into ``SdaService``.
Absence of a resource is signalled by ``None`` returns; errors raise
``sda_tpu_torch.protocol.errors.SdaError`` subclasses.
"""

from __future__ import annotations

import abc
from typing import List, Optional

from .resources import (
    Agent,
    AgentId,
    Aggregation,
    AggregationId,
    AggregationStatus,
    ClerkCandidate,
    ClerkingJob,
    ClerkingResult,
    Committee,
    EncryptionKeyId,
    Participation,
    Profile,
    Snapshot,
    SnapshotId,
    SnapshotResult,
)
from .helpers import Signed


class Pong:
    """Return message of ``ping`` (methods.rs:6-10)."""

    __slots__ = ("running",)

    def __init__(self, running: bool):
        self.running = bool(running)

    def __eq__(self, other):
        return isinstance(other, Pong) and self.running == other.running

    def to_obj(self):
        return {"running": self.running}

    @classmethod
    def from_obj(cls, obj):
        return cls(obj["running"])


class SdaBaseService(abc.ABC):
    @abc.abstractmethod
    def ping(self) -> Pong:
        """Health check; raises if the service is not running correctly."""


class SdaAgentService(SdaBaseService):
    """Discovery and maintenance of agents and their identities (methods.rs:31-50)."""

    @abc.abstractmethod
    def create_agent(self, caller: Agent, agent: Agent) -> None: ...

    @abc.abstractmethod
    def get_agent(self, caller: Agent, agent: AgentId) -> Optional[Agent]: ...

    @abc.abstractmethod
    def upsert_profile(self, caller: Agent, profile: Profile) -> None: ...

    @abc.abstractmethod
    def get_profile(self, caller: Agent, owner: AgentId) -> Optional[Profile]: ...

    @abc.abstractmethod
    def create_encryption_key(self, caller: Agent, key: Signed) -> None: ...

    @abc.abstractmethod
    def get_encryption_key(self, caller: Agent, key: EncryptionKeyId) -> Optional[Signed]: ...


class SdaAggregationService(SdaBaseService):
    """Discovery of aggregation objects (methods.rs:53-64)."""

    @abc.abstractmethod
    def list_aggregations(
        self,
        caller: Agent,
        filter: Optional[str] = None,
        recipient: Optional[AgentId] = None,
    ) -> List[AggregationId]: ...

    @abc.abstractmethod
    def get_aggregation(self, caller: Agent, aggregation: AggregationId) -> Optional[Aggregation]: ...

    @abc.abstractmethod
    def get_committee(self, caller: Agent, aggregation: AggregationId) -> Optional[Committee]: ...


class SdaParticipationService(SdaBaseService):
    """Participation upload (methods.rs:68-73)."""

    @abc.abstractmethod
    def create_participation(self, caller: Agent, participation: Participation) -> None: ...


class SdaClerkingService(SdaBaseService):
    """Clerk job polling and result upload (methods.rs:76-84)."""

    @abc.abstractmethod
    def get_clerking_job(self, caller: Agent, clerk: AgentId) -> Optional[ClerkingJob]: ...

    @abc.abstractmethod
    def create_clerking_result(self, caller: Agent, result: ClerkingResult) -> None: ...


class SdaRecipientService(SdaBaseService):
    """Aggregation lifecycle operations reserved to the recipient (methods.rs:87-112)."""

    @abc.abstractmethod
    def create_aggregation(self, caller: Agent, aggregation: Aggregation) -> None: ...

    @abc.abstractmethod
    def delete_aggregation(self, caller: Agent, aggregation: AggregationId) -> None: ...

    @abc.abstractmethod
    def suggest_committee(self, caller: Agent, aggregation: AggregationId) -> List[ClerkCandidate]: ...

    @abc.abstractmethod
    def create_committee(self, caller: Agent, committee: Committee) -> None: ...

    @abc.abstractmethod
    def get_aggregation_status(
        self, caller: Agent, aggregation: AggregationId
    ) -> Optional[AggregationStatus]: ...

    @abc.abstractmethod
    def create_snapshot(self, caller: Agent, snapshot: Snapshot) -> None: ...

    @abc.abstractmethod
    def get_snapshot_result(
        self, caller: Agent, aggregation: AggregationId, snapshot: SnapshotId
    ) -> Optional[SnapshotResult]: ...

    def get_round_status(
        self, caller: Agent, aggregation: AggregationId
    ) -> Optional["RoundStatus"]:
        """Lifecycle state of the aggregation's current round
        (``server/lifecycle.py`` state machine), or ``None`` when this
        service does not track round lifecycle — deliberately concrete
        (not abstract) so pre-supervisor service implementations keep
        working unchanged."""
        return None


class SdaService(
    SdaAgentService,
    SdaAggregationService,
    SdaParticipationService,
    SdaClerkingService,
    SdaRecipientService,
):
    """The combined SDA service (methods.rs:13-22)."""
