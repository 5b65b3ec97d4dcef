"""Error model for the SDA protocol and services.

Mirrors the error kinds the reference distinguishes (reference:
protocol/src/errors.rs and server/src/errors.rs): permission denied,
invalid credentials, invalid request, and generic failures — these drive
both the server-side ACL wrapper and the HTTP status mapping
(reference: server-http/src/lib.rs:105-122).
"""

from __future__ import annotations


class SdaError(Exception):
    """Base class for all protocol-level errors."""


class PermissionDenied(SdaError):
    """Caller is not allowed to perform the operation (ACL failure)."""

    def __init__(self, message: str = "permission denied"):
        super().__init__(message)


class InvalidCredentials(SdaError):
    """Authentication failed (bad or missing auth token)."""

    def __init__(self, message: str = "invalid credentials"):
        super().__init__(message)


class InvalidRequest(SdaError):
    """Request is malformed or violates an invariant (HTTP 400)."""


class NotFound(SdaError):
    """Referenced resource does not exist.

    Services normally signal missing resources by returning ``None``; this
    error is for flows where absence is fatal (e.g. "aggregation not found"
    while creating a committee, reference: server/src/server.rs:86-99).
    """


class ServerError(SdaError):
    """Internal server failure (HTTP 500).

    ``retry_after`` (seconds, optional) is stamped on instances that know
    when the condition clears — the HTTP client copies the server's
    ``Retry-After`` hint here on terminal 5xx responses, and pollers
    (``SdaClient.await_result``) honor it instead of their fixed cadence.
    """

    retry_after = None


class StoreUnavailable(ServerError):
    """The storage backend is browning out and the circuit breaker is
    OPEN (``server/breaker.py``): the operation was shed WITHOUT touching
    the store. Maps to HTTP 503 + ``Retry-After`` — the client-side
    immutable-document cache keeps reads flowing and the retrying
    transport resubmits writes once the breaker half-opens."""

    def __init__(self, message: str = "store unavailable",
                 retry_after: float = None):
        super().__init__(message)
        self.retry_after = retry_after


class ParticipationConflict(SdaError):
    """Exactly-once ingestion rejected a participation upload.

    The store already holds a DIFFERENT share bundle under the same key —
    either the same ``(aggregation, participant)`` pair with other content
    (a device that recomputed with fresh randomness instead of resuming
    its journal, or an equivocating device submitting two inputs) or the
    same participation id with other bytes (a buggy peer trying to
    replace an earlier upload in place). Byte-identical replays are NOT
    conflicts: they return success idempotently, which is what makes
    crash/retry loops safe. Maps to HTTP 409, which the retrying
    transport classifies terminal — retrying an equivocation cannot ever
    succeed (docs/robustness.md)."""

    def __init__(self, message: str = "participation conflict", *,
                 participant=None, aggregation=None):
        super().__init__(message)
        self.participant = participant
        self.aggregation = aggregation


class RoundFailed(SdaError):
    """The round lifecycle supervisor declared the round terminally
    ``failed`` — e.g. a dead clerk under additive sharing (every share is
    required) or dead clerks leaving a Shamir committee below its
    reconstruction threshold. Carries the server's diagnosis so callers
    can act on it programmatically (``server/lifecycle.py``)."""

    def __init__(self, message: str = "round failed", *, state=None,
                 reason=None, dead_clerks=None):
        super().__init__(message)
        self.state = state
        self.reason = reason
        self.dead_clerks = list(dead_clerks or [])


class RoundExpired(RoundFailed):
    """The round ran out of time — a phase deadline lapsed server-side
    (terminal ``expired`` state) or a client-side ``await_result``
    deadline was exceeded before the round completed."""

    def __init__(self, message: str = "round expired", *, state=None,
                 reason=None, dead_clerks=None):
        super().__init__(message, state=state, reason=reason,
                         dead_clerks=dead_clerks)
