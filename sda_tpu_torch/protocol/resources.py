"""Core protocol resources — the nouns of the SDA system.

Mirrors reference: protocol/src/resources.rs (Agent :12-17, Profile :23-35,
Aggregation :44-67, ClerkCandidate :73-79, Committee :83-88, Participation
:92-108, Snapshot :116-121, ClerkingJob :128-139, ClerkingResult :146-153,
AggregationStatus :157-164, SnapshotStatus :167-175, SnapshotResult :179-188).

Serde: `to_obj`/`from_obj` produce the same JSON shapes as the reference's
serde derive — struct fields in declaration order (canonical-JSON signing
depends on it), ids as uuid strings, Option as null, Vec<(A,B)> as nested
arrays.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .crypto import (
    AdditiveEncryptionScheme,
    Encryption,
    EncryptionKey,
    LinearMaskingScheme,
    LinearSecretSharingScheme,
    Signature,
    VerificationKey,
)
from .helpers import Labelled, ResourceId, Signed, canonical_json


class AgentId(ResourceId):
    pass


class VerificationKeyId(ResourceId):
    pass


class EncryptionKeyId(ResourceId):
    pass


class AggregationId(ResourceId):
    pass


class ParticipationId(ResourceId):
    pass


class SnapshotId(ResourceId):
    pass


class ClerkingJobId(ResourceId):
    pass


def labelled_verification_key(id: VerificationKeyId, key: VerificationKey):
    return Labelled(id, key)


class Agent:
    """Fundamental description of an agent (participant/clerk/recipient/admin)."""

    __slots__ = ("id", "verification_key")

    def __init__(self, id: AgentId, verification_key: Labelled):
        self.id = id
        self.verification_key = verification_key

    def __eq__(self, other):
        return (
            isinstance(other, Agent)
            and self.id == other.id
            and self.verification_key == other.verification_key
        )

    def __repr__(self):
        return f"Agent(id={self.id!r})"

    def to_obj(self):
        return {"id": self.id.to_obj(), "verification_key": self.verification_key.to_obj()}

    @classmethod
    def from_obj(cls, obj):
        return cls(
            id=AgentId.from_obj(obj["id"]),
            verification_key=Labelled.from_obj(
                obj["verification_key"], VerificationKeyId, VerificationKey
            ),
        )


class Profile:
    """Extended, trust-building profile of an agent."""

    __slots__ = ("owner", "name", "twitter_id", "keybase_id", "website")

    def __init__(
        self,
        owner: AgentId,
        name: Optional[str] = None,
        twitter_id: Optional[str] = None,
        keybase_id: Optional[str] = None,
        website: Optional[str] = None,
    ):
        self.owner = owner
        self.name = name
        self.twitter_id = twitter_id
        self.keybase_id = keybase_id
        self.website = website

    def __eq__(self, other):
        return isinstance(other, Profile) and self.to_obj() == other.to_obj()

    def to_obj(self):
        return {
            "owner": self.owner.to_obj(),
            "name": self.name,
            "twitter_id": self.twitter_id,
            "keybase_id": self.keybase_id,
            "website": self.website,
        }

    @classmethod
    def from_obj(cls, obj):
        return cls(
            owner=AgentId.from_obj(obj["owner"]),
            name=obj.get("name"),
            twitter_id=obj.get("twitter_id"),
            keybase_id=obj.get("keybase_id"),
            website=obj.get("website"),
        )


#: Encryption key labelled by its id and signed by the owning agent.
#: SignedEncryptionKey = Signed<Labelled<EncryptionKeyId, EncryptionKey>>
def signed_encryption_key_from_obj(obj) -> Signed:
    return Signed.from_obj(
        obj,
        signature_type=Signature,
        signer_type=AgentId,
        body_from_obj=lambda b: Labelled.from_obj(b, EncryptionKeyId, EncryptionKey),
    )


class TreeLink:
    """Position of an aggregation inside a hierarchical (tree) round.

    Flat committees cap out structurally — every clerk touches every
    participation — so population-scale rounds shard the population into
    leaf groups whose committees feed a parent round (``sda_tpu_torch/tree``;
    Bonawitz et al., MLSys 2019). This resource is the linkage that makes
    the topology first-class on the wire:

    - ``root``: the aggregation at the top of the tree (the one whose
      recipient learns the final aggregate);
    - ``parent``: the immediate parent aggregation this node's *relay*
      re-shares its masked total into (``None`` on the root itself);
    - ``children``: the child aggregations feeding this node (empty on
      leaves) — recorded at plan time so any worker can walk the tree
      from the round documents alone;
    - ``level``: 0 at the root, increasing towards the leaves;
    - ``group``: the leaf-group index assigned by the routing ring
      (``server/routing.py``), ``None`` for internal nodes;
    - ``mask_recipient`` / ``mask_recipient_key``: where participants
      seal their recipient-mask ciphertexts. In a tree these name the
      ROOT recipient, not the node's own recipient (the relay): the
      relay quorum-reconstructs only the *masked* leaf total and
      forwards the mask ciphertexts upward unopened, so privacy composes
      per level — no relay ever sees an unmasked value.
    """

    __slots__ = ("root", "parent", "children", "level", "group",
                 "mask_recipient", "mask_recipient_key")

    def __init__(
        self,
        root: AggregationId,
        parent: Optional[AggregationId] = None,
        children: Optional[List[AggregationId]] = None,
        level: int = 0,
        group: Optional[int] = None,
        mask_recipient: Optional[AgentId] = None,
        mask_recipient_key: Optional[EncryptionKeyId] = None,
    ):
        self.root = root
        self.parent = parent
        self.children = list(children or [])
        self.level = int(level)
        self.group = None if group is None else int(group)
        self.mask_recipient = mask_recipient
        self.mask_recipient_key = mask_recipient_key

    def __eq__(self, other):
        return isinstance(other, TreeLink) and self.to_obj() == other.to_obj()

    def __repr__(self):
        return (f"TreeLink(root={self.root!r}, parent={self.parent!r}, "
                f"level={self.level}, group={self.group})")

    def to_obj(self):
        return {
            "root": self.root.to_obj(),
            "parent": None if self.parent is None else self.parent.to_obj(),
            "children": [c.to_obj() for c in self.children],
            "level": self.level,
            "group": self.group,
            "mask_recipient": (
                None if self.mask_recipient is None
                else self.mask_recipient.to_obj()),
            "mask_recipient_key": (
                None if self.mask_recipient_key is None
                else self.mask_recipient_key.to_obj()),
        }

    @classmethod
    def from_obj(cls, obj):
        parent = obj.get("parent")
        mask_recipient = obj.get("mask_recipient")
        mask_key = obj.get("mask_recipient_key")
        return cls(
            root=AggregationId.from_obj(obj["root"]),
            parent=None if parent is None else AggregationId.from_obj(parent),
            children=[AggregationId.from_obj(c)
                      for c in (obj.get("children") or [])],
            level=obj.get("level") or 0,
            group=obj.get("group"),
            mask_recipient=(None if mask_recipient is None
                            else AgentId.from_obj(mask_recipient)),
            mask_recipient_key=(None if mask_key is None
                                else EncryptionKeyId.from_obj(mask_key)),
        )


class Aggregation:
    """Description of an aggregation: dimensions, modulus, schemes, recipient.

    ``tree`` places the aggregation inside a hierarchical round
    (:class:`TreeLink`); ``None`` — the default, and the only shape the
    reference knows — means an ordinary flat round. The field is omitted
    from the serialized object when absent, so flat aggregations keep the
    exact reference wire shape."""

    __slots__ = (
        "id",
        "title",
        "vector_dimension",
        "modulus",
        "recipient",
        "recipient_key",
        "masking_scheme",
        "committee_sharing_scheme",
        "recipient_encryption_scheme",
        "committee_encryption_scheme",
        "tree",
    )

    def __init__(
        self,
        id: AggregationId,
        title: str,
        vector_dimension: int,
        modulus: int,
        recipient: AgentId,
        recipient_key: EncryptionKeyId,
        masking_scheme: LinearMaskingScheme,
        committee_sharing_scheme: LinearSecretSharingScheme,
        recipient_encryption_scheme: AdditiveEncryptionScheme,
        committee_encryption_scheme: AdditiveEncryptionScheme,
        tree: Optional[TreeLink] = None,
    ):
        self.id = id
        self.title = title
        self.vector_dimension = int(vector_dimension)
        self.modulus = int(modulus)
        self.recipient = recipient
        self.recipient_key = recipient_key
        self.masking_scheme = masking_scheme
        self.committee_sharing_scheme = committee_sharing_scheme
        self.recipient_encryption_scheme = recipient_encryption_scheme
        self.committee_encryption_scheme = committee_encryption_scheme
        self.tree = tree

    def __eq__(self, other):
        return isinstance(other, Aggregation) and self.to_obj() == other.to_obj()

    def __repr__(self):
        return f"Aggregation(id={self.id!r}, title={self.title!r})"

    def replace(self, **kwargs) -> "Aggregation":
        """Functional update, mirroring Rust struct-update syntax in tests."""
        fields = {name: getattr(self, name) for name in self.__slots__}
        fields.update(kwargs)
        return Aggregation(**fields)

    def mask_seal_target(self):
        """``(owner AgentId, EncryptionKeyId)`` the recipient-MASK
        ciphertext must seal to. Flat rounds: the aggregation's own
        recipient. Tree rounds redirect to the ROOT recipient
        (``TreeLink.mask_recipient_key``) — the node's own recipient is
        a relay that must reconstruct only the masked total, and sealing
        the mask past it is what makes privacy compose per level. THE
        single rule for every participant implementation (Python client
        and embedded client both call this)."""
        if self.tree is not None and self.tree.mask_recipient_key is not None:
            return self.tree.mask_recipient, self.tree.mask_recipient_key
        return self.recipient, self.recipient_key

    def to_obj(self):
        obj = {
            "id": self.id.to_obj(),
            "title": self.title,
            "vector_dimension": self.vector_dimension,
            "modulus": self.modulus,
            "recipient": self.recipient.to_obj(),
            "recipient_key": self.recipient_key.to_obj(),
            "masking_scheme": self.masking_scheme.to_obj(),
            "committee_sharing_scheme": self.committee_sharing_scheme.to_obj(),
            "recipient_encryption_scheme": self.recipient_encryption_scheme.to_obj(),
            "committee_encryption_scheme": self.committee_encryption_scheme.to_obj(),
        }
        if self.tree is not None:
            obj["tree"] = self.tree.to_obj()
        return obj

    @classmethod
    def from_obj(cls, obj):
        tree = obj.get("tree")
        return cls(
            id=AggregationId.from_obj(obj["id"]),
            title=obj["title"],
            vector_dimension=obj["vector_dimension"],
            modulus=obj["modulus"],
            recipient=AgentId.from_obj(obj["recipient"]),
            recipient_key=EncryptionKeyId.from_obj(obj["recipient_key"]),
            masking_scheme=LinearMaskingScheme.from_obj(obj["masking_scheme"]),
            committee_sharing_scheme=LinearSecretSharingScheme.from_obj(
                obj["committee_sharing_scheme"]
            ),
            recipient_encryption_scheme=AdditiveEncryptionScheme.from_obj(
                obj["recipient_encryption_scheme"]
            ),
            committee_encryption_scheme=AdditiveEncryptionScheme.from_obj(
                obj["committee_encryption_scheme"]
            ),
            tree=None if tree is None else TreeLink.from_obj(tree),
        )


class ClerkCandidate:
    """Suggested clerk for an aggregation, with matching encryption keys."""

    __slots__ = ("id", "keys")

    def __init__(self, id: AgentId, keys: List[EncryptionKeyId]):
        self.id = id
        self.keys = list(keys)

    def __eq__(self, other):
        return isinstance(other, ClerkCandidate) and self.to_obj() == other.to_obj()

    def to_obj(self):
        return {"id": self.id.to_obj(), "keys": [k.to_obj() for k in self.keys]}

    @classmethod
    def from_obj(cls, obj):
        return cls(
            id=AgentId.from_obj(obj["id"]),
            keys=[EncryptionKeyId.from_obj(k) for k in obj["keys"]],
        )


class Committee:
    """Committee elected for an aggregation: clerks with their chosen keys."""

    __slots__ = ("aggregation", "clerks_and_keys")

    def __init__(
        self, aggregation: AggregationId, clerks_and_keys: List[Tuple[AgentId, EncryptionKeyId]]
    ):
        self.aggregation = aggregation
        self.clerks_and_keys = [(a, k) for (a, k) in clerks_and_keys]

    def __eq__(self, other):
        return isinstance(other, Committee) and self.to_obj() == other.to_obj()

    def to_obj(self):
        return {
            "aggregation": self.aggregation.to_obj(),
            "clerks_and_keys": [[a.to_obj(), k.to_obj()] for (a, k) in self.clerks_and_keys],
        }

    @classmethod
    def from_obj(cls, obj):
        return cls(
            aggregation=AggregationId.from_obj(obj["aggregation"]),
            clerks_and_keys=[
                (AgentId.from_obj(a), EncryptionKeyId.from_obj(k))
                for (a, k) in obj["clerks_and_keys"]
            ],
        )


class Participation:
    """A participant's encrypted input to an aggregation.

    The fresh ``id`` lets the server dedupe retried uploads
    (resources.rs:93-101).

    ``forwarded_masks`` is the tree-aggregation extension: a *relay*
    re-sharing its leaf's masked total into a parent round attaches the
    leaf's recipient-mask ciphertexts (sealed to the ROOT recipient,
    which the relay cannot open) so they travel upward IN-BAND with the
    re-share — one exactly-once ingest covers both, and the parent's
    snapshot mask collection picks them up alongside the relay's own
    mask. ``None`` (the default) keeps the exact reference wire shape
    and canonical digest for ordinary participations.
    """

    __slots__ = ("id", "participant", "aggregation", "recipient_encryption",
                 "clerk_encryptions", "forwarded_masks")

    def __init__(
        self,
        id: ParticipationId,
        participant: AgentId,
        aggregation: AggregationId,
        recipient_encryption: Optional[Encryption],
        clerk_encryptions: List[Tuple[AgentId, Encryption]],
        forwarded_masks: Optional[List[Encryption]] = None,
    ):
        self.id = id
        self.participant = participant
        self.aggregation = aggregation
        self.recipient_encryption = recipient_encryption
        self.clerk_encryptions = [(a, e) for (a, e) in clerk_encryptions]
        self.forwarded_masks = (
            None if forwarded_masks is None else list(forwarded_masks))

    def __eq__(self, other):
        return isinstance(other, Participation) and self.to_obj() == other.to_obj()

    def canonical_digest(self) -> str:
        """SHA-256 over the canonical JSON bytes of this participation —
        the content half of the exactly-once ingestion key. Two uploads
        with equal digests are byte-identical replays of one sealed
        bundle (safe to dedupe); unequal digests under one
        ``(aggregation, participant)`` key are an equivocation
        (``ParticipationConflict``). Uses the same ``canonical_json``
        serialization the signature layer trusts, so the digest is
        stable across store round trips."""
        import hashlib

        return hashlib.sha256(canonical_json(self.to_obj())).hexdigest()

    def to_obj(self):
        obj = {
            "id": self.id.to_obj(),
            "participant": self.participant.to_obj(),
            "aggregation": self.aggregation.to_obj(),
            "recipient_encryption": (
                None if self.recipient_encryption is None else self.recipient_encryption.to_obj()
            ),
            "clerk_encryptions": [
                [a.to_obj(), e.to_obj()] for (a, e) in self.clerk_encryptions
            ],
        }
        if self.forwarded_masks is not None:
            obj["forwarded_masks"] = [e.to_obj() for e in self.forwarded_masks]
        return obj

    @classmethod
    def from_obj(cls, obj):
        rec = obj.get("recipient_encryption")
        forwarded = obj.get("forwarded_masks")
        return cls(
            id=ParticipationId.from_obj(obj["id"]),
            participant=AgentId.from_obj(obj["participant"]),
            aggregation=AggregationId.from_obj(obj["aggregation"]),
            recipient_encryption=None if rec is None else Encryption.from_obj(rec),
            clerk_encryptions=[
                (AgentId.from_obj(a), Encryption.from_obj(e))
                for (a, e) in obj["clerk_encryptions"]
            ],
            forwarded_masks=(
                None if forwarded is None
                else [Encryption.from_obj(e) for e in forwarded]),
        )


class Snapshot:
    """Freezes a consistent subset of participations for clerking."""

    __slots__ = ("id", "aggregation")

    def __init__(self, id: SnapshotId, aggregation: AggregationId):
        self.id = id
        self.aggregation = aggregation

    def __eq__(self, other):
        return isinstance(other, Snapshot) and self.to_obj() == other.to_obj()

    def to_obj(self):
        return {"id": self.id.to_obj(), "aggregation": self.aggregation.to_obj()}

    @classmethod
    def from_obj(cls, obj):
        return cls(
            id=SnapshotId.from_obj(obj["id"]),
            aggregation=AggregationId.from_obj(obj["aggregation"]),
        )


class ClerkingJob:
    """Partial-aggregation job for one clerk: its column of encryptions."""

    __slots__ = ("id", "clerk", "aggregation", "snapshot", "encryptions")

    def __init__(
        self,
        id: ClerkingJobId,
        clerk: AgentId,
        aggregation: AggregationId,
        snapshot: SnapshotId,
        encryptions: List[Encryption],
    ):
        self.id = id
        self.clerk = clerk
        self.aggregation = aggregation
        self.snapshot = snapshot
        self.encryptions = list(encryptions)

    def __eq__(self, other):
        return isinstance(other, ClerkingJob) and self.to_obj() == other.to_obj()

    def to_obj(self):
        return {
            "id": self.id.to_obj(),
            "clerk": self.clerk.to_obj(),
            "aggregation": self.aggregation.to_obj(),
            "snapshot": self.snapshot.to_obj(),
            "encryptions": [e.to_obj() for e in self.encryptions],
        }

    @classmethod
    def from_obj(cls, obj):
        return cls(
            id=ClerkingJobId.from_obj(obj["id"]),
            clerk=AgentId.from_obj(obj["clerk"]),
            aggregation=AggregationId.from_obj(obj["aggregation"]),
            snapshot=SnapshotId.from_obj(obj["snapshot"]),
            encryptions=[Encryption.from_obj(e) for e in obj["encryptions"]],
        )


class ClerkingResult:
    """Result of a clerking job: encryption of the combined shares."""

    __slots__ = ("job", "clerk", "encryption")

    def __init__(self, job: ClerkingJobId, clerk: AgentId, encryption: Encryption):
        self.job = job
        self.clerk = clerk
        self.encryption = encryption

    def __eq__(self, other):
        return isinstance(other, ClerkingResult) and self.to_obj() == other.to_obj()

    def to_obj(self):
        return {
            "job": self.job.to_obj(),
            "clerk": self.clerk.to_obj(),
            "encryption": self.encryption.to_obj(),
        }

    @classmethod
    def from_obj(cls, obj):
        return cls(
            job=ClerkingJobId.from_obj(obj["job"]),
            clerk=AgentId.from_obj(obj["clerk"]),
            encryption=Encryption.from_obj(obj["encryption"]),
        )


class SnapshotStatus:
    """Progress of one snapshot: result count and readiness."""

    __slots__ = ("id", "number_of_clerking_results", "result_ready")

    def __init__(self, id: SnapshotId, number_of_clerking_results: int, result_ready: bool):
        self.id = id
        self.number_of_clerking_results = int(number_of_clerking_results)
        self.result_ready = bool(result_ready)

    def __eq__(self, other):
        return isinstance(other, SnapshotStatus) and self.to_obj() == other.to_obj()

    def to_obj(self):
        return {
            "id": self.id.to_obj(),
            "number_of_clerking_results": self.number_of_clerking_results,
            "result_ready": self.result_ready,
        }

    @classmethod
    def from_obj(cls, obj):
        return cls(
            id=SnapshotId.from_obj(obj["id"]),
            number_of_clerking_results=obj["number_of_clerking_results"],
            result_ready=obj["result_ready"],
        )


class AggregationStatus:
    """Participation count plus per-snapshot statuses."""

    __slots__ = ("aggregation", "number_of_participations", "snapshots")

    def __init__(
        self,
        aggregation: AggregationId,
        number_of_participations: int,
        snapshots: List[SnapshotStatus],
    ):
        self.aggregation = aggregation
        self.number_of_participations = int(number_of_participations)
        self.snapshots = list(snapshots)

    def to_obj(self):
        return {
            "aggregation": self.aggregation.to_obj(),
            "number_of_participations": self.number_of_participations,
            "snapshots": [s.to_obj() for s in self.snapshots],
        }

    @classmethod
    def from_obj(cls, obj):
        return cls(
            aggregation=AggregationId.from_obj(obj["aggregation"]),
            number_of_participations=obj["number_of_participations"],
            snapshots=[SnapshotStatus.from_obj(s) for s in obj["snapshots"]],
        )


class RoundStatus:
    """Lifecycle state of an aggregation's current round — the explicit
    state machine the round supervisor persists (``server/lifecycle.py``:
    ``collecting → frozen → clerking → ready → revealed`` plus terminal
    ``degraded``/``failed``/``expired``). ``results`` is the LIVE
    clerking-result count; ``history`` is the bounded list of
    ``[state, unix_ts]`` transition stamps.

    ``parent``/``children`` expose the hierarchical-round linkage
    (:class:`TreeLink`): a stuck tree is diagnosable from any worker by
    walking round documents — ``GET /v1/aggregations/{id}/round`` on the
    root names its children, each child names its parent."""

    __slots__ = ("aggregation", "state", "snapshot", "scheme",
                 "committee_size", "reconstruction_threshold", "results",
                 "dead_clerks", "reason", "deadline_at", "updated_at",
                 "history", "parent", "children")

    def __init__(
        self,
        aggregation: AggregationId,
        state: str,
        snapshot: Optional[SnapshotId] = None,
        scheme: Optional[str] = None,
        committee_size: int = 0,
        reconstruction_threshold: int = 0,
        results: int = 0,
        dead_clerks=None,
        reason: Optional[str] = None,
        deadline_at: Optional[float] = None,
        updated_at: Optional[float] = None,
        history=None,
        parent: Optional[AggregationId] = None,
        children=None,
    ):
        self.aggregation = aggregation
        self.state = str(state)
        self.snapshot = snapshot
        self.scheme = scheme
        self.committee_size = int(committee_size)
        self.reconstruction_threshold = int(reconstruction_threshold)
        self.results = int(results)
        self.dead_clerks = [AgentId(c) for c in (dead_clerks or [])]
        self.reason = reason
        self.deadline_at = None if deadline_at is None else float(deadline_at)
        self.updated_at = None if updated_at is None else float(updated_at)
        self.history = [[str(s), float(ts)] for (s, ts) in (history or [])]
        self.parent = None if parent is None else AggregationId(parent)
        self.children = [AggregationId(c) for c in (children or [])]

    def __eq__(self, other):
        return isinstance(other, RoundStatus) and self.to_obj() == other.to_obj()

    def __repr__(self):
        return (f"RoundStatus(aggregation={self.aggregation!r}, "
                f"state={self.state!r}, results={self.results})")

    def to_obj(self):
        return {
            "aggregation": self.aggregation.to_obj(),
            "state": self.state,
            "snapshot": None if self.snapshot is None else self.snapshot.to_obj(),
            "scheme": self.scheme,
            "committee_size": self.committee_size,
            "reconstruction_threshold": self.reconstruction_threshold,
            "results": self.results,
            "dead_clerks": [c.to_obj() for c in self.dead_clerks],
            "reason": self.reason,
            "deadline_at": self.deadline_at,
            "updated_at": self.updated_at,
            "history": [[s, ts] for (s, ts) in self.history],
            "parent": None if self.parent is None else self.parent.to_obj(),
            "children": [c.to_obj() for c in self.children],
        }

    @classmethod
    def from_obj(cls, obj):
        snap = obj.get("snapshot")
        return cls(
            aggregation=AggregationId.from_obj(obj["aggregation"]),
            state=obj["state"],
            snapshot=None if snap is None else SnapshotId.from_obj(snap),
            scheme=obj.get("scheme"),
            committee_size=obj.get("committee_size") or 0,
            reconstruction_threshold=obj.get("reconstruction_threshold") or 0,
            results=obj.get("results") or 0,
            dead_clerks=obj.get("dead_clerks") or [],
            reason=obj.get("reason"),
            deadline_at=obj.get("deadline_at"),
            updated_at=obj.get("updated_at"),
            history=obj.get("history") or [],
            parent=obj.get("parent"),
            children=obj.get("children") or [],
        )


class SnapshotResult:
    """Everything the recipient needs to reconstruct: clerk results + masks."""

    __slots__ = ("snapshot", "number_of_participations", "clerk_encryptions", "recipient_encryptions")

    def __init__(
        self,
        snapshot: SnapshotId,
        number_of_participations: int,
        clerk_encryptions: List[ClerkingResult],
        recipient_encryptions: Optional[List[Encryption]],
    ):
        self.snapshot = snapshot
        self.number_of_participations = int(number_of_participations)
        self.clerk_encryptions = list(clerk_encryptions)
        self.recipient_encryptions = (
            None if recipient_encryptions is None else list(recipient_encryptions)
        )

    def to_obj(self):
        return {
            "snapshot": self.snapshot.to_obj(),
            "number_of_participations": self.number_of_participations,
            "clerk_encryptions": [c.to_obj() for c in self.clerk_encryptions],
            "recipient_encryptions": (
                None
                if self.recipient_encryptions is None
                else [e.to_obj() for e in self.recipient_encryptions]
            ),
        }

    @classmethod
    def from_obj(cls, obj):
        rec = obj.get("recipient_encryptions")
        return cls(
            snapshot=SnapshotId.from_obj(obj["snapshot"]),
            number_of_participations=obj["number_of_participations"],
            clerk_encryptions=[ClerkingResult.from_obj(c) for c in obj["clerk_encryptions"]],
            recipient_encryptions=None if rec is None else [Encryption.from_obj(e) for e in rec],
        )
