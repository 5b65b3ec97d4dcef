"""Serde helpers: ids, binary blobs, canonical JSON, Signed/Labelled wrappers.

Wire compatibility targets the reference's serde conventions
(reference: protocol/src/helpers.rs, protocol/src/byte_arrays.rs):

- ids are hyphenated-UUID strings (helpers.rs:46-60);
- binary blobs are standard base64 with padding (helpers.rs:178-186);
- fixed-size byte arrays (B8/B32/B64) are base64 too (byte_arrays.rs:3-99);
- enums are externally tagged: unit variant -> ``"None"``, newtype variant ->
  ``{"Sodium": <value>}``, struct variant -> ``{"Full": {"modulus": 433}}``;
- signing operates over *canonical JSON* — compact separators, declared field
  order (helpers.rs:129-142: ``Sign::canonical`` is ``serde_json::to_vec``).
"""

from __future__ import annotations

import base64
import json
import uuid as _uuid
from typing import Any, Callable, Generic, Optional, Type, TypeVar


# ---------------------------------------------------------------------------
# Canonical JSON

def canonical_json(obj: Any) -> bytes:
    """Compact, declaration-ordered JSON bytes — the signing payload.

    Matches serde_json's default output (no whitespace, struct-field order,
    raw UTF-8), reference: protocol/src/helpers.rs:138-142.
    """
    return json.dumps(obj, separators=(",", ":"), ensure_ascii=False).encode("utf-8")


# ---------------------------------------------------------------------------
# Identifiers

class ResourceId:
    """UUID-valued unique identifier, serialized as a hyphenated string.

    Subclasses (AgentId, AggregationId, ...) exist purely for type clarity,
    mirroring the reference's ``uuid_id!`` macro (protocol/src/helpers.rs:19-86).
    """

    __slots__ = ("uuid",)

    def __init__(self, value: "str | _uuid.UUID | ResourceId | None" = None):
        if value is None:
            self.uuid = _uuid.uuid4()
        elif isinstance(value, _uuid.UUID):
            self.uuid = value
        elif isinstance(value, ResourceId):
            self.uuid = value.uuid
        else:
            try:
                self.uuid = _uuid.UUID(str(value))
            except ValueError:
                raise ValueError(f"unparseable uuid {value!r}")

    @classmethod
    def random(cls):
        return cls(_uuid.uuid4())

    def __str__(self) -> str:
        return str(self.uuid)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.uuid})"

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self.uuid == other.uuid

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.uuid))

    def __lt__(self, other: "ResourceId") -> bool:
        # UUID ordering = byte order, matching Rust's Uuid Ord (used by
        # suggest_committee sorting, reference: server/src/jfs_stores/agents.rs:66-72).
        return self.uuid.bytes < other.uuid.bytes

    def to_obj(self) -> str:
        return str(self.uuid)

    @classmethod
    def from_obj(cls, obj: str):
        return cls(obj)


# ---------------------------------------------------------------------------
# Binary blobs and fixed-size byte arrays

class Binary:
    """Arbitrary byte blob, base64 on the wire (helpers.rs:175-216)."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        if not isinstance(data, (bytes, bytearray)):
            raise TypeError("Binary wraps bytes")
        self.data = bytes(data)

    def __eq__(self, other) -> bool:
        return isinstance(other, Binary) and self.data == other.data

    def __hash__(self) -> int:
        return hash(self.data)

    def __len__(self) -> int:
        return len(self.data)

    def __repr__(self) -> str:
        return f"Binary({len(self.data)} bytes)"

    def to_obj(self) -> str:
        return base64.b64encode(self.data).decode("ascii")

    @classmethod
    def from_obj(cls, obj: str) -> "Binary":
        try:
            return cls(base64.b64decode(obj, validate=True))
        except Exception as e:
            raise ValueError(f"Base64 decoding error: {e}")


class ByteArray:
    """Fixed-size byte array with base64 serde (byte_arrays.rs:3-99)."""

    SIZE = 0
    __slots__ = ("data",)

    def __init__(self, data: Optional[bytes] = None):
        if data is None:
            data = bytes(self.SIZE)
        data = bytes(data)
        if len(data) != self.SIZE:
            raise ValueError(f"{type(self).__name__} requires {self.SIZE} bytes, got {len(data)}")
        self.data = data

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self.data == other.data

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.data))

    def __repr__(self) -> str:
        return f"{type(self).__name__}(<{self.SIZE} bytes>)"

    def to_obj(self) -> str:
        return base64.b64encode(self.data).decode("ascii")

    @classmethod
    def from_obj(cls, obj: str):
        return cls(base64.b64decode(obj, validate=True))


class B8(ByteArray):
    SIZE = 8


class B32(ByteArray):
    SIZE = 32


class B64(ByteArray):
    SIZE = 64


# ---------------------------------------------------------------------------
# Externally-tagged enum helper

class TaggedEnum:
    """Base for serde externally-tagged enums with a single payload.

    Each subclass declares ``VARIANTS: {variant_name: payload_codec | None}``
    where ``payload_codec`` is a class with to_obj/from_obj, or ``None`` for a
    unit variant. An instance is (variant, value).
    """

    VARIANTS: dict = {}
    __slots__ = ("variant", "value")

    def __init__(self, variant: str, value: Any = None):
        if variant not in self.VARIANTS:
            raise ValueError(f"unknown variant {variant!r} for {type(self).__name__}")
        codec = self.VARIANTS[variant]
        if codec is None:
            if value is not None:
                raise ValueError(f"unit variant {variant} takes no value")
        elif not isinstance(value, codec):
            value = codec(value)
        self.variant = variant
        self.value = value

    def __eq__(self, other) -> bool:
        return (
            type(self) is type(other)
            and self.variant == other.variant
            and self.value == other.value
        )

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.variant, self.value))

    def __repr__(self) -> str:
        if self.value is None:
            return f"{type(self).__name__}.{self.variant}"
        return f"{type(self).__name__}.{self.variant}({self.value!r})"

    def to_obj(self):
        if self.VARIANTS[self.variant] is None:
            return self.variant
        return {self.variant: self.value.to_obj()}

    @classmethod
    def from_obj(cls, obj):
        if isinstance(obj, str):
            return cls(obj)
        if isinstance(obj, dict) and len(obj) == 1:
            [(variant, payload)] = obj.items()
            codec = cls.VARIANTS.get(variant)
            if codec is None:
                raise ValueError(f"variant {variant!r} of {cls.__name__} is not a newtype")
            return cls(variant, codec.from_obj(payload))
        raise ValueError(f"cannot decode {cls.__name__} from {obj!r}")


# ---------------------------------------------------------------------------
# Labelled and Signed wrappers

M = TypeVar("M")
ID = TypeVar("ID", bound=ResourceId)


class Labelled(Generic[ID, M]):
    """A message labelled by an identifier (helpers.rs:144-162)."""

    __slots__ = ("id", "body")

    def __init__(self, id: ID, body: M):
        self.id = id
        self.body = body

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Labelled)
            and self.id == other.id
            and self.body == other.body
        )

    def __repr__(self) -> str:
        return f"Labelled(id={self.id!r}, body={self.body!r})"

    def to_obj(self):
        return {"id": self.id.to_obj(), "body": self.body.to_obj()}

    @classmethod
    def from_obj(cls, obj, id_type: Type[ResourceId], body_type):
        return cls(id_type.from_obj(obj["id"]), body_type.from_obj(obj["body"]))

    def canonical(self) -> bytes:
        """Bytes that get signed (helpers.rs:129-142)."""
        return canonical_json(self.to_obj())


class Signed(Generic[M]):
    """A message with a detached signature and claimed signer (helpers.rs:99-127)."""

    __slots__ = ("signature", "signer", "body")

    def __init__(self, signature, signer, body):
        self.signature = signature
        self.signer = signer
        self.body = body

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Signed)
            and self.signature == other.signature
            and self.signer == other.signer
            and self.body == other.body
        )

    def __repr__(self) -> str:
        return f"Signed(signer={self.signer!r}, body={self.body!r})"

    @property
    def id(self):
        return self.body.id

    def to_obj(self):
        # Field order matters for canonical bytes: signature, signer, body
        # (declaration order in helpers.rs:101-107).
        return {
            "signature": self.signature.to_obj(),
            "signer": self.signer.to_obj(),
            "body": self.body.to_obj(),
        }

    @classmethod
    def from_obj(cls, obj, signature_type, signer_type, body_from_obj: Callable):
        return cls(
            signature_type.from_obj(obj["signature"]),
            signer_type.from_obj(obj["signer"]),
            body_from_obj(obj["body"]),
        )
