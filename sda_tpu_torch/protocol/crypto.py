"""Scheme parameters for the cryptographic primitives — schemes are *data*.

Mirrors the reference's scheme algebra (reference: protocol/src/crypto.rs):
ciphertext/key wrappers (:8-39), masking schemes (:43-75), secret-sharing
schemes with derived properties (:79-155), and additive encryption schemes
(:159-188). All scheme configuration travels in-band inside the Aggregation
resource, so adding a scheme never changes the wire protocol shape.
"""

from __future__ import annotations

from .helpers import B32, B64, Binary, TaggedEnum


# ---------------------------------------------------------------------------
# Ciphertexts, keys, signatures (crypto.rs:8-39)

class Encryption(TaggedEnum):
    """A ciphertext. ``Sodium`` = Curve25519+XSalsa20+Poly1305 sealed box;
    ``PackedPaillier`` = length-framed homomorphic ciphertext batch (the
    reference declares this variant but ships it disabled,
    crypto.rs:164-174)."""
    VARIANTS = {"Sodium": Binary, "PackedPaillier": Binary}

    @classmethod
    def sodium(cls, data: bytes) -> "Encryption":
        return cls("Sodium", Binary(data))


class EncryptionKey(TaggedEnum):
    """A public encryption key: 32-byte Curve25519, or a big-endian
    Paillier modulus n."""
    VARIANTS = {"Sodium": B32, "PackedPaillier": Binary}


class Signature(TaggedEnum):
    """A detached signature (64-byte Ed25519)."""
    VARIANTS = {"Sodium": B64}


class SigningKey(TaggedEnum):
    """A secret signing key (64-byte Ed25519 expanded key)."""
    VARIANTS = {"Sodium": B64}


class VerificationKey(TaggedEnum):
    """A public signature-verification key (32-byte Ed25519)."""
    VARIANTS = {"Sodium": B32}


# ---------------------------------------------------------------------------
# Masking schemes (crypto.rs:43-75)

#: ChaCha mask-PRG identifiers. The bare Rust wire shape (no "prg" key)
#: means the stream the reference actually draws — rand 0.3's ChaChaRng
#: (crypto.rs:53 documents the scheme as `rand::chacha::ChaChaRng`) — so a
#: scheme parsed from a Rust peer expands masks identically here and a
#: mixed round reveals the CORRECT aggregate. The TPU-native CHACHA_PRG_V1
#: spec is an explicit opt-in extension serialized as an extra "prg" key.
#: Unknown tags are rejected at parse time: an unrecognized stream must
#: fail loudly, never silently alias another one (that is the
#: wrong-aggregate hazard the tag exists to prevent). Literals duplicated
#: in fields.chacha (the spec home) to keep this wire layer import-light;
#: tests pin the two sets equal.
CHACHA_PRG_RAND03 = "rand-0.3/chacharng"
CHACHA_PRG_V1 = "sda-tpu/chacha20-prg/v1"
_CHACHA_PRGS = (CHACHA_PRG_RAND03, CHACHA_PRG_V1)


class LinearMaskingScheme:
    """Masking between recipient and committee; subclasses are the variants."""

    #: whether masks are produced at all (crypto.rs:66-75)
    has_mask: bool = True

    def to_obj(self):
        raise NotImplementedError

    @staticmethod
    def from_obj(obj) -> "LinearMaskingScheme":
        if obj == "None":
            return NoMasking()
        if isinstance(obj, dict) and len(obj) == 1:
            [(variant, p)] = obj.items()
            if variant == "Full":
                return FullMasking(modulus=p["modulus"])
            if variant == "ChaCha":
                return ChaChaMasking(
                    modulus=p["modulus"],
                    dimension=p["dimension"],
                    seed_bitsize=p["seed_bitsize"],
                    prg=p.get("prg", CHACHA_PRG_RAND03),
                )
        raise ValueError(f"unknown masking scheme {obj!r}")

    def __eq__(self, other):
        return type(self) is type(other) and self.to_obj() == other.to_obj()

    def __hash__(self):
        return hash(repr(self.to_obj()))

    def __repr__(self):
        return f"{type(self).__name__}({self.to_obj()!r})"


class NoMasking(LinearMaskingScheme):
    """No masking: secrets are shared directly to the clerks."""
    has_mask = False

    def to_obj(self):
        return "None"


class FullMasking(LinearMaskingScheme):
    """Per-element fresh-random mask; mask uploaded in full (O(d))."""

    def __init__(self, modulus: int):
        self.modulus = int(modulus)

    def to_obj(self):
        return {"Full": {"modulus": self.modulus}}


class ChaChaMasking(LinearMaskingScheme):
    """Seed-compressed masking: upload a <=256-bit seed, not an O(d) mask.

    Trades upload/download bandwidth for seed-expansion compute on both
    participant and recipient sides (crypto.rs:53-62). ``prg`` names the
    expansion stream; the default (CHACHA_PRG_RAND03) serializes to the
    exact Rust wire shape and draws the exact rand-0.3 ChaChaRng stream,
    so rounds mixed with a Rust peer stay correct.
    """

    def __init__(self, modulus: int, dimension: int, seed_bitsize: int,
                 prg: str = CHACHA_PRG_RAND03):
        self.modulus = int(modulus)
        self.dimension = int(dimension)
        self.seed_bitsize = int(seed_bitsize)
        if prg not in _CHACHA_PRGS:
            raise ValueError(
                f"unknown ChaCha PRG {prg!r}; known: {list(_CHACHA_PRGS)}"
            )
        self.prg = str(prg)

    def to_obj(self):
        obj = {
            "modulus": self.modulus,
            "dimension": self.dimension,
            "seed_bitsize": self.seed_bitsize,
        }
        if self.prg != CHACHA_PRG_RAND03:
            obj["prg"] = self.prg
        return {"ChaCha": obj}


# ---------------------------------------------------------------------------
# Secret-sharing schemes (crypto.rs:79-155)

class LinearSecretSharingScheme:
    """Sharing of masked secrets across the committee, with derived properties."""

    #: number of secrets shared together (crypto.rs:120-126)
    input_size: int
    #: number of shares produced == committee size (crypto.rs:129-135)
    output_size: int
    #: max colluding clerks before privacy is lost (crypto.rs:138-144)
    privacy_threshold: int
    #: min clerk results needed to reconstruct (crypto.rs:147-153)
    reconstruction_threshold: int

    def to_obj(self):
        raise NotImplementedError

    @staticmethod
    def from_obj(obj) -> "LinearSecretSharingScheme":
        if isinstance(obj, dict) and len(obj) == 1:
            [(variant, p)] = obj.items()
            if variant == "Additive":
                return AdditiveSharing(share_count=p["share_count"], modulus=p["modulus"])
            if variant == "BasicShamir":
                return BasicShamirSharing(
                    share_count=p["share_count"],
                    privacy_threshold=p["privacy_threshold"],
                    prime_modulus=p["prime_modulus"],
                )
            if variant == "PackedShamir":
                return PackedShamirSharing(
                    secret_count=p["secret_count"],
                    share_count=p["share_count"],
                    privacy_threshold=p["privacy_threshold"],
                    prime_modulus=p["prime_modulus"],
                    omega_secrets=p["omega_secrets"],
                    omega_shares=p["omega_shares"],
                )
        raise ValueError(f"unknown sharing scheme {obj!r}")

    def __eq__(self, other):
        return type(self) is type(other) and self.to_obj() == other.to_obj()

    def __hash__(self):
        return hash(repr(self.to_obj()))

    def __repr__(self):
        return f"{type(self).__name__}({self.to_obj()!r})"


class AdditiveSharing(LinearSecretSharingScheme):
    """n-of-n additive sharing over Z_modulus (computationally cheap)."""

    def __init__(self, share_count: int, modulus: int):
        self.share_count = int(share_count)
        self.modulus = int(modulus)

    input_size = 1

    @property
    def output_size(self) -> int:
        return self.share_count

    @property
    def privacy_threshold(self) -> int:
        return self.share_count - 1

    @property
    def reconstruction_threshold(self) -> int:
        return self.share_count

    def to_obj(self):
        return {"Additive": {"share_count": self.share_count, "modulus": self.modulus}}


class BasicShamirSharing(LinearSecretSharingScheme):
    """Classic (non-packed) Shamir over Z_p: one secret per polynomial,
    any ``privacy_threshold + 1`` of ``share_count`` shares reconstruct.

    The reference DECLARES this variant but ships it commented out
    (protocol/src/crypto.rs:89-95: share_count, privacy_threshold,
    prime_modulus), with its derived properties spelled out in the
    commented match arms of crypto.rs:117-155 (input_size 1,
    output_size share_count, reconstruction_threshold t + 1). Implemented
    for real here: shares are Vandermonde evaluations at points 1..n and
    reconstruction is Lagrange interpolation at zero — host-built
    matrices applied with the same device matmuls as the packed scheme,
    so every execution mode (federated, pod, streamed, Pallas, dropout
    quorums) works unchanged. Unlike PackedShamir the prime needs no
    root-of-unity structure: ANY prime > share_count qualifies.
    """

    def __init__(self, share_count: int, privacy_threshold: int,
                 prime_modulus: int):
        self.share_count = int(share_count)
        self._privacy_threshold = int(privacy_threshold)
        self.prime_modulus = int(prime_modulus)
        if not 1 <= self._privacy_threshold < self.share_count:
            raise ValueError(
                f"privacy threshold {privacy_threshold} must be in "
                f"[1, share_count {share_count})"
            )
        if self.prime_modulus <= self.share_count:
            raise ValueError(
                f"prime modulus {prime_modulus} must exceed share_count "
                f"{share_count} (evaluation points 1..n must be distinct "
                f"and nonzero mod p)"
            )

    #: one secret per polynomial — the k=1 degenerate of the packed layout,
    #: so downstream batching/matrix code is shared
    secret_count = 1
    input_size = 1

    @property
    def output_size(self) -> int:
        return self.share_count

    @property
    def privacy_threshold(self) -> int:
        return self._privacy_threshold

    @property
    def reconstruction_threshold(self) -> int:
        return self._privacy_threshold + 1

    def to_obj(self):
        return {
            "BasicShamir": {
                "share_count": self.share_count,
                "privacy_threshold": self._privacy_threshold,
                "prime_modulus": self.prime_modulus,
            }
        }


class PackedShamirSharing(LinearSecretSharingScheme):
    """Packed Shamir over Z_p: k secrets per polynomial, fault-tolerant.

    ``omega_secrets`` is a root of unity of power-of-2 order
    ``secret_count + privacy_threshold + 1``; ``omega_shares`` of power-of-3
    order ``share_count + 1`` — enabling NTT-based polynomial evaluation
    (reference scheme parameters: protocol/src/crypto.rs:98-113; working
    vector p=433, omega=354/150: integration-tests/tests/full_loop.rs:55-67).
    """

    def __init__(
        self,
        secret_count: int,
        share_count: int,
        privacy_threshold: int,
        prime_modulus: int,
        omega_secrets: int,
        omega_shares: int,
    ):
        self.secret_count = int(secret_count)
        self.share_count = int(share_count)
        self._privacy_threshold = int(privacy_threshold)
        self.prime_modulus = int(prime_modulus)
        self.omega_secrets = int(omega_secrets)
        self.omega_shares = int(omega_shares)

    @property
    def input_size(self) -> int:
        return self.secret_count

    @property
    def output_size(self) -> int:
        return self.share_count

    @property
    def privacy_threshold(self) -> int:
        return self._privacy_threshold

    @property
    def reconstruction_threshold(self) -> int:
        return self._privacy_threshold + self.secret_count

    def to_obj(self):
        return {
            "PackedShamir": {
                "secret_count": self.secret_count,
                "share_count": self.share_count,
                "privacy_threshold": self._privacy_threshold,
                "prime_modulus": self.prime_modulus,
                "omega_secrets": self.omega_secrets,
                "omega_shares": self.omega_shares,
            }
        }


# ---------------------------------------------------------------------------
# Additive encryption schemes (crypto.rs:159-188)

class AdditiveEncryptionScheme:
    """Share-transport encryption scheme."""

    batch_size: int = 1

    def to_obj(self):
        raise NotImplementedError

    @staticmethod
    def from_obj(obj) -> "AdditiveEncryptionScheme":
        if obj == "Sodium":
            return SodiumEncryption()
        if isinstance(obj, dict) and set(obj) == {"PackedPaillier"}:
            p = obj["PackedPaillier"]
            return PackedPaillierEncryption(
                component_count=p["component_count"],
                component_bitsize=p["component_bitsize"],
                max_value_bitsize=p["max_value_bitsize"],
                min_modulus_bitsize=p["min_modulus_bitsize"],
            )
        raise ValueError(f"unknown encryption scheme {obj!r}")

    def __eq__(self, other):
        return type(self) is type(other) and self.to_obj() == other.to_obj()

    def __hash__(self):
        return hash(repr(self.to_obj()))

    def __repr__(self):
        return f"{type(self).__name__}()"


class SodiumEncryption(AdditiveEncryptionScheme):
    """libsodium sealed box (Curve25519+XSalsa20+Poly1305), anonymous sender."""

    batch_size = 1

    def to_obj(self):
        return "Sodium"


class PackedPaillierEncryption(AdditiveEncryptionScheme):
    """Packed Paillier: additively homomorphic ciphertexts.

    Parameter semantics follow the reference's (disabled) declaration,
    crypto.rs:164-174: ``component_count`` values are packed per plaintext in
    ``component_bitsize``-bit windows; fresh values must fit
    ``max_value_bitsize`` bits, so up to ``2^(component_bitsize -
    max_value_bitsize)`` ciphertexts can be summed homomorphically before a
    component overflows its window; ``min_modulus_bitsize`` floors the key
    size n (and component_count * component_bitsize must fit under it).
    ``batch_size()`` is ``component_count``, matching crypto.rs:181-186.

    Sizing note: in the *recipient* slot under ChaCha masking the encrypted
    "mask" vector carries 32-bit seed words (chacha.rs:49-53 convention), so
    that slot needs ``max_value_bitsize >= 32``; the committee slot only
    carries field elements ``< modulus``.
    """

    def __init__(self, component_count: int, component_bitsize: int,
                 max_value_bitsize: int, min_modulus_bitsize: int):
        if max_value_bitsize > component_bitsize:
            raise ValueError("max_value_bitsize exceeds the component window")
        if component_bitsize > 63:
            raise ValueError("component window exceeds the int64 share range")
        if component_count * component_bitsize >= min_modulus_bitsize:
            raise ValueError("packed plaintext does not fit under the modulus floor")
        self.component_count = component_count
        self.component_bitsize = component_bitsize
        self.max_value_bitsize = max_value_bitsize
        self.min_modulus_bitsize = min_modulus_bitsize

    @property
    def batch_size(self) -> int:  # type: ignore[override]
        return self.component_count

    @property
    def additive_capacity(self) -> int:
        """How many fresh ciphertexts may be summed without window overflow."""
        return 1 << (self.component_bitsize - self.max_value_bitsize)

    def to_obj(self):
        return {
            "PackedPaillier": {
                "component_count": self.component_count,
                "component_bitsize": self.component_bitsize,
                "max_value_bitsize": self.max_value_bitsize,
                "min_modulus_bitsize": self.min_modulus_bitsize,
            }
        }

    def __repr__(self):
        return (
            f"PackedPaillierEncryption({self.component_count}, "
            f"{self.component_bitsize}, {self.max_value_bitsize}, "
            f"{self.min_modulus_bitsize})"
        )
