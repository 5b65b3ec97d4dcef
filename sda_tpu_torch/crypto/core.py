"""Crypto module core: keypairs, keystore interface, RNG seeds.

Mirrors the reference's CryptoModule/Keystore plumbing
(client/src/crypto/mod.rs:33-66): type aliases Secret=Mask=Share=i64 become
int64 numpy arrays and torch tensors; the keystore stores encryption and
signature keypairs by id and is shared between the crypto module and the
client store.

Port of ``sda_tpu/crypto/core.py``: the per-operation randomness root is a
``torch.Generator`` on the role's device instead of a threefry key.
"""

from __future__ import annotations

import abc
import secrets as _secrets
from typing import Optional

from .._lazy import torch

from ..protocol import (
    B32,
    B64,
    Binary,
    EncryptionKey,
    EncryptionKeyId,
    SigningKey,
    VerificationKey,
    VerificationKeyId,
)


class DecryptionKey:
    """Secret half of an encryption keypair: 32-byte Curve25519 for
    ``Sodium``, a length-framed (p, q) factorisation for ``PackedPaillier``."""

    __slots__ = ("variant", "value")

    _PAYLOADS = {"Sodium": B32, "PackedPaillier": Binary}

    def __init__(self, variant: str, value):
        if variant not in self._PAYLOADS:
            raise ValueError(f"unknown decryption key variant {variant!r}")
        self.variant = variant
        self.value = value

    def to_obj(self):
        return {self.variant: self.value.to_obj()}

    @classmethod
    def from_obj(cls, obj):
        [(variant, payload)] = obj.items()
        if variant not in cls._PAYLOADS:
            raise ValueError(f"unknown decryption key variant {variant!r}")
        return cls(variant, cls._PAYLOADS[variant].from_obj(payload))


class EncryptionKeypair:
    """Public + secret encryption key (encryption/mod.rs:12-17)."""

    __slots__ = ("ek", "dk")

    def __init__(self, ek: EncryptionKey, dk: DecryptionKey):
        self.ek = ek
        self.dk = dk

    def to_obj(self):
        return {"ek": self.ek.to_obj(), "dk": self.dk.to_obj()}

    @classmethod
    def from_obj(cls, obj):
        return cls(EncryptionKey.from_obj(obj["ek"]), DecryptionKey.from_obj(obj["dk"]))


class SignatureKeypair:
    """Verification + signing key (signing/mod.rs:20-25)."""

    __slots__ = ("vk", "sk")

    def __init__(self, vk: VerificationKey, sk: SigningKey):
        self.vk = vk
        self.sk = sk

    def to_obj(self):
        return {"vk": self.vk.to_obj(), "sk": self.sk.to_obj()}

    @classmethod
    def from_obj(cls, obj):
        return cls(VerificationKey.from_obj(obj["vk"]), SigningKey.from_obj(obj["sk"]))


class Keystore(abc.ABC):
    """Typed keypair storage (client/src/crypto/mod.rs:43-52).

    Implementations: in-memory (tests), file-based (sda_tpu_torch.store.Filebased).
    """

    @abc.abstractmethod
    def put_encryption_keypair(self, id: EncryptionKeyId, kp: EncryptionKeypair) -> None: ...

    @abc.abstractmethod
    def get_encryption_keypair(self, id: EncryptionKeyId) -> Optional[EncryptionKeypair]: ...

    @abc.abstractmethod
    def put_signature_keypair(self, id: VerificationKeyId, kp: SignatureKeypair) -> None: ...

    @abc.abstractmethod
    def get_signature_keypair(self, id: VerificationKeyId) -> Optional[SignatureKeypair]: ...


class MemoryKeystore(Keystore):
    def __init__(self):
        self._enc = {}
        self._sig = {}

    def put_encryption_keypair(self, id, kp):
        self._enc[id] = kp

    def get_encryption_keypair(self, id):
        return self._enc.get(id)

    def put_signature_keypair(self, id, kp):
        self._sig[id] = kp

    def get_signature_keypair(self, id):
        return self._sig.get(id)


def fresh_prng_key(device) -> torch.Generator:
    """Generator on ``device`` seeded from OS entropy — the device-side
    randomness root.

    Replaces the reference's per-call OsRng (additive.rs:17, full.rs:16):
    bulk share/mask randomness is generated on-device from a 63-bit
    OS-entropy seed per operation, as the JAX package seeds its threefry
    key.
    """
    seed = int.from_bytes(_secrets.token_bytes(8), "little") & ((1 << 63) - 1)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return generator
