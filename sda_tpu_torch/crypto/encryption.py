"""Share-transport encryption: sealed boxes over varint-packed shares.

Reference: client/src/crypto/encryption/{mod,sodium}.rs — shares are
zigzag-varint encoded then sealed to the receiver's Curve25519 key
(anonymous sender). The varint packing is part of the wire format and is
kept bit-compatible (sodium.rs:36-45).

Also implements the reference's *declared-but-disabled* PackedPaillier
scheme (crypto.rs:164-174) for real — additively homomorphic ciphertext
batches that let shares be summed without decryption (``paillier_combine``).

Port of ``sda_tpu/crypto/encryption.py``: the ciphertext fold is the host
fold. The JAX package's opt-in device premix (``SDA_PREMIX_DEVICE=1``, TPU
kernel K4 in ``crypto/paillier_tpu.py``) has no counterpart yet, so asking
for it raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..protocol import (
    AdditiveEncryptionScheme,
    Binary,
    Encryption,
    EncryptionKey,
    EncryptionKeyId,
    PackedPaillierEncryption,
    SodiumEncryption,
)
from . import paillier, sodium, varint
from .core import DecryptionKey, EncryptionKeypair, Keystore


class ShareEncryptor:
    def encrypt(self, shares: Sequence[int]) -> Encryption:
        raise NotImplementedError


class ShareDecryptor:
    def decrypt(self, encryption: Encryption) -> np.ndarray:
        raise NotImplementedError


class SodiumEncryptor(ShareEncryptor):
    def __init__(self, ek: EncryptionKey):
        if ek.variant != "Sodium":
            raise ValueError(f"unsupported encryption key variant {ek.variant}")
        self._pk = ek.value.data

    def encrypt(self, shares):
        payload = varint.encode(np.asarray(shares, dtype=np.int64))
        return Encryption("Sodium", Binary(sodium.seal(payload, self._pk)))


class SodiumDecryptor(ShareDecryptor):
    def __init__(self, key_id: EncryptionKeyId, keystore: Keystore):
        keypair = keystore.get_encryption_keypair(key_id)
        if keypair is None:
            raise ValueError("could not load keypair for decryption")
        self._pk = keypair.ek.value.data
        self._sk = keypair.dk.value.data

    def decrypt(self, encryption):
        if encryption.variant != "Sodium":
            raise ValueError(f"unsupported encryption variant {encryption.variant}")
        payload = sodium.seal_open(encryption.value.data, self._pk, self._sk)
        return varint.decode(payload)


class PackedPaillierEncryptor(ShareEncryptor):
    """Shares -> one framed batch of packed Paillier ciphertexts.

    Wire format of the ``PackedPaillier`` payload: LEB128(share count),
    LEB128(summand count), then per ciphertext LEB128(byte length) +
    big-endian bytes. The last plaintext is zero-padded to
    ``component_count`` (stripped on decrypt via the recorded share count).
    A fresh encryption has summand count 1; ``paillier_combine`` adds the
    counts, so window-overflow validation survives nested/incremental
    combining.
    """

    def __init__(self, ek: EncryptionKey, scheme: PackedPaillierEncryption):
        if ek.variant != "PackedPaillier":
            raise ValueError(f"unsupported encryption key variant {ek.variant}")
        self._pk = paillier.PaillierPublicKey.from_bytes(ek.value.data)
        if self._pk.bitsize < scheme.min_modulus_bitsize:
            raise ValueError(
                f"{self._pk.bitsize}-bit key below the scheme's "
                f"{scheme.min_modulus_bitsize}-bit floor"
            )
        self._scheme = scheme

    def encrypt(self, shares):
        s = self._scheme
        values = [int(v) for v in np.asarray(shares, dtype=np.int64)]
        for v in values:
            if v < 0 or v.bit_length() > s.max_value_bitsize:
                raise ValueError(
                    f"share {v} outside the fresh-value bound "
                    f"2^{s.max_value_bitsize} (crypto.rs:169-171 semantics)"
                )
        out = [_leb128(len(values)), _leb128(1)]
        for i in range(0, len(values), s.component_count):
            m = paillier.pack(values[i : i + s.component_count], s.component_bitsize)
            c = paillier.encrypt(self._pk, m)
            raw = c.to_bytes((c.bit_length() + 7) // 8 or 1, "big")
            out.append(_leb128(len(raw)) + raw)
        return Encryption("PackedPaillier", Binary(b"".join(out)))


class PackedPaillierDecryptor(ShareDecryptor):
    def __init__(self, key_id: EncryptionKeyId, keystore: Keystore,
                 scheme: PackedPaillierEncryption):
        keypair = keystore.get_encryption_keypair(key_id)
        if keypair is None:
            raise ValueError("could not load keypair for decryption")
        if keypair.dk.variant != "PackedPaillier":
            raise ValueError(f"unsupported decryption key variant {keypair.dk.variant}")
        self._sk = paillier.PaillierSecretKey.from_bytes(keypair.dk.value.data)
        self._scheme = scheme

    def decrypt(self, encryption):
        if encryption.variant != "PackedPaillier":
            raise ValueError(f"unsupported encryption variant {encryption.variant}")
        s = self._scheme
        count, summands, ciphertexts = _unframe_paillier(encryption.value.data)
        if summands > s.additive_capacity:
            raise ValueError(
                f"batch records {summands} summands, over the scheme's "
                f"additive capacity of {s.additive_capacity}"
            )
        values: list = []
        for c in ciphertexts:
            m = paillier.decrypt(self._sk, c)
            values.extend(paillier.unpack(m, s.component_count, s.component_bitsize))
        if len(values) < count:
            raise ValueError("ciphertext batch shorter than its declared share count")
        return np.asarray(values[:count], dtype=np.int64)


def paillier_combine(ek: EncryptionKey, scheme: PackedPaillierEncryption,
                     encryptions: Sequence[Encryption]) -> Encryption:
    """Homomorphic share combine: multiply ciphertext batches componentwise.

    This is the point of PackedPaillier — a clerk (or the server itself) sums
    participants' share vectors *without decrypting anything*; the plaintext
    components add under the ciphertext product. All batches must have the
    same length; the accumulated fresh-summand count (tracked in the wire
    frame, so nested/incremental combines are safe) must stay within
    ``scheme.additive_capacity`` — then integer sums can't wrap inside the
    window and the recipient recovers the modular sum exactly by reducing
    the decrypted sums ``mod m``.
    """
    if not encryptions:
        raise ValueError("nothing to combine")
    if ek.variant != "PackedPaillier":
        raise ValueError(f"unsupported encryption key variant {ek.variant}")
    pk = paillier.PaillierPublicKey.from_bytes(ek.value.data)
    if pk.bitsize < scheme.min_modulus_bitsize:
        raise ValueError(
            f"{pk.bitsize}-bit key below the scheme's "
            f"{scheme.min_modulus_bitsize}-bit floor"
        )
    if os.environ.get("SDA_PREMIX_DEVICE") == "1":
        raise NotImplementedError(
            "SDA_PREMIX_DEVICE=1: the device premix (TPU kernel K4) is not "
            "ported to sda_tpu_torch yet (ROADMAP queue 1, item 11); unset "
            "it to fold on the host")
    # the host fold is INCREMENTAL (O(B) working set)
    count: Optional[int] = None
    batch_len: Optional[int] = None
    total_summands = 0
    acc: list = []
    for e in encryptions:
        if e.variant != "PackedPaillier":
            raise ValueError(f"unsupported encryption variant {e.variant}")
        n, summands, cs = _unframe_paillier(e.value.data)
        total_summands += summands
        if count is None:
            count, batch_len = n, len(cs)
        elif n != count or len(cs) != batch_len:
            raise ValueError("mismatched batch shapes in homomorphic combine")
        if not acc:
            acc = list(cs)
        else:
            acc = [paillier.add(pk, a, c) for a, c in zip(acc, cs)]
    # summand counts accumulate through nested combines, so the window-
    # overflow bound holds for the TOTAL number of fresh encryptions folded
    # in, not just this call's operand list
    if total_summands > scheme.additive_capacity:
        raise ValueError(
            f"{total_summands} accumulated summands exceed the scheme's "
            f"additive capacity of {scheme.additive_capacity}"
        )
    out = [_leb128(count), _leb128(total_summands)]
    for c in acc:
        raw = c.to_bytes((c.bit_length() + 7) // 8 or 1, "big")
        out.append(_leb128(len(raw)) + raw)
    return Encryption("PackedPaillier", Binary(b"".join(out)))


def _leb128(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_leb128(raw: bytes, pos: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        if pos >= len(raw):
            raise ValueError("truncated varint in PackedPaillier payload")
        if shift > 63:
            raise ValueError("oversized varint in PackedPaillier payload")
        b = raw[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _unframe_paillier(raw: bytes) -> Tuple[int, int, list]:
    count, pos = _read_leb128(raw, 0)
    summands, pos = _read_leb128(raw, pos)
    if summands < 1:
        raise ValueError("PackedPaillier batch records zero summands")
    ciphertexts = []
    while pos < len(raw):
        ln, pos = _read_leb128(raw, pos)
        if pos + ln > len(raw):
            raise ValueError("truncated ciphertext frame in PackedPaillier payload")
        ciphertexts.append(int.from_bytes(raw[pos : pos + ln], "big"))
        pos += ln
    return count, summands, ciphertexts


#: Public names for the LEB128 framing helpers: the binary wire codec
#: (``protocol/bincodec.py``) frames its lengths with the exact same
#: encoding the PackedPaillier payload uses.
leb128 = _leb128
read_leb128 = _read_leb128


def new_share_encryptor(ek: EncryptionKey, scheme: AdditiveEncryptionScheme) -> ShareEncryptor:
    if isinstance(scheme, SodiumEncryption):
        return SodiumEncryptor(ek)
    if isinstance(scheme, PackedPaillierEncryption):
        return PackedPaillierEncryptor(ek, scheme)
    raise ValueError(f"unknown encryption scheme {scheme!r}")


def new_share_decryptor(
    key_id: EncryptionKeyId, scheme: AdditiveEncryptionScheme, keystore: Keystore
) -> ShareDecryptor:
    if isinstance(scheme, SodiumEncryption):
        return SodiumDecryptor(key_id, keystore)
    if isinstance(scheme, PackedPaillierEncryption):
        return PackedPaillierDecryptor(key_id, keystore, scheme)
    raise ValueError(f"unknown encryption scheme {scheme!r}")


def new_encryption_keypair(
    scheme: Optional[AdditiveEncryptionScheme] = None,
) -> EncryptionKeypair:
    """Fresh keypair for ``scheme`` (default Sodium, sodium.rs:95-109):
    Curve25519 for Sodium, an exactly-min_modulus_bitsize-bit Paillier
    modulus for PackedPaillier."""
    from ..protocol import B32

    if scheme is None or isinstance(scheme, SodiumEncryption):
        pk, sk = sodium.box_keypair()
        return EncryptionKeypair(
            ek=EncryptionKey("Sodium", B32(pk)),
            dk=DecryptionKey("Sodium", B32(sk)),
        )
    if isinstance(scheme, PackedPaillierEncryption):
        ppk, psk = paillier.keygen(scheme.min_modulus_bitsize)
        return EncryptionKeypair(
            ek=EncryptionKey("PackedPaillier", Binary(ppk.to_bytes())),
            dk=DecryptionKey("PackedPaillier", Binary(psk.to_bytes())),
        )
    raise ValueError(f"unknown encryption scheme {scheme!r}")
