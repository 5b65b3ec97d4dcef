"""Share-transport encryption: sealed boxes over varint-packed shares.

Reference: client/src/crypto/encryption/{mod,sodium}.rs — shares are
zigzag-varint encoded then sealed to the receiver's Curve25519 key
(anonymous sender). The varint packing is part of the wire format and is
kept bit-compatible (sodium.rs:36-45).

Also implements the reference's *declared-but-disabled* PackedPaillier
scheme (crypto.rs:164-174) for real — additively homomorphic ciphertext
batches that let shares be summed without decryption (``paillier_combine``).

Port of ``sda_tpu/crypto/encryption.py``. The opt-in device premix
(``SDA_PREMIX_DEVICE=1``) folds on ``PREMIX_DEVICE`` through K4
(``crypto/paillier_tpu.py``). Unlike the reference, a device failure
raises: there is no fallback to the host fold.
"""

from __future__ import annotations

import os
from collections import OrderedDict
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
    # default host path folds INCREMENTALLY (O(B) working set); only the
    # opt-in device path batches rows (its users accept the O(P*B) staging
    # in exchange for the kernel fold)
    device = os.environ.get("SDA_PREMIX_DEVICE") == "1"
    count: Optional[int] = None
    batch_len: Optional[int] = None
    total_summands = 0
    rows: list = []
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
        if device:
            rows.append(list(cs))
        elif not acc:
            acc = list(cs)
        else:
            acc = [paillier.add(pk, a, c) for a, c in zip(acc, cs)]
    if device:
        acc = _premix_rows(pk, rows)
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


#: device premix engages only when the fold is big enough to amortize the
#: kernel dispatch (a dispatch rule: smaller folds take the host fold)
_DEVICE_PREMIX_MIN_MODMULS = 64
#: rows per device fold chunk: bounds the [P, B, L] upload block (~23 KB
#: per row at 2048-bit keys) while keeping each dispatch large
_DEVICE_PREMIX_CHUNK_ROWS = 512
#: the device of the premix (``None``: CUDA; ``"cpu"`` runs K4's plain
#: version, as the tests do); ``sdad --device`` sets it
PREMIX_DEVICE = None

#: MontgomeryContext per n^2, tiny LRU: a long-lived broker rotates
#: committee keys — keep only the few most recent instead of growing
#: forever
_MONT_CTX_CACHE: "OrderedDict" = OrderedDict()
_MONT_CTX_CACHE_MAX = 4


def _premix_rows(pk, rows: list) -> list:
    """Fold [P][B] ciphertext ints to [B] products mod n^2 (the device
    leg of paillier_combine: bit-identical to the host paillier.add fold;
    the server's premix hot loop scales with P, reference
    server/src/snapshot.rs:4-47). Rows are chunked
    (_DEVICE_PREMIX_CHUNK_ROWS bounds every upload block) and the chunks'
    products folded again, as a tree. Chunks are not padded: the
    reference pads each to a power of two with ciphertext 1 to bound its
    compiled shapes, and eager torch compiles none (the product is the
    same integer either way). Folds below the size floor take the host
    fold; a device failure raises."""
    if len(rows) <= 1:
        return list(rows[0]) if rows else []
    B = len(rows[0])
    if len(rows) * B >= _DEVICE_PREMIX_MIN_MODMULS:
        return _device_premix_rows(pk, rows)
    acc = list(rows[0])
    for cs in rows[1:]:
        acc = [paillier.add(pk, a, c) for a, c in zip(acc, cs)]
    return acc


def _mont_ctx(modulus):
    from .paillier_tpu import MontgomeryContext

    ctx = _MONT_CTX_CACHE.get(modulus)
    if ctx is None:
        ctx = _MONT_CTX_CACHE[modulus] = MontgomeryContext(modulus)
        while len(_MONT_CTX_CACHE) > _MONT_CTX_CACHE_MAX:
            _MONT_CTX_CACHE.popitem(last=False)
    else:
        _MONT_CTX_CACHE.move_to_end(modulus)
    return ctx


def _device_premix_rows(pk, rows: list) -> list:
    n2 = pk.n_squared
    ctx = _mont_ctx(n2)
    # the host fold reduces every product mod n^2, so a wire value at or
    # above n^2 folds as its residue (K4 takes operands below m)
    rows = [[c if c < n2 else c % n2 for c in row] for row in rows]
    # tree reduction: every level folds chunks of at most
    # _DEVICE_PREMIX_CHUNK_ROWS rows, so no single dispatch (including
    # the reduction over partial products) exceeds the upload bound
    while len(rows) > 1:
        next_rows = []
        for lo in range(0, len(rows), _DEVICE_PREMIX_CHUNK_ROWS):
            chunk = rows[lo:lo + _DEVICE_PREMIX_CHUNK_ROWS]
            if len(chunk) == 1:
                next_rows.append(chunk[0])
                continue
            next_rows.append(ctx.premix(chunk, device=PREMIX_DEVICE))
        rows = next_rows
    return rows[0]


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
