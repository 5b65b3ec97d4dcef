"""ctypes bindings to libsodium — the host-side curve crypto.

The reference reaches libsodium (C) through the sodiumoxide Rust crate
(client/src/crypto/encryption/sodium.rs, signing/mod.rs); here we bind the
same primitives directly: sealed boxes (Curve25519+XSalsa20+Poly1305,
anonymous sender) for share transport, Ed25519 detached signatures for
resource signing. Curve crypto stays on the CPU host — only bulk vector
algebra goes to the TPU.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

_SONAMES = ["libsodium.so.23", "libsodium.so", "libsodium.so.26", "libsodium.so.18"]

_lib: Optional[ctypes.CDLL] = None


class SodiumUnavailable(RuntimeError):
    pass


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    last = None
    names = list(_SONAMES)
    found = ctypes.util.find_library("sodium")
    if found:
        names.insert(0, found)
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError as e:
            last = e
    else:
        raise SodiumUnavailable(f"libsodium not found: {last}")
    if lib.sodium_init() < 0:
        raise SodiumUnavailable("sodium_init failed")
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except SodiumUnavailable:
        return False


SEAL_OVERHEAD = 48  # crypto_box_SEALBYTES: 32 ephemeral pk + 16 MAC
BOX_PK = 32
BOX_SK = 32
SIGN_PK = 32
SIGN_SK = 64
SIGN_BYTES = 64


def box_keypair() -> Tuple[bytes, bytes]:
    """Curve25519 (pk, sk) for sealed boxes (sodium.rs:95-109 keygen)."""
    lib = _load()
    pk = ctypes.create_string_buffer(BOX_PK)
    sk = ctypes.create_string_buffer(BOX_SK)
    if lib.crypto_box_keypair(pk, sk) != 0:
        raise RuntimeError("crypto_box_keypair failed")
    return pk.raw, sk.raw


def seal(message: bytes, pk: bytes) -> bytes:
    """Anonymous-sender sealed box (sodium.rs:42-45 encrypt path)."""
    lib = _load()
    out = ctypes.create_string_buffer(len(message) + SEAL_OVERHEAD)
    if lib.crypto_box_seal(out, message, ctypes.c_ulonglong(len(message)), pk) != 0:
        raise RuntimeError("crypto_box_seal failed")
    return out.raw


def seal_open(ciphertext: bytes, pk: bytes, sk: bytes) -> bytes:
    """Open a sealed box; raises ValueError on authentication failure
    (sodium.rs:78-82 decrypt path)."""
    lib = _load()
    if len(ciphertext) < SEAL_OVERHEAD:
        raise ValueError("ciphertext shorter than sealed-box overhead")
    out = ctypes.create_string_buffer(len(ciphertext) - SEAL_OVERHEAD)
    rc = lib.crypto_box_seal_open(
        out, ciphertext, ctypes.c_ulonglong(len(ciphertext)), pk, sk
    )
    if rc != 0:
        raise ValueError("sealed box decryption failure")
    return out.raw


def sign_keypair() -> Tuple[bytes, bytes]:
    """Ed25519 (vk 32B, sk 64B) (signing/mod.rs:28-41 keygen)."""
    lib = _load()
    pk = ctypes.create_string_buffer(SIGN_PK)
    sk = ctypes.create_string_buffer(SIGN_SK)
    if lib.crypto_sign_keypair(pk, sk) != 0:
        raise RuntimeError("crypto_sign_keypair failed")
    return pk.raw, sk.raw


def sign_detached(message: bytes, sk: bytes) -> bytes:
    """Detached Ed25519 signature (signing/mod.rs:95-99)."""
    lib = _load()
    sig = ctypes.create_string_buffer(SIGN_BYTES)
    siglen = ctypes.c_ulonglong(0)
    if lib.crypto_sign_detached(
        sig, ctypes.byref(siglen), message, ctypes.c_ulonglong(len(message)), sk
    ) != 0:
        raise RuntimeError("crypto_sign_detached failed")
    return sig.raw


def verify_detached(sig: bytes, message: bytes, pk: bytes) -> bool:
    """True iff the detached signature verifies (signing/mod.rs:119-130)."""
    lib = _load()
    rc = lib.crypto_sign_verify_detached(
        sig, message, ctypes.c_ulonglong(len(message)), pk
    )
    return rc == 0
