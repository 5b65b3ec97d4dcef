"""The host-side curve crypto, built from the port's own C sources.

The reference reaches libsodium (C) through the sodiumoxide Rust crate
(client/src/crypto/encryption/sodium.rs, signing/mod.rs); the port carries
the same primitives itself, byte-compatible with libsodium 1.0.18, in
``csrc/sodium.c``: sealed boxes (Curve25519+XSalsa20+Poly1305, anonymous
sender) for share transport, Ed25519 detached signatures for resource
signing. The library is compiled by the host compiler at first use
(``fields/_build.build_host``) and bound with ``ctypes``; no system
libsodium is loaded, so one code path runs on every machine. Curve crypto
stays on the CPU host: only bulk vector algebra goes to the card.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

from ..fields import _build

#: the C sources of the host crypto, for every library that links it
SOURCES = (Path(__file__).resolve().parent / "csrc" / "sodium.c",)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class SodiumUnavailable(RuntimeError):
    pass


def _bind(lib: ctypes.CDLL) -> None:
    p, u64 = ctypes.c_char_p, ctypes.c_uint64
    for name, args in (
        ("sda_box_public", [p, p]),
        ("sda_box_keypair", [p, p]),
        ("sda_box_seal", [p, p, u64, p]),
        ("sda_box_seal_with_ephemeral", [p, p, u64, p, p]),
        ("sda_box_seal_open", [p, p, u64, p, p]),
        ("sda_sign_seed_keypair", [p, p, p]),
        ("sda_sign_keypair", [p, p]),
        ("sda_sign_detached", [p, p, u64, p]),
        ("sda_sign_verify_detached", [p, p, u64, p]),
    ):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int


def _load() -> ctypes.CDLL:
    """The host crypto library, compiled on first use; raises
    SodiumUnavailable with the compiler's output when it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                path = _build.build_host("sda_hostcrypto", SOURCES)
            except RuntimeError as e:
                raise SodiumUnavailable(str(e)) from e
            lib = ctypes.CDLL(str(path))
            _bind(lib)
            _lib = lib
    return _lib


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
SIGN_SEED = 32
SIGN_BYTES = 64


def _check_len(name: str, value: bytes, size: int) -> None:
    if len(value) != size:
        raise ValueError(f"{name} must be {size} bytes, got {len(value)}")


def box_keypair() -> Tuple[bytes, bytes]:
    """Curve25519 (pk, sk) for sealed boxes (sodium.rs:95-109 keygen)."""
    lib = _load()
    pk = ctypes.create_string_buffer(BOX_PK)
    sk = ctypes.create_string_buffer(BOX_SK)
    if lib.sda_box_keypair(pk, sk) != 0:
        raise RuntimeError("box keypair generation failed")
    return pk.raw, sk.raw


def box_public(sk: bytes) -> bytes:
    """The Curve25519 public key of ``sk`` (crypto_scalarmult_base)."""
    _check_len("sk", sk, BOX_SK)
    pk = ctypes.create_string_buffer(BOX_PK)
    if _load().sda_box_public(pk, sk) != 0:
        raise ValueError("secret key gives the all-zero public key")
    return pk.raw


def seal(message: bytes, pk: bytes) -> bytes:
    """Anonymous-sender sealed box (sodium.rs:42-45 encrypt path)."""
    _check_len("pk", pk, BOX_PK)
    lib = _load()
    out = ctypes.create_string_buffer(len(message) + SEAL_OVERHEAD)
    if lib.sda_box_seal(out, message, len(message), pk) != 0:
        raise RuntimeError("sealing failed (small-order public key?)")
    return out.raw


def seal_with_ephemeral(message: bytes, pk: bytes, esk: bytes) -> bytes:
    """``seal`` with the ephemeral secret key given instead of drawn: the
    deterministic form the known-answer checks use."""
    _check_len("pk", pk, BOX_PK)
    _check_len("esk", esk, BOX_SK)
    out = ctypes.create_string_buffer(len(message) + SEAL_OVERHEAD)
    if _load().sda_box_seal_with_ephemeral(
            out, message, len(message), pk, esk) != 0:
        raise RuntimeError("sealing failed (small-order public key?)")
    return out.raw


def seal_open(ciphertext: bytes, pk: bytes, sk: bytes) -> bytes:
    """Open a sealed box; raises ValueError on authentication failure
    (sodium.rs:78-82 decrypt path)."""
    _check_len("pk", pk, BOX_PK)
    _check_len("sk", sk, BOX_SK)
    lib = _load()
    if len(ciphertext) < SEAL_OVERHEAD:
        raise ValueError("ciphertext shorter than sealed-box overhead")
    out = ctypes.create_string_buffer(len(ciphertext) - SEAL_OVERHEAD)
    if lib.sda_box_seal_open(out, ciphertext, len(ciphertext), pk, sk) != 0:
        raise ValueError("sealed box decryption failure")
    return out.raw


def sign_keypair() -> Tuple[bytes, bytes]:
    """Ed25519 (vk 32B, sk 64B) (signing/mod.rs:28-41 keygen)."""
    lib = _load()
    pk = ctypes.create_string_buffer(SIGN_PK)
    sk = ctypes.create_string_buffer(SIGN_SK)
    if lib.sda_sign_keypair(pk, sk) != 0:
        raise RuntimeError("signing keypair generation failed")
    return pk.raw, sk.raw


def sign_seed_keypair(seed: bytes) -> Tuple[bytes, bytes]:
    """The Ed25519 keypair of a 32-byte seed (crypto_sign_seed_keypair);
    the secret key is ``seed || vk``."""
    _check_len("seed", seed, SIGN_SEED)
    pk = ctypes.create_string_buffer(SIGN_PK)
    sk = ctypes.create_string_buffer(SIGN_SK)
    _load().sda_sign_seed_keypair(pk, sk, seed)
    return pk.raw, sk.raw


def sign_detached(message: bytes, sk: bytes) -> bytes:
    """Detached Ed25519 signature (signing/mod.rs:95-99)."""
    _check_len("sk", sk, SIGN_SK)
    lib = _load()
    sig = ctypes.create_string_buffer(SIGN_BYTES)
    lib.sda_sign_detached(sig, message, len(message), sk)
    return sig.raw


def verify_detached(sig: bytes, message: bytes, pk: bytes) -> bool:
    """True iff the detached signature verifies (signing/mod.rs:119-130),
    under libsodium's rules: a canonical S, R and the key not of small
    order, a canonical key."""
    if len(sig) != SIGN_BYTES or len(pk) != SIGN_PK:
        return False
    lib = _load()
    return lib.sda_sign_verify_detached(sig, message, len(message), pk) == 0
