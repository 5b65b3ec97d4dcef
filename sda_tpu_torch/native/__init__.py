"""Native host kernels: build-on-demand C++ shared library via ctypes.

``available()`` gates all use — every caller has a pure-Python/numpy
fallback, so a missing compiler degrades performance, never correctness.
The library links the port's host crypto (``crypto/csrc/sodium.c``) for
the participant core's sealed boxes and random draws, and is compiled once
into ``sda_tpu_torch/_build/`` (``fields/_build.build_host``), keyed on
its sources.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..fields import _build

_SRC = Path(__file__).parent / "src" / "sda_native.cpp"
_ABI_VERSION = 6

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        from ..crypto import sodium

        try:
            lib = ctypes.CDLL(str(_build.build_host(
                "sda_native", (_SRC, *sodium.SOURCES))))
            if lib.sda_native_abi_version() != _ABI_VERSION:
                _build_failed = True
                return None
        except (OSError, RuntimeError):
            _build_failed = True
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.sda_modmatmul_i64.argtypes = [i64p, i64p, i64p] + [ctypes.c_int64] * 4
        lib.sda_modsum_axis0.argtypes = [i64p, i64p] + [ctypes.c_int64] * 3
        lib.sda_chacha_expand_mask.argtypes = [u32p] + [ctypes.c_int64] * 3 + [i64p]
        lib.sda_chacha_expand_mask_r03.argtypes = (
            [u32p] + [ctypes.c_int64] * 3 + [i64p]
        )
        lib.sda_chacha_combine_masks.argtypes = (
            [i64p] + [ctypes.c_int64] * 4 + [i64p, i64p]
        )
        lib.sda_chacha_combine_masks_r03.argtypes = (
            [i64p] + [ctypes.c_int64] * 4 + [i64p, i64p]
        )
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.sda_powmod.argtypes = [
            u64p, u64p, ctypes.c_int64, u64p, ctypes.c_int64, u64p, u64p,
        ]
        lib.sda_powmod_batch.argtypes = [
            u64p, ctypes.c_int64, u64p, ctypes.c_int64, u64p, ctypes.c_int64,
            u64p, u64p,
        ]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.sda_embed_participate.argtypes = [
            i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            u8p, u8p, u8p, ctypes.c_int64, i64p,
        ]
        lib.sda_embed_participate_shamir.argtypes = [
            i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            u8p, u8p, u8p, ctypes.c_int64, i64p,
        ]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def modmatmul(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    """Exact (a @ b) mod p in C++ (128-bit accumulation); p < 2^62."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError("shape mismatch")
    out = np.empty((m, n), dtype=np.int64)
    rc = lib.sda_modmatmul_i64(_i64(a), _i64(b), _i64(out), m, k, n, p)
    if rc:
        raise ValueError("sda_modmatmul_i64 failed")
    return out


def modsum_axis0(x: np.ndarray, m: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    x = np.ascontiguousarray(x, dtype=np.int64)
    rows, n = x.shape
    out = np.empty(n, dtype=np.int64)
    rc = lib.sda_modsum_axis0(_i64(x), _i64(out), rows, n, m)
    if rc:
        raise ValueError("sda_modsum_axis0 failed")
    return out


#: wire PRG tag -> native expand/combine symbol pair, keyed on the spec
#: home's constants so a tag rename cannot drift past this map. ``prg`` is
#: REQUIRED at this layer: a defaulted stream choice here could silently
#: expand the wrong stream for a wire seed — the exact hazard the tag
#: exists to prevent.
from ..fields.chacha import CHACHA_PRG_RAND03, CHACHA_PRG_V1  # noqa: E402

_CHACHA_FNS = {
    CHACHA_PRG_V1: ("sda_chacha_expand_mask", "sda_chacha_combine_masks"),
    CHACHA_PRG_RAND03: ("sda_chacha_expand_mask_r03",
                        "sda_chacha_combine_masks_r03"),
}


def chacha_expand_mask(
    seed: Sequence[int], dim: int, modulus: int, *, prg: str
) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if not 0 < modulus < (1 << 62):  # same validation as the Python spec
        raise ValueError("modulus out of range")
    if prg not in _CHACHA_FNS:
        raise ValueError(f"unknown ChaCha PRG {prg!r}")
    seed_arr = np.asarray(list(seed), dtype=np.uint32)
    out = np.empty(dim, dtype=np.int64)
    rc = getattr(lib, _CHACHA_FNS[prg][0])(
        seed_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        seed_arr.size, dim, modulus, _i64(out),
    )
    if rc:
        raise ValueError(f"{_CHACHA_FNS[prg][0]} failed")
    return out


def chacha_combine_masks(
    seeds: np.ndarray, dim: int, modulus: int, *, prg: str
) -> np.ndarray:
    """Sum of expanded masks for [n_seeds, seed_words] i64 seeds — the
    recipient hot loop in one native call."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if not 0 < modulus < (1 << 62):  # same validation as the Python spec
        raise ValueError("modulus out of range")
    if prg not in _CHACHA_FNS:
        raise ValueError(f"unknown ChaCha PRG {prg!r}")
    seeds = np.ascontiguousarray(seeds, dtype=np.int64)
    n_seeds, seed_words = seeds.shape
    scratch = np.empty(dim, dtype=np.int64)
    out = np.empty(dim, dtype=np.int64)
    rc = getattr(lib, _CHACHA_FNS[prg][1])(
        _i64(seeds), n_seeds, seed_words, dim, modulus, _i64(scratch), _i64(out)
    )
    if rc:
        raise ValueError(f"{_CHACHA_FNS[prg][1]} failed")
    return out


def _u64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _limbs(x: int, count: int) -> np.ndarray:
    return np.frombuffer(x.to_bytes(count * 8, "little"), dtype=np.uint64)


def powmod(base: int, exp: int, mod: int) -> int:
    """``pow(base, exp, mod)`` on the Montgomery C++ ladder — the Paillier
    hot op (~3.5-5x CPython's 30-bit-digit pow at 2048-bit keys). Requires
    an odd modulus; callers fall back to ``pow`` otherwise."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if mod <= 0 or not (mod & 1):
        raise ValueError("modulus must be positive and odd")
    if exp < 0:
        raise ValueError("negative exponents unsupported")
    nl = (mod.bit_length() + 63) // 64
    el = max(1, (exp.bit_length() + 63) // 64)
    scratch = np.zeros(22 * nl + 3, dtype=np.uint64)
    out = np.zeros(nl, dtype=np.uint64)
    rc = lib.sda_powmod(
        _u64(_limbs(base % mod, nl)), _u64(_limbs(exp, el)), el,
        _u64(_limbs(mod, nl)), nl, _u64(scratch), _u64(out),
    )
    if rc:
        raise ValueError("sda_powmod failed")
    return int.from_bytes(out.tobytes(), "little")


_MASKING_KIND = {"none": 0, "full": 1, "chacha": 2, "chacha_rand03": 3}


def embed_participate(
    secret: Sequence[int], modulus: int, share_count: int,
    masking: str = "none", seed_bits: int = 128,
    recipient_pk: bytes = b"", clerk_pks: Sequence[bytes] = (),
    share_matrix=None, secret_count: int = 0,
    mask_modulus: Optional[int] = None,
) -> tuple:
    """The embeddable participant core (C ABI `sda_embed_participate` /
    `sda_embed_participate_shamir`): canonicalize -> mask -> share ->
    varint -> sealed boxes, all in native code. Additive sharing by
    default; pass ``share_matrix`` ([share_count, 1+k+t] canonical
    residues from numtheory.share_matrix_for) + ``secret_count`` for
    packed-Shamir/BasicShamir committees. Returns
    ``(recipient_blob | None, [clerk_blob, ...])`` — raw sealedbox bytes
    wire-compatible with the Python clerks and recipient. Reference
    analog: the declared-but-unreleased /embeddable-client (reference
    README.md:196-204).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if masking not in _MASKING_KIND:
        raise ValueError(f"masking must be one of {sorted(_MASKING_KIND)}")
    if len(clerk_pks) != share_count:
        raise ValueError("need one clerk public key per share")
    if masking != "none" and len(recipient_pk) != 32:
        raise ValueError("recipient_pk must be 32 bytes")
    for pk in clerk_pks:
        if len(pk) != 32:
            raise ValueError("clerk public keys must be 32 bytes")
    arr = np.ascontiguousarray(secret, dtype=np.int64)
    if arr.ndim != 1:
        raise ValueError("secret must be a vector")
    dim = arr.shape[0]
    seal_overhead = 48
    # worst case: 10 varint bytes per value per blob, plus seed words
    cap = (share_count + 1) * (10 * dim + seal_overhead + 128)
    out = np.zeros(cap, dtype=np.uint8)
    lens = np.zeros(1 + share_count, dtype=np.int64)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    rpk = np.frombuffer(
        recipient_pk.ljust(32, b"\0"), dtype=np.uint8).copy()
    cpk = np.frombuffer(b"".join(clerk_pks), dtype=np.uint8).copy()
    if share_matrix is None:
        rc = lib.sda_embed_participate(
            _i64(arr), dim, modulus, share_count,
            _MASKING_KIND[masking], seed_bits,
            rpk.ctypes.data_as(u8), cpk.ctypes.data_as(u8),
            out.ctypes.data_as(u8), cap, _i64(lens),
        )
        what = "sda_embed_participate"
    else:
        mat = np.ascontiguousarray(share_matrix, dtype=np.int64) % modulus
        if mat.ndim != 2 or mat.shape[0] != share_count:
            raise ValueError(
                "share_matrix must be [share_count, 1+k+t]")
        m2 = mat.shape[1]
        if not 1 <= secret_count <= m2 - 1:
            raise ValueError("secret_count inconsistent with share_matrix")
        rc = lib.sda_embed_participate_shamir(
            _i64(arr), dim, modulus,
            mask_modulus if mask_modulus is not None else modulus,
            _i64(mat), share_count, m2, secret_count,
            _MASKING_KIND[masking], seed_bits,
            rpk.ctypes.data_as(u8), cpk.ctypes.data_as(u8),
            out.ctypes.data_as(u8), cap, _i64(lens),
        )
        what = "sda_embed_participate_shamir"
    if rc == 5:
        raise RuntimeError("the system's random source failed")
    if rc:
        raise ValueError(f"{what} failed (rc={rc})")
    blobs, pos = [], 0
    for n in lens.tolist():
        blobs.append(out[pos:pos + n].tobytes())
        pos += n
    recipient_blob = blobs[0] if lens[0] else None
    return recipient_blob, blobs[1:]


def powmod_batch(bases: Sequence[int], exp: int, mod: int) -> List[int]:
    """Many bases against one (exp, mod) in a single native call — the
    Paillier batch-encrypt/decrypt shape."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if mod <= 0 or not (mod & 1):
        raise ValueError("modulus must be positive and odd")
    if exp < 0:
        raise ValueError("negative exponents unsupported")
    nl = (mod.bit_length() + 63) // 64
    el = max(1, (exp.bit_length() + 63) // 64)
    count = len(bases)
    base_arr = np.concatenate(
        [_limbs(b % mod, nl) for b in bases]
    ) if count else np.zeros(0, dtype=np.uint64)
    base_arr = np.ascontiguousarray(base_arr, dtype=np.uint64)
    scratch = np.zeros(22 * nl + 3, dtype=np.uint64)
    outs = np.zeros(count * nl, dtype=np.uint64)
    rc = lib.sda_powmod_batch(
        _u64(base_arr), count, _u64(_limbs(exp, el)), el,
        _u64(_limbs(mod, nl)), nl, _u64(scratch), _u64(outs),
    )
    if rc:
        raise ValueError("sda_powmod_batch failed")
    raw = outs.tobytes()
    step = nl * 8
    return [int.from_bytes(raw[i * step:(i + 1) * step], "little")
            for i in range(count)]
