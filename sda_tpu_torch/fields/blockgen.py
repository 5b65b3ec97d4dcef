"""The device block provider's coordinate hash (K6) — port of the jitted
``gen`` of ``sda_tpu/mesh/streaming.py::synthetic_device_block_provider32``.

Streamed and model-scale rounds read their inputs from a virtual [P, d]
matrix whose element (i, j) is a uint32 hash of its absolute coordinates,
reduced mod a bound. The JAX package compiles that hash under ``jax.jit``
into one fused pass a block; here it is a hand-written CUDA kernel for
Hopper (``csrc/blockgen.cu``, built by ``_build``). This module holds

- ``coordinate_block``: the kernel's wrapper. For a CUDA device it
  launches the kernel on the current stream (a build or launch failure
  raises); for the CPU it runs the plain version. It counts its launches
  in ``coordinate_block.launches``;
- ``launch_args``: what the host hands the kernel (the coordinates and
  the seed word mod 2^32, the bound and its remainder multiplier);
- ``block_plain``: the same block in int64 torch, each 32-bit product
  split into 16-bit halves (``hash32_plain``), the kernel's yardstick.
"""

from __future__ import annotations

import ctypes
import functools

from .._lazy import torch

from . import _build
from ..device import resolve_device

_MASK32 = 0xFFFFFFFF
_U64_MAX = (1 << 64) - 1
#: the reference's seed whitening: the hash's seed word is (seed ^ it)
SEED_XOR = 0x5851F42D


def seed_word(seed: int) -> int:
    """The hash's seed word of a provider seed."""
    return (int(seed) ^ SEED_XOR) & _MASK32


def check_bound(bound: int) -> int:
    """``bound`` as an int; raises ValueError unless 0 < bound < 2^32."""
    bound = int(bound)
    if not 0 < bound <= _MASK32:
        raise ValueError("synthetic32 values must fit uint32")
    return bound


def fastmod_multiplier(bound: int) -> int:
    """M = floor((2^64 - 1) / bound) + 1 mod 2^64: with it the kernel takes
    x mod bound as the high 64 bits of ((M * x mod 2^64) * bound), exact for
    every x < 2^32 (Lemire, Kaser, Kurz 2019); bound = 1 wraps M to 0."""
    return (_U64_MAX // check_bound(bound) + 1) & _U64_MAX


def launch_args(p0: int, d0: int, seed: int, bound: int):
    """The kernel's scalars for a block at (p0, d0): (p0 mod 2^32, d0 mod
    2^32, the seed word, bound, its multiplier)."""
    return (int(p0) & _MASK32, int(d0) & _MASK32, seed_word(seed),
            check_bound(bound), fastmod_multiplier(bound))


# ---------------------------------------------------------------------------
# Plain version (int64 torch, any device)

def _mul32(x, c: int):
    """x * c mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32,
    split into 16-bit halves of c so no product reaches 2^63."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def hash32_plain(rows, cols, seed_word_: int):
    """``mesh/streaming.py::_hash32`` on int64 tensors holding uint32
    values."""
    x = _mul32(rows, 0x9E3779B1) ^ _mul32(cols, 0x85EBCA77) ^ seed_word_
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def block_plain(p0: int, p1: int, d0: int, d1: int, seed: int, bound: int,
                device):
    """[p1 - p0, d1 - d0] int64 block of the coordinate hash mod ``bound``
    on ``device``, coordinates wrapping mod 2^32."""
    bound = check_bound(bound)
    dev = torch.device(device)
    rows = (p0 + torch.arange(p1 - p0, dtype=torch.int64,
                              device=dev))[:, None] & _MASK32
    cols = (d0 + torch.arange(d1 - d0, dtype=torch.int64,
                              device=dev))[None, :] & _MASK32
    return torch.remainder(hash32_plain(rows, cols, seed_word(seed)), bound)


# ---------------------------------------------------------------------------
# K6: kernel wrapper

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built ``csrc/blockgen.cu`` with its C interface declared."""
    lib = _build.load("blockgen")
    u32, i64 = ctypes.c_uint32, ctypes.c_longlong
    lib.sda_blockgen.argtypes = [u32, u32, i64, i64, u32, u32,
                                 ctypes.c_ulonglong, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.sda_blockgen.restype = ctypes.c_int
    return lib


def coordinate_block(p0: int, p1: int, d0: int, d1: int, seed: int,
                     bound: int, device=None):
    """One K6 call: the [p1 - p0, d1 - d0] int64 block of the provider of
    ``seed`` and ``bound`` at (p0, d0), contiguous, on ``device`` (CUDA
    unless ``device="cpu"``). A CUDA device launches the kernel on the
    current stream (a launch error raises); the CPU runs the plain
    version."""
    dev = resolve_device(device)
    rows, cols = int(p1) - int(p0), int(d1) - int(d0)
    if rows < 0 or cols < 0:
        raise ValueError(f"reversed block [{p0}, {p1}) x [{d0}, {d1})")
    if dev.type == "cpu":
        return block_plain(p0, p1, d0, d1, seed, bound, dev)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    args = launch_args(p0, d0, seed, bound)
    out = torch.empty((rows, cols), dtype=torch.int64, device=dev)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sda_blockgen(args[0], args[1], rows, cols, *args[2:],
                               out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K6 kernel launch failed: CUDA error {err}")
    coordinate_block.launches += 1
    return out


coordinate_block.launches = 0
