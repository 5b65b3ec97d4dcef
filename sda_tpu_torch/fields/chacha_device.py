"""ChaCha20 seed masks on the device (K3) — port of
``sda_tpu/fields/chacha_jax.py``.

The recipient's hot loop re-expands every participant's ChaCha seed into
its mask and sums them: O(participants x dimension) keystream work
(client/src/receive.rs:102-118 in the reference). The JAX package runs it
as jnp lanes on its accelerator; here it is a hand-written CUDA kernel for
Hopper (``csrc/chacha.cu``, built by ``_build``). This module holds

- the four entry points of the JAX module, with its arguments and checks:
  ``chacha_block_words``, ``expand_mask``, ``combine_masks`` and
  ``stream_residues_at`` (``stream_u64_at`` with the reduction mod m of
  ``FieldOps.from_u64`` fused in: torch has no uint64 arithmetic, so the
  window comes back as canonical int64 residues);
- ``mask_residues_at``: the ChaCha branch of the JAX package's
  ``mesh/simpod.py::_mask_stage`` (``stream_u64_at`` -> ``from_u64`` ->
  ``add`` and ``sum``, one fused XLA pass there) as one fused kernel pass:
  the masked rows and the mask sum, with no [S, d] mask tensor;
- ``mask_residues_derived``: the same op with the seeds' keys derived in
  the kernel from the round seed and the participants' global ids (the
  reference's ``_chacha_seed_words`` inside its jitted step), so a step
  passes no [S, 8] seed tensor, the sum optionally added in place into the
  caller's accumulator (the streamed step's donated ``acc_mask``);
  ``chacha_seed_words`` is that derivation in int64 torch, the derived
  mode's plain version;
- ``chacha_kernel``: the wrapper of the C entries. For a CUDA tensor it
  launches the kernel on the current stream (and raises on a launch
  error); for a CPU tensor it runs the plain version. It counts its
  launches in ``chacha_kernel.launches``, by operation in
  ``chacha_kernel.op_launches``, and the seeds ``combine_masks`` replayed
  on the host in ``chacha_kernel.replayed``;
- the plain versions (``*_plain``): the same functions in int64 torch,
  32-bit wraparound by masking, each u64 draw held as two 32-bit halves.

Bit-exactness with the host spec (``fields.chacha``) includes its
rejection sampling: a draw above the acceptance zone is redrawn there,
which shifts every later output. The kernel reduces without rejection and
flags each seed whose first ``dimension`` draws met one (probability below
m / 2^64 a draw); the host replays exactly those seeds, as the JAX module
does. Outputs equal ``chacha.expand_mask_for`` in every case.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
from .._lazy import torch

from . import _build, chacha
from .modular import modsum
from ..device import resolve_device

_MASK32 = 0xFFFFFFFF
_U64_MAX = (1 << 64) - 1
#: Philox counter word separating the ChaCha-seed stream (``kSeedTag`` in
#: ``csrc/chacha.cu``)
SEED_TAG = 0x5EED
_CONSTANTS = tuple(int(c) for c in chacha._CONSTANTS)
#: blocks the plain version expands at once (its working set is ~40
#: int64 words a block)
_PLAIN_BLOCKS = 1 << 20
OPS = ("blocks", "expand", "combine", "mask")
#: the C entries' codes of the operations that chunk their seeds
#: (``sda_chacha_chunks``): the mask op's by its output width
_CHUNK_OPS = {"expand": 0, "combine": 1, "mask32": 2, "mask64": 3}


def _check_modulus(modulus: int) -> None:
    if modulus <= 0 or modulus >= (1 << 62):
        raise ValueError("modulus out of range")


def _check_prg(prg: str) -> None:
    if prg not in chacha._EXPANDERS:
        raise ValueError(f"unknown ChaCha PRG {prg!r}")


def _zone(prg: str, modulus: int) -> int:
    """The largest u64 draw the host spec accepts under ``prg``: V1's zone
    is floor(2^64/m)*m - 1 inclusive, rand 0.3's u64::MAX - u64::MAX % m
    exclusive."""
    if prg == chacha.CHACHA_PRG_RAND03:
        return _U64_MAX - _U64_MAX % modulus - 1
    return ((1 << 64) // modulus) * modulus - 1


def _hi_first(prg: str) -> bool:
    """rand 0.3 reads a block's first word of a pair as the HIGH half."""
    return prg == chacha.CHACHA_PRG_RAND03


# ---------------------------------------------------------------------------
# Plain versions (int64 torch, any device)

def _add32(a, b):
    return (a + b) & _MASK32


def _rotl32(x, n: int):
    return ((x << n) | (x >> (32 - n))) & _MASK32


def _quarter(s, a, b, c, d):
    s[a] = _add32(s[a], s[b])
    s[d] = _rotl32(s[d] ^ s[a], 16)
    s[c] = _add32(s[c], s[d])
    s[b] = _rotl32(s[b] ^ s[c], 12)
    s[a] = _add32(s[a], s[b])
    s[d] = _rotl32(s[d] ^ s[a], 8)
    s[c] = _add32(s[c], s[d])
    s[b] = _rotl32(s[b] ^ s[c], 7)


def block_words_plain(seed_words, counter0: int, nblocks: int):
    """[S, 8] key words (int64 in [0, 2^32)) -> [S, nblocks, 16] int64
    keystream words of block counters counter0, ... (mod 2^32)."""
    S = seed_words.shape[0]
    dev = seed_words.device
    counters = (int(counter0) + torch.arange(
        nblocks, dtype=torch.int64, device=dev)) & _MASK32
    shape = (S, nblocks)
    init = ([torch.full(shape, c, dtype=torch.int64, device=dev)
             for c in _CONSTANTS]
            + [seed_words[:, j:j + 1].expand(shape) for j in range(8)]
            + [counters[None, :].expand(shape)]
            + [torch.zeros(shape, dtype=torch.int64, device=dev)] * 3)
    state = list(init)
    for _ in range(10):
        _quarter(state, 0, 4, 8, 12)
        _quarter(state, 1, 5, 9, 13)
        _quarter(state, 2, 6, 10, 14)
        _quarter(state, 3, 7, 11, 15)
        _quarter(state, 0, 5, 10, 15)
        _quarter(state, 1, 6, 11, 12)
        _quarter(state, 2, 7, 8, 13)
        _quarter(state, 3, 4, 9, 14)
    return torch.stack([_add32(s, i) for s, i in zip(state, init)], dim=-1)


def u64_mod(hi, lo, modulus: int):
    """(hi * 2^32 + lo) mod m for int64 halves in [0, 2^32) and m < 2^62,
    exact: hi is shifted in by steps of at most 63 - bitlen(m) bits, so no
    intermediate reaches 2^63."""
    step = 63 - int(modulus).bit_length()
    r = torch.remainder(hi, modulus)
    left = 32
    while left:
        k = min(step, left)
        r = torch.remainder(r << k, modulus)
        left -= k
    return torch.remainder(r + lo, modulus)


def _draws_plain(seed_words, counter0: int, dimension: int, modulus: int,
                 hi_first: bool, zone=None):
    """([S, dimension] residues, [S] rejected or None) of S streams from
    block counter0, in chunks of seeds that bound the working set."""
    S = seed_words.shape[0]
    nblocks = -(-dimension // 8)
    per = max(1, _PLAIN_BLOCKS // max(1, nblocks))
    out, flags = [], []
    for s0 in range(0, S, per):
        words = block_words_plain(seed_words[s0:s0 + per], counter0, nblocks)
        words = words.reshape(words.shape[0], -1)
        a, b = words[:, 0::2][:, :dimension], words[:, 1::2][:, :dimension]
        hi, lo = (a, b) if hi_first else (b, a)
        out.append(u64_mod(hi, lo, modulus))
        if zone is not None:
            zhi, zlo = zone >> 32, zone & _MASK32
            above = (hi > zhi) | ((hi == zhi) & (lo > zlo))
            flags.append(above.any(dim=1))
    masks = torch.cat(out) if out else seed_words.new_zeros((0, dimension))
    if zone is None:
        return masks, None
    return masks, (torch.cat(flags) if flags else
                   torch.zeros(0, dtype=torch.bool, device=seed_words.device))


def expand_plain(seed_words, counter0: int, dimension: int, modulus: int,
                 prg: str):
    """The kernel's ``expand`` in plain torch: ([S, dimension] int64
    residues without rejection, [S] bool rejected)."""
    return _draws_plain(seed_words, counter0, dimension, modulus,
                        _hi_first(prg), _zone(prg, modulus))


def chacha_seed_words(round_seed: int, global_ids, seed_bitsize: int):
    """[S] global participant ids -> [S, 8] int64 seed words in [0, 2^32):
    the derived mode's keys in plain torch (port of the JAX package's
    ``mesh/simpod.py::_chacha_seed_words``, in Philox form).

    Seed i's words are Philox4x32-10 of counter (id mod 2^32, id >> 32,
    ``SEED_TAG``, pair) under key (round_seed mod 2^32, round_seed >> 32
    mod 2^32), words 0-3 from pair 0 and 4-7 from pair 1. The seed depends
    only on (round seed, participant id): every dim tile of one
    participant derives the SAME seed and expands disjoint windows of one
    stream, which is the whole point of seed-compressed masks. Words from
    ceil(seed_bitsize/32) on are zero, matching the host spec's
    zero-padded ChaCha key (fields/chacha.py).
    """
    from .fused_round import philox4x32_10

    words = (int(seed_bitsize) + 31) // 32
    if words > 8:
        raise ValueError("seed_bitsize > 256 unsupported")
    ids = torch.as_tensor(global_ids, dtype=torch.int64)
    key0, key1 = round_seed & _MASK32, (round_seed >> 32) & _MASK32
    tag = torch.full_like(ids, SEED_TAG)
    out = []
    for pair in range(2):
        out += philox4x32_10(ids & _MASK32, ids >> 32, tag,
                             torch.full_like(ids, pair), key0, key1)
    seeds = torch.stack(out, dim=1)
    seeds[:, words:] = 0
    return seeds


def mask_plain(seed_words, counter0: int, x, modulus: int, out_dtype,
               acc=None):
    """The kernel's ``mask`` in plain torch: ([S, d] ``(x + w) mod m`` as
    ``out_dtype``, [d] int64 ``sum_s w mod m``) for any int64 ``x`` (its
    floor mod m taken first, the round's residue pass) and ``w`` the
    CHACHA_PRG_V1 windows of the S seeds from block ``counter0``:
    ``torch.remainder`` -> ``expand_plain`` -> mod add -> mod sum. With
    ``acc`` ([d] int64 canonical residues) the sum is added mod m into it
    in place, and ``acc`` comes back as the second result."""
    masks, _ = _draws_plain(seed_words, counter0, x.shape[1], modulus, False)
    masked = torch.remainder(x, modulus) + masks
    masked = torch.where(masked >= modulus, masked - modulus, masked)
    total = modsum(masks, modulus, axis=0)
    if acc is not None:
        total = torch.remainder(acc.add_(total), modulus, out=acc)
    return masked.to(out_dtype), total


def combine_plain(seed_words, dimension: int, modulus: int, prg: str):
    """The kernel's ``combine`` in plain torch: ([dimension] int64 sum mod
    m of the S masks without rejection, [S] bool rejected)."""
    dev = seed_words.device
    total = torch.zeros(dimension, dtype=torch.int64, device=dev)
    flags = []
    nblocks = max(1, -(-dimension // 8))
    per = max(1, _PLAIN_BLOCKS // nblocks)
    for s0 in range(0, seed_words.shape[0], per):
        masks, rej = expand_plain(seed_words[s0:s0 + per], 0, dimension,
                                  modulus, prg)
        total = modsum(torch.cat([total[None], masks]), modulus, axis=0)
        flags.append(rej)
    return total, (torch.cat(flags) if flags else
                   torch.zeros(0, dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# K3: kernel wrapper

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built ``csrc/chacha.cu`` with its C interface declared (ctypes
    would otherwise pass pointers as 32-bit ints)."""
    lib = _build.load("chacha")
    ptr, i64, i32, u32, u64 = (ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_uint32,
                               ctypes.c_ulonglong)
    lib.sda_chacha_blocks.argtypes = [ptr, u32, i64, ptr, ptr]
    lib.sda_chacha_expand.argtypes = [ptr, i32, u32, i64, u64, u64, u64, i32,
                                      ptr, ptr, ptr]
    lib.sda_chacha_combine.argtypes = [ptr, i32, i64, u64, u64, u64, i32, ptr,
                                       ptr, i32, ptr, ptr]
    lib.sda_chacha_mask.argtypes = [ptr, i32, u32, i64, u64, u64, ptr, i64,
                                    i32, ptr, ptr, i32, ptr, ptr]
    lib.sda_chacha_mask_into.argtypes = [ptr, ptr, u64, i32, i32, u32, i64,
                                         u64, u64, ptr, i64, i32, ptr, ptr,
                                         i32, i32, ptr, ptr]
    lib.sda_chacha_chunks.argtypes = [i32, i32, i64, u64, ptr]
    for fn in (lib.sda_chacha_blocks, lib.sda_chacha_expand,
               lib.sda_chacha_combine, lib.sda_chacha_mask,
               lib.sda_chacha_mask_into, lib.sda_chacha_chunks):
        fn.restype = ctypes.c_int
    return lib


def _chunks(lib, op: str, S: int, d: int, modulus: int) -> int:
    """The chunks of seeds the kernel splits ``op`` into on the current
    device (``sda_chacha_chunks``: enough to fill the card a few waves
    over); their partial sums need a [chunks - 1, d] int64 scratch."""
    out = ctypes.c_int()
    err = lib.sda_chacha_chunks(_CHUNK_OPS[op], S, d, modulus,
                                ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"K3 {op} plan failed: CUDA error {err}")
    return out.value


def _scratch(chunks: int, d: int, dev):
    """[chunks - 1, d] int64 partial sums, or None for one chunk."""
    if chunks < 2:
        return None
    return torch.empty((chunks - 1, d), dtype=torch.int64, device=dev)


def _ptr(t):
    """A tensor's address for ctypes, or None (a null pointer)."""
    return None if t is None else t.data_ptr()


def _u32_storage(words):
    """int64 words in [0, 2^32) -> contiguous int32 tensor of the same
    bits, the kernel's uint32 input (a fresh allocation: 16-byte aligned,
    as the kernels' key loads need)."""
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32).contiguous()


def _check_seed_words(seed_words):
    if seed_words.dim() != 2 or seed_words.shape[1] != 8:
        raise ValueError(
            f"seed words must be [S, 8], got {tuple(seed_words.shape)}")
    if seed_words.shape[0] >= 1 << 31:
        raise ValueError("too many seeds for one launch")


def check_accumulator(acc, shape, device, what: str) -> None:
    """An accumulator a kernel adds into in place: a contiguous int64
    tensor of ``shape`` on ``device``; anything else raises (it is never
    copied, which would lose the sum)."""
    if not isinstance(acc, torch.Tensor):
        raise TypeError(f"{what} must be a tensor, got {type(acc).__name__}")
    if acc.dtype != torch.int64 or acc.device != device:
        raise ValueError(f"{what} must be int64 on {device}, got {acc.dtype}"
                         f" on {acc.device}")
    if tuple(acc.shape) != tuple(shape):
        raise ValueError(f"{what} must be {list(shape)}, got "
                         f"{list(acc.shape)}")
    if not acc.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_mask_args(S: int, dev, x, modulus: int, prg: str, out_dtype,
                     acc):
    if x is None:
        raise ValueError("the mask op needs x")
    if x.dim() != 2 or x.shape[0] != S:
        raise ValueError(f"x must be [S, d] with S = {S}, "
                         f"got {tuple(x.shape)}")
    if x.dtype != torch.int64:
        raise ValueError(f"x must be int64, got {x.dtype}")
    if x.device != dev:
        raise ValueError(f"x on {x.device}, seeds on {dev}")
    if x.shape[1] % 8:
        raise ValueError(
            "dimension must be a multiple of 8 (one ChaCha block)")
    if out_dtype not in (torch.int32, torch.int64):
        raise ValueError(f"out_dtype must be int32 or int64, got {out_dtype}")
    if out_dtype == torch.int32 and modulus >= 1 << 31:
        raise ValueError("int32 out needs a modulus below 2^31")
    if prg != chacha.CHACHA_PRG_V1:
        raise ValueError("the mask op takes the CHACHA_PRG_V1 window")
    if acc is not None:
        check_accumulator(acc, (x.shape[1],), dev, "acc_mask")


def _check_derive(derive, x):
    """(round seed, first global id, seed bits) of the derived mode."""
    round_seed, pid_base, bits = (int(v) for v in derive)
    if not 0 <= round_seed < 1 << 64:
        raise ValueError(f"round seed {round_seed} outside [0, 2^64)")
    if not 0 < bits <= 256:
        raise ValueError(f"seed_bitsize {bits} outside (0, 256]")
    S = 0 if x is None else x.shape[0]
    if pid_base < 0 or pid_base + S > (1 << 63) - 1:
        raise ValueError(f"participant ids {pid_base}.. outside int64")
    return round_seed, pid_base, bits


def chacha_kernel(op: str, seed_words, *, counter0: int = 0,
                  dimension: int = 0, nblocks: int = 0, modulus: int = 1,
                  prg: str = chacha.CHACHA_PRG_V1, flags: bool = True,
                  x=None, out_dtype=None, derive=None, acc=None):
    """One K3 call on ``seed_words`` ([S, 8] int64 words in [0, 2^32); for
    ``blocks``, S = 1) on their device:

    - ``blocks``: [nblocks, 16] int64 keystream words from ``counter0``;
    - ``expand``: ([S, dimension] int64 residues mod ``modulus`` of the
      ``prg`` streams from block ``counter0``, [S] bool rejected, or None
      without ``flags``);
    - ``combine``: ([dimension] sum mod ``modulus`` of the S masks from
      block 0, [S] bool rejected);
    - ``mask``: for ``x`` [S, d] int64, any values (the kernel takes
      their floor mod ``modulus``; d a multiple of 8), ([S, d] ``(x + w)
      mod m`` as ``out_dtype``, int32 only for m < 2^31, or int64 (None);
      [d] int64 ``sum_s w mod m``), w the CHACHA_PRG_V1 windows from block
      ``counter0`` without rejection. ``derive``: (round seed, first
      global id, seed bits) in place of ``seed_words`` (None): the keys of
      ``chacha_seed_words`` for ids first .. first + S - 1, which the
      kernel derives itself. ``acc`` (derived mode only): a contiguous [d]
      int64 accumulator of canonical residues the sum is added into mod m,
      in place; it comes back as the second result.

    A CUDA tensor launches the kernel (a launch error raises); a CPU tensor
    runs the plain version.
    """
    if derive is not None:
        if op != "mask" or seed_words is not None:
            raise ValueError("derived seeds are the mask op's, in place of "
                             "seed words")
        derive = _check_derive(derive, x)
        if x is None:
            raise ValueError("the mask op needs x")
        S, dev = x.shape[0], x.device
    else:
        _check_seed_words(seed_words)
        seed_words = seed_words.to(torch.int64) & _MASK32
        S, dev = seed_words.shape[0], seed_words.device
    counter0 = int(counter0) & _MASK32
    if op not in OPS:
        raise ValueError(f"unknown K3 operation {op!r}")
    if op != "blocks":
        _check_modulus(modulus)
        _check_prg(prg)
    if acc is not None and derive is None:
        raise ValueError("only the derived mask mode accumulates")
    if op == "mask":
        out_dtype = torch.int64 if out_dtype is None else out_dtype
        _check_mask_args(S, dev, x, modulus, prg, out_dtype, acc)
    if dev.type == "cpu":
        if derive is not None:
            round_seed, pid_base, bits = derive
            seed_words = chacha_seed_words(
                round_seed, pid_base + torch.arange(S, dtype=torch.int64),
                bits)
        if op == "blocks":
            return block_words_plain(seed_words[:1], counter0, nblocks)[0]
        if op == "expand":
            masks, rej = expand_plain(seed_words, counter0, dimension,
                                      modulus, prg)
            return masks, (rej if flags else None)
        if op == "mask":
            return mask_plain(seed_words, counter0, x, modulus, out_dtype,
                              acc)
        return combine_plain(seed_words, dimension, modulus, prg)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    keys = None if derive is not None else _u32_storage(seed_words)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if op == "blocks":
            if S != 1:
                raise ValueError("blocks takes one key")
            host_key = (ctypes.c_uint32 * 8)(
                *[int(w) for w in seed_words[0].tolist()])
            out = torch.empty((nblocks, 16), dtype=torch.int32, device=dev)
            err = lib.sda_chacha_blocks(ctypes.cast(host_key, ctypes.c_void_p),
                                        counter0, nblocks,
                                        out.data_ptr(), stream)
            result = out.to(torch.int64) & _MASK32
        elif op == "mask":
            err, result = _launch_mask(lib, keys, derive, S, counter0, x,
                                       modulus, out_dtype, acc, dev, stream)
        else:
            mu, zone = _U64_MAX // modulus, _zone(prg, modulus)
            rej = torch.zeros(S, dtype=torch.int32, device=dev)
            if op == "expand":
                out = torch.empty((S, dimension), dtype=torch.int64,
                                  device=dev)
                err = lib.sda_chacha_expand(
                    keys.data_ptr(), S, counter0, dimension, modulus, mu,
                    zone, int(_hi_first(prg)), out.data_ptr(),
                    rej.data_ptr() if flags else None, stream)
            else:
                out = torch.empty(dimension, dtype=torch.int64, device=dev)
                chunks = _chunks(lib, op, S, dimension, modulus)
                partials = _scratch(chunks, dimension, dev)
                err = lib.sda_chacha_combine(
                    keys.data_ptr(), S, dimension, modulus, mu, zone,
                    int(_hi_first(prg)), out.data_ptr(), rej.data_ptr(),
                    chunks, _ptr(partials), stream)
            result = (out, rej.bool() if flags else None)
    if err != 0:
        raise RuntimeError(f"K3 {op} kernel launch failed: CUDA error {err}")
    chacha_kernel.launches += 1
    chacha_kernel.op_launches[op] += 1
    if derive is not None:
        chacha_kernel.derived_launches += 1
    return result


def _launch_mask(lib, keys, derive, S: int, counter0: int, x, modulus: int,
                 out_dtype, acc, dev, stream):
    """The mask op's C entry on the current stream: (CUDA error code,
    (masked, mask sum or ``acc``)). ``x`` is read in place when its rows
    are 16-byte aligned with unit column stride (any contiguous tensor, or
    rows of one), else copied contiguous first. ``keys``: the int32 key
    words, or None with ``derive`` (round seed, first id, seed bits), whose
    round keys go to the kernel by value."""
    from .fused_round import philox_round_keys

    d = x.shape[1]
    if S and (x.stride(1) != 1 or x.stride(0) % 2 or x.stride(0) < d
              or x.data_ptr() % 16):
        x = x.contiguous()
    out = torch.empty((S, d), dtype=out_dtype, device=dev)
    sums = torch.empty(d, dtype=torch.int64, device=dev) if acc is None \
        else acc
    out32 = out_dtype == torch.int32
    chunks = _chunks(lib, "mask32" if out32 else "mask64", S, d, modulus)
    partials = _scratch(chunks, d, dev)
    round_keys, pid_base, words = None, 0, 8
    if derive is not None:
        round_seed, pid_base, bits = derive
        round_keys = philox_round_keys(round_seed)
        words = (bits + 31) // 32
    err = lib.sda_chacha_mask_into(
        _ptr(keys), None if round_keys is None else round_keys.ctypes.data,
        pid_base, words, S, counter0, d, modulus, _U64_MAX // modulus,
        x.data_ptr(), x.stride(0) if S else d, int(out32), out.data_ptr(),
        sums.data_ptr(), int(acc is not None), chunks, _ptr(partials),
        stream)
    return err, (out, sums)


chacha_kernel.launches = 0
#: launches by operation (``OPS``); they add up to ``launches``
chacha_kernel.op_launches = dict.fromkeys(OPS, 0)
#: seeds K3 flagged that ``combine_masks`` replayed on the host
chacha_kernel.replayed = 0
#: mask ops that derived their seeds' keys in the kernel (of ``op_launches``
#: "mask")
chacha_kernel.derived_launches = 0


# ---------------------------------------------------------------------------
# The JAX module's entry points

def _seed_matrix(seeds, device) -> torch.Tensor:
    """Host seeds (sequences of at most 8 words) -> [S, 8] int64 words on
    ``device``, each word masked to 32 bits, zero-padded."""
    mat = np.zeros((len(seeds), 8), dtype=np.int64)
    for i, seed in enumerate(seeds):
        if len(seed) > 8:
            raise ValueError("seed longer than 256 bits")
        for j, w in enumerate(seed):
            mat[i, j] = int(w) & _MASK32
    return torch.from_numpy(mat).to(device)


def chacha_block_words(seed_words, counter0, *, nblocks: int):
    """[nblocks, 16] keystream words (int64 in [0, 2^32)) of the [8]-word
    key ``seed_words`` (a tensor: the call runs on its device), block
    counters counter0, ...; mirrors ``chacha.chacha_block_words``."""
    seed_words = torch.as_tensor(seed_words)
    if seed_words.shape != (8,):
        raise ValueError(f"seed words must be [8], got {tuple(seed_words.shape)}")
    return chacha_kernel("blocks", seed_words[None, :], counter0=counter0,
                         nblocks=int(nblocks))


def stream_residues_at(seed_words, counter0, *, dimension: int,
                       modulus: int):
    """[S, 8] seed words -> [S, dimension] int64 residues mod ``modulus``
    of the CHACHA_PRG_V1 u64 draws from draw offset ``counter0 * 8``
    (``dimension % 8 == 0``), on the seeds' device.

    The windowed stream of tiled and streamed rounds: a tile holding the
    dim window [8*c0, 8*c0 + dimension) expands blocks [c0, c0 +
    dimension/8). Draws are reduced WITHOUT the host spec's rejection step
    — masks cancel within the round, so the aggregate is exact regardless.
    """
    if dimension % 8:
        raise ValueError("dimension must be a multiple of 8 (one ChaCha block)")
    masks, _ = chacha_kernel("expand", seed_words, counter0=counter0,
                             dimension=dimension, modulus=modulus,
                             prg=chacha.CHACHA_PRG_V1, flags=False)
    return masks


def mask_residues_at(seed_words, counter0, x, *, modulus: int,
                     out_dtype=None):
    """The ChaCha mask stage in one K3 pass: [S, 8] seed words and an [S, d]
    int64 block ``x`` (``d % 8 == 0``; raw values, reduced in the kernel)
    -> ([S, d] ``(x + w) mod modulus`` as ``out_dtype``, int64 when None;
    [d] int64 ``sum_s w mod modulus``) on the seeds' device, w the
    CHACHA_PRG_V1 window of each seed from block ``counter0``
    (``stream_residues_at``'s, without rejection). Equals the JAX
    package's ``f.add(f.to_residues(x), f.from_u64(stream_u64_at(...)))``
    and ``f.sum`` of the masks; no [S, d] mask tensor and no residue pass
    exist."""
    return chacha_kernel("mask", seed_words, counter0=counter0,
                         modulus=modulus, x=x, out_dtype=out_dtype)


def mask_residues_derived(round_seed: int, pid_base: int, seed_bitsize: int,
                          counter0, x, *, modulus: int, out_dtype=None,
                          acc_mask=None):
    """``mask_residues_at`` on the seeds of global participants
    ``pid_base .. pid_base + S - 1`` under ``round_seed``
    (``chacha_seed_words``' keys), derived inside the kernel: the whole
    ChaCha part of the reference's jitted streamed step in one launch, with
    no seed tensor. On the CPU: ``chacha_seed_words`` then ``mask_plain``.
    ``acc_mask``: a contiguous [d] int64 accumulator of canonical residues
    on x's device that the sum is added into mod ``modulus`` in place (the
    step's donated accumulator, returned in place of a fresh sum)."""
    return chacha_kernel("mask", None, counter0=counter0, modulus=modulus,
                         x=x, out_dtype=out_dtype,
                         derive=(round_seed, pid_base, seed_bitsize),
                         acc=acc_mask)


def combine_masks(seeds, dimension: int, modulus: int, *, prg: str,
                  device=None) -> np.ndarray:
    """Sum of all seeds' expanded masks mod m — the recipient hot loop
    (receive.rs:102-118) on ``device`` (CUDA unless ``device="cpu"``).
    Bit-identical to summing the host expansion (``prg``-selected) per
    seed; ``prg`` is required: a defaulted stream choice could silently
    expand the wrong stream for a wire seed."""
    _check_modulus(modulus)
    _check_prg(prg)
    dev = resolve_device(device)
    seed_words = _seed_matrix(seeds, dev)
    total, rejected = chacha_kernel("combine", seed_words,
                                    dimension=dimension, modulus=modulus,
                                    prg=prg)
    total = total.cpu().numpy()
    replay = np.nonzero(rejected.cpu().numpy())[0]
    if replay.size:  # replay the affected seeds exactly on the host
        wrong, _ = chacha_kernel("expand", seed_words[replay],
                                 dimension=dimension, modulus=modulus,
                                 prg=prg, flags=False)
        wrong = wrong.cpu().numpy()
        for row, i in zip(wrong, replay):
            seed = [int(w) for w in seeds[i]]
            right = chacha.expand_mask_for(prg, seed, dimension, modulus)
            # residues below m < 2^62: the sum stays inside int64
            total = (total - row + right) % modulus
    chacha_kernel.replayed += int(replay.size)
    return total


def expand_mask(seed: Sequence[int], dimension: int, modulus: int, *,
                prg: str, device=None) -> np.ndarray:
    """Device-accelerated ``chacha.expand_mask_for(prg, ...)`` on
    ``device`` (CUDA unless ``device="cpu"``): bit-identical to the host
    expansion; ``prg`` required for the same reason as combine_masks."""
    _check_modulus(modulus)
    _check_prg(prg)
    if len(seed) > 8:
        raise ValueError("seed longer than 256 bits")
    dev = resolve_device(device)
    mask, rejected = chacha_kernel("expand", _seed_matrix([seed], dev),
                                   dimension=dimension, modulus=modulus,
                                   prg=prg)
    if bool(rejected[0]):  # p < dimension * modulus / 2^64
        return chacha.expand_mask_for(prg, list(seed), dimension, modulus)
    return mask[0].cpu().numpy()
