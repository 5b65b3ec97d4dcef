"""Fused mask + share + participant combine (K1) and the round driver on it.

Port of ``sda_tpu/fields/pallas_round.py``. There, one Pallas kernel
(``fused_mask_share_combine``) draws masks and share randomness on-core,
folds the participants and contracts the share matrix in one pass over the
inputs. Here that kernel is hand-written CUDA for Hopper
(``csrc/fused_round.cu``, built by ``_build``); this module holds

- ``fused_mask_share_combine``: the kernel's wrapper. For a CUDA tensor it
  launches the kernel (or raises); for a CPU tensor it runs the plain
  version. It counts its launches in ``fused_mask_share_combine.launches``,
  and by which of the kernel's instances ran (``INSTANCES``) in
  ``fused_mask_share_combine.instance_launches``;
- ``philox_round_keys`` and ``kernel_scalars``: what the host hands the
  kernel besides the tensors (the seed's Philox round keys, p = 2^e - c);
- ``fused_mask_share_combine_plain``: the same function in plain torch
  int64 (the port's Solinas algebra), the kernel's yardstick;
- ``philox_bits``: the words the kernel draws in internal mode, in the
  external-bits layout, so internal mode is bit-comparable as well;
- ``single_chip_round_pallas``: the round driver (residues, batch
  columns, the kernel, Lagrange reconstruct, unmask).

The TPU block knobs (``tile``, ``p_block``, ``p_tile``, ``tree_fold``) have
no counterpart: each CUDA thread owns one column and folds every
participant, and mod-p sums are order-free, so the output is the one the
Pallas kernel gives for any of those settings, from every instance.

Randomness: with ``external_bits`` ([P, 2*draws, B] words, 2 per drawn
residue, the reference's row layout) the output is bit-identical to the
Pallas kernel fed the same bits. Without them the kernel draws from
Philox4x32-10 keyed by ``seed``; that cannot give the TPU PRNG's bits, and
need not: masks cancel in the round and the random polynomial rows are
annihilated by reconstruction, so the aggregate is exact for any draws.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import _build, numtheory
from .fastfield import (
    SolinasPrime,
    canon32,
    matrix_limbs,
    modadd32,
    modmatmul32_limbs,
    modsub32,
    modsum32,
    to_residues32,
    uniform_from_bits,
)
from .sharing import batch_columns, packed_reconstruct32, unbatch_columns
from ..device import resolve_device

_MASK32 = 0xFFFFFFFF
_WORD_DTYPES = (torch.uint32, torch.int32)
#: kernel limits (csrc/fused_round.cu): value rows k + t and clerks n
_MAX_ROWS = 16
_MAX_SHARES = 32


def _words64(t):
    """32-bit words (uint32 or int32 storage) -> int64 in [0, 2^32)."""
    return t.to(torch.int64) & _MASK32


def _check_shapes(x_cols, m_host, privacy_threshold, masked, external_bits):
    P, k, B = x_cols.shape
    n, m2 = np.shape(m_host)
    t = privacy_threshold
    if m2 != 1 + k + t:
        raise ValueError(f"share matrix width {m2} != 1+k+t={1 + k + t}")
    draws = (k + t) if masked else t
    if external_bits is not None and \
            tuple(external_bits.shape) != (P, 2 * draws, B):
        raise ValueError(
            f"external_bits shape {tuple(external_bits.shape)} != "
            f"{(P, 2 * draws, B)}")
    return P, k, B, n, draws


# ---------------------------------------------------------------------------
# Philox4x32-10 in int64 torch: the kernel's internal draws

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo32(a: int, x):
    """(hi, lo) 32-bit halves of a * x for a constant a < 2^32 and int64
    words x < 2^32, with every partial product below 2^49."""
    t = a * (x & 0xFFFF)
    u = a * (x >> 16)
    return (u + (t >> 16)) >> 16, (((u & 0xFFFF) << 16) + t) & _MASK32


def philox4x32_10(c0, c1, c2, c3, key0: int, key1: int):
    """Philox4x32 with 10 rounds (Salmon et al., SC'11) on int64 word
    tensors; returns the four output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ key0, lo1, hi0 ^ c3 ^ key1, lo0
        key0 = (key0 + _PHILOX_W[0]) & _MASK32
        key1 = (key1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def philox_round_keys(seed: int) -> np.ndarray:
    """[2, 10] uint32: the round keys of Philox4x32-10 under the 64-bit
    ``seed``, as the kernels take them (``csrc/philox.cuh``): round r is
    keyed by (seed mod 2^32 + r*W0, seed >> 32 + r*W1) mod 2^32, the key
    schedule :func:`philox4x32_10` runs."""
    seed = int(seed) & ((1 << 64) - 1)
    halves = (seed & _MASK32, seed >> 32)
    return np.array([[(key + r * w) & _MASK32 for r in range(10)]
                     for key, w in zip(halves, _PHILOX_W)], dtype=np.uint32)


def philox_bits(seed: int, P: int, k: int, t: int, B: int, masked: bool,
                device):
    """[P, 2*draws, B] int64 words: the kernel's internal-mode draws laid
    out as ``external_bits``, so the plain version reproduces them.

    Value row c of column b for participant q (rows [0, k) are masks,
    [k, k+t) share randomness) takes words (0, 1) of Philox block
    counter (b mod 2^32, b >> 32, q, c >> 1), key (seed mod 2^32,
    seed >> 32), when c is even, and words (2, 3) when c is odd.
    """
    seed = int(seed) & ((1 << 64) - 1)
    key0, key1 = seed & _MASK32, seed >> 32
    nmask = k if masked else 0
    draws = nmask + t
    b = torch.arange(B, dtype=torch.int64, device=device)[None, :]
    q = torch.arange(P, dtype=torch.int64, device=device)[:, None]
    c0 = (b & _MASK32).expand(P, B)
    c1 = (b >> 32).expand(P, B)
    c2 = q.expand(P, B)
    out = torch.empty((P, 2 * draws, B), dtype=torch.int64, device=device)
    blocks = {}
    for c in range(k + t):
        if c < k and not masked:
            continue
        if c >> 1 not in blocks:
            blocks[c >> 1] = philox4x32_10(
                c0, c1, c2, torch.full_like(c0, c >> 1), key0, key1)
        w = blocks[c >> 1]
        hi, lo = (w[0], w[1]) if c % 2 == 0 else (w[2], w[3])
        if c < k:
            hi_row, lo_row = c, k + c
        else:
            hi_row, lo_row = 2 * nmask + (c - k), 2 * nmask + t + (c - k)
        out[:, hi_row] = hi
        out[:, lo_row] = lo
    return out


def draw_sum(bits, rows: int, row0: int, sp: SolinasPrime):
    """Σ over participants of the [rows, B] uniform residues of a draw in
    the external-bits layout ([P, 2*draws, B] int64 words): hi words in
    rows [2*row0, 2*row0+rows), lo in [2*row0+rows, 2*(row0+rows))."""
    hi = bits[:, 2 * row0:2 * row0 + rows]
    lo = bits[:, 2 * row0 + rows:2 * (row0 + rows)]
    return modsum32(uniform_from_bits(hi, lo, sp), sp, axis=0)


# ---------------------------------------------------------------------------
# K1: plain version and kernel wrapper

def fused_mask_share_combine_plain(x_cols, seed, sp: SolinasPrime, m_host,
                                   privacy_threshold: int, masked: bool,
                                   external_bits=None):
    """[P, k, B] 32-bit words -> ([n, B] combined shares, [k, B] mask
    totals), canonical int64 residues; plain torch on any device.

    Canons and sums the inputs over P, draws from ``external_bits`` (or
    from ``philox_bits(seed, ...)``), adds the masks and contracts with
    the share matrix minus its zero column. Mask totals are zero when
    unmasked.
    """
    P, k, B, n, draws = _check_shapes(
        x_cols, m_host, privacy_threshold, masked, external_bits)
    t = privacy_threshold
    dev = x_cols.device
    xsum = modsum32(canon32(_words64(x_cols), sp), sp, axis=0)      # [k, B]
    if external_bits is None:
        bits = philox_bits(seed, P, k, t, B, masked, dev)
    else:
        bits = _words64(external_bits)

    mh, ml = matrix_limbs(np.asarray(m_host)[:, 1:], sp, dev)
    if masked:
        masksum = draw_sum(bits, k, 0, sp)
        values_k = modadd32(xsum, masksum, sp)
        randsum = draw_sum(bits, t, k, sp)
    else:
        masksum = torch.zeros((k, B), dtype=torch.int64, device=dev)
        values_k = xsum
        randsum = draw_sum(bits, t, 0, sp)
    shares = modadd32(
        modmatmul32_limbs(mh[:, :k], ml[:, :k], values_k, sp),
        modmatmul32_limbs(mh[:, k:], ml[:, k:], randsum, sp),
        sp,
    )
    return shares, masksum


def kernel_operands(x_cols, sp: SolinasPrime, m_host, t: int) -> np.ndarray:
    """What a CUDA kernel of K1's shape takes (K1, and K5 in
    ``benchmarks/kernel_probe.py``): checks the device, the word type and
    strides of ``x_cols`` [P, k, B], the kernel's row and clerk limits and
    the prime; returns the active share-matrix columns (the zero column
    dropped) as contiguous uint32 canonical residues."""
    dev = x_cols.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if x_cols.dtype not in _WORD_DTYPES:
        raise TypeError(f"x_cols must hold 32-bit words, got {x_cols.dtype}")
    if min(x_cols.stride()) < 0:
        raise ValueError("x_cols strides must be non-negative")
    k = x_cols.shape[1]
    n = np.shape(m_host)[0]
    if k + t > _MAX_ROWS or n > _MAX_SHARES:
        raise ValueError(
            f"kernel supports k+t <= {_MAX_ROWS} and n <= {_MAX_SHARES}, "
            f"got k+t={k + t}, n={n}")
    # raw per-row contraction sums: (k+t) products < p^2 must fit uint64
    if (k + t) * (sp.p - 1) ** 2 >= 1 << 64:
        raise ValueError(f"prime {sp.p} too large for the kernel")
    return np.ascontiguousarray(
        np.asarray(m_host, dtype=np.int64)[:, 1:] % sp.p, dtype=np.uint32)


def kernel_scalars(sp: SolinasPrime, seed: int):
    """(round keys, p, e, c): what a kernel of K1's shape takes besides
    the tensors, the seed's Philox round keys and p = 2^e - c, the
    Solinas form in which it reduces mod p."""
    return philox_round_keys(seed), sp.p, sp.b, sp.delta


@functools.lru_cache(maxsize=None)
def _library():
    return bind_library(_build.load("fused_round"))


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``csrc/fused_round.cu`` on
    ``lib`` (ctypes would otherwise pass pointers as 32-bit ints)."""
    ptr, i64, i32, u64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_ulonglong)
    fn = lib.sda_fused_mask_share_combine
    fn.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr, i32, i32, i32, i32,
                   i64, i32, ptr, u64, i32, u64, ptr,
                   ctypes.POINTER(ctypes.c_int), ptr]
    fn.restype = ctypes.c_int
    lib.sda_fused_round_occupancy.argtypes = [i32,
                                              ctypes.POINTER(ctypes.c_int)]
    lib.sda_fused_round_occupancy.restype = ctypes.c_int
    return lib


#: K1's instances (``csrc/fused_round.cu``), in the kernel's numbering:
#: the generic one (every call below), and the main path's for internal
#: draws, k=3, t=4 and the ``batch_columns`` layout, masked and unmasked
INSTANCES = ("generic", "columns", "columns_unmasked")


def resident_blocks(instance: str) -> int:
    """Blocks of 256 threads an SM holds at once of K1's ``instance``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; the generic one
    with internal draws and at most 8 value rows). Needs the card."""
    blocks = ctypes.c_int()
    err = _library().sda_fused_round_occupancy(
        INSTANCES.index(instance), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    return blocks.value


def fused_mask_share_combine(x_cols, seed, sp: SolinasPrime, m_host,
                             privacy_threshold: int, masked: bool,
                             external_bits=None):
    """[P, k, B] 32-bit words -> ([n, B] combined shares, [k, B] mask
    totals), canonical int64 residues.

    ``x_cols``: uint32 or int32 storage read as uint32 words (canonical
    or not: the sums are taken mod p), at any strides — the strided view
    ``batch_columns`` returns is read in place. ``external_bits``:
    optional contiguous [P, 2*(k+t) or 2*t, B] words (mask rows first when
    masked); without them the kernel draws Philox words keyed by ``seed``.

    A CUDA tensor launches the kernel (errors raise); a CPU tensor runs
    :func:`fused_mask_share_combine_plain`.
    """
    P, k, B, n, draws = _check_shapes(
        x_cols, m_host, privacy_threshold, masked, external_bits)
    t = privacy_threshold
    dev = x_cols.device
    if dev.type == "cpu":
        return fused_mask_share_combine_plain(
            x_cols, seed, sp, m_host, t, masked, external_bits)
    m_active = kernel_operands(x_cols, sp, m_host, t)
    if external_bits is not None:
        if external_bits.device != dev or \
                external_bits.dtype not in _WORD_DTYPES:
            raise TypeError("external_bits must be 32-bit words on "
                            f"{dev}, got {external_bits.dtype} on "
                            f"{external_bits.device}")
        if not external_bits.is_contiguous():
            raise ValueError("external_bits must be contiguous")
    shares = torch.empty((n, B), dtype=torch.int64, device=dev)
    mask_tot = torch.empty((k, B), dtype=torch.int64, device=dev)
    keys, p, e, c = kernel_scalars(sp, seed)
    instance = ctypes.c_int()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().sda_fused_mask_share_combine(
            x_cols.data_ptr(), *x_cols.stride(),
            None if external_bits is None else external_bits.data_ptr(),
            shares.data_ptr(), mask_tot.data_ptr(), P, k, t, n, B,
            int(masked), keys.ctypes.data, p, e, c, m_active.ctypes.data,
            ctypes.byref(instance), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_mask_share_combine kernel launch failed: CUDA error {err}")
    fused_mask_share_combine.launches += 1
    fused_mask_share_combine.instance_launches[INSTANCES[instance.value]] += 1
    return shares, mask_tot


fused_mask_share_combine.launches = 0
#: launches by instance (``INSTANCES``); they add up to ``launches``
fused_mask_share_combine.instance_launches = dict.fromkeys(INSTANCES, 0)


# ---------------------------------------------------------------------------
# The round driver

def _input_words(inputs, sp: SolinasPrime):
    """[P, d] integer inputs -> 32-bit words the kernel sums mod p.

    uint32 inputs are reinterpreted in place as int32 storage (no copy, no
    pass: the kernel canonicalizes); other integer types are reduced to
    canonical residues first (negative int32 as in ``to_residues32``)."""
    if inputs.dtype == torch.uint32:
        return inputs.view(torch.int32)
    return to_residues32(inputs, sp).to(torch.int32)


def single_chip_round_pallas(sharing_scheme, masking_scheme=None,
                             dim_tile=None, device=None):
    """The aggregation round on the fused kernel: counterpart of
    ``sda_tpu.fields.pallas_round.single_chip_round_pallas``.

    Returns ``round_fn(inputs, generator)``: [P, d] integer inputs -> [d]
    int64 aggregate mod p. ``generator`` is a CPU ``torch.Generator``
    whatever the round's device: it only draws the kernel's 64-bit Philox
    key, one per tile, so the host never waits on the card for it.
    Requires a Solinas prime and None or Full masking. ``dim_tile`` runs
    the round in fixed-width dimension tiles, one kernel launch each.
    """
    from ..protocol import FullMasking, NoMasking

    dev = resolve_device(device)
    s = sharing_scheme
    masking = masking_scheme or NoMasking()
    if not isinstance(masking, (NoMasking, FullMasking)):
        raise ValueError("fused round masking: None or Full")
    if isinstance(masking, FullMasking) and masking.modulus != s.prime_modulus:
        raise ValueError("masking modulus must equal the sharing prime")
    sp = SolinasPrime.try_from(s.prime_modulus)
    if sp is None:
        raise ValueError(f"prime {s.prime_modulus} is not Solinas-form")
    masked = isinstance(masking, FullMasking)
    # scheme-dispatched matrices: PackedShamir (NTT) or BasicShamir
    # (Vandermonde/Lagrange, k=1) — the kernel is layout-agnostic
    m_host = numtheory.share_matrix_for(s)
    l_host = numtheory.reconstruct_matrix_for(s, tuple(range(s.share_count)))
    k = s.secret_count
    t = s.privacy_threshold

    def one_tile(x, generator):
        d = x.shape[1]
        x_cols = batch_columns(x, k)                               # [P, k, B]
        seed = int(torch.randint(0, 1 << 62, (), generator=generator))
        shares, mask_tot = fused_mask_share_combine(
            x_cols, seed, sp, m_host, t, masked)
        total = packed_reconstruct32(shares, l_host, sp, dimension=d)
        if masked:
            total = modsub32(total, unbatch_columns(mask_tot, d), sp)
        return total

    if dim_tile is None:
        tiled = None
    else:
        from .dimtile import scan_dim_tiles

        grain = k * 8 // math.gcd(k, 8)
        tiled = scan_dim_tiles(
            lambda blk, generator, i, width: one_tile(blk, generator),
            grain, dim_tile)

    def round_fn(inputs, generator: torch.Generator):
        if generator.device.type != "cpu":
            raise ValueError(
                "the fused round seeds its kernel from a CPU generator, "
                f"got one on {generator.device}")
        x = _input_words(torch.as_tensor(inputs, device=dev), sp)
        if tiled is None:
            return one_tile(x, generator)
        return tiled(x, generator)

    return round_fn
