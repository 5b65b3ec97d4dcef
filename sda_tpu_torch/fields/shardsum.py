"""The pod's clerk combine (K9): the p_shards participant-summed partials of
one d column summed, canonicalized and gathered in one pass — the port of
the collectives the JAX package compiles into its jitted pod programs
(``psum_scatter`` over ``p`` + ``canon`` + ``all_gather``, and the mask
``psum`` + ``canon``: ``sda_tpu/mesh/simpod.py:588-610``,
``streaming.py:740-755``, ``devscale.py:287-297``).

On one device the scatter's split into clerk blocks and the gather change
no element, so a column's gathered clerk rows are ``(Σ_j parts[j]) mod m``
and its mask total ``(Σ_j mask_parts[j]) mod m``. Here that is a
hand-written CUDA kernel for Hopper (``csrc/shardsum.cu``, built by
``_build``) that reads every partial in place through a pointer table.
This module holds

- ``shard_combine``: the kernel's wrapper. For CUDA tensors it launches
  the kernel on the current stream (a build or launch failure raises); for
  CPU tensors it runs the plain version. It counts its launches in
  ``shard_combine.launches``;
- ``launch_args``: what the host hands the kernel (the pointer table, the
  row strides, the shapes and the modulus' Barrett constant);
- ``shard_combine_plain``: the chain the port ran before K9 (a clerk
  block's partials added, canonicalized, the blocks concatenated; the mask
  partials added and canonicalized), the kernel's yardstick.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .._lazy import torch

from . import _build

#: the most partials (p shards) one launch reads: the pointer table is a
#: kernel argument of this many entries (``csrc/shardsum.cu``)
MAX_PARTS = 64
_U64_MAX = (1 << 64) - 1


class LaunchArgs(NamedTuple):
    """The kernel's arguments besides the outputs: ``ptrs``/``strides``
    the partials' addresses and row strides (elements), ``mask_ptrs`` the
    mask partials' addresses (None without masks), the [rows, cols] and
    [mask_cols] shapes, the modulus and its Barrett constant ``mu``."""

    ptrs: np.ndarray
    strides: np.ndarray
    mask_ptrs: Optional[np.ndarray]
    rows: int
    cols: int
    mask_cols: int
    modulus: int
    mu: int


def _check_headroom(n_parts: int, modulus: int) -> None:
    """The partials' sum must fit where the chain adds it (an int64, as
    the pod checks: ``mesh.simpod._check_collective_headroom``)."""
    if not 0 < modulus <= 1 << 63:
        raise ValueError(f"modulus {modulus} outside (0, 2^63]")
    if n_parts * (modulus - 1) >= 1 << 63:
        raise ValueError(f"{n_parts} partials mod {modulus} could overflow "
                         f"int64")


def _check_parts(parts: Sequence, mask_parts) -> Tuple[int, int, int]:
    """-> (rows, cols, mask_cols); raises on partials that are not int64
    [rows, cols] (and [mask_cols]) tensors on one device."""
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"{len(parts)} partials; K9 takes 1 to {MAX_PARTS}")
    dev = parts[0].device
    shape = tuple(parts[0].shape)
    if len(shape) != 2:
        raise ValueError(f"partials must be [rows, cols], got {shape}")
    for x in parts:
        if x.dtype != torch.int64 or tuple(x.shape) != shape:
            raise ValueError(f"partials must be int64 {list(shape)}, got "
                             f"{x.dtype}{list(x.shape)}")
        if x.device != dev:
            raise ValueError(f"partials on {x.device} and {dev}: move them "
                             "to one device first")
    mask_cols = 0
    if mask_parts is not None:
        if len(mask_parts) != len(parts):
            raise ValueError(f"{len(mask_parts)} mask partials for "
                             f"{len(parts)} partials")
        for v in mask_parts:
            if (v.dtype != torch.int64 or v.dim() != 1
                    or v.shape != mask_parts[0].shape):
                raise ValueError(f"mask partials must be int64 vectors of "
                                 f"one length, got {v.dtype}{list(v.shape)}")
            if v.device != dev:
                raise ValueError(f"mask partial on {v.device}, partials on "
                                 f"{dev}")
        mask_cols = mask_parts[0].shape[0]
    return shape[0], shape[1], mask_cols


def launch_args(parts: Sequence, mask_parts, modulus: int) -> LaunchArgs:
    """The pointer table, row strides, shapes and Barrett constant the
    kernel takes for ``parts`` (int64 [rows, cols], columns contiguous) and
    ``mask_parts`` (int64 [mask_cols], contiguous, or None) mod
    ``modulus``. Raises ValueError on a layout the kernel does not read in
    place (the wrapper makes such a partial contiguous first)."""
    modulus = int(modulus)
    _check_headroom(len(parts), modulus)
    rows, cols, mask_cols = _check_parts(parts, mask_parts)
    for x in parts:
        if (cols > 1 and x.stride(1) != 1) or (rows > 1
                                               and x.stride(0) < cols):
            raise ValueError(f"partial strides {x.stride()} are not rows "
                             "of contiguous columns")
    if mask_parts is not None and any(
            mask_cols > 1 and v.stride(0) != 1 for v in mask_parts):
        raise ValueError("mask partials must be contiguous")
    return LaunchArgs(
        ptrs=np.array([x.data_ptr() for x in parts], dtype=np.uint64),
        strides=np.array([x.stride(0) if rows > 1 else cols for x in parts],
                         dtype=np.int64),
        mask_ptrs=None if mask_parts is None else np.array(
            [v.data_ptr() for v in mask_parts], dtype=np.uint64),
        rows=rows, cols=cols, mask_cols=mask_cols, modulus=modulus,
        mu=_U64_MAX // modulus)


# ---------------------------------------------------------------------------
# Plain version (int64 torch, any device)

def shard_combine_plain(parts: Sequence, mask_parts, modulus: int):
    """The combine as the port ran it before K9, on the partials' device:
    for each of the p = ``len(parts)`` clerk blocks (rows ``c * n/p`` ..),
    the block's partials added in int64 and canonicalized (the
    ``psum_scatter``), the blocks concatenated (the ``all_gather``); the
    mask partials added and canonicalized (the ``psum``). The field is
    the pod's: ``FieldOps.create(modulus, cross_terms=p)``. ->
    (gathered [n, B], mask total [d] or None)."""
    from .ops import FieldOps

    p = len(parts)
    _check_headroom(p, int(modulus))
    _check_parts(parts, mask_parts)
    f = FieldOps.create(int(modulus), cross_terms=p)
    blk = parts[0].shape[0] // p

    def total(xs):
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x
        return f.canon(acc)

    gathered = torch.cat([total([x[c * blk:(c + 1) * blk] for x in parts])
                          for c in range(p)])
    return gathered, None if mask_parts is None else total(list(mask_parts))


# ---------------------------------------------------------------------------
# K9: kernel wrapper

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built ``csrc/shardsum.cu`` with its C interface declared."""
    lib = _build.load("shardsum")
    ptr, i64, i32, u64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_ulonglong)
    lib.sda_shardsum.argtypes = [ptr, ptr, ptr, i32, i64, i64, i64, u64, u64,
                                 ptr, ptr, ptr]
    lib.sda_shardsum.restype = ctypes.c_int
    return lib


def shard_combine(parts: Sequence, mask_parts, modulus: int):
    """One K9 call: the p participant-summed share partials of one d
    column (int64 [n, B] each, canonical residues mod ``modulus``) and
    their mask sums (int64 [d] each, or None) -> (the gathered [n, B]
    clerk rows, the [d] mask total or None), canonical, on the partials'
    device. CUDA tensors launch the kernel on the current stream (a launch
    error raises); CPU tensors run :func:`shard_combine_plain`. Every
    partial must already be on one device (the pod's ``all_gather`` moves
    them there)."""
    dev = parts[0].device if len(parts) else None
    if dev is None or dev.type == "cpu":
        return shard_combine_plain(parts, mask_parts, modulus)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rows, cols, mask_cols = _check_parts(parts, mask_parts)
    parts = [x if (cols <= 1 or x.stride(1) == 1)
             and (rows <= 1 or x.stride(0) >= cols) else x.contiguous()
             for x in parts]
    if mask_parts is not None:
        mask_parts = [v if mask_cols <= 1 or v.stride(0) == 1
                      else v.contiguous() for v in mask_parts]
    args = launch_args(parts, mask_parts, modulus)
    out = torch.empty((rows, cols), dtype=torch.int64, device=dev)
    out_mask = (None if mask_parts is None else
                torch.empty(mask_cols, dtype=torch.int64, device=dev))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sda_shardsum(
            args.ptrs.ctypes.data, args.strides.ctypes.data,
            None if args.mask_ptrs is None else args.mask_ptrs.ctypes.data,
            len(parts), rows, cols, mask_cols, args.modulus, args.mu,
            out.data_ptr(), None if out_mask is None else out_mask.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"K9 kernel launch failed: CUDA error {err}")
    shard_combine.launches += 1
    return out, out_mask


shard_combine.launches = 0
