"""The reveal (K7): Lagrange reconstruct and unmask in one pass — the port
of the reveal the JAX package compiles into its jitted programs
(``sda_tpu/fields/sharing.py::packed_reconstruct32``, ``modsub32`` of the
mask total and ``to_int64``, inside ``jax.jit`` in the streamed finale, the
pod round and ``sharing.packed_reconstruct``).

From the gathered clerk rows [n, B] (canonical int64 residues mod a
Solinas prime p) and the reconstruction matrix L [k, r+1] (host ints; its
column 0 multiplies the implicit point-1 zero row), the reveal computes
``secrets = L @ [0; rows[rows_index]] mod p``, writes them unbatched
(``out[b*k + i] = secrets[i, b]``, truncated to d), subtracts the mask
total mod p and returns the [d] int64 aggregate. Here it is a hand-written
CUDA kernel for Hopper (``csrc/reveal.cu``, built by ``_build``) that
takes any k and r. This module holds

- ``reconstruct``: the reveal over any prime, where every Shamir reveal
  of the port goes (the pods', the streamed finales', the recipient's):
  K7 over a Solinas prime, the generic ``modmatmul`` otherwise;
- ``reveal``: K7's wrapper. For a CUDA tensor it launches the kernel on
  the current stream (a build or launch failure raises); for a CPU tensor
  it runs the plain version. It counts its launches in ``reveal.launches``;
- ``launch_args``: what the host hands the kernel (L without its column
  0, the row indices);
- ``reveal_plain``: today's eager chain (``packed_reconstruct32``,
  ``unbatch_columns``, ``modsub32``, ``to(int64)``), the kernel's
  yardstick.

The mask is None, the [k, B] batched totals (``fused_round``'s
``mask_tot``) or a flat [d] vector (the streamed and pod accumulators);
the kernel reads either in place through its strides.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .._lazy import torch

from . import _build
from .fastfield import SolinasPrime, modsub32
from .modular import modsub
from .sharing import (packed_reconstruct, packed_reconstruct32,
                      unbatch_columns)


def launch_args(l_host, sp: SolinasPrime, rows_index, n_rows: int):
    """(L's active columns as a contiguous uint32 [k, r] array, the rows
    read as an int32 [r] array): what the kernel takes besides the tensors.
    ``rows_index`` None reads rows 0..r-1; raises ValueError on a matrix
    or rows that do not match."""
    l_host = np.asarray(l_host, dtype=np.int64)
    if l_host.ndim != 2 or l_host.shape[0] < 1 or l_host.shape[1] < 2:
        raise ValueError(f"reconstruction matrix must be [k, r+1], got "
                         f"{l_host.shape}")
    r = l_host.shape[1] - 1
    idx = np.arange(r) if rows_index is None else np.asarray(
        [int(i) for i in rows_index])
    if idx.shape != (r,) or ((idx < 0) | (idx >= n_rows)).any():
        raise ValueError(f"rows {idx.tolist()} for {r} matrix columns of "
                         f"{n_rows} rows")
    table = np.ascontiguousarray((l_host[:, 1:] % sp.p).astype(np.uint32))
    return table, np.ascontiguousarray(idx.astype(np.int32))


def _mask_strides(mask, k: int, B: int, d: int):
    """(ms_i, ms_b): the strides at which the kernel reads mask value
    (i, b) of a [k, B] batched mask or a flat [d] one."""
    if mask.dim() == 2:
        if tuple(mask.shape) != (k, B):
            raise ValueError(f"batched mask must be [{k}, {B}], got "
                             f"{tuple(mask.shape)}")
        return mask.stride(0), mask.stride(1)
    if mask.dim() != 1 or mask.shape[0] != d:
        raise ValueError(f"flat mask must be [{d}], got {tuple(mask.shape)}")
    return mask.stride(0), k * mask.stride(0)


def reconstruct(rows, l_host, *, prime: int, dimension: int, mask=None,
                rows_index=None):
    """The reveal over any prime: [n, B] canonical int64 clerk rows, the
    [k, r+1] reconstruction matrix (host ints or a tensor) and the rows it
    reads (``rows_index``, the first r when None) -> the [d] int64
    aggregate, ``mask`` (None, [k, B] or [d]) subtracted mod ``prime``.
    Over a Solinas prime this is K7 (:func:`reveal`); over another the
    rows go through ``sharing.packed_reconstruct``'s ``modmatmul`` and the
    mask through ``modular.modsub``. Both give the canonical residues."""
    if isinstance(l_host, torch.Tensor):
        l_host = l_host.cpu().numpy()
    sp = SolinasPrime.try_from(prime)
    if sp is not None:
        return reveal(rows, l_host, sp, dimension=dimension, mask=mask,
                      rows_index=rows_index)
    if rows_index is not None:
        rows = rows[list(rows_index)]
    total = packed_reconstruct(rows, l_host, prime=prime, dimension=dimension)
    if mask is not None:
        if mask.dim() == 2:
            mask = unbatch_columns(mask, dimension)
        total = modsub(total, mask.to(torch.int64), prime)
    return total.to(torch.int64)


# ---------------------------------------------------------------------------
# Plain version (int64 torch, any device)

def reveal_plain(rows, l_host, sp: SolinasPrime, *, dimension: int,
                 mask=None, rows_index=None):
    """The reveal as the port ran it before K7: the rows at ``rows_index``
    gathered, ``packed_reconstruct32``, the mask subtracted with
    ``modsub32`` (a batched mask unbatched first), ``to(int64)``."""
    if rows_index is not None:
        rows = rows[list(rows_index)]
    total = packed_reconstruct32(rows, l_host, sp, dimension=dimension)
    if mask is not None:
        if mask.dim() == 2:
            mask = unbatch_columns(mask, dimension)
        total = modsub32(total, mask.to(torch.int64), sp)
    return total.to(torch.int64)


# ---------------------------------------------------------------------------
# K7: kernel wrapper

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built ``csrc/reveal.cu`` with its C interface declared."""
    lib = _build.load("reveal")
    ptr, i64, i32, u64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_ulonglong)
    lib.sda_reveal.argtypes = [ptr, i64, ptr, i32, i32, i32, i64, i64, u64,
                               i32, u64, ptr, i64, i64, ptr, ptr]
    lib.sda_reveal.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _device_table(words: bytes, device) -> "torch.Tensor":
    """The kernel's table (L's active columns, then a quorum's row
    indices) as an int32 tensor on ``device``, copied once a matrix: every
    tile and round of a committee reveals with the same one."""
    return torch.from_numpy(np.frombuffer(words, dtype=np.int32).copy()).to(
        device)


def reveal(rows, l_host, sp: SolinasPrime, *, dimension: int, mask=None,
           rows_index=None):
    """One K7 call: [n, B] canonical int64 clerk rows, the [k, r+1]
    reconstruction matrix (host ints) and the rows it reads (``rows_index``,
    the first r when None) -> the [d] int64 aggregate, ``mask`` (None, [k,
    B] or [d] canonical residues) subtracted mod p. A CUDA tensor launches
    the kernel on the current stream (a launch error raises); a CPU tensor
    runs :func:`reveal_plain`."""
    dev = rows.device
    if dev.type == "cpu":
        return reveal_plain(rows, l_host, sp, dimension=dimension,
                            mask=mask, rows_index=rows_index)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if rows.dim() != 2 or rows.dtype != torch.int64:
        raise ValueError(f"rows must be [n, B] int64, got {rows.dtype}"
                         f"{tuple(rows.shape)}")
    n_rows, B = rows.shape
    table, idx = launch_args(l_host, sp, rows_index, n_rows)
    k, r = table.shape
    d = int(dimension)
    if not 0 <= d <= B * k:
        raise ValueError(f"dimension {d} does not fit {B} columns of {k}")
    if B and rows.stride(1) != 1:
        rows = rows.contiguous()
    ms_i = ms_b = 0
    if mask is not None:
        if mask.device != dev or mask.dtype != torch.int64:
            raise ValueError(f"mask must be int64 on {dev}, got "
                             f"{mask.dtype} on {mask.device}")
        ms_i, ms_b = _mask_strides(mask, k, B, d)
    out = torch.empty(d, dtype=torch.int64, device=dev)
    if d == 0:
        return out
    lib = _library()
    # rows 0..r-1 need no index table: their loads wait on no other load
    indexed = not np.array_equal(idx, np.arange(r))
    with torch.cuda.device(dev):
        words = _device_table(
            table.tobytes() + (idx.tobytes() if indexed else b""), dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sda_reveal(
            rows.data_ptr(), rows.stride(0), words.data_ptr(), int(indexed),
            k, r, B, d, sp.p, sp.b, sp.delta,
            None if mask is None else mask.data_ptr(), ms_i, ms_b,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K7 kernel launch failed: CUDA error {err}")
    reveal.launches += 1
    return out


reveal.launches = 0
