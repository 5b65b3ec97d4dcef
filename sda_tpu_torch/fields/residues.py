"""The residue pass of the K1 lanes (K8): a block of integer inputs to int32
canonical residues mod a Solinas prime in one pass — the port of
``sda_tpu/fields/fastfield.py::to_residues32`` and the int32 cast that the
JAX package's jitted steps fuse into the step; and the clerk's device-tile
fold (K10): a bundle tile's floor mod m added into a column accumulator in
one pass — the port of ``sda_tpu/mesh/devscale.py::DeviceTileCombiner.
_fold_step``, a jitted ``acc + Σ_rows to_residues(bundle)``.

The K1 lanes without ChaCha masks (``mesh.simpod._pallas_stage`` with Full
or no masks) take the block's floor mod p as the int32 words K1 reads.
Here that is a hand-written CUDA kernel for Hopper (``csrc/residues.cu``,
built by ``_build``): it reads 8 bytes and writes 4 an int64 element, where
``torch.remainder`` and ``.to(torch.int32)`` read 16 and wrote 12. This
module holds

- ``residues_int32``: the kernel's wrapper. For a CUDA tensor it launches
  the kernel on the current stream (a build or launch failure raises); for
  a CPU tensor it runs the plain version. It counts its launches in
  ``residues_int32.launches``;
- ``sign_fold``: the constant the kernel adds back after reducing a
  value's word with its sign bit flipped;
- ``residues_int32_plain``: ``to_residues32(x, sp).to(torch.int32)``, the
  kernel's yardstick;
- ``fold_columns``: K10's wrapper (same file, ``csrc/residues.cu``), in
  place on the accumulator, counting ``fold_columns.launches``; for CPU
  tensors ``fold_columns_plain``, the three eager passes it replaces.

``residues_int32(..., width=)`` takes a ragged last tile at its own width
and writes the zero columns past its edge itself, so no ``torch.cat``
copies the tile to pad it.
"""

from __future__ import annotations

import ctypes
import functools

from .._lazy import torch

from . import _build
from .fastfield import SolinasPrime, to_residues32

_U64_MAX = (1 << 64) - 1

#: the dtypes the kernel reads, by the code its C entry takes, and the bias
#: that flipping the sign bit of each one's word adds
_DTYPES = {"int64": (0, 1 << 63), "int32": (1, 1 << 31), "uint32": (2, 0)}


def _dtype_name(x) -> str:
    for name in _DTYPES:
        if x.dtype == getattr(torch, name):
            return name
    raise ValueError(f"K8 takes int64, int32 or uint32, got {x.dtype}")


def sign_fold(dtype_name: str, p: int) -> int:
    """-bias mod p: the kernel reads a value as its word with the sign bit
    flipped (x + 2^63 for int64, x + 2^31 for int32, x for uint32), reduces
    that word mod p and adds this back."""
    return -_DTYPES[dtype_name][1] % p


def residues_int32_plain(x, sp: SolinasPrime, width=None):
    """[rows, cols] integer block -> its floor mod p as int32, the two
    eager passes the kernel replaces; with ``width`` (>= cols) zero columns
    appended up to it."""
    out = to_residues32(x, sp).to(torch.int32)
    if width is not None and width > out.shape[-1]:
        out = torch.cat([out, out.new_zeros(
            out.shape[:-1] + (width - out.shape[-1],))], dim=-1)
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built ``csrc/residues.cu`` with its C interface declared."""
    lib = _build.load("residues")
    ptr, i64, i32, u64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_ulonglong)
    lib.sda_residues.argtypes = [ptr, i32, i64, i64, i64, i64, u64, i32,
                                 u64, u64, ptr, ptr]
    lib.sda_residues.restype = ctypes.c_int
    lib.sda_fold_columns.argtypes = [ptr, i64, i64, i64, u64, u64, u64, ptr,
                                     ptr]
    lib.sda_fold_columns.restype = ctypes.c_int
    return lib


def _out_width(cols: int, width) -> int:
    if width is None:
        return cols
    if int(width) < cols:
        raise ValueError(f"width {width} is narrower than the block's "
                         f"{cols} columns")
    return int(width)


def residues_int32(x, sp: SolinasPrime, width=None):
    """One K8 call: a [rows, cols] (or [cols]) int64, int32 or uint32 block
    -> its contiguous int32 floor mod p, same shape; with ``width`` (>=
    cols) the output is [rows, width] and its columns past the block's are
    zeros (a ragged tile's padding, written by the kernel). A CUDA tensor
    launches the kernel on the current stream (a launch error raises); a
    CPU tensor runs :func:`residues_int32_plain`."""
    name = _dtype_name(x)
    dev = x.device
    out_cols = _out_width(x.shape[-1] if x.dim() else 0, width)
    if dev.type == "cpu":
        return residues_int32_plain(x, sp, width)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if x.dim() not in (1, 2):
        raise ValueError(f"K8 takes a [rows, cols] block, got "
                         f"{tuple(x.shape)}")
    block = x if x.dim() == 2 else x[None, :]
    rows, cols = block.shape
    if (cols > 1 and block.stride(1) != 1) or (rows > 1
                                               and block.stride(0) < cols):
        block = block.contiguous()
    out = torch.empty(x.shape[:-1] + (out_cols,), dtype=torch.int32,
                      device=dev)
    if out.numel() == 0:
        return out
    code, _ = _DTYPES[name]
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sda_residues(
            block.data_ptr() if cols else None, code, rows, cols,
            block.stride(0) if rows > 1 else cols, out_cols, sp.p, sp.b,
            sp.delta, sign_fold(name, sp.p), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K8 kernel launch failed: CUDA error {err}")
    residues_int32.launches += 1
    return out


residues_int32.launches = 0


# ---------------------------------------------------------------------------
# K10: the clerk's device-tile fold

def fold_constants(modulus: int):
    """(mu, fold): the Barrett constant floor((2^64 - 1) / m) and -2^63
    mod m that K10 takes with the modulus; raises ValueError outside the
    moduli it folds exactly, (0, 2^63]."""
    m = int(modulus)
    if not 0 < m <= 1 << 63:
        raise ValueError(f"K10 folds mod m in (0, 2^63], got {m}")
    return _U64_MAX // m, -(1 << 63) % m


def fold_columns_plain(acc, blk, modulus: int):
    """``acc + Σ_rows to_residues(blk)`` mod m as the clerk's fold ran it
    before K10 (``FieldOps.create(modulus)``'s residues, sum and add: three
    eager passes) -> a new [cols] int64 tensor."""
    from .ops import FieldOps

    f = FieldOps.create(int(modulus))
    return f.add(acc, f.sum(f.to_residues(blk), axis=0))


def fold_columns(acc, blk, modulus: int):
    """One K10 call: ``acc[c] = (acc[c] + Σ_r floor_mod(blk[r, c], m)) mod
    m`` in place, for a [rows, cols] int64 bundle tile (any values; columns
    contiguous, rows any stride) and a contiguous [cols] int64 accumulator
    of canonical residues on the same device; returns ``acc``. A CUDA
    tensor launches the kernel on the current stream (a launch error
    raises); a CPU tensor runs :func:`fold_columns_plain` and copies the
    sum into ``acc``."""
    mu, fold = fold_constants(modulus)
    if blk.dim() != 2 or blk.dtype != torch.int64:
        raise ValueError(f"K10 takes an int64 [rows, cols] tile, got "
                         f"{blk.dtype}{tuple(blk.shape)}")
    rows, cols = blk.shape
    if (acc.dtype != torch.int64 or tuple(acc.shape) != (cols,)
            or acc.device != blk.device or not acc.is_contiguous()):
        raise ValueError(f"the accumulator must be a contiguous int64 "
                         f"[{cols}] on {blk.device}, got {acc.dtype}"
                         f"{tuple(acc.shape)} on {acc.device}")
    dev = blk.device
    if dev.type == "cpu":
        return acc.copy_(fold_columns_plain(acc, blk, modulus))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if (cols > 1 and blk.stride(1) != 1) or (rows > 1
                                             and blk.stride(0) < cols):
        blk = blk.contiguous()
    if rows == 0 or cols == 0:
        return acc
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sda_fold_columns(
            blk.data_ptr(), rows, cols, blk.stride(0) if rows > 1 else cols,
            int(modulus), mu, fold, acc.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K10 kernel launch failed: CUDA error {err}")
    fold_columns.launches += 1
    return acc


fold_columns.launches = 0
