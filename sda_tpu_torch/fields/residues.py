"""The residue pass of the K1 lanes (K8): a block of integer inputs to int32
canonical residues mod a Solinas prime in one pass — the port of
``sda_tpu/fields/fastfield.py::to_residues32`` and the int32 cast that the
JAX package's jitted steps fuse into the step.

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
  kernel's yardstick.
"""

from __future__ import annotations

import ctypes
import functools

from .._lazy import torch

from . import _build
from .fastfield import SolinasPrime, to_residues32

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


def residues_int32_plain(x, sp: SolinasPrime):
    """[rows, cols] integer block -> its floor mod p as int32, the two
    eager passes the kernel replaces."""
    return to_residues32(x, sp).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built ``csrc/residues.cu`` with its C interface declared."""
    lib = _build.load("residues")
    ptr, i64, i32, u64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_ulonglong)
    lib.sda_residues.argtypes = [ptr, i32, i64, i64, i64, u64, i32, u64, u64,
                                 ptr, ptr]
    lib.sda_residues.restype = ctypes.c_int
    return lib


def residues_int32(x, sp: SolinasPrime):
    """One K8 call: a [rows, cols] (or [cols]) int64, int32 or uint32 block
    -> its contiguous int32 floor mod p, same shape. A CUDA tensor launches
    the kernel on the current stream (a launch error raises); a CPU tensor
    runs :func:`residues_int32_plain`."""
    name = _dtype_name(x)
    dev = x.device
    if dev.type == "cpu":
        return residues_int32_plain(x, sp)
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
    out = torch.empty(x.shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    code, _ = _DTYPES[name]
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sda_residues(
            block.data_ptr(), code, rows, cols,
            block.stride(0) if rows > 1 else cols, sp.p, sp.b, sp.delta,
            sign_fold(name, sp.p), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K8 kernel launch failed: CUDA error {err}")
    residues_int32.launches += 1
    return out


residues_int32.launches = 0
