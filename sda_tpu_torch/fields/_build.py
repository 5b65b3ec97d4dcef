"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library and
loaded with ``ctypes``. The library is built at first use into
``sda_tpu_torch/_build/`` and keyed by a hash of its source, of every
``csrc`` header it includes (``#include "<name>.cuh"``, transitively) and
of the compiler flags, so an edited kernel, header or flag is rebuilt and
an unchanged one is not. There is no fallback: a missing ``nvcc`` or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: building the CUDA kernels needs the CUDA toolkit")
    return path


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes,
    transitively, in the order they are first met."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path not in seen:
            seen.append(path)
            todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())]
    return seen


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives, keyed by its current
    sources and ``NVCC_FLAGS``."""
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode() + b"\0")
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists.

    Returns the library path and the compiler's log (``-Xptxas -v``:
    registers, shared memory and spills of each kernel; empty when the
    library was already built).
    """
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
