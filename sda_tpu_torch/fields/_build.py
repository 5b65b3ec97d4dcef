"""Build and load the port's hand-written CUDA kernels and host libraries.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library and
loaded with ``ctypes``. The library is built at first use into
``sda_tpu_torch/_build/`` and keyed by a hash of its source, of every
``csrc`` header it includes (``#include "<name>.cuh"``, transitively) and
of the compiler flags, so an edited kernel, header or flag is rebuilt and
an unchanged one is not. There is no fallback: a missing ``nvcc`` or a
failed build raises.

Host code (the port's own crypto, ``crypto/csrc/sodium.c``, and the native
participant core) takes the same route through the host compiler:
``build_host`` compiles a list of C and C++ sources into one library,
keyed the same way on the sources and ``HOST_FLAGS``.
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
from typing import Iterable, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: portable codegen only (no -march=native): a library built for one CPU
#: dies of SIGILL on another
HOST_FLAGS = ("-O2", "-fPIC", "-shared")
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


def _keyed_path(name: str, flags: Iterable[str],
                paths: Iterable[Path]) -> Path:
    h = hashlib.sha256()
    for flag in flags:
        h.update(flag.encode() + b"\0")
    for path in paths:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives, keyed by its current
    sources and ``NVCC_FLAGS``."""
    return _keyed_path(name, NVCC_FLAGS, sources(name))


def _compile(out: Path, compiler: List[str], inputs: List[str],
             what: str) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [*compiler, "-o", str(tmp), *inputs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cmd[0]} failed to build {what}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return res.stdout + res.stderr


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists.

    Returns the library path and the compiler's log (``-Xptxas -v``:
    registers, shared memory and spills of each kernel; empty when the
    library was already built).
    """
    out = library_path(name)
    if out.exists():
        return out, ""
    log = _compile(out, [_nvcc(), *NVCC_FLAGS], [str(CSRC / f"{name}.cu")],
                   f"{name}.cu")
    return out, log


def _host_compiler() -> str:
    path = shutil.which("g++") or shutil.which("c++")
    if path is None:
        raise RuntimeError(
            "g++ not found: building the host libraries needs a C/C++ "
            "compiler")
    return path


def build_host(name: str, srcs: Sequence[Path]) -> Path:
    """Compile the C (``.c``) and C++ sources ``srcs`` into one host
    library ``lib<name>_<key>.so`` unless it exists; raises RuntimeError
    with the compiler's output when the build fails."""
    out = _keyed_path(name, HOST_FLAGS, srcs)
    if not out.exists():
        inputs: List[str] = []
        for src in srcs:
            inputs += ["-x", "c" if src.suffix == ".c" else "c++", str(src)]
        _compile(out, [_host_compiler(), *HOST_FLAGS], inputs, name)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
