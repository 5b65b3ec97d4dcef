"""What the compiler made of the port's kernels: ``nvcc -Xptxas -v`` lines
and the SASS opcode mix of a kernel's participant loop (``cuobjdump
-sass``, beside ``nvcc`` in the CUDA toolkit). Diagnostics for
``chip_smoke.py``; the kernels' bounds are counted from their algorithm,
not from this.
"""

from __future__ import annotations

import functools
import re
import subprocess
from pathlib import Path

#: wide-multiply instruction forms (Philox's multiplies)
MUL_OPS = ("IMAD.WIDE", "IMAD.HI", "UIMAD.WIDE", "UIMAD.HI")
_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
    r"(?:\s+0x([0-9a-f]+))?[^;\n]*")


def ptxas_info(log: str) -> dict:
    """``nvcc -Xptxas -v`` log -> {mangled kernel: its register, stack and
    spill lines}."""
    info, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = info.setdefault(m[1], [])
        elif cur is not None and ("registers" in line or "spill" in line):
            cur.append(line.split("ptxas info    :")[-1].strip())
    return info


def spills(lines) -> bool:
    """Whether ptxas lines report a non-zero spill."""
    return any(re.search(r"[1-9]\d* bytes spill", ln) for ln in lines)


@functools.lru_cache(maxsize=None)
def _sass(lib_path: Path, cuobjdump: Path) -> str:
    """``cuobjdump -sass`` of a built library (libraries are keyed by their
    sources, so one dump serves every kernel in it)."""
    return subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout


def loop_instructions(lib_path: Path, cuobjdump: Path, kernel: str,
                      innermost: bool = False):
    """The SASS lines (opcode and operands) of the participant loop of
    ``kernel`` (a substring of its mangled name) in a built library: the
    instructions between a backward branch and its target, for the branch
    whose body holds the most global loads and wide multiplies (the inputs
    and Philox), the longest among equals (the shortest with
    ``innermost``: a loop nested in another holds the same work). Raises
    LookupError without such a kernel."""
    body = None
    for chunk in _sass(lib_path, cuobjdump).split("Function : ")[1:]:
        if kernel in chunk.split("\n", 1)[0]:
            body = chunk
    if body is None:
        raise LookupError(f"{kernel} not in the SASS of {lib_path.name}")
    instrs = [(int(m[1], 16), m[2], m[3], m[0])
              for m in _SASS_LINE.finditer(body)]

    def weight(loop):
        work = sum(op.startswith(("LDG",) + MUL_OPS)
                   for addr, op, _, _ in instrs
                   if loop[0] <= addr <= loop[1])
        return work, (loop[0] - loop[1]) if innermost else loop[1] - loop[0]

    lo, hi = max(((int(tgt, 16), addr) for addr, op, tgt, _ in instrs
                  if op.split(".")[0] == "BRA" and tgt
                  and int(tgt, 16) < addr), key=weight)
    return [(op, text) for addr, op, _, text in instrs if lo <= addr <= hi]


#: Hopper's integer pipes by opcode (its first dot-separated part): the
#: ALU pipe's logic, shifts, permutes, adds, compares and selects; the FMA
#: pipe's multiply-adds (IMAD, and the IMAD.IADD / IMAD.MOV forms ptxas
#: moves adds and moves to); the uniform datapath's U* opcodes; the rest
#: (memory, control) under "other"
ALU_OPS = ("LOP3", "SHF", "PRMT", "IADD3", "ISETP", "SEL", "LEA", "IMNMX",
           "MOV", "PLOP3", "IABS", "FLO", "POPC", "BMSK", "SGXT", "VIADD")
FMA_OPS = ("IMAD", "IMUL", "FFMA", "FMUL", "FADD")


def pipe_mix(lines) -> dict:
    """{"alu", "fma", "uniform", "other": instructions} of
    :func:`loop_instructions` lines, by the pipe each opcode issues to."""
    mix = dict.fromkeys(("alu", "fma", "uniform", "other"), 0)
    for op, _ in lines:
        head = op.split(".")[0]
        pipe = ("uniform" if head.startswith("U")
                else "alu" if head in ALU_OPS
                else "fma" if head in FMA_OPS else "other")
        mix[pipe] += 1
    return mix


#: Philox's multipliers as SASS prints an immediate: signed 32-bit hex
PHILOX_IMMEDIATES = ("-0x2daee0ad", "-0x326172a9", "0xd2511f53", "0xcd9e8d57")


def philox_muls(lines) -> int:
    """Multiplies by a Philox multiplier (wide, high or low, vector or
    uniform) among :func:`loop_instructions` lines."""
    return sum(op.startswith(("IMAD", "UIMAD"))
               and any(imm in text for imm in PHILOX_IMMEDIATES)
               for op, text in lines)
