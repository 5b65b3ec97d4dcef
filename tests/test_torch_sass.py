"""The port's compiler diagnostics (``sda_tpu_torch/utils/sass.py``), on
canned inputs: the CPU has no ``nvcc`` and no ``cuobjdump``, so the tools'
output is given as text."""

import types
from pathlib import Path

import pytest

from sda_tpu_torch.utils import sass

LIB = Path("lib.so")
PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119fused_round_columnsILi3ELi4ELb1EEEvPKj' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119fused_round_columnsILi3ELi4ELb1EEEvPKj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 110 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118fused_round_kernelILi8ELb0EEEvPKj' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118fused_round_kernelILi8ELb0EEEvPKj
    40 bytes stack frame, 52 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
"""

SASS = """\
\t\tFunction : _ZN12_GLOBAL__N_119fused_round_columnsILi3ELi4ELb1EEEvPKj
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;
        /*0010*/                   LDG.E.CONSTANT R2, desc[UR12][R40.64] ;
        /*0020*/                   IMAD.WIDE.U32 R4, R2, -0x2daee0ad, RZ ;
        /*0030*/                   UIMAD.WIDE.U32 UR8, UR4, -0x326172a9, URZ ;
        /*0040*/                   LOP3.LUT R6, R5, R7, R8, 0x96, !PT ;
        /*0050*/                   IMAD.WIDE.U32 R48, R42, 0xc, R48 ;
        /*0060*/              @!P2 BRA 0x10 ;
        /*0070*/                   ISETP.GE.AND P0, PT, R1, R2, PT ;
        /*0080*/                   IADD3 R3, R3, 0x1, RZ ;
        /*0090*/               @P0 BRA 0x70 ;
        /*00a0*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_112probe_kernelILb1ELb0ELb0ELb0EEEvNS_9ProbeArgsE
        /*0000*/                   EXIT ;
"""


def test_ptxas_lines_by_kernel_and_spills():
    info = sass.ptxas_info(PTXAS)
    cols = next(v for k, v in info.items() if "fused_round_columns" in k)
    gen = next(v for k, v in info.items() if "fused_round_kernel" in k)
    assert cols == ["0 bytes stack frame, 0 bytes spill stores, "
                    "0 bytes spill loads", "Used 110 registers, used 0 barriers"]
    assert not sass.spills(cols) and sass.spills(gen)


def test_loop_is_the_branch_with_the_loads_and_multiplies(monkeypatch):
    monkeypatch.setattr(sass.subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=SASS))
    lines = sass.loop_instructions(LIB, "cuobjdump", "fused_round_columns")
    assert [op for op, _ in lines] == [
        "LDG.E.CONSTANT", "IMAD.WIDE.U32", "UIMAD.WIDE.U32", "LOP3.LUT",
        "IMAD.WIDE.U32", "BRA"]
    # the address multiply by 0xc is not Philox's
    assert sass.philox_muls(lines) == 2
    with pytest.raises(LookupError, match="not in the SASS"):
        sass.loop_instructions(LIB, "cuobjdump", "no_such_kernel")


NESTED = """\
\t\tFunction : _ZN12_GLOBAL__N_120chacha_combine_kernelILb0ELb1EEEvPKj
        /*0000*/                   LDS.128 R4, [R2] ;
        /*0010*/                   IMAD.WIDE.U32 R8, R6, R7, RZ ;
        /*0020*/                   LOP3.LUT R9, R9, R4, RZ, 0x3c, !PT ;
        /*0030*/                   SHF.L.W.U32.HI R9, R9, 0x10, R9 ;
        /*0040*/                   IMAD.IADD R5, R5, 0x1, R9 ;
        /*0050*/                   IADD3 R3, R3, 0x1, RZ ;
        /*0060*/                   UIADD3 UR4, UR4, 0x1, URZ ;
        /*0070*/               @P0 BRA 0x10 ;
        /*0080*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0090*/               @P1 BRA 0x0 ;
        /*00a0*/                   EXIT ;
"""


@pytest.mark.parametrize("innermost,first", [(False, "LDS.128"),
                                             (True, "IMAD.WIDE.U32")])
def test_nested_loops_and_the_pipe_mix(monkeypatch, innermost, first):
    """A loop nested in another holds the same multiplies: the outer one
    is taken by default, the inner one with ``innermost``; ``pipe_mix``
    sorts a loop's opcodes by the pipe they issue to (ptxas's IMAD.IADD
    adds on the FMA pipe, IADD3 on the ALU pipe, U* on the uniform
    datapath)."""
    monkeypatch.setattr(sass.subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=NESTED))
    sass._sass.cache_clear()
    lines = sass.loop_instructions(LIB, "cuobjdump", "chacha_combine",
                                   innermost=innermost)
    sass._sass.cache_clear()
    assert lines[0][0] == first
    inner = [(op, t) for op, t in lines if op != "LDS.128"
             and not op.startswith("BAR")][:7]
    assert sass.pipe_mix(inner) == {"alu": 3, "fma": 2, "uniform": 1,
                                    "other": 1}
