"""The least time an H100 could take for the work of K1, K3 and K4,
counted from the algorithm and the bytes: shared by ``chip_smoke.py`` and
``k1_ab``."""

from __future__ import annotations

#: H100 SXM (NVIDIA data sheet, dense, 700 W): device memory rate; 132 SMs
#: whose fp32 peak of 67 TFLOP/s (an FMA counted as 2, 128 lanes an SM)
#: implies the SM clock. Integer work goes to two pipes of 64 lanes an SM
#: that issue side by side: multiplies (IMAD*) to the FMA pipe, logic and
#: adds (LOP3, IADD3) to the ALU pipe; carry-in adds may go to either.
#: Each SM issues at most 128 thread instructions a clock (4 x 32).
HBM_BYTES_PER_S = 3.35e12
SMS = 132
SM_CLOCK_HZ = 67e12 / (SMS * 128 * 2)
PIPE_OPS_PER_S = SMS * 64 * SM_CLOCK_HZ
INSTR_PER_S = SMS * 128 * SM_CLOCK_HZ
#: The work of one participant and column on the main path (masked
#: internal draws, k=3, t=4, a column index below 2^32), counted from the
#: algorithm and not from a compiled loop: 7 drawn rows take 3.5 Philox
#: blocks of 10 rounds (2 wide multiplies and 2 three-input xors a round),
#: 80 and 80 in all. The counter (column, participant, row pair) makes 20
#: multiplies and 12 xors of rounds 1-3 invariant in the participant or
#: the column (fields/csrc/columns.cuh), and the half-used block's last
#: multiply and xor are dead: 60 wide multiplies (FMA pipe) and 68 LOP3
#: (ALU pipe) stay. Each input word (3) and drawn word (14) is one 64-bit
#: accumulate, an IADD3 (ALU pipe) and a carry-in add (FMA pipe).
MULS, XORS, ACCUMULATES = 60, 68, 17
#: the count of K1's first CUDA version: 35 whole Philox rounds, nothing
#: factored
WHOLE_ROUND_MULS, WHOLE_ROUND_XORS = 70, 70


def philox_ops(rows: int):
    """Wide multiplies and xors a participant and column needs to draw
    ``rows`` 64-bit rows: a Philox block (two rows) costs what a block of
    the main path's count does, 60 / 4 multiplies and 68 / 4 xors."""
    blocks = -(-rows // 2)
    return MULS * blocks // 4, XORS * blocks // 4


def k1_ops(P, B, k, draws, do_x, muls=MULS, xors=XORS, external_bits=False):
    """(FMA-pipe, ALU-pipe) integer operations of the work of a kernel of
    K1's shape at these shapes: a participant and column takes ``muls``
    wide multiplies (FMA pipe) and ``xors`` LOP3 (ALU pipe) when it draws,
    and one 64-bit accumulate (an IADD3 on the ALU pipe and a carry-in add
    on the FMA pipe) per input word and drawn word. With ``external_bits``
    the ``draws`` rows are read instead of drawn. The per-column epilogue
    (one reduction and contraction a column, not a participant) is left
    out."""
    fold_words = (k if do_x else 0) + 2 * draws
    if not draws or external_bits:
        muls = xors = 0
    return P * B * (muls + fold_words), P * B * (xors + fold_words)


def k1_pipe_ops(P, B, k, draws, do_x, external_bits=False) -> int:
    """K1's operations on its busier pipe (``k1_ops``): the count its
    operation bound divides by ``PIPE_OPS_PER_S`` (the issue rate is two
    pipes' rate, so it never binds first)."""
    return max(k1_ops(P, B, k, draws, do_x, external_bits=external_bits))


def k1_bound(P, B, k, draws, do_x, out_rows, muls=MULS, xors=XORS,
             external_bits=False):
    """Least time (ms) the card could take for the work of a kernel of K1's
    shape at these shapes, and what bounds it: the larger of its bytes
    (input words once, int64 outputs once) at the memory rate and its
    integer operations (``k1_ops``) at a pipe's rate and at the issue
    rate. With ``external_bits`` the ``draws`` rows are read (two uint32
    words each) instead of drawn. Returns (bound_ms, bound_by, detail)."""
    fold_words = (k if do_x else 0) + 2 * draws
    if not draws or external_bits:
        muls = xors = 0
    fma_ops, alu_ops = k1_ops(P, B, k, draws, do_x, muls, xors)
    ops_ms = max(max(fma_ops, alu_ops) / PIPE_OPS_PER_S,
                 (fma_ops + alu_ops) / INSTR_PER_S) * 1e3
    # the same work if a wide multiply took two FMA-pipe issue slots
    fma_half = fma_ops + P * B * muls
    half_ms = max(max(fma_half, alu_ops) / PIPE_OPS_PER_S,
                  (fma_half + alu_ops) / INSTR_PER_S) * 1e3
    bytes_moved = ((P * k * B * 4 if do_x else 0) + out_rows * B * 8
                   + (P * 2 * draws * B * 4 if external_bits else 0))
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    detail = (f"{bytes_moved} bytes -> {bytes_ms:.4f} ms; {fma_ops:.0f} "
              f"FMA-pipe + {alu_ops:.0f} ALU-pipe ops ({muls} multiplies, "
              f"{xors} xors, {fold_words} accumulates a participant and "
              f"column) -> {ops_ms:.4f} ms ({half_ms:.4f} ms with wide "
              f"multiplies at half rate)")
    return (max(bytes_ms, ops_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", detail)


#: K3 (fields/csrc/chacha.cu), counted from the algorithm. A ChaCha20 block
#: is 20 rounds of 4 quarter-rounds of 4 adds, 4 xors and 4 rotates (a
#: rotate is one funnel shift): 320 xors and 320 rotates on the ALU pipe and
#: 320 adds on either pipe, 960 in all, plus 16 feed-forward adds. Per u64
#: draw: the exact reduction mod m (Barrett: the 64-bit high product is 4
#: wide multiplies and 4 carry adds, q*m's low half 3 multiplies, v - q*m 2
#: subtracts, two conditional subtracts a 64-bit compare and subtract each,
#: 8), the zone test (a 64-bit compare and an or, 3) and, in the combine,
#: the accumulate mod m (a 64-bit add, compare and subtract, 6).
CHACHA_ALU_OPS = 640
CHACHA_EITHER_OPS = 320 + 16
DRAW_MULS = 7
DRAW_EITHER_OPS = 4 + 2 + 8 + 3
DRAW_ACCUMULATE_OPS = 6


def _k3_ops(seeds: int, dimension: int, combine: bool):
    """(blocks, ALU-pipe-only, FMA-pipe-only, all) operations of K3's work
    on ``seeds`` streams of ``dimension`` draws."""
    blocks = seeds * -(-dimension // 8)
    draws = seeds * dimension
    alu = blocks * CHACHA_ALU_OPS
    fma = draws * DRAW_MULS
    total = (alu + fma + blocks * CHACHA_EITHER_OPS
             + draws * (DRAW_EITHER_OPS
                        + (DRAW_ACCUMULATE_OPS if combine else 0)))
    return blocks, alu, fma, total


def k3_pipe_ops(seeds: int, dimension: int, combine: bool) -> int:
    """K3's operations on its busier pipe: the ALU-only or FMA-only work,
    or half of all work where the either-pipe operations fill both (the
    issue rate is two pipes' rate)."""
    _, alu, fma, total = _k3_ops(seeds, dimension, combine)
    return max(alu, fma, -(-total // 2))


def k3_bound(seeds: int, dimension: int, combine: bool):
    """Least time (ms) the card could take for K3's work on ``seeds``
    streams of ``dimension`` draws (``combine``: summed into one [d] row;
    else each written), and what bounds it: the larger of its bytes (8
    key words a seed read once, int64 residues written once) at the memory
    rate and its integer operations, ALU-pipe work at one pipe's rate and
    all work at the issue rate. Returns (bound_ms, bound_by, detail)."""
    blocks, alu, _, total = _k3_ops(seeds, dimension, combine)
    ops_ms = k3_pipe_ops(seeds, dimension, combine) / PIPE_OPS_PER_S * 1e3
    bytes_moved = seeds * 8 * 4 + (dimension if combine
                                   else seeds * dimension) * 8
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    detail = (f"{bytes_moved} bytes -> {bytes_ms:.4f} ms; {blocks} blocks, "
              f"{total:.0f} integer ops ({alu:.0f} ALU-pipe only, "
              f"{total / blocks:.0f} a block) -> {ops_ms:.4f} ms")
    return (max(bytes_ms, ops_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", detail)


def k4_bound(montmuls: int, L: int, rows: int, lanes: int):
    """Least time (ms) the card could take for K4's work: ``montmuls``
    Montgomery multiplications of L 32-bit limbs, whose inputs are
    ``rows`` x ``lanes`` operands (read once) and whose output is ``lanes``
    operands (written once), and what bounds it: the larger of those bytes
    at the memory rate and the CIOS's 2 L^2 + L 32x32 -> 64-bit multiplies
    a montmul, each taking two FMA-pipe issue slots (the half rate
    ``k1_bound`` gives wide multiplies). Returns (bound_ms, bound_by,
    detail)."""
    wide = montmuls * (2 * L * L + L)
    ops_ms = wide / (PIPE_OPS_PER_S / 2) * 1e3
    bytes_moved = (rows + 1) * lanes * 4 * L
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    detail = (f"{bytes_moved} bytes -> {bytes_ms:.4f} ms; {montmuls} "
              f"montmuls x {2 * L * L + L} wide multiplies = {wide:.4g} "
              f"at half the FMA pipe's rate -> {ops_ms:.4f} ms")
    return (max(bytes_ms, ops_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", detail)
