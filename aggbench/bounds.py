"""The least time an H100 could take for the work of K1, K3 and K8,
counted from the algorithm and the bytes.

A frozen copy of the parts of ``sda_tpu_torch/benchmarks/bounds.py`` that
the roofline metrics read, as they stood when the benchmark was defined:
the per-layer roofline metrics divide these bounds by the kernels' traced
device time, so a later change to the program cannot move the yardstick.
Do not edit; a new count goes into a new file, with the metric that
reads it."""

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
MULS, XORS = 60, 68


def philox_ops(k: int, t: int, masked: bool):
    """Wide multiplies and xors a participant and column needs to draw its
    value rows as the column loop does (``fields/csrc/columns.cuh``): the
    Philox blocks from pair 0 when masked, else from pair k // 2 (the one
    holding row k, the first share-randomness row), to the pair of the
    last row k + t - 1. A block costs what a block of the main path's count
    does, 60 / 4 multiplies and 68 / 4 xors."""
    blocks = -(-(k + t) // 2) - (0 if masked else k // 2)
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


def k1_bound(P, B, k, draws, do_x, out_rows, muls=MULS, xors=XORS,
             external_bits=False, acc_rows=0):
    """Least time (ms) the card could take for the work of a kernel of K1's
    shape at these shapes, and what bounds it: the larger of its bytes
    (input words once, int64 outputs once) at the memory rate and its
    integer operations (``k1_ops``) at a pipe's rate and at the issue
    rate. With ``external_bits`` the ``draws`` rows are read (two uint32
    words each) instead of drawn. ``acc_rows``: int64 rows of B read once
    besides (the accumulators the outputs are added into: n shares, and k
    masks when masked). Returns (bound_ms, bound_by, detail)."""
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
    bytes_moved = ((P * k * B * 4 if do_x else 0)
                   + (out_rows + acc_rows) * B * 8
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
#: the accumulate mod m (a 64-bit add, compare and subtract, 6); the mask
#: op takes x's floor mod m (its word's sign bit flipped, 1, the draws'
#: reduction without the zone test, 7 multiplies and 14, and an add of the
#: fold constant mod m, 6), then adds the draw to it mod m and accumulates
#: it (6 each).
CHACHA_ALU_OPS = 640
CHACHA_EITHER_OPS = 320 + 16
DRAW_MULS = 7
DRAW_EITHER_OPS = 4 + 2 + 8 + 3
DRAW_ACCUMULATE_OPS = 6
RAW_RESIDUE_EITHER_OPS = 1 + (DRAW_EITHER_OPS - 3) + DRAW_ACCUMULATE_OPS
#: the mask op's derived keys (``derive_keys`` in chacha.cu): two
#: Philox4x32-10 blocks a seed, each 10 rounds of 2 wide multiplies (FMA
#: pipe) and 2 three-input xors (ALU pipe); the function needs them once a
#: seed (the kernel repeats them in each column strip)
DERIVE_MULS = DERIVE_XORS = 2 * 10 * 2
#: K3's operations, and the accumulates mod m each does a draw (``blocks``
#: makes keystream words and draws nothing)
K3_ACCUMULATES = {"blocks": 0, "expand": 0, "combine": 1, "mask": 2}
#: the reductions of K3's x a draw (the mask op's raw x, one a draw)
K3_RAW_REDUCTIONS = {"blocks": 0, "expand": 0, "combine": 0, "mask": 1}


def _k3_ops(seeds: int, dimension: int, op: str, derived: bool = False):
    """(blocks, ALU-pipe-only, FMA-pipe-only, all) operations of K3's
    ``op`` on ``seeds`` streams of ``dimension`` draws (``blocks``: one
    key's dimension / 8 blocks); ``derived``: the mask op deriving its
    keys."""
    blocks = seeds * -(-dimension // 8)
    draws = 0 if op == "blocks" else seeds * dimension
    raw = K3_RAW_REDUCTIONS[op]
    alu = blocks * CHACHA_ALU_OPS
    fma = draws * DRAW_MULS * (1 + raw)
    if derived:
        alu += seeds * DERIVE_XORS
        fma += seeds * DERIVE_MULS
    total = (alu + fma + blocks * CHACHA_EITHER_OPS
             + draws * (DRAW_EITHER_OPS
                        + raw * RAW_RESIDUE_EITHER_OPS
                        + K3_ACCUMULATES[op] * DRAW_ACCUMULATE_OPS))
    return blocks, alu, fma, total


def k3_pipe_ops(seeds: int, dimension: int, op: str,
                derived: bool = False) -> int:
    """K3's operations on its busier pipe for ``op`` (``expand``,
    ``combine`` or ``mask``): the ALU-only or FMA-only work, or half of all
    work where the either-pipe operations fill both (the issue rate is two
    pipes' rate)."""
    _, alu, fma, total = _k3_ops(seeds, dimension, op, derived)
    return max(alu, fma, -(-total // 2))


def k3_bound(seeds: int, dimension: int, op: str, out_itemsize: int = 8,
             derived: bool = False, accumulate: bool = False):
    """Least time (ms) the card could take for K3's ``op`` on ``seeds``
    streams of ``dimension`` draws, and what bounds it: the larger of its
    bytes at the memory rate and its integer operations, ALU-pipe work at
    one pipe's rate and all work at the issue rate. Bytes: 8 key words a
    seed read once, and ``blocks``: 16 words a block written; ``expand``:
    the [S, d] int64 residues written; ``combine``: the [d] int64 sum
    written; ``mask``: x [S, d] int64 read, the masked [S, d] written at
    ``out_itemsize`` bytes and the [d] int64 sum written. The mask op's
    options: ``derived`` keys are computed (two Philox blocks a seed),
    not read; with ``accumulate`` the [d] accumulator is read too.
    Returns (bound_ms, bound_by, detail)."""
    if op not in K3_ACCUMULATES:
        raise ValueError(f"unknown K3 operation {op!r}")
    blocks, alu, _, total = _k3_ops(seeds, dimension, op, derived)
    ops_ms = (k3_pipe_ops(seeds, dimension, op, derived) / PIPE_OPS_PER_S
              * 1e3)
    elements = seeds * dimension
    bytes_moved = (0 if derived else seeds * 8 * 4) + {
        "blocks": blocks * 16 * 4,
        "expand": elements * 8,
        "combine": dimension * 8,
        "mask": elements * (8 + out_itemsize) + dimension * 8}[op] + (
            dimension * 8 if accumulate else 0)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    detail = (f"{bytes_moved} bytes -> {bytes_ms:.4f} ms; {blocks} blocks, "
              f"{total:.0f} integer ops ({alu:.0f} ALU-pipe only, "
              f"{total / max(1, blocks):.0f} a block) -> {ops_ms:.4f} ms")
    return (max(bytes_ms, ops_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", detail)


#: K8 (fields/csrc/residues.cu), counted from its source: an element takes
#: the sign bit's xor (1), the Solinas fold of a 64-bit word (at most 5
#: folds: 5 multiplies on the FMA pipe, 15 shifts, masks and adds on the
#: ALU pipe), its conditional subtract and the fold constant's add mod p
#: (4).
RESIDUES_FMA_OPS = 5
RESIDUES_ALU_OPS = 1 + 15 + 4


def residues_bound(n: int, in_itemsize: int = 8):
    """Least time (ms) the card could take for K8's pass over ``n``
    elements of ``in_itemsize`` bytes, and what bounds it: the larger of
    its bytes (each input read once, each int32 output written once) at
    the memory rate and its integer operations at a pipe's rate and at the
    issue rate. Returns (bound_ms, bound_by, detail)."""
    bytes_moved = n * (in_itemsize + 4)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    fma, alu = RESIDUES_FMA_OPS * n, RESIDUES_ALU_OPS * n
    ops_ms = max(max(fma, alu) / PIPE_OPS_PER_S,
                 (fma + alu) / INSTR_PER_S) * 1e3
    detail = (f"{bytes_moved} bytes -> {bytes_ms:.4f} ms; "
              f"{RESIDUES_ALU_OPS} ALU-pipe + {RESIDUES_FMA_OPS} FMA-pipe "
              f"ops an element -> {ops_ms:.4f} ms")
    return (max(bytes_ms, ops_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", detail)
