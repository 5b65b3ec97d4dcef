"""The least time an H100 could take for the work of K1, K3, K4, K6, K7,
K8, K9 and K10, counted from the algorithm and the bytes: shared by
``chip_smoke.py``, ``k1_ab``, ``k3_ab`` and ``k4_ab``."""

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


def k1_pipe_ops(P, B, k, draws, do_x, external_bits=False) -> int:
    """K1's operations on its busier pipe (``k1_ops``): the count its
    operation bound divides by ``PIPE_OPS_PER_S`` (the issue rate is two
    pipes' rate, so it never binds first)."""
    return max(k1_ops(P, B, k, draws, do_x, external_bits=external_bits))


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


#: K6 (fields/csrc/blockgen.cu), counted from its source: an element takes
#: on the ALU pipe the xor of its column's product into the row's word and
#: three shift-and-xor pairs of the hash (7), on the FMA pipe the column's
#: multiply, the hash's two multiplies and the remainder's four (the wide
#: product M * x and its high word's multiply, a multiply-high and a wide
#: multiply-add: 7).
BLOCKGEN_ALU_OPS = 7
BLOCKGEN_FMA_OPS = 7


def blockgen_bound(rows: int, cols: int, alu_ops: float = BLOCKGEN_ALU_OPS,
                   fma_ops: float = BLOCKGEN_FMA_OPS):
    """Least time (ms) the card could take for K6's block of ``rows`` x
    ``cols`` int64 values, and what bounds it: the larger of its bytes (each
    value written once, nothing read) at the memory rate and its integer
    operations (``alu_ops`` and ``fma_ops`` an element) at a pipe's rate
    and at the issue rate. Returns (bound_ms, bound_by, detail)."""
    n = rows * cols
    bytes_moved = 8 * n
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = max(max(alu_ops, fma_ops) * n / PIPE_OPS_PER_S,
                 (alu_ops + fma_ops) * n / INSTR_PER_S) * 1e3
    detail = (f"{bytes_moved} bytes -> {bytes_ms:.4f} ms; {alu_ops:g} "
              f"ALU-pipe + {fma_ops:g} FMA-pipe ops an element -> "
              f"{ops_ms:.4f} ms")
    return (max(bytes_ms, ops_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", detail)


#: K7 (fields/csrc/reveal.cu), counted from its source: a column takes k r
#: wide multiply-adds (FMA pipe) and, a secret, the Solinas fold of a
#: uint64 sum (at most 4 folds of a shift, a multiply, a mask and an add:
#: 4 on the FMA pipe, 12 on the ALU pipe) and its conditional subtract (2)
#: once every REVEAL_FOLD_ROWS rows and at the end, and the mask's modular
#: subtract (3).
REVEAL_FOLD_FMA = 4
REVEAL_FOLD_ALU = 12 + 2
REVEAL_UNMASK_ALU = 3
#: rows summed between two folds (kRows x kFoldGroups in reveal.cu)
REVEAL_FOLD_ROWS = 8 * 7


def reveal_bound(r: int, B: int, k: int, d: int, mask_layout=None):
    """Least time (ms) the card could take for K7's reveal of ``B`` columns
    from ``r`` clerk rows into ``d`` secrets (k a column), and what bounds
    it: the larger of its bytes (the r int64 rows read once, the mask read
    once: k B int64 for the ``"batched"`` layout, d for ``"flat"``, none
    for None; the d int64 outputs written once) at the memory rate and its
    integer operations at a pipe's rate and at the issue rate. Returns
    (bound_ms, bound_by, detail)."""
    if mask_layout not in (None, "batched", "flat"):
        raise ValueError(f"unknown mask layout {mask_layout!r}")
    mask_bytes = {None: 0, "batched": k * B * 8, "flat": d * 8}[mask_layout]
    bytes_moved = r * B * 8 + mask_bytes + d * 8
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    folds = -(-r // REVEAL_FOLD_ROWS)
    fma = B * k * (r + folds * REVEAL_FOLD_FMA)
    alu = B * k * (folds * REVEAL_FOLD_ALU
                   + (REVEAL_UNMASK_ALU if mask_layout else 0))
    ops_ms = max(max(fma, alu) / PIPE_OPS_PER_S,
                 (fma + alu) / INSTR_PER_S) * 1e3
    detail = (f"{bytes_moved} bytes -> {bytes_ms:.4f} ms; {fma} FMA-pipe + "
              f"{alu} ALU-pipe ops ({k * r} multiply-adds and {k * folds} "
              f"folds a column) -> {ops_ms:.4f} ms")
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


#: K9 (fields/csrc/shardsum.cu) and K10 (the fold of csrc/residues.cu),
#: counted from their sources. Both reduce a 64-bit word mod m by Barrett:
#: the high product v mu is 4 wide multiplies and 4 carry adds, q m's low
#: half 3 multiplies, v - q m 2 subtracts, the conditional subtract a
#: 64-bit compare and select (4): 7 on the FMA pipe, 10 on the ALU pipe.
#: K9 adds each further partial with a 64-bit add (2, ALU pipe); K10 flips
#: the word's sign bit (1), adds the fold constant mod m and accumulates
#: the column mod m (a 64-bit add, compare and select each: 6 + 6).
BARRETT_FMA_OPS = 7
BARRETT_ALU_OPS = 10
K10_ALU_OPS = 1 + BARRETT_ALU_OPS + 6 + 6


def _bytes_or_ops(bytes_moved: int, fma: float, alu: float, what: str):
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = max(max(fma, alu) / PIPE_OPS_PER_S,
                 (fma + alu) / INSTR_PER_S) * 1e3
    detail = (f"{bytes_moved} bytes -> {bytes_ms:.4f} ms; {fma:.0f} "
              f"FMA-pipe + {alu:.0f} ALU-pipe ops ({what}) -> "
              f"{ops_ms:.4f} ms")
    return (max(bytes_ms, ops_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", detail)


def k9_bound(p_shards: int, rows: int, cols: int, mask_cols: int = 0):
    """Least time (ms) the card could take for K9's combine of one d
    column, and what bounds it: the larger of its bytes (the p_shards
    [rows, cols] share partials and [mask_cols] mask partials read once,
    the [rows, cols] gathered rows and the [mask_cols] total written once,
    all int64) at the memory rate and its integer operations (p_shards - 1
    adds and one reduction an output) at a pipe's rate and at the issue
    rate. Returns (bound_ms, bound_by, detail)."""
    n = rows * cols + mask_cols
    fma = BARRETT_FMA_OPS * n
    alu = (2 * (p_shards - 1) + BARRETT_ALU_OPS) * n
    return _bytes_or_ops(8 * (p_shards + 1) * n, fma, alu,
                         f"{p_shards - 1} adds and a Barrett reduction an "
                         f"output")


def k10_bound(rows: int, cols: int):
    """Least time (ms) the card could take for K10's fold of a [rows,
    cols] int64 tile into its [cols] accumulator, and what bounds it: the
    larger of its bytes (the tile read once, the accumulator read and
    written once) at the memory rate and its integer operations (a sign
    flip, a Barrett reduction, the fold constant's and the accumulate's
    adds mod m an element) at a pipe's rate and at the issue rate.
    Returns (bound_ms, bound_by, detail)."""
    n = rows * cols
    return _bytes_or_ops(8 * n + 16 * cols, BARRETT_FMA_OPS * n,
                         K10_ALU_OPS * n,
                         f"{BARRETT_FMA_OPS} + {K10_ALU_OPS} an element")
