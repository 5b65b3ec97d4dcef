"""The frozen roofline counts against values worked out by hand at one
full tile of the cells, [250, 3,145,728] (B = 1,048,576 packed columns)."""

import pytest

from aggbench import bounds

ROWS, WIDTH = 250, 3_145_728
B = WIDTH // 3
HBM = 3.35e12
#: a pipe's integer rate: 132 SMs x 64 lanes at the clock that the fp32
#: peak of 67 TFLOP/s (132 SMs x 128 lanes x 2) implies
PIPE = 67e12 / 4


def test_k8_residue_pass_is_bound_by_bytes():
    # int64 in, int32 out: 12 bytes an element
    want = ROWS * WIDTH * 12 / HBM * 1e3
    ms, by, _ = bounds.residues_bound(ROWS * WIDTH, 8)
    assert by == "bytes"
    assert ms == pytest.approx(want, rel=1e-12)
    assert ms == pytest.approx(2.81707, abs=1e-5)


def test_k1_unmasked_tile_is_bound_by_bytes():
    # 3 int32 input words a column and participant; 8 share rows written
    # and 8 accumulator rows read, int64
    muls, xors = bounds.philox_ops(3, 4, False)
    assert (muls, xors) == (45, 51)  # 3 Philox blocks of 15 and 17
    want = (ROWS * 3 * B * 4 + 16 * B * 8) / HBM * 1e3
    ms, by, _ = bounds.k1_bound(ROWS, B, 3, 4, True, 8, muls, xors,
                                acc_rows=8)
    assert by == "bytes"
    assert ms == pytest.approx(want, rel=1e-12)
    assert ms == pytest.approx(0.979088, abs=1e-6)


def test_k1_masked_tile_is_bound_by_the_alu_pipe():
    # 7 drawn rows: 60 multiplies and 68 xors; 3 + 14 accumulates, each an
    # ALU-pipe add
    muls, xors = bounds.philox_ops(3, 4, True)
    assert (muls, xors) == (60, 68)
    want = ROWS * B * (68 + 17) / PIPE * 1e3
    ms, by, _ = bounds.k1_bound(ROWS, B, 3, 7, True, 11, muls, xors,
                                acc_rows=11)
    assert by == "operations"
    assert ms == pytest.approx(want, rel=1e-12)
    assert ms == pytest.approx(1.330283, abs=1e-6)


def test_k3_mask_op_is_bound_by_its_busier_pipe():
    blocks = ROWS * (WIDTH // 8)
    draws = ROWS * WIDTH
    alu = blocks * 640 + ROWS * 40                  # rounds, derived keys
    fma = draws * 7 * 2 + ROWS * 40                 # two reductions a draw
    either = blocks * 336 + draws * (17 + 21 + 2 * 6)
    want = max(alu, fma, -(-(alu + fma + either) // 2)) / PIPE * 1e3
    ms, by, _ = bounds.k3_bound(ROWS, WIDTH, "mask", 4, derived=True,
                                accumulate=True)
    assert by == "operations"
    assert ms == pytest.approx(want, rel=1e-12)
    assert ms == pytest.approx(4.36646, abs=1e-5)
