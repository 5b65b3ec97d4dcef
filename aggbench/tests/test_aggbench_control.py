"""The control comes out not correct: the reference accumulated in float32,
put in the program's place, fails the comparison at a size where its sums
pass 2^24, as they do at every cell's size (2^10 or more 16-bit values)."""

import copy

from aggbench.cell import load_cell
from aggbench.control import control_reading


def test_float32_control_is_not_correct():
    cell = copy.deepcopy(load_cell("cohort16k-full"))
    # 1,024 participants' values below 2^16: column sums up to 2^26
    cell["config"].update(participants=1024, dimension=200,
                          participants_chunk=250, dim_tile=96)
    for seed in (1, 2**31 + 5, 77):
        got = control_reading(cell, seed, rounds=4, device="cpu")
        assert got["elements"] == 800
        assert got["mismatched_elements"] > 0
        assert got["failed_rounds"] == 4
