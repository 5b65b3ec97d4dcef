"""The benchmark's inputs and its plain reference: the map covers every
(participant, column) once, blocks are read in place and aligned, no two
chunks of a round hold the same values, consecutive rounds differ, and
the reference is the brute-force int64 sum mod p."""

import numpy as np
import pytest
import torch

from aggbench import inputs
from aggbench.reference import Reference, mismatched_elements

P_MOD = 536_870_233


def _tiling(P, d, pc, dc):
    return [(p0, min(p0 + pc, P), d0, min(d0 + dc, d))
            for d0 in range(0, d, dc) for p0 in range(0, P, pc)]


def _pool(P, d, pc, dc, seed, value_bits=20):
    return inputs.make_pool(min(pc, P), min(dc, d), value_bits, seed, "cpu")


def _materialize(pool, r, P, d, pc, dc):
    get = inputs.provider(pool, r, P, d, pc, dc)
    full = torch.full((P, d), -1, dtype=torch.int64)
    hits = torch.zeros((P, d), dtype=torch.int64)
    for p0, p1, d0, d1 in _tiling(P, d, pc, dc):
        full[p0:p1, d0:d1] = get(p0, p1, d0, d1)
        hits[p0:p1, d0:d1] += 1
    return full, hits


@pytest.mark.parametrize("P,d,pc,dc", [(12, 50, 4, 16), (10, 48, 4, 24),
                                       (7, 13, 7, 13)])
def test_map_covers_each_participant_and_column_once(P, d, pc, dc):
    pool = _pool(P, d, pc, dc, 5)
    for r in range(4):
        full, hits = _materialize(pool, r, P, d, pc, dc)
        assert torch.equal(hits, torch.ones_like(hits))
        assert int(full.min()) >= 0 and int(full.max()) < 1 << 20


def test_blocks_are_read_in_place():
    pool = _pool(10, 40, 4, 16, 5)
    get = inputs.provider(pool, 3, 10, 40, 4, 16)
    for p0, p1, d0, d1 in _tiling(10, 40, 4, 16):
        block = get(p0, p1, d0, d1)
        assert block.is_contiguous()
        assert block.shape == (p1 - p0, d1 - d0)
        base = [b for b in pool if b.untyped_storage().data_ptr()
                == block.untyped_storage().data_ptr()]
        assert len(base) == 1
        assert (block.data_ptr() - base[0].data_ptr()) % 512 == 0


@pytest.mark.parametrize("P,d,pc,dc", [(12, 50, 4, 16), (10, 48, 4, 24)])
def test_no_two_chunks_of_a_round_hold_the_same_values(P, d, pc, dc):
    pool = _pool(P, d, pc, dc, 9)
    get = inputs.provider(pool, 0, P, d, pc, dc)
    seen = []
    for p0, p1, d0, d1 in _tiling(P, d, pc, dc):
        block = get(p0, p1, d0, d1)
        for other in seen:
            assert other.shape != block.shape or not torch.equal(other,
                                                                 block)
        seen.append(block)


def test_consecutive_rounds_differ_and_seeds_are_large():
    chunks, tiles = 66, 6
    for r in range(100):
        now = {(inputs.block_index(r, c, t, chunks),
                inputs.window_index(r, c, t, chunks, tiles))
               for t in range(tiles) for c in range(chunks)}
        nxt = {(inputs.block_index(r + 1, c, t, chunks),
                inputs.window_index(r + 1, c, t, chunks, tiles))
               for t in range(tiles) for c in range(chunks)}
        assert len(now) == chunks * tiles
        assert not now & nxt
    with pytest.raises(ValueError, match="windows"):
        inputs.window_index(0, 0, 0, inputs.WINDOWS + 1, 1)
    big = 2**31 + 7_654_321
    assert inputs.round_seed(big, 0) != inputs.round_seed(big, 1)
    assert 0 <= inputs.round_seed(2**64 + 3, 9) < 1 << 62
    a = inputs.make_pool(4, 8, 20, big, "cpu")
    b = inputs.make_pool(4, 8, 20, big, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("P,d,pc,dc", [(12, 50, 4, 16), (9, 30, 4, 30)])
def test_reference_is_the_brute_force_sum(P, d, pc, dc):
    pool = _pool(P, d, pc, dc, 11)
    ref = Reference(pool, P, d, pc, dc, P_MOD)
    outs = []
    for r in range(5):
        full, _ = _materialize(pool, r, P, d, pc, dc)
        want = np.array([int(sum(int(v) for v in full[:, j])) % P_MOD
                         for j in range(d)], dtype=np.int64)
        assert np.array_equal(ref.aggregate(r), want)
        outs.append((r, want))
    assert mismatched_elements(ref, outs) == dict.fromkeys(range(5), 0)
    wrong = want.copy()
    wrong[3] = (wrong[3] + 1) % P_MOD
    assert mismatched_elements(ref, [(4, wrong), (2, want[:-1])]) == {
        4: 1, 2: d}
