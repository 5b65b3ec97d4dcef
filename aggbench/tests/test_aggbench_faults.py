"""A run whose timed path is broken underneath comes out not correct.

Each test drives ``run.run_cell`` (everything of a run but the look for a
chip) on the CPU, where the program runs its kernels' plain versions, at a
tiny size, with one fault planted in the program's entry: a step that
returns its state unchanged; half of the batch left out and the rest
counted twice (the sum's form of a mean over the rest); in the first dim
tile, one participant chunk read twice and the next one dropped; for the
first participant chunk, one dim tile's columns read in another's place;
an answer altered where it is produced. The cells
run on one chip, so no exchange between chips can be left out. Unbroken,
the same runs come out correct.
"""

import copy
import time

import pytest
import torch

from aggbench import run
from aggbench.cell import load_cell
from sda_tpu_torch.mesh import StreamedPod, StreamingAggregator

#: ragged in both: a participant tail of 2, a dim tile of 4 (of 48 and 48)
TINY = dict(participants=14, dimension=100, participants_chunk=4,
            dim_tile=48)
#: the cells (the single-device aggregator), and the pod entry that the
#: harness also drives: (cell, configuration changes, entry class)
CELLS = {"cohort16k-chacha": ("cohort16k-chacha", {}, StreamingAggregator),
         "cohort16k-full": ("cohort16k-full", {}, StreamingAggregator),
         "pod-full": ("cohort16k-full", {"entry": "pod", "mesh": [1, 1]},
                      StreamedPod)}


def _state_unchanged(orig):
    def step(self, block, tile_seed, round_seed, p0, dblk0, acc_shares,
             acc_mask, **kw):
        return acc_shares, acc_mask
    return step


def _half_batch(orig):
    def step(self, block, *args, **kw):
        half = block[: block.shape[0] // 2]
        return orig(self, torch.cat([half, half]), *args, **kw)
    return step


def _chunk_repeated(orig):
    """In the first dim tile, the second participant chunk reads the first
    one's rows: one chunk counted twice, the next one left out."""
    def aggregate_blocks(self, get_block, participants, dimension, **kw):
        pc = self.participants_chunk

        def faulty(p0, p1, d0, d1):
            if p0 == pc and d0 == 0:
                return get_block(0, p1 - p0, d0, d1)
            return get_block(p0, p1, d0, d1)
        return orig(self, faulty, participants, dimension, **kw)
    return aggregate_blocks


def _tile_repeated(orig):
    """For the first participant chunk, the second dim tile reads the
    first one's columns."""
    def aggregate_blocks(self, get_block, participants, dimension, **kw):
        dc = self.dim_chunk

        def faulty(p0, p1, d0, d1):
            if d0 == dc and p0 == 0:
                return get_block(p0, p1, 0, d1 - d0)
            return get_block(p0, p1, d0, d1)
        return orig(self, faulty, participants, dimension, **kw)
    return aggregate_blocks


def _answer_altered(orig):
    def final(self, *args, **kw):
        out = orig(self, *args, **kw).clone()
        out[1] += 1
        return out
    return final


FAULTS = {"state_unchanged": ("_step", _state_unchanged),
          "half_batch": ("_step", _half_batch),
          "chunk_repeated": ("aggregate_blocks", _chunk_repeated),
          "tile_repeated": ("aggregate_blocks", _tile_repeated),
          "answer_altered": ("_final", _answer_altered)}


def _run(name, seconds=0.05):
    workload, changes, _ = CELLS[name]
    cell = copy.deepcopy(load_cell(workload))
    cell["config"].update(TINY, **changes)
    return run.run_cell(cell, 2**31 + 99, seconds, False, device="cpu",
                        t_start=time.perf_counter())


@pytest.mark.parametrize("name", sorted(CELLS))
def test_unbroken_run_is_correct(name):
    res = _run(name)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert res["checks"] == {"mismatched_elements": {"value": 0,
                                                     "limit": 0}}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(CELLS))
def test_broken_run_is_not_correct(name, fault, monkeypatch):
    cls = CELLS[name][2]
    attr, make = FAULTS[fault]
    monkeypatch.setattr(cls, attr, make(getattr(cls, attr)))
    res = _run(name)
    assert res["correct"] is False
    assert res["failed"] == res["attempted"]
    assert res["checks"]["mismatched_elements"]["value"] > 0


def test_past_the_cap_a_sample_of_rounds_is_compared(monkeypatch):
    monkeypatch.setattr(run, "KEEP_BYTES", 2 * TINY["dimension"] * 8)
    res = _run("pod-full", seconds=0.5)
    assert res["correct"] is True
    assert res["compared_rounds"] == 2 < res["attempted"]
    attr, make = FAULTS["answer_altered"]
    monkeypatch.setattr(StreamedPod, attr, make(getattr(StreamedPod, attr)))
    res = _run("pod-full", seconds=0.5)
    assert res["correct"] is False and res["failed"] == 2
