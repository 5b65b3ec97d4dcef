"""utils.benchtime of the port: the chained marginal timer and the bench
knobs, mirroring tests/test_benchtime.py on torch dispatches (on the CPU
here; on a card each chain ends in a synchronize)."""

import pytest
import torch

from sda_tpu_torch.utils import benchtime
from sda_tpu_torch.utils.benchtime import chain_seconds, marginal_seconds


def _dispatch(work=2048):
    x = torch.arange(work, dtype=torch.float32)

    def d(i):
        return torch.sin(x + i).sum()

    return d


def test_chain_seconds_scales_with_reps():
    d = _dispatch(1 << 18)
    chain_seconds(d, 1)  # warm
    t1 = chain_seconds(d, 1)
    t40 = chain_seconds(d, 40)
    assert t1 > 0
    # 40 serialized reps must exceed 1: catches a regression that
    # ignores the reps argument
    assert t40 > t1


def test_marginal_seconds_respects_max_reps_and_reports_chain():
    per, info = marginal_seconds(_dispatch(), target_seconds=0.2, max_reps=7)
    assert per > 0
    chain = info["chain"]
    # r2 is clamped by max_reps even though max(10, ...) wants more
    assert chain["r2"] <= 7
    assert 1 <= chain["r1"] <= chain["r2"]
    assert info["probe_s"] > 0
    assert info["fixed_overhead_s"] >= 0


def test_marginal_seconds_fallback_when_difference_is_noise():
    # max_reps=1 forces r1 == r2 == 1: the (t2-t1)/(r2-r1) form is
    # undefined, so the helper falls back to t2/r2
    per, info = marginal_seconds(_dispatch(), target_seconds=0.1, max_reps=1)
    assert per > 0
    assert info["chain"]["r1"] == info["chain"]["r2"] == 1


def test_marginal_cancels_the_fixed_overhead(monkeypatch):
    """On a clock that each dispatch advances by 2 ms and each drain by
    30 ms (the fixed launch-and-sync overhead), the marginal is the 2 ms
    a rep, the overhead is reported, and the marginal stays below the
    1-rep probe (the reference's sanity check, exact here)."""
    clock = {"t": 100.0}

    class FakeTime:
        @staticmethod
        def perf_counter():
            return clock["t"]

    def dispatch(i):
        clock["t"] += 0.002
        return i

    def drain(out):
        clock["t"] += 0.030

    monkeypatch.setattr(benchtime, "time", FakeTime)
    monkeypatch.setattr(benchtime, "_drain", drain)
    per, info = marginal_seconds(dispatch, target_seconds=0.5, max_reps=32)
    assert per == pytest.approx(0.002)
    # r2 = 0.5 s over the 32 ms probe, r1 = r2 // 5
    assert info["chain"]["r2"] == 16 and info["chain"]["r1"] == 3
    assert info["probe_s"] == pytest.approx(0.032)
    assert info["fixed_overhead_s"] == pytest.approx(0.030)
    assert per <= info["probe_s"]


def test_chain_drains_only_a_card(monkeypatch):
    # a CPU output is complete when the call returns: no synchronize; the
    # drain keys on the LAST output of the chain
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: synced.append(dev))
    chain_seconds(lambda i: torch.ones(2), 3)
    chain_seconds(lambda i: None, 2)
    assert synced == []


def test_knobs_default_without_env(monkeypatch):
    for var in ("SDA_PALLAS_DIMTILE", "SDA_BENCH_STREAM_PC"):
        monkeypatch.delenv(var, raising=False)
    assert benchtime.dim_tile_knob() == benchtime.DEFAULT_DIM_TILE == 262_144
    assert benchtime.stream_pc_knob() == 64
    assert benchtime.dim_tile_knob(default=1200) == 1200


@pytest.mark.parametrize("env,want", [("0", None), ("4800", 4800)])
def test_dim_tile_knob_env(monkeypatch, env, want):
    monkeypatch.setenv("SDA_PALLAS_DIMTILE", env)
    assert benchtime.dim_tile_knob() == want


def test_stream_pc_knob_env(monkeypatch):
    monkeypatch.setenv("SDA_BENCH_STREAM_PC", "100")
    assert benchtime.stream_pc_knob() == 100


def test_tpu_sweep_knobs_not_carried_over():
    for name in ("pallas_knobs", "tile_from_sweep", "export_knobs_to_env",
                 "tree_fold_knob"):
        assert not hasattr(benchtime, name), name
