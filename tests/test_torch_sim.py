"""The port's ``sda-sim`` (``sda_tpu_torch/cli/sim.py``) on the CPU: the
recipes of ``tests/test_cli.py`` (clerk dropout, multihost) and
``tests/test_gray_failure.py`` (repeatable ``--chaos-spec``), the mesh
modes held to the reference's ``sim.main`` on the same flags, the
``--device`` contract (no CPU fallback, ``--pallas`` only on CUDA) and the
drill profiles' dispatch with ``--device cpu``.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sda_tpu_torch import chaos
from sda_tpu_torch.cli import sim

ROOT = Path(__file__).resolve().parent.parent

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small tensor ops: with one intra-op thread they do not spin
    against the suite's other workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(capsys, argv, main=sim.main):
    rc = main(argv)
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), captured.err


# ---------------------------------------------------------------------------
# tests/test_cli.py's sda-sim recipes


def test_sim_cli_clerk_dropout(capsys):
    """``--drop-clerks``: the finale reveals exactly from the surviving
    quorum; below-quorum drops fail fast with a clear error."""
    rc, result, _ = _run(capsys, [
        "--participants", "8", "--dim", "99", "--clerks", "8",
        "--drop-clerks", "6", "--verify", "--device", "cpu"])
    assert rc == 0
    assert result["exact"] is True and result["dropped_clerks"] == [6]

    rc, _, err = _run(capsys, [
        "--participants", "8", "--dim", "99", "--clerks", "8",
        "--drop-clerks", "0,1,2,3,4", "--device", "cpu"])
    assert rc == 1
    assert "below the reconstruction threshold" in err


def test_sim_cli_multihost(capsys):
    """``--multihost 2`` spawns two worker processes over gloo and prints
    exactly one JSON result line, exact against the all-gathered plain
    sum; an invalid split is rejected before any process spawns."""
    rc = sim.main([
        "--participants", "8", "--dim", "24", "--clerks", "8",
        "--multihost", "2", "--devices-per-process", "4", "--verify",
        "--device", "cpu"])
    assert rc == 0
    out_lines = capsys.readouterr().out.strip().splitlines()
    assert len(out_lines) == 1
    result = json.loads(out_lines[0])
    assert result["mode"] == "multihost x2 simpod mesh (8, 1)"
    assert result["exact"] is True

    rc = sim.main([
        "--participants", "8", "--dim", "24", "--clerks", "8",
        "--multihost", "3", "--device", "cpu"])
    assert rc == 1


def test_sim_cli_multihost_streamed_chacha(capsys):
    """The streamed multihost mode with ChaCha masks over gloo: every
    process streams its own rows, one JSON line, exact."""
    rc = sim.main([
        "--participants", "8", "--dim", "40", "--multihost", "2",
        "--streaming", "--participants-chunk", "4", "--mask", "chacha",
        "--verify", "--device", "cpu"])
    assert rc == 0
    out_lines = capsys.readouterr().out.strip().splitlines()
    assert len(out_lines) == 1
    result = json.loads(out_lines[0])
    assert result["mode"].startswith("multihost x2 streamed mesh")
    assert result["exact"] is True


def test_cli_chaos_spec_flags_compose():
    """``sda-sim`` accepts repeated ``--chaos-spec`` flags and the merge
    rejects cross-flag conflicts (``tests/test_gray_failure.py``)."""
    from sda_tpu_torch.cli.serverd import build_parser as sdad_parser

    args = sdad_parser().parse_args(
        ["--memory", "--chaos-spec", "a=error", "--chaos-spec",
         "b=brownout:0.01,for=2", "httpd"])
    assert args.chaos_spec == ["a=error", "b=brownout:0.01,for=2"]
    args = sim.build_parser().parse_args(
        ["--chaos", "--chaos-spec", "a=error", "--chaos-spec", "b=kill"])
    assert args.chaos_spec == ["a=error", "b=kill"]
    with pytest.raises(ValueError, match="conflict"):
        chaos.configure_from_specs(args.chaos_spec + ["a=drop"])


# ---------------------------------------------------------------------------
# the mesh modes against the reference's sim.main


@pytest.mark.parametrize("flags", [
    [],
    ["--streaming", "--participants-chunk", "3"],
    ["--mask", "chacha"],
    ["--streaming", "--mask", "chacha", "--participants-chunk", "4"],
    ["--drop-clerks", "6"],
    ["--mask", "none", "--sharing", "basic", "--clerks", "5"],
], ids=["pod", "streaming", "chacha", "streaming-chacha", "drop-clerks",
        "basic"])
def test_mesh_modes_match_reference(capsys, monkeypatch, flags):
    from sda_tpu.cli import sim as ref_sim

    monkeypatch.setenv("SDA_SIM_PLATFORM", "cpu")
    argv = ["--participants", "10", "--dim", "61", "--verify", *flags]
    rc, got, _ = _run(capsys, [*argv, "--device", "cpu"])
    ref_rc, ref, _ = _run(capsys, argv, main=ref_sim.main)
    assert rc == ref_rc == 0
    assert got["exact"] is True
    for key in ("exact", "prime", "dim", "dropped_clerks", "participants",
                "clerks", "fast_path"):
        assert got[key] == ref[key], key
    # the mesh's shape follows each backend's device count
    assert got["mode"].split(" mesh")[0] == ref["mode"].split(" mesh")[0]


def test_parser_keeps_the_references_flags():
    """Every flag of the reference's parser, with its default, choices
    and type; the port adds ``--device`` (default cuda)."""
    from sda_tpu.cli import sim as ref_sim

    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                         a.type, a.nargs, a.const)
                for a in parser._actions}

    ours, ref = options(sim.build_parser()), options(ref_sim.build_parser())
    assert set(ours) - set(ref) == {"device"}
    assert {k: ours[k] for k in ref} == ref
    assert ours["device"][:2] == (("--device",), "cuda")


def test_streamed_report_names_the_tiling_that_ran(capsys, monkeypatch):
    """The streamed mode reports its tile count and tile 0's [rows, padded
    columns] as its aggregator stepped them, and the K1/K3 launches of
    its rounds (none on the CPU, where the plain versions run)."""
    from sda_tpu_torch.mesh import StreamingAggregator

    shapes = []
    step = StreamingAggregator._step

    def recording_step(self, block, *args):
        shapes.append(list(block.shape))
        return step(self, block, *args)

    monkeypatch.setattr(StreamingAggregator, "_step", recording_step)
    rc, result, _ = _run(capsys, [
        "--participants", "10", "--dim", "100", "--streaming",
        "--participants-chunk", "4", "--mask", "chacha", "--verify",
        "--device", "cpu"])
    assert rc == 0 and result["exact"] is True
    assert result["tiles"] == len(shapes) == 3
    assert result["tile_shape"] == shapes[0]
    assert result["launches"] == {"k1": 0, "k3": 0}


# ---------------------------------------------------------------------------
# --device: CUDA by default, no fallback; --pallas only on CUDA


def test_pallas_on_the_cpu_is_an_error(capsys):
    rc, result, err = _run(capsys, ["--participants", "4", "--dim", "24",
                                    "--pallas", "--device", "cpu"])
    assert rc == 1 and result is None
    assert "--pallas needs a CUDA device" in err


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the default runs")
def test_default_device_is_cuda_without_fallback():
    """``python -m sda_tpu_torch.cli.sim`` without ``--device`` asks for
    CUDA and raises without it: no result line, no CPU round."""
    res = subprocess.run(
        [sys.executable, "-m", "sda_tpu_torch.cli.sim", "--participants",
         "8", "--dim", "24"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "RuntimeError: CUDA is not available" in res.stderr


# ---------------------------------------------------------------------------
# the profiles' dispatch with --device cpu


def test_devscale_profile_on_the_cpu(capsys):
    rc, record, _ = _run(capsys, [
        "--devscale", "--devscale-dim", "25000", "--devscale-shards", "4x2",
        "--devscale-rounds", "2", "--device", "cpu"])
    assert rc == 0
    assert record["exact"] and record["ok"]
    assert record["dim"] == 25000 and record["p_shards"] == 4
    assert record["platform"] == "cpu"


def test_tree_profile_on_the_cpu(capsys):
    rc, report, _ = _run(capsys, ["--tree", "--participants", "12", "--dim",
                                  "4", "--tree-group-size", "4",
                                  "--tree-sim", "2000",
                                  "--device", "cpu"])
    assert rc == 0
    assert report["exact"] and report["flat_exact"]


def test_fl_profile_on_the_cpu(capsys):
    rc, report, _ = _run(capsys, ["--fl", "--participants", "4",
                                  "--fl-rounds", "1", "--device", "cpu"])
    assert report["exact"] is True and report["platform"] == "cpu"
    assert rc == (0 if report["reached_target"] else 1)


def test_soak_profile_on_the_cpu(capsys):
    rc, report, _ = _run(capsys, ["--soak", "--soak-tenants", "1",
                                  "--soak-epochs", "2", "--device", "cpu"])
    assert rc == 0
    assert report["exact"] and report["rounds_exact"] == 2
