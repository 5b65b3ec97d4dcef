"""The port's bench twin (``python -m sda_tpu_torch.benchmarks.bench``)
and its ``sda-bench`` front-end, on the CPU at P=8 x d=3,003: every lane
exact, the line's keys and tags, the aggregate against the JAX package's
``single_chip_round`` on the same seeded inputs, no CPU line when the card
was asked for, and the gate on twin lines."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.mesh import single_chip_round as ref_single_chip_round
from sda_tpu.protocol import FullMasking as RefFullMasking
from sda_tpu.protocol import PackedShamirSharing as RefPackedShamir

from sda_tpu_torch.benchmarks import bench
from sda_tpu_torch.cli import bench as sda_bench

ROOT = Path(__file__).resolve().parent.parent
P, D = 8, 3003
SMALL = ["--participants", str(P), "--dim", str(D), "--seconds", "0.01",
         "--dim-tile", "1200", "--stream-pc", "3"]
#: the reference bench line's keys (bench.py:121-157, 161, 188, 210)
REFERENCE_KEYS = {"metric", "value", "unit", "vs_baseline", "platform",
                  "device_kind", "pallas", "execution",
                  "round_seconds_marginal", "compile_seconds", "timing",
                  "probe_s", "chain", "fixed_overhead_s", "roofline", "xla",
                  "dim_tiled", "streamed"}


@pytest.fixture(scope="module")
def line():
    return bench.run(bench.build_parser().parse_args(
        ["--device", "cpu", *SMALL]))


def test_every_lane_is_exact(line):
    assert line["exact"] is True
    assert line["dim_tiled"]["exact"] is True
    assert line["dim_tiled"]["tiles"] == 3          # 3003 in 1200 columns
    assert line["streamed"]["exact"] is True
    assert line["streamed"]["steps"] == 3           # 8 = 3 + 3 + 2


def test_line_keys_and_tags(line):
    assert REFERENCE_KEYS <= set(line)
    assert line["framework"] == "torch"
    assert line["platform"] == "cpu" and line["device_kind"] == "cpu"
    assert line["power_limit"] is None
    assert line["pallas"] is True and line["execution"] == "monolithic"
    assert line["metric"] == (
        "secure-aggregated shared-elements/sec/chip (Packed-Shamir n=8 t=4 "
        f"p={(1 << 29) - 679}, full mask, {P} x {D})")
    assert line["rounds"] == 10
    assert line["round_seconds_min"] <= line["round_seconds_median"] \
        <= line["round_seconds_max"]
    assert line["value"] == round(P * D / line["round_seconds_median"])
    assert line["round_seconds_marginal"] > 0
    assert line["chain"]["r2"] >= 10
    json.loads(json.dumps(line))


def test_launch_counts_and_calls(line):
    # the plain versions run on the CPU and count no launch; every lane's
    # calls are recorded for the card's launch check
    assert line["k1_launches"] == {"monolithic": 0, "tiled": 0,
                                   "streamed": 0}
    chain = line["chain"]
    # warm-up, timed rounds, the marginal's probe and chains, the profiled
    # pass with its dropped warm-up round
    assert line["round_calls"] == (1 + 10 + 1 + chain["r1"] + chain["r2"]
                                   + 1 + bench.PROFILE_ROUNDS)
    assert line["streamed"]["round_calls"] == 11
    functions = line["xla"]["functions"]
    assert functions["bench.round"]["calls"] == line["round_calls"]
    assert functions["bench.round"]["compiles"] == 0
    assert functions["stream.step"]["calls"] == 3 * 11
    assert len(functions["stream.step"]["block_shapes"]) == 2


def test_roofline_hbm_and_profile(line):
    roof = line["roofline"]
    assert roof["platform"] == "cpu" and roof["basis"] == "per_call"
    assert roof["ops_unit"] == "int32/int64 pipe ops, counted"
    assert set(roof["phases"]) == {"bench.round"}
    assert roof["bytes"] == P * D * 4 + D * 8
    assert 0 < roof["utilization"] <= 1.05
    assert line["hbm"]["hbm_peak_bytes"] == 0 and "note" in line["hbm"]
    prof = line["device_profile"]
    assert prof["device_lanes"] == 0 and prof["busy_share"] is None
    assert prof["k1_median_ms"] is None


def test_aggregate_equals_the_jax_round():
    """The twin's round on its flagship inputs gives what the JAX
    package's single_chip_round gives on the same numpy inputs."""
    from sda_tpu_torch.fields.fused_round import single_chip_round_pallas

    scheme, masking, host = bench.flagship(P, D)
    p = scheme.prime_modulus
    np.testing.assert_array_equal(
        host, np.random.default_rng(0).integers(0, 1 << 20, size=(P, D),
                                                dtype=np.uint32))
    got = single_chip_round_pallas(scheme, masking, device="cpu")(
        torch.from_numpy(host), torch.Generator().manual_seed(1))
    ref_scheme = RefPackedShamir(3, 8, scheme.privacy_threshold, p,
                                 scheme.omega_secrets, scheme.omega_shares)
    want = jax.jit(ref_single_chip_round(ref_scheme, RefFullMasking(p)))(
        jnp.asarray(host), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  host.astype(np.int64).sum(0) % p)


def test_without_cpu_flag_it_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--device", "cuda", *SMALL])


@pytest.mark.parametrize("lanes", ["tiled,streamed", "monolithic,warp"])
def test_lanes_are_validated(lanes):
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu", "--lanes", lanes, *SMALL])
    assert exc.value.code == 2


def test_env_leaves_lanes_out(monkeypatch):
    monkeypatch.setenv("SDA_BENCH_TILED", "0")
    monkeypatch.setenv("SDA_BENCH_STREAMED", "0")
    assert bench._lanes(None) == ["monolithic"]
    monkeypatch.setenv("SDA_BENCH_STREAMED", "1")
    assert bench._lanes(None) == ["monolithic", "streamed"]
    assert bench._lanes("monolithic, tiled") == ["monolithic", "tiled"]


def _sda_bench(*args):
    return subprocess.run(
        [sys.executable, "-m", "sda_tpu_torch.cli.bench", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_sda_bench_run_forwards_one_line_and_exit_code():
    res = _sda_bench("--run", "--device", "cpu", "--participants", "4",
                     "--dim", "300", "--seconds", "0.01", "--lanes",
                     "monolithic")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["framework"] == "torch" and rec["platform"] == "cpu"
    assert rec["exact"] is True
    if not torch.cuda.is_available():
        res = _sda_bench("--run", "--participants", "4", "--dim", "300")
        assert res.returncode != 0
        assert res.stdout == ""
        assert "CUDA is not available" in res.stderr


def test_sda_bench_check_flags_a_2x_regression_of_twin_lines(line,
                                                             tmp_path):
    paths = []
    for n, scale in enumerate((1.0, 1.02, 0.98, 0.5)):
        rec = dict(line, value=line["value"] * scale,
                   round_seconds_marginal=line["round_seconds_marginal"]
                   / scale, chain={}, fixed_overhead_s=0.0)
        path = tmp_path / f"twin{n}.json"
        path.write_text(json.dumps(rec))
        paths.append(str(path))
    assert sda_bench.main(["--check", *paths[:3]]) == 0
    assert sda_bench.main(["--check", *paths]) == 1
    assert sda_bench.main(["--check", "--advisory", *paths]) == 0
