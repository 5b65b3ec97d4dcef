"""The regression gate of both packages (``sda_tpu.obs.regress`` and the
port's copy, ``sda_tpu_torch.obs.regress``, with their ``sda-bench``
front-ends): tests/test_regress.py's cases, each run against both, and the
port's ``framework`` key — a torch record never gates against the JAX
package's history, and torch records gate among themselves."""

import glob
import importlib
import json
import os

import pytest

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "regress")


@pytest.fixture(params=["sda_tpu", "sda_tpu_torch"])
def pkg(request):
    return request.param


@pytest.fixture
def regress(pkg):
    return importlib.import_module(f"{pkg}.obs.regress")


def _fx(*names):
    return [os.path.join(FIXTURES, n) for n in names]


def _history(*extra):
    base = [f"BENCH_r{n:02d}.json" for n in range(1, 6)]
    return _fx(*base, *extra)


# -- tests/test_regress.py's scenarios, on both packages ---------------------

def test_clean_trajectory_passes(regress):
    assert regress.main(_history()) == 0
    result = regress.check(regress.load_records(_history()))
    assert result["checked"]
    assert result["regressions"] == []
    assert any("r01" in s["path"] for s in result["skipped"])


def test_clean_continuation_passes(regress):
    assert regress.main(_history("BENCH_r06_clean.json")) == 0


def test_synthetic_2x_slowdown_is_confirmed_regression(regress):
    paths = _history("BENCH_r06_regression.json")
    assert regress.main(paths) == 1
    result = regress.check(regress.load_records(paths))
    assert "value" in result["regressions"]
    assert "round_seconds_marginal" in result["regressions"]
    by_metric = {r["metric"]: r for r in result["rows"]}
    assert by_metric["value"]["verdict"] == "REGRESSION"
    assert not by_metric.get("compile_seconds", {"gates": False})["gates"]


def test_noisy_within_threshold_passes(regress):
    paths = _history("BENCH_r06_noisy.json")
    assert regress.main(paths) == 0
    result = regress.check(regress.load_records(paths))
    row = {r["metric"]: r for r in result["rows"]}["value"]
    assert row["delta"] < -0.10
    assert row["verdict"].startswith("pass")


def test_error_record_as_newest_is_skipped_not_flagged(regress):
    paths = _history("BENCH_r06_error.json")
    assert regress.main(paths) == 0
    result = regress.check(regress.load_records(paths))
    assert any("r06_error" in s["path"] for s in result["skipped"])
    assert result["newest"].endswith("BENCH_r05.json")
    assert result["regressions"] == []


def test_advisory_mode_reports_but_exits_zero(regress, capsys):
    paths = _history("BENCH_r06_regression.json")
    assert regress.main(paths + ["--advisory"]) == 0
    assert "REGRESSION" in capsys.readouterr().out


def test_malformed_record_exits_2(regress, tmp_path):
    bad = tmp_path / "BENCH_r99.json"
    bad.write_text("this is not json")
    assert regress.main(_history() + [str(bad)]) == 2
    shapeless = tmp_path / "BENCH_r98.json"
    shapeless.write_text(json.dumps({"hello": "world"}))
    assert regress.main(_history() + [str(shapeless)]) == 2


def test_platform_mismatch_is_not_compared(regress, tmp_path):
    rec = json.load(open(_fx("BENCH_r05.json")[0]))
    rec["n"] = 6
    rec["parsed"]["platform"] = "tpu"
    rec["parsed"]["value"] = rec["parsed"]["value"] * 700
    path = tmp_path / "BENCH_r06.json"
    path.write_text(json.dumps(rec))
    result = regress.check(regress.load_records(_history() + [str(path)]))
    assert not result["checked"]
    assert "insufficient comparable history" in result["note"]


def test_codec_tagged_record_is_not_compared_to_untagged_history(regress):
    paths = _history("BENCH_r06_codec_bin.json")
    result = regress.check(regress.load_records(paths))
    assert not result["checked"]
    assert "insufficient comparable history" in result["note"]
    assert regress.main(paths) == 0


def test_codec_tagged_records_gate_among_themselves(regress, tmp_path):
    base = json.load(open(_fx("BENCH_r06_codec_bin.json")[0]))
    paths = []
    for n, value in enumerate([3600000, 3650000, 3580000, 1700000], start=6):
        rec = json.loads(json.dumps(base))
        rec["n"] = n
        rec["parsed"]["value"] = value
        rec["parsed"]["round_seconds_marginal"] = 1e7 / value
        path = tmp_path / f"BENCH_r{n:02d}.json"
        path.write_text(json.dumps(rec))
        paths.append(str(path))
    result = regress.check(regress.load_records(_history() + paths))
    assert result["checked"]
    assert "value" in result["regressions"]


def test_devscale_tags_open_their_own_trajectory(regress, tmp_path):
    base = {"metric": "model-scale device round elements/sec",
            "platform": "cpu", "dim": 100_000_000, "p_shards": 4,
            "d_shards": 2, "pallas": False}
    paths = []
    for n, value in enumerate([5_000_000, 5_100_000, 4_900_000], start=1):
        path = tmp_path / f"BENCH_d{n:02d}.json"
        path.write_text(json.dumps(dict(base, value=value)))
        paths.append(str(path))
    slow = tmp_path / "BENCH_d09.json"
    slow.write_text(json.dumps(dict(base, value=2_400_000)))
    result = regress.check(regress.load_records(paths + [str(slow)]))
    assert result["checked"] and "value" in result["regressions"]
    for n, tags in enumerate([{"p_shards": 8, "d_shards": 1},
                              {"pallas": True}, {"dim": 3_731_890}],
                             start=10):
        other = tmp_path / f"BENCH_d{n:02d}.json"
        other.write_text(json.dumps(dict(base, value=2_400_000, **tags)))
        assert not regress.check(regress.load_records(
            paths + [str(other)]))["checked"], tags


def test_devscale_advisory_metrics_reported_not_gated(regress, tmp_path):
    base = {"metric": "model-scale device round elements/sec",
            "platform": "cpu", "dim": 1000, "p_shards": 4, "d_shards": 2,
            "pallas": False, "value": 5_000_000,
            "roofline_utilization": 0.5, "hbm_watermark_ratio": 0.4}
    paths = []
    for n in range(3):
        path = tmp_path / f"BENCH_a{n:02d}.json"
        path.write_text(json.dumps(base))
        paths.append(str(path))
    worse = tmp_path / "BENCH_a09.json"
    worse.write_text(json.dumps(dict(base, roofline_utilization=0.1,
                                     hbm_watermark_ratio=0.99)))
    result = regress.check(regress.load_records(paths + [str(worse)]))
    rows = {r["metric"]: r for r in result["rows"]}
    assert not rows["roofline_utilization"]["gates"]
    assert not rows["hbm_watermark_ratio"]["gates"]
    assert result["regressions"] == []
    assert regress.main(paths + [str(worse)]) == 0


def test_record_carried_direction_lower(regress, tmp_path):
    def record(n, value):
        path = tmp_path / f"FL_r{n:02d}.json"
        path.write_text(json.dumps({
            "metric": "rounds to target accuracy 0.8 (secure FedAvg)",
            "value": value, "direction": "lower", "unit": "rounds",
            "platform": "cpu", "seed": 1,
        }))
        return str(path)

    history = [record(n, v) for n, v in enumerate([3, 3, 4])]
    worse = regress.check(regress.load_records(history + [record(9, 8)]))
    assert worse["checked"] and "value" in worse["regressions"]
    better = regress.check(regress.load_records(history + [record(9, 2)]))
    assert better["checked"] and better["regressions"] == []


def test_json_output_mode(regress, capsys):
    assert regress.main(_history() + ["--json"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    parsed = json.loads(out)
    assert parsed["checked"] and parsed["regressions"] == []


def test_raw_bench_line_appended_after_wrappers_is_gated(regress, tmp_path):
    slow = json.load(open(_fx("BENCH_r06_regression.json")[0]))["parsed"]
    path = tmp_path / "fresh_run.json"
    path.write_text(json.dumps(slow))
    paths = _history() + [str(path)]
    result = regress.check(regress.load_records(paths))
    assert result["newest"] == str(path)
    assert "value" in result["regressions"]
    assert regress.main(paths) == 1


def test_committed_bench_trajectory_gates_green(regress):
    committed = sorted(glob.glob(os.path.join(regress.repo_root(),
                                              "BENCH_r*.json")))
    assert len(committed) >= 3
    assert committed == regress.default_paths()
    assert regress.main(committed) == 0


def test_committed_trajectory_with_synthetic_2x_slowdown_fails(regress,
                                                               tmp_path):
    committed = regress.default_paths()
    real = [e for e in regress.load_records(committed)
            if e["record"] is not None]
    newest = next(
        e for e in reversed(real)
        if sum(regress._comparable(e["record"], other["record"])
               for other in real if other is not e) >= 2)
    slow = {"n": 99, "cmd": "synthetic", "rc": 0, "tail": "",
            "parsed": dict(newest["record"])}
    slow["parsed"]["value"] = newest["record"]["value"] / 2
    if isinstance(newest["record"].get("round_seconds_marginal"),
                  (int, float)):
        slow["parsed"]["round_seconds_marginal"] = \
            newest["record"]["round_seconds_marginal"] * 2
    path = tmp_path / "BENCH_r99.json"
    path.write_text(json.dumps(slow))
    assert regress.main(committed + [str(path)]) == 1


def test_sda_bench_check_forwards_to_regress(pkg):
    sda_bench = importlib.import_module(f"{pkg}.cli.bench")
    assert sda_bench.main(["--check", *_history()]) == 0
    assert sda_bench.main(
        ["--check", *_history("BENCH_r06_regression.json")]) == 1
    assert sda_bench.main(
        ["--check", "--advisory",
         *_history("BENCH_r06_regression.json")]) == 0


# -- the port's framework key -----------------------------------------------

def _torch_line(value, n=None, **tags):
    """A bench line of the port's twin (CPU platform, the flagship metric
    string of BENCH_r05), in the committed records' wrapper shape when
    ``n`` is given."""
    rec = json.load(open(_fx("BENCH_r05.json")[0]))["parsed"]
    rec = dict(rec, value=value, framework="torch",
               round_seconds_marginal=1e10 / value, **tags)
    rec.pop("chain"), rec.pop("fixed_overhead_s")
    return rec if n is None else {"n": n, "rc": 0, "parsed": rec}


def _write(tmp_path, name, obj):
    path = tmp_path / name
    path.write_text(json.dumps(obj))
    return str(path)


def test_torch_line_never_gates_against_jax_history(tmp_path):
    from sda_tpu_torch.obs import regress

    # the same platform and metric string as BENCH_r02-r05, at half their
    # mean: gated against them it would be a confirmed regression
    slow = _write(tmp_path, "BENCH_r06.json", _torch_line(3_000_000, n=6))
    result = regress.check(regress.load_records(_history() + [slow]))
    assert result["newest"] == slow
    assert not result["checked"]
    assert "insufficient comparable history" in result["note"]
    assert regress.main(_history() + [slow]) == 0
    # ... while the JAX package's gate, which has no framework key, does
    # read it as one (the fault this key closes)
    from sda_tpu.obs import regress as ref

    assert ref.main(_history() + [slow]) == 1


def test_jax_line_never_gates_against_torch_history(tmp_path):
    from sda_tpu_torch.obs import regress

    torch_hist = [_write(tmp_path, f"BENCH_r{n:02d}.json",
                         _torch_line(v, n=n))
                  for n, v in ((6, 9_000_000), (7, 9_100_000),
                               (8, 8_900_000))]
    jax_line = json.load(open(_fx("BENCH_r05.json")[0]))
    jax_line["n"] = 9
    jax_path = _write(tmp_path, "BENCH_r09.json", jax_line)
    result = regress.check(regress.load_records(torch_hist + [jax_path]))
    assert result["newest"] == jax_path
    assert not result["checked"]


def test_torch_lines_gate_among_themselves(tmp_path):
    from sda_tpu_torch.cli import bench as sda_bench
    from sda_tpu_torch.obs import regress

    hist = [_write(tmp_path, f"t{n}.json", _torch_line(v))
            for n, v in enumerate((9_000_000, 9_100_000, 8_900_000))]
    same = _write(tmp_path, "t9.json", _torch_line(9_050_000))
    result = regress.check(regress.load_records(_history() + hist + [same]))
    assert result["checked"] and result["regressions"] == []
    assert result["window"] == hist
    slow = _write(tmp_path, "t10.json", _torch_line(4_500_000))
    result = regress.check(regress.load_records(_history() + hist + [slow]))
    assert result["checked"] and "value" in result["regressions"]
    assert sda_bench.main(["--check", *_history(), *hist, slow]) == 1
    # the CUDA platform opens its own trajectory again
    card = _write(tmp_path, "t11.json", _torch_line(4_500_000,
                                                    platform="cuda"))
    assert not regress.check(regress.load_records(
        _history() + hist + [card]))["checked"]
