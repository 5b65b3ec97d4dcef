"""The twin of ``tests/test_analytics.py`` on the port
(``sda_tpu_torch/analytics``): the shared field-sizing contract, encoder
and decoder semantics against plaintext ground truth, the seeded sketch
error contracts, the in-process scenario smoke (clients on the CPU) and
the CLI's typed refusals, with the same seeds and sizes; then every
encoder held to the reference's on the same inputs, the scenario held to
the reference's report on the same seed, and ``ci.sh``'s analytics
drill through the port's ``sda-sim --analytics``.
"""

import math

import numpy as np
import pytest

from sda_tpu_torch.analytics import (
    ABMetricEncoder,
    CountMinEncoder,
    CountSketchEncoder,
    HistogramEncoder,
    QuantileEncoder,
    expand_kinds,
    make_encoder,
)
from sda_tpu_torch.models.encoding import (
    FieldSizingError,
    FixedPointCodec,
    field_capacity,
    field_headroom_check,
)

MOD = 1 << 24
SEEDS = 120  # >= 100 seeded populations for the property tests


def _aggregate(encoder, per_device_values):
    """Plaintext secure-sum stand-in: sum of residue uploads mod m —
    exactly what the round reveals."""
    total = np.zeros(encoder.dim, dtype=np.int64)
    for value in per_device_values:
        total = (total + encoder.encode(value)) % encoder.modulus
    return total


# ---------------------------------------------------------------------------
# the shared headroom rule (satellite: one contract, two callers)


def test_field_capacity_matches_codec_rule():
    for modulus, summands in ((433, 3), (1 << 16, 10), (1 << 24, 100)):
        assert field_capacity(modulus, summands) \
            == (modulus // 2 - 1) // summands


def test_field_headroom_check_margin_and_refusal():
    # 100 * 50 = 5000 <= 2^14//2 - 1 = 8191: margin 3191
    assert field_headroom_check(100, 50, 1 << 14) == 8191 - 5000
    with pytest.raises(FieldSizingError, match="decodable band"):
        field_headroom_check(100, 100, 1 << 14)
    # the typed error names the caller's context
    with pytest.raises(FieldSizingError, match="MyEncoder"):
        field_headroom_check(100, 100, 1 << 14, context="MyEncoder")


def test_codec_and_helper_cannot_drift():
    # the codec's constructor seals its own invariant through the SAME
    # helper: any (modulus, summands, q_max) it accepts must pass the
    # helper, and the refusal is the helper's typed error
    codec = FixedPointCodec(1 << 16, 8, max_summands=10, clip=1.0)
    assert field_headroom_check(codec.q_max, codec.max_summands,
                                codec.modulus) >= 0
    with pytest.raises(FieldSizingError, match="headroom"):
        FixedPointCodec(433, 8, max_summands=300)


def test_encoder_bind_is_the_same_contract():
    enc = HistogramEncoder(0.0, 1.0, bins=4, samples_per_device=100)
    # 100 per-coordinate max * 200 devices = 20000 > 433//2 - 1
    with pytest.raises(FieldSizingError, match="HistogramEncoder"):
        enc.bind(433, 200)
    margin = enc.bind(MOD, 200).headroom_margin
    assert margin == field_headroom_check(100, 200, MOD)


def test_unbound_encoder_refuses_encode():
    enc = HistogramEncoder(bins=4)
    with pytest.raises(FieldSizingError, match="bind"):
        enc.encode([0.5])


def test_ab_second_moment_dominates_sizing():
    # the q^2 lane is the point of the typed error: a modulus that fits
    # FedAvg deltas is far too small for sum-of-squares
    enc = ABMetricEncoder(arms=2, lo=0.0, hi=1.0, fractional_bits=10)
    assert enc.max_abs == enc.q_max ** 2
    with pytest.raises(FieldSizingError, match="ABMetricEncoder"):
        enc.bind(1 << 16, 100)
    enc.bind(1 << 31, 100)


def test_decode_sum_errors_name_aggregation_context():
    codec = FixedPointCodec(1 << 16, 8, max_summands=4)
    values = codec.encode(np.zeros(3))
    with pytest.raises(ValueError, match="at least one summand") as e:
        codec.decode_sum(values, 0)
    assert "dim 3" in str(e.value) and str(codec.modulus) in str(e.value)
    with pytest.raises(ValueError, match="exceeds configured capacity") as e:
        codec.decode_sum(values, 9)
    assert "dim 3" in str(e.value) and "wrapped" in str(e.value)


def test_registry_round_trip_and_unknown_kind():
    enc = make_encoder("histogram", bins=8)
    assert isinstance(enc, HistogramEncoder) and enc.bins == 8
    with pytest.raises(ValueError, match="registered"):
        make_encoder("bogus")


def test_expand_kinds_aliases_and_refusal():
    assert expand_kinds("heavy") == ["countmin", "countsketch"]
    assert expand_kinds("all")[0] == "histogram" and len(
        expand_kinds("all")) == 5
    assert expand_kinds("ab,histogram,ab") == ["ab", "histogram"]
    with pytest.raises(ValueError, match="unknown analytics profile"):
        expand_kinds("histogram,nope")


# ---------------------------------------------------------------------------
# encoder/decoder unit semantics


def test_histogram_exact_counts_and_edge_clamp():
    enc = HistogramEncoder(0.0, 1.0, bins=4, samples_per_device=4)
    enc.bind(MOD, 8)
    devices = [[0.1, 0.1, 0.6, 0.9], [-5.0, 7.0, float("nan"), 0.3]]
    revealed = _aggregate(enc, devices)
    block = enc.decode(revealed, len(devices))
    # -5.0 and NaN clamp to bin 0, 7.0 to the last bin
    assert block["counts"].tolist() == [4, 1, 1, 2]
    assert block["total"] == 8


def test_histogram_contribution_magnitude_is_enforced():
    enc = HistogramEncoder(0.0, 1.0, bins=2, samples_per_device=2)
    enc.bind(MOD, 8)
    with pytest.raises(FieldSizingError, match="samples_per_device"):
        enc.encode([0.1, 0.2, 0.3])


def test_quantile_within_one_grid_step():
    enc = QuantileEncoder(0.0, 1.0, bins=64, samples_per_device=16)
    enc.bind(MOD, 8)
    rng = np.random.default_rng(7)
    devices = [rng.uniform(0, 1, 16) for _ in range(8)]
    revealed = _aggregate(enc, devices)
    flat = np.sort(np.concatenate(devices))
    for q in (0.1, 0.5, 0.9):
        est = float(enc.decode_quantiles(revealed, [q])[0])
        rank = min(flat.size - 1, max(0, math.ceil(q * flat.size) - 1))
        assert abs(est - flat[rank]) <= enc.grid_step + 1e-12


def test_quantile_empty_population_is_typed():
    enc = QuantileEncoder(bins=4, samples_per_device=1)
    enc.bind(MOD, 8)
    with pytest.raises(ValueError, match="empty population"):
        enc.decode_quantiles(np.zeros(4, np.int64), [0.5])


def test_ab_mean_variance_exact_in_quantized_domain():
    enc = ABMetricEncoder(arms=2, lo=0.0, hi=1.0, fractional_bits=6)
    enc.bind(MOD, 16)
    devices = [(0, 0.25), (0, 0.75), (1, 0.5), (1, 0.5), (1, 0.9)]
    revealed = _aggregate(enc, devices)
    block = enc.decode(revealed, len(devices))
    arm0, arm1 = block["arms"]["arm0"], block["arms"]["arm1"]
    assert arm0["count"] == 2 and arm1["count"] == 3
    q = np.array([enc.quantize(0.25), enc.quantize(0.75)], np.float64)
    assert arm0["mean"] == pytest.approx(q.mean() / enc.scale, abs=1e-12)
    assert arm0["variance"] == pytest.approx(
        (np.mean(q * q) - q.mean() ** 2) / enc.scale ** 2, abs=1e-12)
    assert block["total"] == 5


def test_ab_empty_arm_decodes_to_none():
    enc = ABMetricEncoder(arms=3, lo=0.0, hi=1.0)
    enc.bind(MOD, 4)
    revealed = _aggregate(enc, [(0, 0.5)])
    block = enc.decode(revealed, 1)
    assert block["arms"]["arm2"]["count"] == 0
    assert block["arms"]["arm2"]["mean"] is None


def test_sketch_seed_mismatch_breaks_agreement():
    # recipient and devices MUST share the hash family: a decoder with a
    # different seed reads garbage — this is why the seed rides the
    # aggregation identity in the scenario
    enc_a = CountMinEncoder(width=32, depth=3, seed=1, items_per_device=4)
    enc_b = CountMinEncoder(width=32, depth=3, seed=2, items_per_device=4)
    enc_a.bind(MOD, 8)
    enc_b.bind(MOD, 8)
    devices = [["x"] * 4 for _ in range(8)]
    revealed = _aggregate(enc_a, devices)
    assert enc_a.estimate(revealed, "x") == 32
    assert enc_b.estimate(revealed, "x") < 32  # wrong family, wrong cells


# ---------------------------------------------------------------------------
# sketch error contracts: seeded property tests (>= 100 populations)


def _zipf_stream(rng, devices, items_per_device, domain):
    raw = rng.zipf(1.5, size=(devices, items_per_device))
    idx = np.minimum(raw - 1, domain - 1)
    return [[f"k{int(i)}" for i in row] for row in idx]


def test_countmin_overestimate_only_and_eps_delta_bound():
    """Count-min over >= 100 seeded populations: EVERY point query is an
    overestimate (a single underestimate is a hard failure — collisions
    can only add), and the ``est <= true + eps * N`` bound holds with
    frequency >= 1 - delta across the whole query corpus (binomial
    slack on the failure budget)."""
    width, depth, domain = 32, 4, 40
    enc_proto = CountMinEncoder(width=width, depth=depth, seed=0,
                                items_per_device=8)
    eps, delta = enc_proto.eps, enc_proto.delta
    queries = 0
    violations = 0
    for seed in range(SEEDS):
        rng = np.random.default_rng(seed)
        enc = CountMinEncoder(width=width, depth=depth, seed=seed * 7 + 1,
                              items_per_device=8)
        enc.bind(MOD, 8)
        devices = _zipf_stream(rng, 8, 8, domain)
        revealed = _aggregate(enc, devices)
        truth = {}
        for row in devices:
            for item in row:
                truth[item] = truth.get(item, 0) + 1
        total = sum(truth.values())
        for i in range(domain):
            item = f"k{i}"
            true = truth.get(item, 0)
            est = enc.estimate(revealed, item)
            assert est >= true, (
                f"seed {seed}: count-min UNDERestimated {item}: "
                f"{est} < {true}")
            queries += 1
            if est > true + eps * total:
                violations += 1
    # failure budget: mean + 6 binomial sigmas over the whole corpus
    budget = queries * delta
    allowance = budget + 6.0 * math.sqrt(budget * (1 - delta)) + 1
    assert violations <= allowance, (
        f"{violations} eps-violations over {queries} queries breaks "
        f"delta={delta:.4g} (allowance {allowance:.1f})")


def test_countsketch_unbiased_and_bounded():
    """Count-sketch over >= 100 seeded populations: the estimator is
    unbiased (the mean signed error across independently-seeded sketches
    of the same item concentrates at 0), and per-query error exceeds
    the declared ``sqrt(3 F2 / width)`` bound no more often than the
    declared delta (with binomial slack)."""
    width, depth, domain = 32, 5, 40
    delta = math.exp(-depth / 6.0)
    queries = 0
    violations = 0
    signed_errors = []
    for seed in range(SEEDS):
        rng = np.random.default_rng(10_000 + seed)
        enc = CountSketchEncoder(width=width, depth=depth,
                                 seed=seed * 13 + 5, items_per_device=8)
        enc.bind(MOD, 8)
        devices = _zipf_stream(rng, 8, 8, domain)
        revealed = _aggregate(enc, devices)
        truth = {}
        for row in devices:
            for item in row:
                truth[item] = truth.get(item, 0) + 1
        f2 = float(sum(c * c for c in truth.values()))
        bound = enc.error_bound(f2)
        for i in range(domain):
            item = f"k{i}"
            err = enc.estimate(revealed, item) - truth.get(item, 0)
            signed_errors.append(err)
            queries += 1
            if abs(err) > bound:
                violations += 1
    budget = queries * delta
    allowance = budget + 6.0 * math.sqrt(budget * (1 - delta)) + 1
    assert violations <= allowance
    # unbiasedness: the grand mean of signed errors concentrates at 0 —
    # systematic bias on the heavy zipf head would push it far outside
    mean_err = float(np.mean(signed_errors))
    sem = float(np.std(signed_errors)) / math.sqrt(len(signed_errors))
    assert abs(mean_err) <= 6.0 * sem + 1e-9, (
        f"count-sketch biased: mean signed error {mean_err:.4f} "
        f"(sem {sem:.4f})")


def test_sketches_survive_single_ultra_heavy_hitter():
    """The adversarial tail: one item carries ~95% of the stream. The
    sketch contracts must hold where they are weakest — count-min's
    eps*N bound balloons with N, and count-sketch's F2 bound balloons
    with the heavy hitter's square — and both must still rank the
    ultra-heavy item first at every seed."""
    width, depth, domain = 32, 4, 20
    for seed in range(SEEDS):
        rng = np.random.default_rng(20_000 + seed)
        devices = []
        for _ in range(8):
            row = ["whale"] * 15 + [f"k{int(rng.integers(0, domain))}"]
            devices.append(row)
        truth = {}
        for row in devices:
            for item in row:
                truth[item] = truth.get(item, 0) + 1
        total = sum(truth.values())
        f2 = float(sum(c * c for c in truth.values()))
        candidates = ["whale"] + [f"k{i}" for i in range(domain)]

        cm = CountMinEncoder(width=width, depth=depth, seed=seed + 1,
                             items_per_device=16)
        cm.bind(MOD, 8)
        revealed = _aggregate(cm, devices)
        assert cm.estimate(revealed, "whale") >= truth["whale"]
        hits = cm.heavy_hitters(revealed, candidates, 0.5, total)
        assert hits and hits[0][0] == "whale"

        cs = CountSketchEncoder(width=width, depth=depth, seed=seed + 1,
                                items_per_device=16)
        cs.bind(MOD, 8)
        revealed = _aggregate(cs, devices)
        err = abs(cs.estimate(revealed, "whale") - truth["whale"])
        assert err <= cs.error_bound(f2) + 1e-9
        hits = cs.heavy_hitters(revealed, candidates, 0.5, total)
        assert hits and hits[0][0] == "whale"


def test_signed_contributions_ride_nonneg_residues():
    # count-sketch uploads are residues in [0, m): a -1 contribution is
    # m-1 on the wire and the centered lift restores it after the sum
    enc = CountSketchEncoder(width=8, depth=1, seed=3, items_per_device=1)
    enc.bind(433, 4)
    item = next(f"i{k}" for k in range(100) if enc._sign(0, f"i{k}") == -1)
    upload = enc.encode([item])
    assert upload.min() >= 0 and upload.max() < 433
    assert 432 in upload  # the -1, as a residue


# ---------------------------------------------------------------------------
# the scenario over the real stack + CLI hygiene


def test_analytics_scenario_smoke_in_process():
    from sda_tpu_torch.analytics import AnalyticsProfile, run_analytics

    report = run_analytics(AnalyticsProfile(
        kinds=["histogram", "ab"], participants=3, epochs=2,
        values_per_device=4, seed=11, device="cpu"))
    assert report["exact"] and report["bounds_ok"]
    assert report["leaks"] == 0 and report["client_failures"] == 0
    assert report["rounds_exact"] == 4  # 2 tenants x 2 epochs
    assert report["unit"] == "values/s" and report["value"] > 0
    tenant = report["per_tenant"]["analytics-histogram-0"]
    assert tenant["contract"] == "exact"
    assert tenant["headroom_margin"] >= 0


def test_analytics_scenario_refuses_oversized_encoder():
    from sda_tpu_torch.analytics import AnalyticsProfile, run_analytics

    # the packed-sharing order constraints floor the prime near 2^21, so
    # the derived aggregation modulus caps per-coordinate sums at 32767:
    # 40000 samples/device cannot fit, and the typed refusal names the
    # encoder and fires BEFORE any service spins up (sizing is checked
    # after crypto availability, so gate)
    with pytest.raises(FieldSizingError, match="HistogramEncoder"):
        run_analytics(AnalyticsProfile(
            kinds=["histogram"], participants=4, values_per_device=40000,
            modulus_bits=14, device="cpu"))


def test_cli_analytics_rejects_profile_combos(capsys):
    from sda_tpu_torch.cli import sim

    assert sim.main(["--analytics", "histogram", "--fl"]) == 1
    err = capsys.readouterr().err
    assert "--analytics" in err and "--fl" in err

    assert sim.main(["--analytics", "histogram", "--poison", "0.2"]) == 1
    err = capsys.readouterr().err
    assert "--poison" in err and "--analytics" in err

    assert sim.main(["--analytics", "histogram", "--devscale"]) == 1
    err = capsys.readouterr().err
    assert "--analytics" in err and "--devscale" in err


def test_cli_analytics_rejects_unknown_kind(capsys):
    from sda_tpu_torch.cli import sim

    assert sim.main(["--analytics", "nope"]) == 1
    assert "unknown analytics profile" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the port held to the reference


def _equal(a, b) -> bool:
    """Nested dicts/lists/arrays/floats equal, NaN included."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple, np.ndarray)):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == object or b.dtype == object:
            return a.shape == b.shape and all(
                _equal(x, y) for x, y in zip(a.reshape(-1), b.reshape(-1)))
        return a.shape == b.shape and np.array_equal(
            a, b, equal_nan=a.dtype.kind in "fc" and b.dtype.kind in "fc")
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


@pytest.mark.parametrize("kind,params", [
    ("histogram", dict(lo=0.0, hi=1.0, bins=16, samples_per_device=4)),
    ("countmin", dict(width=32, depth=3, seed=5, items_per_device=4)),
    ("countsketch", dict(width=32, depth=3, seed=5, items_per_device=4)),
    ("quantile", dict(lo=-2.0, hi=2.0, bins=24, samples_per_device=4)),
    ("ab", dict(arms=3, lo=-1.0, hi=1.0, fractional_bits=6)),
])
def test_encoders_match_reference(kind, params):
    """Each encoder of the port encodes a seeded population to the
    reference's residues and decodes their sum to the same answer."""
    from sda_tpu.analytics import make_encoder as ref_make_encoder

    modulus, n = (1 << 24) - 3, 10
    rng = np.random.default_rng(23)
    ours = make_encoder(kind, **params).bind(modulus, n)
    ref = ref_make_encoder(kind, **params).bind(modulus, n)
    if kind in ("histogram", "quantile"):
        values = [rng.uniform(-2.5, 2.5, size=4) for _ in range(n)]
    elif kind == "ab":
        values = [(int(rng.integers(0, 3)), float(rng.uniform(-1.5, 1.5)))
                  for _ in range(n)]
    else:
        values = [rng.integers(0, 40, size=4) for _ in range(n)]
    enc = [ours.encode(v) for v in values]
    for mine, v in zip(enc, values):
        assert np.array_equal(mine, ref.encode(v))
    revealed = np.sum(enc, axis=0) % modulus
    if kind in ("countmin", "countsketch"):
        for item in range(40):
            assert ours.estimate(revealed, item) == ref.estimate(revealed,
                                                                 item)
    else:
        assert _equal(ours.decode(revealed, n), ref.decode(revealed, n))


def test_analytics_scenario_matches_reference_on_the_same_seed():
    """One scenario through both packages on the same seed: the same
    rounds, verdicts, modulus, counters and per-tenant checks against the
    seeded ground truth; only times differ."""
    from sda_tpu.crypto import sodium

    if not sodium.available():
        pytest.skip("libsodium not present")
    from sda_tpu.analytics import AnalyticsProfile as RefProfile
    from sda_tpu.analytics import run_analytics as ref_run
    from sda_tpu_torch.analytics import AnalyticsProfile, run_analytics

    kw = dict(kinds=["histogram", "countmin"], participants=3, epochs=2,
              values_per_device=4, seed=11)
    ref = ref_run(RefProfile(**kw))
    got = run_analytics(AnalyticsProfile(**kw, device="cpu"))
    assert got["exact"] and got["bounds_ok"]
    for key in ("rounds", "rounds_exact", "rounds_within_bounds", "exact",
                "bounds_ok", "leaks", "modulus", "sharing", "values_total",
                "scheduler", "counters", "client_failures"):
        assert got[key] == ref[key], key
    for name, tenant in ref["per_tenant"].items():
        mine = got["per_tenant"][name]
        for key in ("kind", "encoder", "contract", "dim", "max_abs",
                    "headroom_margin", "epochs_exact", "admitted",
                    "checks"):
            assert _equal(mine[key], tenant[key]), (name, key)


def test_ci_analytics_drill_through_the_ports_sim(capsys):
    """``ci.sh``'s analytics drill (histogram + count-min tenants, 2
    recurring epochs each, sqlite + HTTP) through the port's
    ``sda-sim --analytics``."""
    import json

    from sda_tpu_torch.cli import sim

    rc = sim.main(["--analytics", "histogram,countmin",
                   "--analytics-participants", "4", "--analytics-epochs", "2",
                   "--analytics-store", "sqlite", "--analytics-http",
                   "--analytics-seed", "20260806", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert report["exact"] is True, report
    assert report["rounds_exact"] == report["rounds"] == 4, report
    assert report["bounds_ok"] is True, report
    assert report["rounds_within_bounds"] == 4, report
    assert report["leaks"] == 0 and report["client_failures"] == 0, report
    sched = report["scheduler"]
    assert sched["installed"] == 2 and sched["epochs_closed"] == 4, sched
    per = report["per_tenant"]
    hist, cm = per["analytics-histogram-0"], per["analytics-countmin-1"]
    assert all(c["error"] == 0.0 for c in hist["checks"]), hist["checks"]
    assert all(c["error"] <= c["bound"] and c["underestimates"] == 0
               and c["eps_violations"] <= c["delta_allowance"]
               for c in cm["checks"]), cm["checks"]
