"""The FL scenario suite (``sda_tpu_torch/fl``) on the CPU: the recipes
of ``tests/test_fl_scenario.py`` against the port (its families and
trainer on ``FLProfile(device="cpu")``), and the port held to the JAX
package: the seeded data equal, and ``run_fl`` at the default profile
with the same report keys, the same participation and reveal counts a
round, and accuracy a round within 0.02. The reference's input bench
(``loadgen/inputbench.py``) waits for the port's ``loadgen``.
"""

import gzip
import json
import struct

import numpy as np
import pytest
import torch

from sda_tpu_torch import chaos
from sda_tpu_torch.fl import (
    FLProfile,
    gaussian_accounting,
    load_mnist_idx,
    run_fl,
    shard_dataset,
    synthetic_classification,
)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many small tensor ops: with one intra-op thread
    they do not spin against the suite's other workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cpu(**kw):
    """A profile whose families, trainer and clients run on the CPU."""
    return FLProfile(device="cpu", **kw)


# ---------------------------------------------------------------------------
# data shim

def test_synthetic_data_is_seed_deterministic():
    a = synthetic_classification(64, 32, image_shape=(8, 8, 1), seed=9)
    b = synthetic_classification(64, 32, image_shape=(8, 8, 1), seed=9)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = synthetic_classification(64, 32, image_shape=(8, 8, 1), seed=10)
    assert not np.array_equal(a[0], c[0])
    # eval drawn after train from one stream: growing train_size must not
    # reshuffle the evaluation set of a fixed seed's run
    assert a[0].dtype == np.float32 and a[1].dtype == np.int32
    assert a[0].shape == (64, 8, 8, 1) and a[2].shape == (32, 8, 8, 1)


def test_shard_dataset_partitions_evenly():
    x = np.arange(50, dtype=np.float32)[:, None]
    y = np.arange(50, dtype=np.int32)
    shards = shard_dataset(x, y, 4, seed=1)
    assert len(shards) == 4
    assert all(len(sx) == 12 for sx, _ in shards)  # remainder dropped
    seen = np.concatenate([sy for _, sy in shards])
    assert len(set(seen.tolist())) == 48  # disjoint
    again = shard_dataset(x, y, 4, seed=1)
    for (sx, sy), (tx, ty) in zip(shards, again):
        np.testing.assert_array_equal(sx, tx)
    with pytest.raises(ValueError, match="shard"):
        shard_dataset(x[:2], y[:2], 4)


def _write_idx_images(path, images, compress=False):
    payload = struct.pack(">IIII", 0x00000803, *images.shape) \
        + images.astype(np.uint8).tobytes()
    opener = gzip.open if compress else open
    with opener(path, "wb") as f:
        f.write(payload)


def _write_idx_labels(path, labels, compress=False):
    payload = struct.pack(">II", 0x00000801, len(labels)) \
        + labels.astype(np.uint8).tobytes()
    opener = gzip.open if compress else open
    with opener(path, "wb") as f:
        f.write(payload)


def test_mnist_idx_loader_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    train = rng.integers(0, 256, size=(10, 28, 28), dtype=np.uint8)
    test = rng.integers(0, 256, size=(4, 28, 28), dtype=np.uint8)
    # mixed plain/gzip: the loader must find either spelling
    _write_idx_images(tmp_path / "train-images-idx3-ubyte", train)
    _write_idx_labels(tmp_path / "train-labels-idx1-ubyte.gz",
                      np.arange(10) % 10, compress=True)
    _write_idx_images(tmp_path / "t10k-images-idx3-ubyte.gz", test,
                      compress=True)
    _write_idx_labels(tmp_path / "t10k-labels-idx1-ubyte", np.arange(4))
    tx, ty, ex, ey = load_mnist_idx(str(tmp_path), limit=8, eval_limit=3)
    assert tx.shape == (8, 28, 28, 1) and ex.shape == (3, 28, 28, 1)
    assert tx.dtype == np.float32 and float(tx.max()) <= 1.0
    np.testing.assert_array_equal(ty, np.arange(8) % 10)
    assert ey.tolist() == [0, 1, 2]


def test_mnist_idx_loader_missing_files(tmp_path):
    with pytest.raises(FileNotFoundError, match="train-images"):
        load_mnist_idx(str(tmp_path))


# ---------------------------------------------------------------------------
# DP accounting

def test_gaussian_accounting_composition():
    one = gaussian_accounting(2.0, 1, clip=1.0, dim=100)
    ten = gaussian_accounting(2.0, 10, clip=1.0, dim=100)
    assert ten["epsilon"] > one["epsilon"] > 0
    assert ten["rho_zcdp"] == pytest.approx(10 * one["rho_zcdp"])
    quieter = gaussian_accounting(8.0, 10, clip=1.0, dim=100)
    assert quieter["epsilon"] < ten["epsilon"]
    assert one["clip_l2"] == pytest.approx(10.0)  # clip * sqrt(dim)
    with pytest.raises(ValueError, match="sigma"):
        gaussian_accounting(0.0, 1, clip=1.0, dim=4)
    with pytest.raises(ValueError, match="delta"):
        gaussian_accounting(1.0, 1, clip=1.0, dim=4, delta=1.5)


# ---------------------------------------------------------------------------
# churn plan epoch keying

def test_churn_schedule_epoch_key():
    base = chaos.churn_schedule(16, 0.5, seed=3)
    e0 = chaos.churn_schedule(16, 0.5, seed=3, epoch=0)
    e1 = chaos.churn_schedule(16, 0.5, seed=3, epoch=1)
    # per-epoch plans are independent draws but reproducible
    assert e0 != e1
    assert e0 == chaos.churn_schedule(16, 0.5, seed=3, epoch=0)
    assert base == chaos.churn_schedule(16, 0.5, seed=3)  # legacy key stable


def test_poison_schedule_epoch_key():
    """The attacker plan follows churn_schedule's (seed, epoch) key
    discipline on a DISJOINT key, so poisoning and churn compose as
    uncorrelated seeded draws."""
    base = chaos.poison_schedule(16, 0.5, seed=3)
    e0 = chaos.poison_schedule(16, 0.5, seed=3, epoch=0)
    e1 = chaos.poison_schedule(16, 0.5, seed=3, epoch=1)
    assert e0 != e1
    assert e0 == chaos.poison_schedule(16, 0.5, seed=3, epoch=0)
    assert base == chaos.poison_schedule(16, 0.5, seed=3)
    # disjoint from the churn key: same (agents, rate, seed, epoch) must
    # not select the same agents as the churn plan does
    churn = chaos.churn_schedule(16, 0.5, seed=3, epoch=0)
    assert [e["attacker"] for e in e0] != [c["departs"] for c in churn]
    # rate edges and validation
    assert not any(e["attacker"] for e in chaos.poison_schedule(8, 0.0))
    assert all(e["attacker"] for e in chaos.poison_schedule(8, 1.0))
    with pytest.raises(ValueError, match="rate"):
        chaos.poison_schedule(8, 1.5)


def test_parse_poison_kind():
    assert chaos.parse_poison_kind("boost:-8") == {
        "kind": "boost", "factor": -8.0, "trigger_dim": None}
    assert chaos.parse_poison_kind("signflip")["factor"] == -1.0
    assert chaos.parse_poison_kind("backdoor:7")["trigger_dim"] == 7
    for bad in ("boost", "boost:1", "boost:x", "signflip:2",
                "backdoor", "backdoor:-1", "gradient_ascent"):
        with pytest.raises(ValueError):
            chaos.parse_poison_kind(bad)
    # corrupt_delta: boost scales, backdoor is a training-time no-op
    delta = np.array([1.0, -2.0], dtype=np.float32)
    np.testing.assert_array_equal(
        chaos.corrupt_delta(delta, chaos.parse_poison_kind("signflip")),
        -delta)
    np.testing.assert_array_equal(
        chaos.corrupt_delta(delta, chaos.parse_poison_kind("backdoor:0")),
        delta)


# ---------------------------------------------------------------------------
# the scenario driver (linear family, in-process: the tier-1 smoke)

def test_fl_round_trip_with_churn():
    report = run_fl(_cpu(participants=5, rounds=2, churn=0.4,
                              target_accuracy=0.5, seed=3))
    assert report["exact"] is True
    assert report["rounds_exact"] == report["rounds_run"] == 2
    assert report["reached_target"] is True
    assert report["leaks"] == 0 and report["client_failures"] == 0
    # the accuracy curve actually learned through the secure rounds
    assert report["final_accuracy"] > report["initial_accuracy"]
    churn = report["churn"]
    assert churn["participants_churned"] >= 1
    assert churn["participants_resumed"] == churn["participants_churned"]
    # every round accounts for the full population: frozen + dropped = P
    for row in report["per_round"]:
        assert row["participations"] + row["dropped"] == 5
    # the record is BENCH-shaped with the lower-is-better tag
    assert report["direction"] == "lower" and report["unit"] == "rounds"
    assert report["value"] == report["rounds_to_target"]
    # scheduler-minted epochs: ids are the deterministic uuid5 sequence
    from sda_tpu_torch.service.scheduler import epoch_aggregation_id

    assert report["per_round"][0]["aggregation"] == str(
        epoch_aggregation_id("fl-3", 0))
    assert report["per_round"][1]["aggregation"] == str(
        epoch_aggregation_id("fl-3", 1))


def test_fl_dead_clerk_degrades_every_round():
    report = run_fl(_cpu(participants=4, rounds=2, dead_clerks=1,
                              target_accuracy=0.5, seed=1))
    assert report["exact"] is True
    assert report["degraded_rounds"] == report["rounds_run"] == 2
    assert report["dead_clerks"] and len(report["dead_clerks"]) == 1
    for row in report["per_round"]:
        assert row["state"] == "revealed"  # degraded -> revealed, never hung


def test_fl_is_seed_deterministic_and_dp_noise_is_seeded():
    profile = _cpu(participants=4, rounds=2, target_accuracy=0.99,
                        dp_sigma=0.05, seed=11)
    a = run_fl(profile)
    b = run_fl(profile)
    # bit-exactness is checked BEFORE the DP noise (the noise is the
    # recipient's post-processing of the already-verified aggregate)
    assert a["exact"] is True and b["exact"] is True
    assert a["accuracy_by_round"] == b["accuracy_by_round"]
    dp = a["dp"]
    assert dp["sigma"] == 0.05 and dp["epsilon"] > 0
    assert dp["rounds"] == 2
    assert json.dumps(a["dp"])  # the block must be JSON-able


def test_fl_tree_population_mode():
    report = run_fl(_cpu(participants=9, rounds=1, tree_group_size=3,
                              target_accuracy=0.5, seed=5))
    assert report["exact"] is True
    assert report["reached_target"] is True
    assert report["per_round"][0]["groups"] >= 2
    assert report["per_round"][0]["depth"] == 2
    assert report["sharing"] == "tree-additive 3"


def test_fl_poisoning_undefended_vs_norm_clip():
    """The A/B at one seed: the same seeded attacker plan degrades the
    undefended run and is absorbed by the codec's norm clip — BOTH stay
    bit-exact (poisoning corrupts inputs, never the protocol) and both
    count every tainted share upload at the clerks."""
    base = dict(participants=5, rounds=2, target_accuracy=0.9, seed=3,
                poison=0.4)
    undef = run_fl(_cpu(**base))
    defend = run_fl(_cpu(**base, norm_clip=0.5))
    for rep in (undef, defend):
        assert rep["exact"] is True
        assert rep["rounds_exact"] == rep["rounds_run"] == 2
        assert rep["client_failures"] == 0
        atk = rep["attack"]
        assert atk["attackers_total"] >= 1
        assert atk["shares_tainted"] == atk["attackers_total"]
        assert atk["out_of_range_detections"] >= atk["attackers_total"]
    # same seeded plan, different outcome: that is the defense
    assert (undef["attack"]["attackers_by_round"]
            == defend["attack"]["attackers_by_round"])
    assert undef["final_accuracy"] < 0.5
    assert defend["final_accuracy"] >= 0.9
    assert undef["attack"]["defended"] is False
    assert defend["attack"]["defended"] is True
    # the quantizer block surfaces the armed defense and its headroom
    q = defend["quantizer"]
    assert q["norm_clip"] == 0.5 and q["headroom_margin"] > 0
    assert q["q_max"] * q["max_summands"] < q["modulus"] // 2


def test_fl_backdoor_reports_attack_success_curve():
    """backdoor:DIM is a training-time attack: main accuracy is not the
    signal — the report must carry the trigger-measured success curve."""
    report = run_fl(_cpu(participants=5, rounds=2, poison=0.4,
                              poison_kind="backdoor:3",
                              target_accuracy=0.5, seed=3))
    assert report["exact"] is True
    atk = report["attack"]
    assert atk["parsed"]["trigger_dim"] == 3
    curve = atk["backdoor_success_by_round"]
    assert isinstance(curve, list) and len(curve) == 2  # one per round
    assert all(0.0 <= v <= 1.0 for v in curve)
    assert atk["backdoor_success_final"] == curve[-1]


def test_fl_tree_robust_trimmed_mean():
    """Tree mode with --fl-tree-robust: signflip attackers inside leaf
    groups, the root's per-coordinate trimmed mean over unmasked leaf
    subtotals holds the target where magnitude defenses are blind."""
    report = run_fl(_cpu(participants=9, rounds=2, tree_group_size=3,
                              poison=0.25, poison_kind="signflip",
                              tree_robust=True, target_accuracy=0.9,
                              seed=5))
    assert report["exact"] is True and report["reached_target"] is True
    assert ", robust" in report["mode"]
    atk = report["attack"]
    assert atk["tree_robust"] is True and atk["attackers_total"] >= 1
    assert atk["out_of_range_detections"] >= 1
    for row in report["per_round"]:
        assert row["robust_leaves"] == 3


def test_fl_profile_validation():
    with pytest.raises(ValueError, match="devices"):
        run_fl(_cpu(participants=1))
    with pytest.raises(ValueError, match="dead clerks"):
        run_fl(_cpu(tree_group_size=3, dead_clerks=1))
    with pytest.raises(ValueError, match="fleet"):
        run_fl(_cpu(tree_group_size=3, fleet=2))
    # every rejected knob combination names BOTH knobs in its message
    with pytest.raises(ValueError, match="chaos_rate and tree_group_size"):
        run_fl(_cpu(tree_group_size=3, chaos_rate=0.1))
    with pytest.raises(ValueError, match="poison"):
        run_fl(_cpu(poison=1.5))
    with pytest.raises(ValueError, match="tree_robust and tree_group_size"):
        run_fl(_cpu(tree_robust=True))
    with pytest.raises(ValueError, match="norm_clip"):
        run_fl(_cpu(norm_clip=-1.0))
    with pytest.raises(ValueError, match="unknown poison kind"):
        run_fl(_cpu(poison=0.2, poison_kind="explode"))
    with pytest.raises(ValueError, match="mnist_dir"):
        run_fl(_cpu(family="lenet", dataset="mnist"))
    with pytest.raises(ValueError, match="28x28x1"):
        run_fl(_cpu(family="linear", dataset="mnist", mnist_dir="/x"))
    with pytest.raises(ValueError, match="unknown family"):
        run_fl(_cpu(family="resnet"))


def test_fl_http_round_trip():
    """One round over a REAL HTTP server: the wire path (binary codec
    negotiation included) must not change the verdict."""
    report = run_fl(_cpu(participants=4, rounds=1, http=True,
                              target_accuracy=0.5, seed=2))
    assert report["exact"] is True and report["reached_target"] is True
    assert "HTTP" in report["mode"]


# ---------------------------------------------------------------------------
# the port against the JAX package

@pytest.mark.parametrize("image_shape,seed", [((8, 8, 1), 0), ((28, 28, 1), 3),
                                              ((32, 32, 3), 0)])
def test_seeded_data_equals_reference(image_shape, seed):
    from sda_tpu.fl import data as ref_data

    ours = synthetic_classification(96, 32, image_shape=image_shape,
                                    seed=seed)
    theirs = ref_data.synthetic_classification(96, 32,
                                               image_shape=image_shape,
                                               seed=seed)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for (ax, ay), (bx, by) in zip(
            shard_dataset(ours[0], ours[1], 6, seed=seed),
            ref_data.shard_dataset(theirs[0], theirs[1], 6, seed=seed)):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)


def test_run_fl_default_profile_matches_reference():
    """The default profile (linear family, zero initialisation) in both
    packages: the same report keys, the same participations and reveals a
    round, and accuracy a round within 0.02 (float training differs in
    the last bits, so a few quantized coordinates may differ by a step)."""
    from sda_tpu.crypto import sodium as ref_sodium

    if not ref_sodium.available():
        pytest.skip("the reference's libsodium not present")
    from sda_tpu.fl import FLProfile as RefProfile
    from sda_tpu.fl import run_fl as ref_run_fl

    ours = run_fl(FLProfile(device="cpu"))
    theirs = ref_run_fl(RefProfile())
    assert set(ours) == set(theirs)
    assert ours["platform"] == "cpu" and ours["dim"] == theirs["dim"]
    assert ours["exact"] is True and theirs["exact"] is True
    assert len(ours["per_round"]) == len(theirs["per_round"]) == 3
    for a, b in zip(ours["per_round"], theirs["per_round"]):
        assert set(a) == set(b)
        assert (a["participations"], a["dropped"], a["state"]) == \
            (b["participations"], b["dropped"], b["state"]) == \
            (6, 0, "revealed")
        assert a["exact"] is True and b["exact"] is True
    np.testing.assert_allclose(ours["accuracy_by_round"],
                               theirs["accuracy_by_round"], rtol=0,
                               atol=0.02)
    assert ours["rounds_exact"] == theirs["rounds_exact"]


@pytest.mark.parametrize("family", ["lenet", "mobilelite", "lora"])
def test_run_fl_families_train_on_the_port(family):
    """The families at run_fl's drill widths train through the secure
    rounds on the port: every round exact, the loss falls."""
    report = run_fl(_cpu(family=family, participants=3,
                              rounds=2, local_steps=2, batch_size=8,
                              shard_size=16, eval_size=32,
                              target_accuracy=0.99, seed=1))
    assert report["exact"] is True and report["rounds_exact"] == 2
    losses = [row["mean_local_loss"] for row in report["per_round"]]
    assert losses[-1] < losses[0]


def test_input_bench_shape():
    """The participate-input bench (``loadgen/inputbench.py``) reports both
    rungs, its participant on the CPU; no perf assertion."""
    from sda_tpu_torch.loadgen.inputbench import run_input_bench

    report = run_input_bench(dim=2048, repeats=2, device="cpu")
    assert report["dim"] == 2048
    assert report["platform"] == "cpu"
    for key in ("convert_list_ms", "convert_array_ms", "seal_list_ms",
                "seal_array_ms", "value"):
        assert isinstance(report[key], (int, float)), key
    assert json.dumps(report)
