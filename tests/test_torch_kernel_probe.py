"""K5, the kernel probe: the port's plain versions (what ``probe_call``
runs on a CPU tensor) against the JAX probe ``benchmarks/kernel_probe.py``
in interpret mode, fed the same seeded numpy inputs. Exact equality.

The JAX probe's draws come from the TPU PRNG, which does not run off the
chip, so the variants with draws are held to the port's own K1 (the same
Philox words for the same seed). The CUDA kernel runs only on the card;
``chip_smoke.py`` holds it against these plain versions there.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "benchmarks"))

import kernel_probe as ref_kp  # noqa: E402

from sda_tpu import protocol as ref_proto  # noqa: E402
from sda_tpu.fields import fastfield as ref_ff  # noqa: E402
from sda_tpu.fields import numtheory as ref_nt  # noqa: E402

from sda_tpu_torch.benchmarks import kernel_probe as kp  # noqa: E402
from sda_tpu_torch.fields import fused_round  # noqa: E402
from sda_tpu_torch.fields.fastfield import SolinasPrime  # noqa: E402

T, P29, W2, W3 = ref_nt.generate_packed_params(3, 8, 28)
SCHEME = ref_proto.PackedShamirSharing(3, 8, T, P29, W2, W3)
M_HOST = ref_nt.share_matrix_for(SCHEME)
SP = SolinasPrime.try_from(P29)
RSP = ref_ff.SolinasPrime.try_from(P29)
K, N = SCHEME.secret_count, SCHEME.share_count
SEED = 2**40 + 3


def _x(P, B, seed):
    """[P, k, B] canonical uint32 residues."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, P29, size=(P, K, B), dtype=np.uint32)


def _plain(x, name, seed=SEED, m_host=M_HOST):
    flags = kp.X_MATMUL if name == "x_matmul" else kp.VARIANTS[name]
    return kp.probe_call_plain(torch.from_numpy(x), seed, SP, m_host, T,
                               **flags)


# -- against the JAX probe (variants without draws) --------------------------

@pytest.mark.parametrize("name", ["fold_only", "fold_tree", "x_matmul"])
def test_plain_matches_jax_probe(name):
    flags = kp.X_MATMUL if name == "x_matmul" else kp.VARIANTS[name]
    x = _x(16, 256, seed=len(name))
    got = _plain(x, name)
    want = ref_kp.probe_call(jnp.asarray(x), 1, RSP, M_HOST, T, tile=128,
                             p_block=8, p_tile=16, interpret=True, **flags)
    assert got.dtype == torch.int64 and got.shape == (N, 256)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("P,fill", [(16, None), (100, None), (100, "max")])
def test_mxu_fold_matches_jax_folds(P, fill):
    rng = np.random.default_rng(P)
    x = rng.integers(0, P29, size=(P, 520), dtype=np.uint32)
    if fill == "max":  # the largest limb sums: every limb of p - 1
        x[:] = P29 - 1
    got = kp.mxu_fold(torch.from_numpy(x), SP)
    assert got.dtype == torch.int64 and got.shape == (520,)
    assert torch.equal(got, kp.mxu_fold_plain(torch.from_numpy(x), SP))
    assert torch.equal(got, kp.xla_fold(torch.from_numpy(x), SP))
    for ref in (ref_kp.mxu_fold, ref_kp.xla_fold):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref(jnp.asarray(x), RSP)).astype(np.int64))


@pytest.mark.parametrize("fold", [kp.mxu_fold, kp.mxu_fold_plain])
def test_mxu_fold_guards_int32_limb_sums(fold):
    P = (1 << 31) // 127 + 1
    x = torch.zeros((1, 1), dtype=torch.int32).expand(P, 32)
    with pytest.raises(ValueError, match="too large for int32 limb sums"):
        fold(x, SP)


def _timings(O, F, R, M):
    return {"fold_only": O + F, "prng_only": O + R, "no_matmul": O + F + R,
            "full": O + F + R + M}


@pytest.mark.parametrize("O,F,R,M", [
    (0.002, 0.010, 0.006, 0.001),
    (0.0, 0.5, 0.25, 0.125),
    (0.01, 0.0, 0.0, 0.0),
    (0.0005, 0.03, 0.001, 0.02),
])
def test_solve_budget_inverts_generative_model(O, F, R, M):
    got = kp.solve_budget(_timings(O, F, R, M))
    assert got["overhead_s"] == pytest.approx(O)
    assert got["fold_s"] == pytest.approx(F)
    assert got["prng_s"] == pytest.approx(R)
    assert got["matmul_s"] == pytest.approx(M)
    assert got == ref_kp.solve_budget(_timings(O, F, R, M))


# -- the draw variants, against the port's K1 --------------------------------

def test_full_is_k1_shares_for_the_same_seed():
    x = _x(7, 100, seed=5)
    shares, _ = fused_round.fused_mask_share_combine_plain(
        torch.from_numpy(x), SEED, SP, M_HOST, T, True)
    assert torch.equal(_plain(x, "full"), shares)
    assert not torch.equal(_plain(x, "full", seed=SEED + 1), shares)


def test_draw_rows_are_k1_masks_and_randomness():
    x = _x(7, 100, seed=6)
    _, masks = fused_round.fused_mask_share_combine_plain(
        torch.from_numpy(x), SEED, SP, M_HOST, T, True)
    bits = fused_round.philox_bits(SEED, 7, K, T, 100, True, "cpu")
    randsum = fused_round.draw_sum(bits, T, K, SP)
    prng_only = _plain(x, "prng_only")
    assert torch.equal(prng_only[:K], masks)
    assert torch.equal(prng_only[K:K + T], randsum)
    assert not prng_only[K + T:].any()
    no_matmul = _plain(x, "no_matmul")
    fold = torch.from_numpy(x.astype(np.int64).sum(0) % P29)
    assert torch.equal(no_matmul[:K], (fold + masks) % P29)
    assert torch.equal(no_matmul[K:], prng_only[K:])


@pytest.mark.parametrize("tree,twin", [("fold_tree", "fold_only"),
                                       ("full_tree", "full")])
def test_tree_twins_equal_one_thread_a_column(tree, twin):
    x = torch.from_numpy(_x(9, 64, seed=8))
    got = kp.probe_call(x, SEED, SP, M_HOST, T, **kp.VARIANTS[tree])
    assert torch.equal(got, kp.probe_call(x, SEED, SP, M_HOST, T,
                                          **kp.VARIANTS[twin]))


# -- the wrapper's contract ---------------------------------------------------

def test_wrapper_validates_variant_shapes_and_device():
    x = torch.zeros((2, 3, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="reads the inputs, draws"):
        kp.probe_call(x, 0, SP, M_HOST, T, do_x=False, do_prng=False,
                      do_matmul=True)
    with pytest.raises(ValueError, match="share matrix width"):
        kp.probe_call(x, 0, SP, M_HOST[:, :-1], T, **kp.VARIANTS["full"])
    with pytest.raises(ValueError, match="cannot hold the uncontracted"):
        kp.probe_call(x, 0, SP, M_HOST[:K + T - 1], T,
                      **kp.VARIANTS["no_matmul"])
    with pytest.raises(ValueError, match="unsupported device"):
        kp.probe_call(torch.empty((2, 3, 10), dtype=torch.int32,
                                  device="meta"),
                      0, SP, M_HOST, T, **kp.VARIANTS["full"])


def test_cpu_tensor_never_counts_a_launch():
    before = kp.probe_call.launches
    kp.probe_call(torch.from_numpy(_x(2, 16, seed=1)), 0, SP, M_HOST, T,
                  **kp.VARIANTS["full"])
    assert kp.probe_call.launches == before


def test_entry_point_on_cpu_runs_the_gates_and_times_nothing():
    res = subprocess.run(
        [sys.executable, "-m", "sda_tpu_torch.benchmarks.kernel_probe",
         "--device", "cpu", "--participants", "8", "--dim", "3000"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [json.loads(line) for line in res.stdout.splitlines()]
    assert [r["stage"] for r in lines] == [
        "probe_env", "mxu_exact", "fold_exact", "fold_tree_exact",
        "full_matches_library", "probe_done"]
    assert all(r["ok"] is True for r in lines[1:])
    assert lines[0]["participants"] == 8 and lines[0]["batch_cols"] == 1000
