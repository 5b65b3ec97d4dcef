"""K3's plain version (``sda_tpu_torch.fields.chacha_device`` on CPU
tensors) against the JAX package's ``fields/chacha_jax.py`` and the host
spec (``fields/chacha.py``, the native C++): bit for bit, since the stream
and its reduction mod m are exact. The CUDA kernel itself is held to this
plain version on the card by ``chip_smoke.py`` (phase 12)."""

import numpy as np
import pytest
import torch

from sda_tpu.fields import chacha as ref_chacha
from sda_tpu.fields import chacha_jax

from sda_tpu_torch.fields import chacha, chacha_device

P29 = (1 << 29) - 679
#: moduli of the checks: small, the flagship prime, 2^61 - 1 (a flat int64
#: sum of 4+ masks wraps) and 3 * 2^60 + 1 (1 draw in 16 lies outside the
#: acceptance zone, so nearly every seed is replayed on the host)
MODULI = [433, P29, (1 << 61) - 1, 3 * (1 << 60) + 1]
PRGS = [chacha.CHACHA_PRG_V1, chacha.CHACHA_PRG_RAND03]
SEEDS = [[0], [1, 2, 3, 4], [0xFFFFFFFF] * 8, [0xDEADBEEF, 0x12345678]]


def _seed_rows(n, rng_seed):
    rng = np.random.default_rng(rng_seed)
    return [[int(w) for w in row]
            for row in rng.integers(0, 1 << 32, size=(n, 4))]


def _words(seed):
    w = np.zeros(8, dtype=np.uint32)
    w[:len(seed)] = np.asarray(seed, dtype=np.uint64).astype(np.uint32)
    return w


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("nblocks,counter0", [(1, 0), (3, 0), (7, 5),
                                               (4, (1 << 32) - 2)])
def test_block_words_match_jax(seed, nblocks, counter0):
    sw = _words(seed)
    got = chacha_device.chacha_block_words(
        torch.from_numpy(sw.astype(np.int64)), counter0, nblocks=nblocks)
    want = np.asarray(chacha_jax.chacha_block_words(
        sw, np.uint32(counter0), nblocks=nblocks))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        got.numpy(), ref_chacha.chacha_block_words(seed, counter0, nblocks))


@pytest.mark.parametrize("prg", PRGS)
@pytest.mark.parametrize("modulus", MODULI)
@pytest.mark.parametrize("dimension", [9, 1000])
def test_expand_mask_matches_jax(prg, modulus, dimension):
    seed = _seed_rows(1, dimension + modulus % 97)[0]
    got = chacha_device.expand_mask(seed, dimension, modulus, prg=prg,
                                    device="cpu")
    want = chacha_jax.expand_mask(seed, dimension, modulus, prg=prg)
    assert got.dtype == np.int64 and got.shape == (dimension,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prg", PRGS)
@pytest.mark.parametrize("modulus", MODULI)
@pytest.mark.parametrize("dimension", [1, 7, 8, 9, 100, 1000])
def test_expand_mask_matches_host_spec(prg, modulus, dimension):
    for seed in SEEDS + _seed_rows(2, dimension):
        np.testing.assert_array_equal(
            chacha_device.expand_mask(seed, dimension, modulus, prg=prg,
                                      device="cpu"),
            ref_chacha.expand_mask_for(prg, seed, dimension, modulus))


@pytest.mark.parametrize("prg", PRGS)
@pytest.mark.parametrize("modulus", MODULI)
def test_no_reject_draws_and_flags_match_jax(prg, modulus):
    """The kernel's own output (draws without rejection and the per-seed
    flags) equals the JAX module's ``_expand_no_reject`` on every seed,
    replayed or not (d = 1000: the JAX function compiled for
    test_expand_mask_matches_jax)."""
    for seed in _seed_rows(6, 7):
        sw = torch.from_numpy(_words(seed).astype(np.int64))[None, :]
        masks, rejected = chacha_device.chacha_kernel(
            "expand", sw, dimension=1000, modulus=modulus, prg=prg)
        want, want_rej = chacha_jax._expand_no_reject(
            _words(seed), dimension=1000, modulus=modulus, prg=prg)
        np.testing.assert_array_equal(masks[0].numpy(), np.asarray(want))
        assert bool(rejected[0]) == bool(want_rej)


def test_replay_is_forced_at_three_times_two_to_the_sixty():
    """At 3 * 2^60 + 1 a draw lies outside the zone with probability 1/16,
    so a 1000-wide mask is replayed: the result is still the host spec's."""
    m = 3 * (1 << 60) + 1
    seeds = _seed_rows(5, 3)
    chacha_device.chacha_kernel.replayed = 0
    got = chacha_device.combine_masks(seeds, 1000, m,
                                      prg=chacha.CHACHA_PRG_V1, device="cpu")
    assert chacha_device.chacha_kernel.replayed == 5
    want = np.zeros(1000, dtype=object)
    for s in seeds:
        want = (want + ref_chacha.expand_mask(s, 1000, m)) % m
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("prg,modulus", [
    (chacha.CHACHA_PRG_V1, 433), (chacha.CHACHA_PRG_V1, P29),
    (chacha.CHACHA_PRG_RAND03, P29),
    (chacha.CHACHA_PRG_V1, (1 << 61) - 1),
    (chacha.CHACHA_PRG_V1, 3 * (1 << 60) + 1),
    (chacha.CHACHA_PRG_RAND03, 3 * (1 << 60) + 1)])
def test_combine_masks_matches_jax(prg, modulus):
    seeds = _seed_rows(5, modulus % 101)
    got = chacha_device.combine_masks(seeds, 1000, modulus, prg=prg,
                                      device="cpu")
    np.testing.assert_array_equal(
        got, chacha_jax.combine_masks(seeds, 1000, modulus, prg=prg))


def test_combine_masks_large_modulus_no_i64_overflow():
    """Nine masks at 2^61 - 1: a flat int64 sum would wrap."""
    modulus, dimension = (1 << 61) - 1, 33
    seeds = _seed_rows(9, 61)
    got = chacha_device.combine_masks(seeds, dimension, modulus,
                                      prg=chacha.CHACHA_PRG_V1, device="cpu")
    want = np.zeros(dimension, dtype=object)
    for s in seeds:
        want = (want + ref_chacha.expand_mask(s, dimension, modulus)) % modulus
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(got, chacha_jax.combine_masks(
        seeds, dimension, modulus, prg=chacha.CHACHA_PRG_V1))


@pytest.mark.parametrize("counter0", [0, 1, 12345, (1 << 32) - 2])
@pytest.mark.parametrize("modulus", [P29, (1 << 61) - 1])
def test_stream_window_matches_jax_stream(counter0, modulus):
    """The windowed V1 stream, reduced mod m: ``stream_u64_at`` then
    ``FieldOps.from_u64`` in the JAX package."""
    rng = np.random.default_rng(counter0 % 1000)
    sw = rng.integers(0, 1 << 32, size=(3, 8)).astype(np.uint32)
    got = chacha_device.stream_residues_at(
        torch.from_numpy(sw.astype(np.int64)), counter0, dimension=48,
        modulus=modulus)
    want = np.asarray(chacha_jax.stream_u64_at(
        sw, np.uint32(counter0), dimension=48)) % np.uint64(modulus)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_stream_window_needs_whole_blocks():
    with pytest.raises(ValueError, match="multiple of 8"):
        chacha_device.stream_residues_at(torch.zeros((1, 8), dtype=torch.int64),
                                         0, dimension=12, modulus=433)


@pytest.mark.parametrize("modulus", [0, 1 << 62])
def test_rejects_out_of_range_modulus(modulus):
    with pytest.raises(ValueError, match="modulus out of range"):
        chacha_device.combine_masks([[1]], 4, modulus,
                                    prg=chacha.CHACHA_PRG_V1, device="cpu")
    with pytest.raises(ValueError, match="modulus out of range"):
        chacha_device.expand_mask([1], 4, modulus, prg=chacha.CHACHA_PRG_V1,
                                  device="cpu")


def test_rejects_unknown_prg_and_long_seed():
    with pytest.raises(ValueError, match="unknown ChaCha PRG"):
        chacha_device.expand_mask([1], 4, 433, prg="nope", device="cpu")
    with pytest.raises(ValueError, match="256 bits"):
        chacha_device.combine_masks([[1] * 9], 4, 433,
                                    prg=chacha.CHACHA_PRG_V1, device="cpu")


@pytest.mark.parametrize("prg", PRGS)
def test_native_oracle_agreement(prg):
    """The port's native C++ expansion and combine agree with K3's plain
    version."""
    from sda_tpu_torch import native

    if not native.available():
        pytest.skip("native library unavailable")
    seeds = _seed_rows(4, 5)
    for m in (433, P29, (1 << 61) - 1):
        np.testing.assert_array_equal(
            chacha_device.expand_mask(seeds[0], 123, m, prg=prg,
                                      device="cpu"),
            native.chacha_expand_mask(seeds[0], 123, m, prg=prg))
        np.testing.assert_array_equal(
            chacha_device.combine_masks(seeds, 123, m, prg=prg,
                                        device="cpu"),
            native.chacha_combine_masks(np.asarray(seeds, dtype=np.int64),
                                        123, m, prg=prg))


def test_u64_mod_is_exact_at_the_edges():
    m = 3 * (1 << 60) + 1
    halves = [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0x80000000, 1),
              (0x30000000, 0), (0x12345678, 0x9ABCDEF0)]
    hi = torch.tensor([h for h, _ in halves], dtype=torch.int64)
    lo = torch.tensor([v for _, v in halves], dtype=torch.int64)
    for mod in (1, 433, m, (1 << 62) - 1):
        got = chacha_device.u64_mod(hi, lo, mod).tolist()
        assert got == [((h << 32) | v) % mod for h, v in halves]


def test_cpu_tensors_take_the_plain_version():
    """On a CPU tensor the wrapper runs the plain version and counts no
    launch."""
    before = chacha_device.chacha_kernel.launches
    chacha_device.chacha_kernel("combine", torch.ones((2, 8), dtype=torch.int64),
                                dimension=16, modulus=433)
    assert chacha_device.chacha_kernel.launches == before
