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


def _mask_inputs(S, d, modulus, seed):
    rng = np.random.default_rng(seed)
    sw = rng.integers(0, 1 << 32, size=(S, 8)).astype(np.uint32)
    x = rng.integers(0, modulus, size=(S, d)).astype(np.int64)
    return sw, x


@pytest.mark.parametrize("counter0", [0, 12345, (1 << 32) - 2])
@pytest.mark.parametrize("modulus,out_dtype", [
    (P29, torch.int32), (P29, torch.int64), ((1 << 61) - 1, torch.int64)])
def test_mask_op_matches_jax_mask_stage(modulus, counter0, out_dtype):
    """The mask op's plain version (a CPU tensor) equals the JAX package's
    ChaCha mask stage, ``f.add(x, f.from_u64(stream_u64_at(...)))`` and
    ``f.sum`` of the masks, exactly; the window from 2^32 - 2 wraps its
    block counter. int32 out only below 2^31."""
    from sda_tpu.fields.ops import FieldOps as RefFieldOps

    S, d = 5, 48
    sw, x = _mask_inputs(S, d, modulus, counter0 % 1000 + modulus % 7)
    f = RefFieldOps.create(modulus)
    masks = f.from_u64(chacha_jax.stream_u64_at(sw, np.uint32(counter0),
                                                dimension=d))
    want_masked = np.asarray(f.add(f.to_residues(x), masks), np.int64)
    want_sum = np.asarray(f.sum(masks, axis=0), np.int64)
    before = chacha_device.chacha_kernel.op_launches["mask"]
    got, got_sum = chacha_device.chacha_kernel(
        "mask", torch.from_numpy(sw.astype(np.int64)), counter0=counter0,
        x=torch.from_numpy(x), modulus=modulus, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (S, d)
    assert got_sum.dtype == torch.int64 and got_sum.shape == (d,)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want_masked)
    np.testing.assert_array_equal(got_sum.numpy(), want_sum)
    # a CPU tensor takes the plain version: no launch is counted
    assert chacha_device.chacha_kernel.op_launches["mask"] == before
    # the public entry is the same call
    again = chacha_device.mask_residues_at(
        torch.from_numpy(sw.astype(np.int64)), counter0, torch.from_numpy(x),
        modulus=modulus, out_dtype=out_dtype)
    assert torch.equal(again[0], got) and torch.equal(again[1], got_sum)


@pytest.mark.parametrize("counter0", [0, (1 << 32) - 2])
def test_mask_op_is_the_expand_added_and_summed(counter0):
    """The mask op's plain version is the expand's window added to x mod m
    and summed mod m; at 2^61 - 1 five masks overflow a flat int64 sum."""
    m = (1 << 61) - 1
    sw, x = _mask_inputs(5, 64, m, 3)
    words = torch.from_numpy(sw.astype(np.int64))
    masks = chacha_device.stream_residues_at(words, counter0, dimension=64,
                                             modulus=m)
    got, got_sum = chacha_device.mask_residues_at(
        words, counter0, torch.from_numpy(x), modulus=m)
    want = (x.astype(object) + masks.numpy().astype(object)) % m
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        got_sum.numpy(),
        (masks.numpy().astype(object).sum(axis=0) % m).astype(np.int64))


@pytest.mark.parametrize("case,kw,match", [
    ("int32 at 2^31", dict(modulus=1 << 31, out_dtype=torch.int32),
     "int32 out needs a modulus below 2\\^31"),
    ("int32 at 2^61 - 1", dict(modulus=(1 << 61) - 1,
                               out_dtype=torch.int32),
     "int32 out needs a modulus below 2\\^31"),
    ("ragged width", dict(d=12), "multiple of 8"),
    ("float out", dict(out_dtype=torch.float32), "int32 or int64"),
    ("int32 x", dict(x_dtype=torch.int32), "x must be int64"),
    ("rows", dict(rows=3), "x must be \\[S, d\\]"),
    ("no x", dict(no_x=True), "needs x"),
    ("rand 0.3", dict(prg=chacha.CHACHA_PRG_RAND03), "CHACHA_PRG_V1"),
])
def test_mask_op_argument_checks(case, kw, match):
    S, d = 2, kw.pop("d", 16)
    x = torch.zeros((kw.pop("rows", S), d), dtype=kw.pop("x_dtype",
                                                        torch.int64))
    if kw.pop("no_x", False):
        x = None
    with pytest.raises(ValueError, match=match):
        chacha_device.chacha_kernel(
            "mask", torch.zeros((S, 8), dtype=torch.int64), x=x,
            **{"modulus": P29, **kw})


def test_mask_op_counts_by_operation_and_refuses_other_devices():
    """``op_launches`` has the mask op beside the others (the card's
    launches are counted there; chip_smoke.py holds them); a tensor that
    is neither on the CPU nor on a CUDA device is refused, not run."""
    assert chacha_device.OPS == ("blocks", "expand", "combine", "mask")
    assert set(chacha_device.chacha_kernel.op_launches) == set(
        chacha_device.OPS)
    sw = torch.zeros((2, 8), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        chacha_device.chacha_kernel(
            "mask", sw, x=torch.zeros((2, 16), dtype=torch.int64,
                                      device="meta"), modulus=P29)


def test_k3_bounds_count_each_operation():
    """``benchmarks/bounds.py``'s K3 bound by operation at the streamed
    round's tile [250, 3,145,728]: the mask op moves x (int64) in, the
    masked rows (int32) out and the [d] sums, 9.46 GB (2.82 ms at 3.35
    TB/s), and is bound by its operations at the issue rate (4.37 ms),
    the expand by the ALU pipe's 640 operations a block (3.76 ms); the
    expand writes int64 residues; the combine one [d] row; the mask op's
    draws cost the raw x's reduction and two accumulates more than the
    expand's."""
    from sda_tpu_torch.benchmarks import bounds

    S, d = 250, 3_145_728
    ms, by, detail = bounds.k3_bound(S, d, "mask", 4)
    assert by == "operations" and ms == pytest.approx(4.3665, abs=1e-4)
    assert detail.startswith(f"{S * 32 + S * d * 12 + d * 8} bytes")
    assert bounds.k3_bound(S, d, "mask", 8)[1] == "operations"
    assert bounds.k3_bound(S, d, "expand")[0] == pytest.approx(3.7561,
                                                               abs=1e-4)
    assert bounds.k3_bound(1, 8 * 125_001, "blocks")[2].startswith(
        f"{32 + 125_001 * 64} bytes")
    _, alu, fma, expand_total = bounds._k3_ops(S, d, "expand")
    assert alu == S * d // 8 * 640 and fma == S * d * 7
    assert (bounds._k3_ops(S, d, "mask")[3] - expand_total
            == S * d * (2 * bounds.DRAW_ACCUMULATE_OPS + bounds.DRAW_MULS
                        + bounds.RAW_RESIDUE_EITHER_OPS))
    assert bounds.k3_pipe_ops(S, d, "combine") == alu
    with pytest.raises(ValueError, match="unknown K3 operation"):
        bounds.k3_bound(S, d, "fold")


def test_fold_ops_count_the_mask_op():
    """The perf plane's counted cost of a ChaCha fold step counts K3's
    mask op (stream, add and sum in one) where the unfused passes were."""
    from types import SimpleNamespace

    from sda_tpu_torch.benchmarks import bounds
    from sda_tpu_torch.mesh import simpod
    from sda_tpu_torch.protocol import ChaChaMasking, NoMasking
    from sda_tpu_torch.protocol import PackedShamirSharing

    scheme = PackedShamirSharing(3, 8, 4, 433, 354, 150)
    pod = SimpleNamespace(scheme=scheme, masking=ChaChaMasking(433, 48, 128),
                          pallas_active=False, _M_host=object())
    none = SimpleNamespace(**{**vars(pod), "masking": NoMasking()})
    assert (simpod._fold_ops(pod, 10, 48) - simpod._fold_ops(none, 10, 48)
            == bounds.k3_pipe_ops(10, 48, "mask"))


# -- the mask op's derived keys and accumulator (the streamed step's) --------

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)


def _philox_with_round_keys(ctr, keys):
    """Philox4x32-10 in Python ints on ``keys`` [2, 10], the round keys
    the kernels take (``philox_round_keys``; csrc/philox.cuh)."""
    c0, c1, c2, c3 = ctr
    for r in range(10):
        p0, p1 = _PHILOX_M[0] * c0, _PHILOX_M[1] * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ int(keys[0][r]),
                          p1 & 0xFFFFFFFF,
                          (p0 >> 32) ^ c3 ^ int(keys[1][r]),
                          p0 & 0xFFFFFFFF)
    return [c0, c1, c2, c3]


@pytest.mark.parametrize("round_seed", [0, 15, (1 << 62) - 12_345])
@pytest.mark.parametrize("pid_base", [0, 12_345, (1 << 32) - 3])
def test_seed_words_are_the_kernels_key_schedule(round_seed, pid_base):
    """``chacha_seed_words`` (the derived mode's plain version) is what
    csrc/chacha.cu's ``derive_keys`` computes from the round keys it is
    handed: Philox4x32-10 of (gid mod 2^32, gid >> 32, 0x5EED, pair) under
    ``philox_round_keys(round_seed)``, words 0-3 from pair 0, 4-7 from
    pair 1; ids past 2^32 carry into the second counter word."""
    from sda_tpu_torch.fields.fused_round import philox_round_keys

    keys = philox_round_keys(round_seed)
    ids = pid_base + torch.arange(5)
    got = chacha_device.chacha_seed_words(round_seed, ids, 256)
    for row, gid in zip(got.tolist(), ids.tolist()):
        want = []
        for pair in (0, 1):
            want += _philox_with_round_keys(
                (gid & 0xFFFFFFFF, gid >> 32, chacha_device.SEED_TAG, pair),
                keys)
        assert row == want


@pytest.mark.parametrize("bits", [32, 128, 256])
@pytest.mark.parametrize("pid_base", [0, 12_345, (1 << 32) - 3])
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("acc", [False, True])
def test_derived_mask_op_is_seed_words_then_mask(bits, pid_base, out_dtype,
                                                 acc):
    """The derived mode (``mask_residues_derived``) equals ``mask_plain`` on
    ``chacha_seed_words`` of ids pid_base .. pid_base + S - 1, whose masks
    are the JAX package's ``stream_u64_at`` windows of those keys (added
    to x and summed by its ``FieldOps``); with an accumulator near m - 1
    the sum is added into it in place. Words past ceil(bits / 32) are
    zero."""
    from sda_tpu.fields.ops import FieldOps as RefFieldOps

    S, d, c0, round_seed = 6, 48, 12_345, (1 << 62) - 7
    rng = np.random.default_rng(bits + pid_base % 97)
    x = rng.integers(-(1 << 62), 1 << 62, size=(S, d))  # raw, as a step's
    ids = pid_base + torch.arange(S)
    sw = chacha_device.chacha_seed_words(round_seed, ids, bits)
    assert (sw[:, -(-bits // 32):] == 0).all()
    f = RefFieldOps.create(P29)
    masks = f.from_u64(chacha_jax.stream_u64_at(
        sw.numpy().astype(np.uint32), np.uint32(c0), dimension=d))
    want_masked = np.asarray(f.add(f.to_residues(x), masks), np.int64)
    want_sum = np.asarray(f.sum(masks, axis=0), np.int64)
    near = torch.from_numpy(P29 - 1 - rng.integers(0, 3, size=d))
    into = near.clone() if acc else None
    got, got_sum = chacha_device.mask_residues_derived(
        round_seed, pid_base, bits, c0, torch.from_numpy(x), modulus=P29,
        out_dtype=out_dtype, acc_mask=into)
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want_masked)
    if acc:
        assert got_sum is into
        want_sum = np.asarray(f.add(near.numpy(), want_sum), np.int64)
    np.testing.assert_array_equal(got_sum.numpy(), want_sum)
    plain = chacha_device.mask_plain(sw, c0, torch.from_numpy(x), P29,
                                     out_dtype, near.clone() if acc else None)
    assert torch.equal(plain[0], got) and torch.equal(plain[1], got_sum)


@pytest.mark.parametrize("case,kw,match", [
    ("acc dtype", dict(seeds=None, derive=(1, 0, 128),
                       acc=torch.zeros(16, dtype=torch.int32)),
     "acc_mask must be int64"),
    ("acc shape", dict(seeds=None, derive=(1, 0, 128),
                       acc=torch.zeros(15, dtype=torch.int64)),
     "acc_mask must be \\[16\\]"),
    ("acc strided", dict(seeds=None, derive=(1, 0, 128),
                         acc=torch.zeros(32, dtype=torch.int64)[::2]),
     "acc_mask must be contiguous"),
    ("acc on another op", dict(op="expand", dimension=16,
                               acc=torch.zeros(16, dtype=torch.int64)),
     "only the derived mask mode accumulates"),
    ("acc with given seeds", dict(acc=torch.zeros(16, dtype=torch.int64)),
     "only the derived mask mode accumulates"),
    ("derive with seeds", dict(derive=(1, 0, 128)),
     "in place of seed words"),
    ("derive bits", dict(seeds=None, derive=(1, 0, 257)),
     "seed_bitsize 257"),
    ("derive ids", dict(seeds=None, derive=(1, (1 << 63) - 1, 128)),
     "outside int64"),
    ("derive seed", dict(seeds=None, derive=(1 << 64, 0, 128)),
     "round seed"),
])
def test_mask_op_options_are_checked(case, kw, match):
    """The derived mode and the accumulator are the mask op's, the
    accumulator the derived mode's only, checked before any work: an
    accumulator that is not a contiguous int64 [d] tensor on the op's
    device raises (it is never copied)."""
    seeds = kw.pop("seeds", torch.zeros((2, 8), dtype=torch.int64))
    with pytest.raises((ValueError, TypeError), match=match):
        chacha_device.chacha_kernel(
            kw.pop("op", "mask"), seeds,
            x=torch.zeros((2, 16), dtype=torch.int64), modulus=P29, **kw)


def test_k3_bound_counts_derived_keys_and_the_accumulator():
    """The derived mode reads no key words but derives two Philox blocks a
    seed, once a seed whatever the kernel's strips repeat; the accumulate
    reads the [d] sums."""
    from sda_tpu_torch.benchmarks import bounds

    S, d = 250, 3_145_728
    nbytes = lambda b: int(b[2].split(" bytes")[0])
    given = bounds.k3_bound(S, d, "mask", 4)
    derived = bounds.k3_bound(S, d, "mask", 4, derived=True,
                              accumulate=True)
    assert nbytes(derived) - nbytes(given) == d * 8 - S * 32
    _, alu, fma, _ = bounds._k3_ops(S, d, "mask", derived=True)
    _, alu0, fma0, _ = bounds._k3_ops(S, d, "mask")
    assert alu - alu0 == fma - fma0 == S * 40
    assert derived[1] == "operations" and derived[0] > given[0]


@pytest.mark.parametrize("cols, width", [(0, 16), (8, 16), (40, 96),
                                         (96, 96)])
@pytest.mark.parametrize("acc", [False, True])
def test_mask_op_width_reads_zeros_past_a_ragged_tile(cols, width, acc):
    """``mask_residues_derived(..., width=)`` on a ragged tile's [S, cols]
    x equals the op on x zero-padded to the width: the masks cover the
    whole window, and the columns past x's mask zeros; an accumulator is
    [width]."""
    S, c0, round_seed = 5, 77, 1234
    rng = np.random.default_rng(cols + width)
    x = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, size=(S, cols)))
    padded = torch.zeros((S, width), dtype=torch.int64)
    padded[:, :cols] = x
    into = (lambda: torch.full((width,), P29 - 2, dtype=torch.int64)) \
        if acc else (lambda: None)
    got = chacha_device.mask_residues_derived(
        round_seed, 3, 128, c0, x, modulus=P29, out_dtype=torch.int32,
        acc_mask=into(), width=width)
    want = chacha_device.mask_residues_derived(
        round_seed, 3, 128, c0, padded, modulus=P29, out_dtype=torch.int32,
        acc_mask=into())
    assert got[0].shape == (S, width)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("x_cols, width, match", [
    (16, 8, "narrower"), (12, 16, "multiple of 8"), (8, 12, "multiple of 8")])
def test_mask_op_width_is_checked(x_cols, width, match):
    with pytest.raises(ValueError, match=match):
        chacha_device.mask_residues_derived(
            1, 0, 128, 0, torch.zeros((2, x_cols), dtype=torch.int64),
            modulus=P29, width=width)
    with pytest.raises(ValueError, match="only the mask op"):
        chacha_device.chacha_kernel("expand", torch.zeros((1, 8)),
                                    dimension=8, modulus=P29, width=16)
