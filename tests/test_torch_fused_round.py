"""K1, the fused mask-share-combine kernel: its plain version (what the
wrapper runs on a CPU tensor) against the JAX package's Pallas kernel in
interpret mode, fed the same seeded numpy inputs and bits. Exact equality.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against this plain version there.
"""

import contextlib
import itertools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.fields import fastfield as ref_ff
from sda_tpu.fields import numtheory as ref_nt
from sda_tpu.fields import pallas_round as ref_pr
from sda_tpu.fields.sharing import batch_columns as ref_batch_columns
from sda_tpu import protocol as ref_proto

from sda_tpu_torch.fields import _build, fused_round
from sda_tpu_torch.fields.fastfield import SolinasPrime

T, P29, W2, W3 = ref_nt.generate_packed_params(3, 8, 28)
#: sda-sim --secrets-per-batch 7 --clerks 26: k=7, t=8 over 2^29 - 2479
T26, P26, W2_26, W3_26 = ref_nt.generate_packed_params(7, 26, 28)
SCHEMES = {
    "packed": ref_proto.PackedShamirSharing(3, 8, T, P29, W2, W3),
    "basic": ref_proto.BasicShamirSharing(8, 3, P29),
    "packed26": ref_proto.PackedShamirSharing(7, 26, T26, P26, W2_26, W3_26),
}
#: the Pallas kernel's fold settings; every one gives the same output
SETTINGS = [dict(p_block=16), dict(p_block=2, tree_fold=True),
            dict(p_block=4, tree_fold=True), dict(p_block=3),
            dict(p_block=8, tree_fold=True)]


@pytest.fixture
def pallas_x64(monkeypatch):
    """The installed jax's ``enable_x64`` is a config State, which the
    Pallas wrapper cannot call; stand in a context manager that sets and
    restores ``jax_enable_x64`` (test-side only, the package is unchanged)."""

    @contextlib.contextmanager
    def enable_x64(flag=True):
        old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", bool(flag))
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", old)

    monkeypatch.setattr(jax, "enable_x64", enable_x64)


def _inputs(scheme, P, B, masked, seed):
    k, t = scheme.secret_count, scheme.privacy_threshold
    draws = (k + t) if masked else t
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=(P, k, B), dtype=np.uint32)  # raw words
    bits = rng.integers(0, 1 << 32, size=(P, 2 * draws, B), dtype=np.uint32)
    return x, bits


def _port(scheme, x, bits, masked, seed=0):
    sp = SolinasPrime.try_from(scheme.prime_modulus)
    m_host = ref_nt.share_matrix_for(scheme)
    return fused_round.fused_mask_share_combine(
        torch.from_numpy(x), seed, sp, m_host, scheme.privacy_threshold,
        masked, external_bits=None if bits is None else torch.from_numpy(bits))


def _pallas(scheme, x, bits, masked, **setting):
    rsp = ref_ff.SolinasPrime.try_from(scheme.prime_modulus)
    return ref_pr.fused_mask_share_combine(
        jnp.asarray(x), 0, rsp, ref_nt.share_matrix_for(scheme),
        scheme.privacy_threshold, masked, tile=128,
        external_bits=jnp.asarray(bits), interpret=True, **setting)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


CASES = [(s, m, P, B, SETTINGS[i % len(SETTINGS)]) for i, (s, m, P, B) in
         enumerate(itertools.product(sorted(SCHEMES), [True, False],
                                     [2, 7, 16], [128, 256]))]


@pytest.mark.parametrize(
    "scheme,masked,P,B,setting", CASES,
    ids=[f"{s}-{'full' if m else 'none'}-P{P}-B{B}-"
         f"pb{st['p_block']}{'-tree' if st.get('tree_fold') else ''}"
         for s, m, P, B, st in CASES])
def test_plain_matches_pallas_kernel(pallas_x64, scheme, masked, P, B, setting):
    s = SCHEMES[scheme]
    x, bits = _inputs(s, P, B, masked, seed=P * 1000 + B + masked)
    got = _port(s, x, bits, masked)
    _assert_same(got, _pallas(s, x, bits, masked, **setting))
    if not masked:
        assert not got[1].any()


def test_every_pallas_setting_gives_the_one_output(pallas_x64):
    s = SCHEMES["packed"]
    x, bits = _inputs(s, 16, 128, True, seed=77)
    got = _port(s, x, bits, True)
    for setting in SETTINGS:
        _assert_same(got, _pallas(s, x, bits, True, **setting))


def test_plain_matches_xla_recipe_same_bits():
    """The recipe of test_pallas_round.py's XLA cross-check: per-
    participant fastfield shares folded with modsum32, from the same bits."""
    s = SCHEMES["packed"]
    rsp = ref_ff.SolinasPrime.try_from(P29)
    k, t = s.secret_count, s.privacy_threshold
    m_host = ref_nt.share_matrix_for(s)
    P, d = 4, 384
    B = d // k
    rng = np.random.default_rng(22)
    xd = rng.integers(0, P29, size=(P, d)).astype(np.uint32)
    x_cols = np.array(ref_batch_columns(jnp.asarray(xd), k))
    bits = rng.integers(0, 1 << 32, size=(P, 2 * (k + t), B), dtype=np.uint32)
    jb = jnp.asarray(bits)
    mask = ref_pr._uniform_from_bits(jb[:, 0:k, :], jb[:, k:2 * k, :], rsp)
    rand = ref_pr._uniform_from_bits(jb[:, 2 * k:2 * k + t, :],
                                     jb[:, 2 * k + t:2 * (k + t), :], rsp)
    masked_cols = ref_ff.modadd32(jnp.asarray(x_cols), mask, rsp)
    values = jnp.concatenate(
        [jnp.zeros((P, 1, B), jnp.uint32), masked_cols, rand], axis=1)
    per_part = ref_ff.modmatmul32(m_host, values, rsp)           # [P, n, B]
    _assert_same(_port(s, x_cols, bits, True),
                 (ref_ff.modsum32(per_part, rsp, axis=0),
                  ref_ff.modsum32(mask, rsp, axis=0)))


# -- internal draws: Philox4x32-10 -----------------------------------------

M32 = 0xFFFFFFFF


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's published philox4x32-10 known-answer vectors."""
    out = fused_round.philox4x32_10(
        *[torch.tensor([c], dtype=torch.int64) for c in ctr], *key)
    assert tuple(int(o) for o in out) == want


def test_philox_bits_layout():
    """A value row keeps its words whatever the masking: only its place in
    the external layout moves (hi rows, then lo rows, per draw)."""
    k, t, P, B = 3, 4, 5, 70
    full = fused_round.philox_bits(2**40 + 5, P, k, t, B, True, "cpu")
    none = fused_round.philox_bits(2**40 + 5, P, k, t, B, False, "cpu")
    assert full.shape == (P, 14, B) and none.shape == (P, 8, B)
    assert torch.equal(full[:, 2 * k:], none)
    assert int(full.min()) >= 0 and int(full.max()) <= M32
    assert not torch.equal(full[:, :k], full[:, k:2 * k])
    other = fused_round.philox_bits(2**40 + 6, P, k, t, B, True, "cpu")
    assert not torch.equal(full, other)


@pytest.mark.parametrize("col0,width", [(0, 70), (1, 30), (40, 30),
                                         (69, 1)])
def test_philox_bits_column_window(col0, width):
    """``col0`` gives a column window's draws of a wider call: its slice of
    the whole call's words, and (as ``external_bits``) the plain version's
    shares of that window."""
    s = SCHEMES["packed"]
    k, t, P, B, seed = s.secret_count, s.privacy_threshold, 5, 70, 2**40 + 5
    whole = fused_round.philox_bits(seed, P, k, t, B, False, "cpu")
    window = fused_round.philox_bits(seed, P, k, t, width, False, "cpu",
                                     col0=col0)
    assert torch.equal(window, whole[:, :, col0:col0 + width])
    x, _ = _inputs(s, P, B, False, seed=4)
    x_cols = torch.from_numpy(x)
    args = (seed, SolinasPrime.try_from(s.prime_modulus),
            ref_nt.share_matrix_for(s), t, False)
    full = fused_round.fused_mask_share_combine_plain(x_cols, *args)
    part = fused_round.fused_mask_share_combine_plain(
        x_cols[:, :, col0:col0 + width], *args, external_bits=window)
    assert torch.equal(part[0], full[0][:, col0:col0 + width])


@pytest.mark.parametrize("scheme,masked", [("packed", True), ("packed", False),
                                           ("basic", True), ("packed26", True),
                                           ("packed26", False)])
def test_internal_mode_draws_philox_bits(scheme, masked):
    s = SCHEMES[scheme]
    k, t = s.secret_count, s.privacy_threshold
    x, _ = _inputs(s, 6, 100, masked, seed=3)
    seed = 123456789012
    got = _port(s, x, None, masked, seed=seed)
    bits = fused_round.philox_bits(seed, 6, k, t, 100, masked, "cpu")
    _assert_same(got, _port(s, x, bits.numpy().astype(np.uint32), masked))


def test_internal_mode_round_is_exact_sum():
    s = SCHEMES["packed"]
    rng = np.random.default_rng(8)
    x = rng.integers(0, 1 << 20, size=(9, 601), dtype=np.uint32)
    fn = fused_round.single_chip_round_pallas(
        fused_round_scheme(s), _full(s), device="cpu")
    out = fn(x, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(out.numpy(), x.astype(np.int64).sum(0) % P29)


def fused_round_scheme(ref_scheme):
    from sda_tpu_torch.protocol import LinearSecretSharingScheme

    return LinearSecretSharingScheme.from_obj(ref_scheme.to_obj())


def _full(ref_scheme):
    from sda_tpu_torch.protocol import FullMasking

    return FullMasking(ref_scheme.prime_modulus)


# -- the wrapper's contract -------------------------------------------------

def test_wrapper_validates_shapes_and_device():
    s = SCHEMES["packed"]
    sp = SolinasPrime.try_from(P29)
    m_host = ref_nt.share_matrix_for(s)
    x = torch.zeros((2, 3, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="share matrix width"):
        fused_round.fused_mask_share_combine(x, 0, sp, m_host[:, :-1], T, True)
    with pytest.raises(ValueError, match="external_bits shape"):
        fused_round.fused_mask_share_combine(
            x, 0, sp, m_host, T, True,
            external_bits=torch.zeros((2, 8, 10), dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_round.fused_mask_share_combine(
            torch.empty((2, 3, 10), dtype=torch.int32, device="meta"),
            0, sp, m_host, T, True)


def test_cpu_tensor_never_counts_a_launch():
    s = SCHEMES["packed"]
    x, bits = _inputs(s, 2, 16, True, seed=1)
    before = fused_round.fused_mask_share_combine.launches
    _port(s, x, bits, True)
    assert fused_round.fused_mask_share_combine.launches == before


def test_build_is_for_hopper_and_raises_without_nvcc(monkeypatch, tmp_path):
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    lib = _build.library_path("fused_round")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("libfused_round_")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("fused_round")


def test_build_key_covers_included_headers_and_flags(monkeypatch, tmp_path):
    """An edited shared header or compiler flag must not load a stale
    library: both kernels include columns.cuh, which includes philox.cuh."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("fused_round", "kernel_probe")
    for name in names:
        assert [p.name for p in _build.sources(name)] == \
            [f"{name}.cu", "columns.cuh", "philox.cuh"]
    before = {name: _build.library_path(name) for name in names}
    header = csrc / "philox.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {name: _build.library_path(name) for name in names}
    assert all(edited[name] != before[name] for name in names)
    assert all(edited[name].name.startswith(f"lib{name}_") for name in names)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert all(_build.library_path(name) != edited[name] for name in names)


# -- the accumulate options (the streamed step's donated accumulators) -------

def _near_top(shape, p, seed):
    """Canonical residues within 2 of p - 1: every add wraps."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(p - 1 - rng.integers(0, 3, size=shape))


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("ragged", [False, True])
def test_accumulate_options_add_in_place(pallas_x64, scheme, masked, ragged):
    """K1 with ``acc_shares`` / ``acc_mask`` adds its outputs mod p into the
    caller's accumulators in place (the same storage comes back): the
    shares as ``f.add`` of the Pallas kernel's, fed the same bits, and the
    mask totals at their unbatched positions b k + j of the [d]
    accumulator, a padded column's dropped (``ragged``: d < k B)."""
    from sda_tpu.fields.ops import FieldOps as RefFieldOps
    from sda_tpu.fields.sharing import unbatch_columns as ref_unbatch

    s = SCHEMES[scheme]
    k, p = s.secret_count, s.prime_modulus
    P, B = 5, 128
    d = k * B - (k - 1 if ragged else 0)
    x, bits = _inputs(s, P, B, masked, seed=B + k + masked)
    acc_s = _near_top((s.share_count, B), p, 1)
    acc_m = _near_top((d,), p, 2) if masked else None
    into = (acc_s.clone(), None if acc_m is None else acc_m.clone())
    ptrs = (into[0].data_ptr(), None if acc_m is None else into[1].data_ptr())
    sp = SolinasPrime.try_from(p)
    got = fused_round.fused_mask_share_combine(
        torch.from_numpy(x), 0, sp, ref_nt.share_matrix_for(s),
        s.privacy_threshold, masked, external_bits=torch.from_numpy(bits),
        acc_shares=into[0], acc_mask=into[1])
    assert got[0] is into[0] and got[0].data_ptr() == ptrs[0]
    shares, mask_tot = _pallas(s, x, bits, masked, p_block=16)
    f = RefFieldOps.create(p)
    np.testing.assert_array_equal(
        got[0].numpy(), np.asarray(f.add(acc_s.numpy(), shares), np.int64))
    if masked:
        assert got[1] is into[1] and got[1].data_ptr() == ptrs[1]
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(f.add(
            acc_m.numpy(), ref_unbatch(mask_tot, d)), np.int64))
    else:  # no mask accumulator: the [k, B] totals, zero
        assert got[1].shape == (k, B) and not got[1].any()


@pytest.mark.parametrize("scheme,masked", [("packed", True), ("basic", False),
                                           ("packed26", True)])
def test_accumulate_options_in_internal_mode(scheme, masked):
    """With internal draws the accumulate equals ``f.add`` of the fresh
    call's outputs (the kernel's plain version on a CPU tensor), twice in
    a row into the same accumulators, as a streamed dim tile's steps do."""
    from sda_tpu_torch.fields.ops import FieldOps
    from sda_tpu_torch.fields.sharing import unbatch_columns

    s = SCHEMES[scheme]
    k, p, n = s.secret_count, s.prime_modulus, s.share_count
    x, _ = _inputs(s, 6, 64, masked, seed=9)
    sp = SolinasPrime.try_from(p)
    args = (torch.from_numpy(x), 0, sp, ref_nt.share_matrix_for(s),
            s.privacy_threshold, masked)
    acc_s, acc_m = _near_top((n, 64), p, 3), _near_top((k * 64,), p, 4)
    want_s, want_m = acc_s.clone(), acc_m.clone()
    f = FieldOps.create(p)
    for seed in (11, 12):
        fresh = fused_round.fused_mask_share_combine(*args[:1], seed,
                                                     *args[2:])
        want_s = f.add(want_s, fresh[0])
        want_m = f.add(want_m, unbatch_columns(fresh[1], k * 64))
        fused_round.fused_mask_share_combine(
            *args[:1], seed, *args[2:], acc_shares=acc_s,
            acc_mask=acc_m if masked else None)
    assert torch.equal(acc_s, want_s)
    if masked:
        assert torch.equal(acc_m, want_m)


@pytest.mark.parametrize("case,kw,match", [
    ("shares dtype", dict(acc_shares=torch.zeros((8, 10), dtype=torch.int32)),
     "acc_shares must be int64"),
    ("shares shape", dict(acc_shares=torch.zeros((8, 11), dtype=torch.int64)),
     "acc_shares must be \\[8, 10\\]"),
    ("shares strided", dict(acc_shares=torch.zeros(
        (10, 8), dtype=torch.int64).t()), "acc_shares must be contiguous"),
    ("mask too short", dict(acc_mask=torch.zeros(27, dtype=torch.int64)),
     "acc_mask must be \\[d\\] with 27 < d <= 30"),
    ("mask 2-D", dict(acc_mask=torch.zeros((3, 10), dtype=torch.int64)),
     "acc_mask must be \\[d\\]"),
    ("mask strided", dict(acc_mask=torch.zeros(60, dtype=torch.int64)[::2]),
     "acc_mask must be contiguous"),
    ("mask unmasked", dict(acc_mask=torch.zeros(30, dtype=torch.int64),
                           masked=False), "acc_mask needs a masked call"),
])
def test_accumulate_options_are_checked_never_copied(case, kw, match):
    """An accumulator that is not a contiguous int64 tensor of its shape on
    the kernel's device raises (a copy would lose the sum)."""
    s = SCHEMES["packed"]
    sp = SolinasPrime.try_from(P29)
    masked = kw.pop("masked", True)
    with pytest.raises(ValueError, match=match):
        fused_round.fused_mask_share_combine(
            torch.zeros((2, 3, 10), dtype=torch.int32), 0, sp,
            ref_nt.share_matrix_for(s), T, masked, **kw)


def test_k1_bound_counts_the_accumulators():
    """``bounds.k1_bound``'s ``acc_rows``: the accumulators' int64 rows are
    read once besides (8 a column at the streamed tile's n = 8)."""
    from sda_tpu_torch.benchmarks import bounds

    B = 1_048_576
    fresh = bounds.k1_bound(250, B, 3, 4, True, 8)
    acc = bounds.k1_bound(250, B, 3, 4, True, 8, acc_rows=8)
    nbytes = lambda b: int(b[2].split(" bytes")[0])
    assert nbytes(acc) - nbytes(fresh) == 8 * B * 8
    assert acc[1] == "operations" and acc[0] == fresh[0]
