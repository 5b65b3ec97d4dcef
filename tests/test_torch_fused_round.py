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
SCHEMES = {
    "packed": ref_proto.PackedShamirSharing(3, 8, T, P29, W2, W3),
    "basic": ref_proto.BasicShamirSharing(8, 3, P29),
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


@pytest.mark.parametrize("scheme,masked", [("packed", True), ("packed", False),
                                           ("basic", True)])
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
    library: both kernels include philox.cuh."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("fused_round", "kernel_probe")
    for name in names:
        assert [p.name for p in _build.sources(name)] == \
            [f"{name}.cu", "philox.cuh"]
    before = {name: _build.library_path(name) for name in names}
    header = csrc / "philox.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {name: _build.library_path(name) for name in names}
    assert all(edited[name] != before[name] for name in names)
    assert all(edited[name].name.startswith(f"lib{name}_") for name in names)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert all(_build.library_path(name) != edited[name] for name in names)
