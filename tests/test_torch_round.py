"""The port's two single-device rounds (plain torch and fused kernel, run
on the CPU) against the JAX package's ``single_chip_round`` and the plain
column sum mod p. Exact equality: masks cancel and the share randomness is
annihilated by reconstruction, so the aggregate is exact for any draws."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu import protocol as ref_proto
from sda_tpu.fields import numtheory as ref_nt
from sda_tpu.mesh import single_chip_round as ref_single_chip_round

from sda_tpu_torch import protocol as proto
from sda_tpu_torch.fields import fused_round
from sda_tpu_torch.fields.fused_round import single_chip_round_pallas
from sda_tpu_torch.mesh import single_chip_round
from sda_tpu_torch.mesh import simpod

T, P29, W2, W3 = ref_nt.generate_packed_params(3, 8, 28)
REF_SCHEMES = {
    "flagship": ref_proto.PackedShamirSharing(3, 8, T, P29, W2, W3),
    "packed433": ref_proto.PackedShamirSharing(3, 8, 4, 433, 354, 150),
    "additive433": ref_proto.AdditiveSharing(5, 433),
    "basic": ref_proto.BasicShamirSharing(8, 3, P29),
}


def _modulus(s):
    return getattr(s, "prime_modulus", None) or s.modulus


def _masking(pkg, s, masked):
    return pkg.FullMasking(_modulus(s)) if masked else pkg.NoMasking()


def _port(name):
    return proto.LinearSecretSharingScheme.from_obj(REF_SCHEMES[name].to_obj())


@functools.lru_cache(maxsize=None)
def _inputs(P, d, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 20, size=(P, d), dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _reference(name, P, d, masked, dim_tile, seed):
    s = REF_SCHEMES[name]
    fn = ref_single_chip_round(s, _masking(ref_proto, s, masked),
                               dim_tile=dim_tile)
    out = np.asarray(jax.jit(fn)(jnp.asarray(_inputs(P, d, seed)),
                                 jax.random.PRNGKey(seed)))
    out.setflags(write=False)
    return out


def _check(name, P, d, masked, dim_tile, seed, rounds):
    x = _inputs(P, d, seed)
    want = x.astype(np.int64).sum(0) % _modulus(REF_SCHEMES[name])
    ref = _reference(name, P, d, masked, dim_tile, seed)
    np.testing.assert_array_equal(ref, want)
    s = _port(name)
    for make in rounds:
        fn = make(s, _masking(proto, s, masked), dim_tile=dim_tile,
                  device="cpu")
        out = fn(x, torch.Generator().manual_seed(seed))
        assert out.dtype == torch.int64 and out.shape == (d,)
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("dim_tile", [None, 1000])
@pytest.mark.parametrize("masked", [True, False], ids=["full", "none"])
@pytest.mark.parametrize("d", [3000, 2999], ids=["on_grain", "off_grain"])
def test_flagship_rounds_match_reference(d, masked, dim_tile):
    """P=100 participants, the flagship scheme; d=3000 is a whole number
    of 24-wide tile grains, 2999 is not."""
    _check("flagship", 100, d, masked, dim_tile, seed=d,
           rounds=(single_chip_round, single_chip_round_pallas))


@pytest.mark.parametrize("name", ["packed433", "additive433"])
@pytest.mark.parametrize("masked", [True, False], ids=["full", "none"])
def test_generic_prime_rounds_match_reference(name, masked):
    _check(name, 12, 101, masked, None, seed=5, rounds=(single_chip_round,))


@pytest.mark.parametrize("dim_tile", [None, 40])
def test_basic_shamir_rounds_match_reference(dim_tile):
    _check("basic", 7, 150, True, dim_tile, seed=6,
           rounds=(single_chip_round, single_chip_round_pallas))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_signed_inputs_reduce_like_reference(dtype):
    """Negative inputs aggregate to their floor-mod residues in both rounds."""
    rng = np.random.default_rng(9)
    x = rng.integers(-(1 << 30), 1 << 30, size=(6, 99)).astype(dtype)
    s = _port("flagship")
    want = x.astype(np.int64).sum(0) % P29
    for make in (single_chip_round, single_chip_round_pallas):
        out = make(s, proto.FullMasking(P29), device="cpu")(
            torch.from_numpy(x), torch.Generator().manual_seed(1))
        np.testing.assert_array_equal(out.numpy(), want)


def test_fused_round_draws_one_host_seed_per_tile(monkeypatch):
    """Each tile launches the kernel once at the tile's shapes, keyed by
    the next draw of the CPU generator, and the round stays exact."""
    s = _port("flagship")
    calls = []
    kernel = fused_round.fused_mask_share_combine

    def spy(x_cols, seed, *args, **kwargs):
        calls.append((tuple(x_cols.shape), seed))
        return kernel(x_cols, seed, *args, **kwargs)

    monkeypatch.setattr(fused_round, "fused_mask_share_combine", spy)
    x = _inputs(10, 700, 3)
    fn = single_chip_round_pallas(s, proto.FullMasking(P29), dim_tile=240,
                                  device="cpu")
    out = fn(x, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(out.numpy(), x.astype(np.int64).sum(0) % P29)
    g = torch.Generator().manual_seed(0)
    seeds = [int(torch.randint(0, 1 << 62, (), generator=g)) for _ in range(3)]
    assert calls == [((10, 3, 80), seed) for seed in seeds]
    assert len(set(seeds)) == 3


def test_rounds_reject_unsupported_configs():
    s = _port("flagship")
    chacha = proto.ChaChaMasking(P29, 10, 128)
    with pytest.raises(ValueError, match="ChaCha"):
        single_chip_round(s, chacha, device="cpu")
    with pytest.raises(ValueError, match="None or Full"):
        single_chip_round_pallas(s, chacha, device="cpu")
    with pytest.raises(ValueError, match="masks would not cancel"):
        single_chip_round(s, proto.FullMasking(433), device="cpu")
    with pytest.raises(ValueError, match="Solinas"):
        single_chip_round_pallas(_port("packed433"), device="cpu")
    assert simpod._scheme_modulus(_port("additive433")) == 433
    assert simpod._build_matrices(_port("additive433")) == (None, None)
