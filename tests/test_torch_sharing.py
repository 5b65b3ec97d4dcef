"""Bit-identity of the port's sharing layer and dimension tiling with the
JAX package's, fed the same seeded numpy draws. Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.fields import dimtile as ref_dimtile
from sda_tpu.fields import fastfield as ref_ff
from sda_tpu.fields import numtheory as ref_nt
from sda_tpu.fields import sharing as ref_sharing

from sda_tpu_torch.fields import dimtile, sharing
from sda_tpu_torch.fields.fastfield import SolinasPrime

FLAGSHIP = ref_nt.generate_packed_params(3, 8, 28)   # (t, p, w2, w3)
P29 = FLAGSHIP[1]


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("lead", [(), (4,)])
@pytest.mark.parametrize("d,k", [(999, 3), (1000, 3), (1001, 3), (7, 1), (13, 5)])
def test_batch_unbatch_columns(d, k, lead):
    x = np.random.default_rng(d).integers(0, 1 << 20, size=lead + (d,))
    got = sharing.batch_columns(_t(x), k)
    _eq(got, ref_sharing.batch_columns(jnp.asarray(x), k))
    _eq(sharing.unbatch_columns(got, d),
        ref_sharing.unbatch_columns(ref_sharing.batch_columns(jnp.asarray(x), k), d))
    _eq(sharing.unbatch_columns(got, d), x)


def test_batch_columns_on_grain_is_a_view():
    x = torch.arange(2 * 12, dtype=torch.int32).reshape(2, 12)
    cols = sharing.batch_columns(x, 3)
    assert cols.data_ptr() == x.data_ptr() and cols.stride() == (12, 1, 3)


@pytest.mark.parametrize("m", [433, P29, (1 << 61) - 1])
def test_additive_share_and_combine(m):
    rng = np.random.default_rng(1)
    secrets = rng.integers(0, m, size=(3, 200))
    draws = rng.integers(0, m, size=(3, 4, 200))
    shares = sharing.additive_share_from_randomness(_t(secrets), _t(draws), modulus=m)
    _eq(shares, ref_sharing.additive_share_from_randomness(
        jnp.asarray(secrets), jnp.asarray(draws), modulus=m))
    _eq(sharing.combine(shares[0], modulus=m), secrets[0])
    _eq(sharing.combine(shares, modulus=m),
        ref_sharing.combine(jnp.asarray(shares.numpy()), modulus=m))
    fresh = sharing.additive_share(torch.Generator().manual_seed(2), _t(secrets),
                                   share_count=5, modulus=m)
    _eq(sharing.combine(torch.movedim(fresh, -2, 0), modulus=m), secrets)


@pytest.mark.parametrize("params", [(4, 433, 354, 150), FLAGSHIP])
def test_packed_share_from_randomness_and_reconstruct(params):
    t, p, w2, w3 = params
    m = ref_nt.packed_share_matrix(3, 8, t, p, w2, w3)
    l_ = ref_nt.packed_reconstruct_matrix(3, 8, t, p, w2, w3, tuple(range(8)))
    rng = np.random.default_rng(3)
    secrets = rng.integers(0, p, size=(2, 1000))
    rand = rng.integers(0, p, size=(2, t, 334))
    shares = sharing.packed_share_from_randomness(
        _t(secrets), _t(rand), m, prime=p, secret_count=3)
    _eq(shares, ref_sharing.packed_share_from_randomness(
        jnp.asarray(secrets), jnp.asarray(rand), jnp.asarray(m),
        prime=p, secret_count=3))
    got = sharing.packed_reconstruct(shares[1], l_, prime=p, dimension=1000)
    _eq(got, ref_sharing.packed_reconstruct(
        jnp.asarray(shares[1].numpy()), jnp.asarray(l_), prime=p, dimension=1000))
    _eq(got, secrets[1])
    fresh = sharing.packed_share(torch.Generator().manual_seed(4), _t(secrets), m,
                                 prime=p, secret_count=3, privacy_threshold=t)
    _eq(sharing.packed_reconstruct(fresh[0], l_, prime=p, dimension=1000), secrets[0])


def test_packed_share32_and_reconstruct32():
    t, p, w2, w3 = FLAGSHIP
    sp, rsp = SolinasPrime.try_from(p), ref_ff.SolinasPrime.try_from(p)
    m = ref_nt.packed_share_matrix(3, 8, t, p, w2, w3)
    rng = np.random.default_rng(5)
    for idx in (tuple(range(8)), (0, 2, 3, 5, 6, 7, 1), (1, 2, 3, 4, 5, 6, 7)):
        l_ = ref_nt.packed_reconstruct_matrix(3, 8, t, p, w2, w3, idx)
        rows = rng.integers(0, p, size=(len(idx), 334)).astype(np.uint32)
        rows[:, 0] = p - 1
        _eq(sharing.packed_reconstruct32(_t(rows), l_, sp, dimension=1000),
            ref_sharing.packed_reconstruct32(jnp.asarray(rows), l_, rsp,
                                             dimension=1000))
    secrets = rng.integers(0, p, size=(1000,))
    shares = sharing.packed_share32(torch.Generator().manual_seed(6), _t(secrets),
                                    m, sp, secret_count=3, privacy_threshold=t)
    l_ = ref_nt.packed_reconstruct_matrix(3, 8, t, p, w2, w3, (1, 3, 4, 5, 6, 7, 0))
    got = sharing.packed_reconstruct32(shares[[1, 3, 4, 5, 6, 7, 0]], l_, sp,
                                       dimension=1000)
    _eq(got, secrets)


def test_tile_plan_matches_reference_on_seeded_triples():
    rng = np.random.default_rng(7)
    triples = [(int(d), int(g), int(t)) for d, g, t in zip(
        rng.integers(1, 10**7, 200), rng.choice([1, 3, 8, 24, 40], 200),
        rng.integers(1, 10**6, 200))]
    triples += [(999_999, 24, 262_144), (24, 24, 24), (23, 24, 24), (1, 1, 1)]
    for d, g, t in triples:
        assert tuple(dimtile.tile_plan(d, g, t)) == \
            tuple(ref_dimtile.tile_plan(d, g, t)), (d, g, t)
        assert dimtile.tile_plan(d, g, t).padded_dim == \
            ref_dimtile.tile_plan(d, g, t).padded_dim
    for bad in ((10, 0, 5), (10, 3, 0)):
        with pytest.raises(ValueError):
            dimtile.tile_plan(*bad)


@pytest.mark.parametrize("d", [50, 96, 97, 250])
def test_scan_dim_tiles_covers_each_column_once(d):
    """Each tile sees its own columns (zero-padded at the ragged end) and
    the generator advances from tile to tile."""
    seen = []

    def one_tile(blk, generator, i, width):
        seen.append((i, width, int(torch.randint(0, 1 << 30, (), generator=generator))))
        return blk.to(torch.int64).sum(0)

    x = torch.from_numpy(np.random.default_rng(d).integers(0, 1 << 20, (4, d)))
    out = dimtile.scan_dim_tiles(one_tile, 8, 30)(x, torch.Generator().manual_seed(0))
    assert torch.equal(out, x.sum(0))
    plan = dimtile.tile_plan(d, 8, 30)
    assert [s[:2] for s in seen] == (
        [(0, d)] if d < 32 else [(i, plan.width) for i in range(plan.n_tiles)])
    assert len({s[2] for s in seen}) == len(seen)
