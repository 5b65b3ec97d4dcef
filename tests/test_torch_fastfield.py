"""Bit-identity of the port's field algebra (int64 torch) with the JAX
package's: the Solinas lane (fastfield), the generic lane (modular) and
the FieldOps dispatch, on the same seeded numpy inputs. Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.fields import fastfield as ref_ff
from sda_tpu.fields import modular as ref_mod
from sda_tpu.fields.ops import FieldOps as RefFieldOps
from sda_tpu.fields.pallas_round import _uniform_from_bits as ref_uniform_from_bits

from sda_tpu_torch.fields import fastfield as ff
from sda_tpu_torch.fields import modular
from sda_tpu_torch.fields.ops import FieldOps

P29 = 536870233   # 2^29 - 679, the flagship prime
P28 = 268435009   # 2^28 - 447
P20 = 1048573     # 2^20 - 3, the smallest Solinas width


def _eq(got, want):
    """Exact equality of a torch result with a JAX/numpy one, by value."""
    got = got.numpy().astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _t(a):
    """numpy ints -> int64 tensor (the port's residue dtype)."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("p", [P29, P28, P20, 433, (1 << 30) + 3,
                               (1 << 29) - (1 << 15), (1 << 21) - 1])
def test_try_from_gating(p):
    ref = ref_ff.SolinasPrime.try_from(p)
    got = ff.SolinasPrime.try_from(p)
    assert (got is None) == (ref is None)
    if got is not None:
        assert (got.p, got.b, got.delta) == (ref.p, ref.b, ref.delta)
    assert ff.supported(p) == ref_ff.supported(p)


@pytest.fixture(params=[P29, P28, P20])
def sps(request):
    return (ff.SolinasPrime.try_from(request.param),
            ref_ff.SolinasPrime.try_from(request.param))


def _words(rng, n, p):
    return np.concatenate([
        rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, p - 1, p, p + 1, 2**32 - 1, 2**31, 2**30],
                 dtype=np.uint32),
    ])


def test_canon32_full_range(sps):
    sp, rsp = sps
    v = _words(np.random.default_rng(0), 20000, sp.p)
    _eq(ff.canon32(_t(v), sp), ref_ff.canon32(jnp.asarray(v), rsp))


def test_addsub_mulconst_compose(sps):
    sp, rsp = sps
    rng = np.random.default_rng(1)
    p = sp.p
    a = np.concatenate([rng.integers(0, p, 20000), [0, p - 1]]).astype(np.uint32)
    b = np.concatenate([rng.integers(0, p, 20000), [p - 1, 0]]).astype(np.uint32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _eq(ff.modadd32(_t(a), _t(b), sp), ref_ff.modadd32(ja, jb, rsp))
    _eq(ff.modsub32(_t(a), _t(b), sp), ref_ff.modsub32(ja, jb, rsp))
    for c in (0, 1, 2, p - 1, int(rng.integers(0, p)), (1 << 32) % p):
        _eq(ff.mulmod32_const(_t(a), c, sp), ref_ff.mulmod32_const(ja, c, rsp))
    t1 = rng.integers(0, 1 << 31, 20000).astype(np.uint32)
    t0 = rng.integers(0, 1 << 31, 20000).astype(np.uint32)
    _eq(ff._compose(_t(t1), _t(t0), sp),
        ref_ff._compose(jnp.asarray(t1), jnp.asarray(t0), rsp))


def test_to_residues32_dtypes(sps):
    sp, rsp = sps
    rng = np.random.default_rng(2)
    u32 = _words(rng, 5000, sp.p)
    i32 = np.concatenate([
        rng.integers(-(1 << 31), 1 << 31, 5000),
        [-(1 << 31), -1, 0, 1, (1 << 31) - 1, -sp.p, sp.p]]).astype(np.int32)
    i64 = np.concatenate([
        rng.integers(-(1 << 62), 1 << 62, 5000),
        [-1, 0, sp.p, -sp.p - 1]]).astype(np.int64)
    for arr in (u32, i32, i64):
        got = ff.to_residues32(torch.from_numpy(arr), sp)
        assert got.dtype == torch.int64
        _eq(got, ref_ff.to_residues32(jnp.asarray(arr), rsp))


@pytest.mark.parametrize("n,axis", [(2, 0), (7, 0), (8, 0), (300, 0), (300, 1)])
def test_modsum32_past_fan(sps, n, axis):
    """Fan is 7 terms at 29 bits and capped at 256: 300 terms fold twice."""
    sp, rsp = sps
    rng = np.random.default_rng(3)
    shape = (n, 40) if axis == 0 else (40, n)
    x = rng.integers(0, sp.p, size=shape).astype(np.uint32)
    x[..., :3] = sp.p - 1  # worst case columns
    _eq(ff.modsum32(_t(x), sp, axis=axis),
        ref_ff.modsum32(jnp.asarray(x), rsp, axis=axis))


def test_uniform_from_bits_and_uniform32(sps):
    sp, rsp = sps
    rng = np.random.default_rng(4)
    hi = _words(rng, 10000, sp.p)
    lo = _words(rng, 10000, sp.p)[::-1].copy()
    _eq(ff.uniform_from_bits(_t(hi), _t(lo), sp),
        ref_uniform_from_bits(jnp.asarray(hi), jnp.asarray(lo), rsp))
    # uniform32 is uniform_from_bits over the generator's word pairs
    g = torch.Generator().manual_seed(9)
    got = ff.uniform32(g, (3, 500), sp)
    bits = torch.randint(0, 1 << 32, (3, 500, 2), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(9))
    assert torch.equal(got, ff.uniform_from_bits(bits[..., 0], bits[..., 1], sp))
    assert int(got.min()) >= 0 and int(got.max()) < sp.p


@pytest.mark.parametrize("n,k,lead", [(8, 8, ()), (3, 9, ()), (8, 7, (4,)),
                                      (26, 16, ()), (8, 40, ())])
def test_modmatmul32_matches_reference(sps, n, k, lead):
    sp, rsp = sps
    rng = np.random.default_rng(5)
    m = rng.integers(0, sp.p, size=(n, k))
    m[0] = sp.p - 1  # worst-case row
    v = rng.integers(0, sp.p, size=lead + (k, 257)).astype(np.uint32)
    v[..., 0] = sp.p - 1
    want = ref_ff.modmatmul32(m, jnp.asarray(v), rsp)
    _eq(ff.modmatmul32(m, _t(v), sp), want)
    mh, ml = ff.matrix_limbs(m, sp, "cpu")
    _eq(ff.modmatmul32_limbs(mh, ml, _t(v), sp), want)
    np.testing.assert_array_equal(
        ff.np_modmatmul32(m, v, sp), ref_ff.np_modmatmul32(m, v, rsp))


# -- the generic int64 lane (modular) --------------------------------------

@pytest.mark.parametrize("m", [433, (1 << 31) - 1, (1 << 61) - 1])
def test_modular_elementwise_and_sum(m):
    rng = np.random.default_rng(6)
    a = rng.integers(-(1 << 62), 1 << 62, size=5000)
    _eq(modular.canon(_t(a), m), ref_mod.canon(jnp.asarray(a), m))
    x = rng.integers(0, m, size=(9, 300))
    y = rng.integers(0, m, size=(9, 300))
    _eq(modular.modadd(_t(x), _t(y), m), ref_mod.modadd(jnp.asarray(x), jnp.asarray(y), m))
    _eq(modular.modsub(_t(x), _t(y), m), ref_mod.modsub(jnp.asarray(x), jnp.asarray(y), m))
    # 9 terms of a 2^61 modulus pass the int64 fan (4): chunked folding
    for axis in (0, 1):
        _eq(modular.modsum(_t(x), m, axis=axis),
            ref_mod.modsum(jnp.asarray(x), m, axis=axis))
    np.testing.assert_array_equal(ref_mod.np_modsum(x, m), modular.np_modsum(x, m))


@pytest.mark.parametrize("p,k", [(433, 8), ((1 << 31) - 1, 7), ((1 << 31) - 1, 1)])
def test_modmatmul_matches_reference(p, k):
    """(2^31-1)^2 allows 2 terms between reductions: k=7 folds in groups."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, p, size=(5, k))
    b = rng.integers(0, p, size=(3, k, 64))
    _eq(modular.modmatmul(a, _t(b), p), ref_mod.modmatmul(jnp.asarray(a), jnp.asarray(b), p))
    _eq(modular.modmatmul(a[0], _t(b[0]), p),
        ref_mod.modmatmul(jnp.asarray(a[0]), jnp.asarray(b[0]), p))
    np.testing.assert_array_equal(modular.np_modmatmul(a, b, p),
                                  ref_mod.np_modmatmul(a, b, p))
    with pytest.raises(ValueError):
        modular.modmatmul(a, _t(b), 1 << 31)


@pytest.mark.parametrize("m", [433, (1 << 31) - 1, (1 << 31) + 11, (1 << 61) - 1])
def test_uniform_mod_range_and_value(m):
    g = torch.Generator().manual_seed(10)
    got = modular.uniform_mod(g, (4000,), m)
    bits = torch.randint(0, 1 << 32, (4000, 2), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(10)).numpy()
    want = [((int(h) << 32) | int(lo)) % m for h, lo in bits]
    np.testing.assert_array_equal(got.numpy(), np.array(want, dtype=np.int64))
    assert torch.equal(got, modular.uniform_mod(
        torch.Generator().manual_seed(10), (4000,), m))


@pytest.mark.parametrize("m,cross", [(P29, 1), (P29, 8), (433, 1),
                                     ((1 << 61) - 1, 1), (P20, 4096)])
def test_fieldops_dispatch_and_ops(m, cross):
    f, rf = FieldOps.create(m, cross_terms=cross), RefFieldOps.create(m, cross_terms=cross)
    assert (f.sp is None) == (rf.sp is None)
    rng = np.random.default_rng(11)
    raw = rng.integers(-(1 << 40), 1 << 40, size=(6, 200))
    x = f.to_residues(_t(raw))
    _eq(x, rf.to_residues(jnp.asarray(raw)))
    y = f.canon(_t(rng.integers(0, min(m, 1 << 32), size=(6, 200))))
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    if f.sp is not None:
        jx, jy = jx.astype(jnp.uint32), jy.astype(jnp.uint32)
    _eq(f.add(x, y), rf.add(jx, jy))
    _eq(f.sub(x, y), rf.sub(jx, jy))
    _eq(f.sum(x, axis=0), rf.sum(jx, axis=0))
    _eq(f.to_int64(x), rf.to_int64(jx))
    u = f.uniform(torch.Generator().manual_seed(1), (3, 50))
    assert u.dtype == torch.int64 and int(u.min()) >= 0 and int(u.max()) < m
