"""The residue pass folded into the kernels that read the block, on the
CPU: K8 (``sda_tpu_torch/fields/residues.py``, ``csrc/residues.cu``), whose
plain version is held to the JAX package's ``FieldOps.to_residues`` under
hypothesis over int64, int32 and uint32 values, and K3's ``mask`` op on raw
int64 blocks (``chacha_device.mask_plain``), held to the op on the JAX
package's residues of the same block; numpy emulations of both kernels'
in-register reductions (K8's word with its sign bit flipped through the
Solinas fold, K3's through its Barrett reduction) held to the floor mod;
the wrapper's CPU leg and the bound. Every tolerance is exact equality."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sda_tpu.fields.ops import FieldOps as RefFieldOps

from sda_tpu_torch.benchmarks import bounds
from sda_tpu_torch.fields import chacha_device, numtheory, residues
from sda_tpu_torch.fields.fastfield import SolinasPrime

P29 = numtheory.generate_packed_params(3, 8, 28)[1]
#: the Solinas primes of the K1 lanes: the flagship's, sda-sim's 2^29 - 3,
#: the 26-clerk committee's and a 20-bit one
PRIMES = [P29, (1 << 29) - 3, numtheory.generate_packed_params(7, 26, 28)[1],
          (1 << 20) - 3]
#: the moduli of K3's mask op: the flagship's (32-bit residues), a small
#: one and two above 2^30 (64-bit residues)
MODULI = [P29, 433, (1 << 31) - 1, (1 << 61) - 1]
INT64 = st.integers(-(1 << 63), (1 << 63) - 1)
DTYPES = {"int64": (np.int64, INT64),
          "int32": (np.int32, st.integers(-(1 << 31), (1 << 31) - 1)),
          "uint32": (np.uint32, st.integers(0, (1 << 32) - 1))}
EDGES = {"int64": [-(1 << 63), (1 << 63) - 1, -1, 0, 1, -(1 << 62)],
         "int32": [-(1 << 31), (1 << 31) - 1, -1, 0],
         "uint32": [0, (1 << 32) - 1, P29, P29 - 1]}


def _tensor(values, dtype_name):
    arr = np.asarray(values, dtype=DTYPES[dtype_name][0])
    return torch.from_numpy(arr)


def _ref_residues(values, dtype_name, p):
    """The JAX package's ``FieldOps.to_residues`` of the same values."""
    arr = np.asarray(values, dtype=DTYPES[dtype_name][0])
    return np.asarray(RefFieldOps.create(p).to_residues(arr)).astype(np.int64)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_residues_plain_at_the_edges(dtype_name, p):
    """K8's plain version at each dtype's extremes: the JAX package's
    residues, as int32."""
    sp = SolinasPrime.try_from(p)
    values = EDGES[dtype_name]
    got = residues.residues_int32_plain(_tensor(values, dtype_name), sp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  _ref_residues(values, dtype_name, p))
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  [int(v) % p for v in values])


@settings(max_examples=150, deadline=None)
@given(data=st.data(), dtype_name=st.sampled_from(list(DTYPES)),
       p=st.sampled_from(PRIMES))
def test_residues_plain_is_the_jax_to_residues(data, dtype_name, p):
    """Under hypothesis: K8's plain version (and its wrapper's CPU leg)
    gives ``FieldOps.to_residues``' values for int64, int32 and uint32."""
    values = data.draw(st.lists(DTYPES[dtype_name][1], min_size=1,
                                max_size=48))
    sp = SolinasPrime.try_from(p)
    x = _tensor(values, dtype_name)
    want = _ref_residues(values, dtype_name, p)
    np.testing.assert_array_equal(
        residues.residues_int32_plain(x, sp).numpy().astype(np.int64), want)
    np.testing.assert_array_equal(
        residues.residues_int32(x[None, :], sp)[0].numpy().astype(np.int64),
        want)


@settings(max_examples=60, deadline=None)
@given(values=st.lists(INT64, min_size=8, max_size=8),
       m=st.sampled_from(MODULI), counter0=st.integers(0, (1 << 32) - 1),
       out32=st.booleans())
def test_mask_op_on_raw_blocks_is_the_op_on_jax_residues(values, m, counter0,
                                                         out32):
    """K3's ``mask`` op's plain version on a raw int64 block equals the op
    on the JAX package's residues of that block: the masked rows and the
    mask sum."""
    out_dtype = torch.int32 if out32 and m < 1 << 31 else torch.int64
    rng = np.random.default_rng(len(values) + m % 97)
    seeds = torch.from_numpy(rng.integers(0, 1 << 32, size=(2, 8)))
    raw = torch.tensor([values, values[::-1]], dtype=torch.int64)
    ref = torch.from_numpy(np.stack([
        _ref_residues(row, "int64", m) for row in raw.tolist()]))
    got = chacha_device.mask_residues_at(seeds, counter0, raw, modulus=m,
                                         out_dtype=out_dtype)
    want = chacha_device.mask_plain(seeds, counter0 & 0xFFFFFFFF, ref, m,
                                    out_dtype)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w.numpy())


# ---------------------------------------------------------------------------
# The kernels' in-register reductions, emulated

def _mod_p(x: int, sp: SolinasPrime) -> int:
    """``columns.cuh::mod_p`` on a Python int below 2^64."""
    low = (1 << sp.b) - 1
    while x >> sp.b:
        x = (x >> sp.b) * sp.delta + (x & low)
    return x - sp.p if x >= sp.p else x


def _k8_value(v: int, dtype_name: str, sp: SolinasPrime) -> int:
    """K8 on one value: its word with the sign bit flipped (x + 2^63, x +
    2^31, x), the Solinas fold, the fold constant added back mod p."""
    bias = {"int64": 1 << 63, "int32": 1 << 31, "uint32": 0}[dtype_name]
    word = v + bias
    assert 0 <= word < 1 << 64
    r = _mod_p(word, sp) + residues.sign_fold(dtype_name, sp.p)
    return r - sp.p if r >= sp.p else r


def _k3_raw(v: int, m: int) -> int:
    """K3's ``raw_residue``: w = x + 2^63, Barrett with mu = floor((2^64 -
    1) / m) (q at most 2 below w / m), two conditional subtracts, then the
    fold constant -2^63 mod m added mod m."""
    mu = ((1 << 64) - 1) // m
    w = v + (1 << 63)
    r = w - ((w * mu) >> 64) * m
    assert 0 <= r < 3 * m
    r = r - m if r >= m else r
    r = r - m if r >= m else r
    s = r + (m - (1 << 63) % m) % m
    return s - m if s >= m else s


@settings(max_examples=200, deadline=None)
@given(data=st.data(), dtype_name=st.sampled_from(list(DTYPES)),
       p=st.sampled_from(PRIMES))
def test_k8_reduction_emulated_is_the_floor_mod(data, dtype_name, p):
    sp = SolinasPrime.try_from(p)
    values = data.draw(st.lists(DTYPES[dtype_name][1], min_size=1,
                                max_size=32)) + EDGES[dtype_name]
    assert [_k8_value(v, dtype_name, sp) for v in values] == \
        [v % p for v in values]


@settings(max_examples=200, deadline=None)
@given(values=st.lists(INT64, min_size=1, max_size=32),
       m=st.sampled_from(MODULI + [2, 3, (1 << 62) - 57]))
def test_k3_raw_reduction_emulated_is_the_floor_mod(values, m):
    values = values + EDGES["int64"]
    assert [_k3_raw(v, m) for v in values] == [v % m for v in values]


# ---------------------------------------------------------------------------
# The wrapper and the bound

def test_wrapper_cpu_leg_counts_no_launch_and_refuses_floats():
    sp = SolinasPrime.try_from(P29)
    before = residues.residues_int32.launches
    x = torch.tensor([[-1, 5], [1 << 40, P29]], dtype=torch.int64)
    got = residues.residues_int32(x, sp)
    assert residues.residues_int32.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  [[P29 - 1, 5], [(1 << 40) % P29, 0]])
    with pytest.raises(ValueError, match="int64, int32 or uint32"):
        residues.residues_int32(x.to(torch.float64), sp)


def test_sign_fold_constants():
    assert residues.sign_fold("int64", P29) == -(1 << 63) % P29
    assert residues.sign_fold("int32", P29) == -(1 << 31) % P29
    assert residues.sign_fold("uint32", P29) == 0


def test_residues_bound_at_the_streamed_tile():
    """K8 on an int64 [250, 3,145,728]: 12 bytes an element, 9.44 GB, 2.817
    ms at 3.35 TB/s; bytes bound it."""
    n = 250 * 3_145_728
    ms, by, detail = bounds.residues_bound(n)
    assert by == "bytes" and ms == pytest.approx(2.8171, abs=1e-4)
    assert detail.startswith(f"{n * 12} bytes")
    assert bounds.residues_bound(n, 4)[0] == pytest.approx(ms * 8 / 12)
