"""K9, the pod's clerk combine (``sda_tpu_torch.fields.shardsum``), on the
CPU: its plain version against numpy's Σ mod m at p_shards in {1, 2, 4, 8}
on Solinas and generic moduli, every partial at m - 1 at the headroom edge
included, and ``torch.equal`` to the eager chain the pods ran before K9
(``_sum_on`` + ``canon`` + ``torch.cat`` a clerk block, and the mask sum);
``launch_args`` (pointer table, row strides, shapes, Barrett constant) at
the pods' shapes; the wrapper on CPU tensors; and whole pods, streamed pods
and model-scale rounds through the rerouted ``_ShardComm.combine``, held
to the JAX package's aggregate. Tolerance 0: every result is exact.
"""

import numpy as np
import pytest
import torch

from sda_tpu import mesh as ref_mesh
from sda_tpu import protocol as ref_proto
from sda_tpu.mesh import devscale as ref_devscale

from sda_tpu_torch.fields import numtheory, shardsum
from sda_tpu_torch.fields.ops import FieldOps
from sda_tpu_torch.mesh import (ModelScaleRound, SimulatedPod, StreamedPod,
                                make_mesh, simpod)
from sda_tpu_torch.protocol import (AdditiveSharing, ChaChaMasking,
                                    FullMasking, LinearMaskingScheme,
                                    NoMasking, PackedShamirSharing)

T, P29, W2, W3 = numtheory.generate_packed_params(3, 8, 28)
#: Solinas moduli (the K1 lane's and the golden 433) and generic ones, up
#: to the largest the pod admits at 8 p shards: 8 (m - 1) < 2^63
MODULI = (433, P29, (1 << 31) - 1, (1 << 57) - 13, (1 << 60) - 93)
P_SHARDS = (1, 2, 4, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _partials(rng, p, n, B, d, m, edge=False):
    """p share partials [n, B] and p mask partials [d] of canonical
    residues mod m (all m - 1 with ``edge``)."""
    def draw(shape):
        if edge:
            return torch.full(shape, m - 1, dtype=torch.int64)
        return torch.from_numpy(rng.integers(0, m, size=shape,
                                             dtype=np.int64))
    return [draw((n, B)) for _ in range(p)], [draw((d,)) for _ in range(p)]


def _old_chain(parts, masks, m):
    """``_ShardComm.combine``'s body for one d column before K9, on one
    device: clerk block c summed by ``_sum_on`` and canonicalized, the
    blocks concatenated; the mask partials summed and canonicalized."""
    p = len(parts)
    f = FieldOps.create(m, cross_terms=p)
    dev = parts[0].device
    blk = parts[0].shape[0] // p
    blocks = [f.canon(simpod._sum_on(dev, [x[c * blk:(c + 1) * blk]
                                           for x in parts]))
              for c in range(p)]
    total = None if masks is None else f.canon(simpod._sum_on(dev, masks))
    return torch.cat(blocks), total


@pytest.mark.parametrize("m", MODULI)
@pytest.mark.parametrize("p", P_SHARDS)
@pytest.mark.parametrize("edge", [False, True])
def test_plain_equals_numpy_and_the_old_chain(m, p, edge):
    rng = np.random.default_rng(p * 7 + int(edge))
    n, B, d = 8, 37, 111
    parts, masks = _partials(rng, p, n, B, d, m, edge)
    got, total = shardsum.shard_combine_plain(parts, masks, m)
    want = sum(x.numpy().astype(object) for x in parts) % m
    want_mask = sum(v.numpy().astype(object) for v in masks) % m
    assert got.dtype == total.dtype == torch.int64
    assert (got.numpy().astype(object) == want).all()
    assert (total.numpy().astype(object) == want_mask).all()
    old, old_total = _old_chain(parts, masks, m)
    assert torch.equal(got, old) and torch.equal(total, old_total)
    # without masks, only the rows
    rows, none = shardsum.shard_combine_plain(parts, None, m)
    assert none is None and torch.equal(rows, old)


@pytest.mark.parametrize("p", P_SHARDS)
def test_headroom_edge(p):
    """Every partial at m - 1 with the largest generic modulus p shards
    admit (p (m - 1) just below 2^63) and the Solinas lane at its own edge
    (the flagship prime: p (m - 1) < 2^32 for p <= 8)."""
    m = (1 << 63) // p - 1 if p > 1 else (1 << 62) - 57
    assert p * (m - 1) < 1 << 63
    for mod in (m, P29):
        parts, masks = _partials(None, p, 8, 5, 15, mod, edge=True)
        got, total = shardsum.shard_combine_plain(parts, masks, mod)
        assert (got == p * (mod - 1) % mod).all()
        assert (total == p * (mod - 1) % mod).all()
        old, old_total = _old_chain(parts, masks, mod)
        assert torch.equal(got, old) and torch.equal(total, old_total)


def test_headroom_and_shape_guards():
    parts, masks = _partials(np.random.default_rng(0), 2, 8, 4, 12, 433)
    with pytest.raises(ValueError, match="overflow"):
        shardsum.shard_combine_plain(parts, masks, 1 << 63)
    with pytest.raises(ValueError, match="modulus"):
        shardsum.launch_args(parts, masks, 0)
    with pytest.raises(ValueError, match="partials must be int64"):
        shardsum.shard_combine_plain([parts[0], parts[1][:4]], None, 433)
    with pytest.raises(ValueError, match="mask partials"):
        shardsum.shard_combine_plain(parts, masks[:1], 433)
    with pytest.raises(ValueError, match="mask partials must be int64"):
        shardsum.shard_combine_plain(parts, [masks[0], masks[1][:5]], 433)
    with pytest.raises(ValueError, match="1 to 64"):
        shardsum.launch_args([], None, 433)
    with pytest.raises(ValueError, match="1 to 64"):
        shardsum.launch_args(parts * 33, None, 433)
    with pytest.raises(ValueError, match="contiguous columns"):
        shardsum.launch_args([parts[0].t().contiguous().t(), parts[1]],
                             None, 433)


#: (p shards, n, B_loc, d_loc): the shapes the pods hand one d column: the
#: 1x1 and 4x2 flagship pods at P=100 x d=999,999, a streamed finale's
#: [8, 16,384] rows of a 4x2 pod's 98,304-wide dim tile, the 26-clerk
#: committee on a (2, 4) mesh and the golden scheme on (8, 1)
POD_SHAPES = ((1, 8, 333_333, 999_999), (4, 8, 166_667, 500_001),
              (4, 8, 16_384, 49_152), (2, 26, 6, 42), (8, 8, 1, 3))


@pytest.mark.parametrize("p, n, B, d", POD_SHAPES)
def test_launch_args_at_the_pods_shapes(p, n, B, d):
    parts = [torch.empty((n, B), dtype=torch.int64) for _ in range(p)]
    masks = [torch.empty(d, dtype=torch.int64) for _ in range(p)]
    a = shardsum.launch_args(parts, masks, P29)
    assert a.ptrs.dtype == np.uint64 and a.ptrs.tolist() == [
        x.data_ptr() for x in parts]
    assert a.mask_ptrs.tolist() == [v.data_ptr() for v in masks]
    assert a.strides.tolist() == [B] * p
    assert (a.rows, a.cols, a.mask_cols) == (n, B, d)
    assert a.modulus == P29 and a.mu == ((1 << 64) - 1) // P29
    bare = shardsum.launch_args(parts, None, P29)
    assert bare.mask_ptrs is None and bare.mask_cols == 0


def test_launch_args_reads_strided_rows_in_place():
    """A partial that is a column window of a wider tensor (rows further
    apart than its width) is read in place: its pointer and row stride."""
    wide = torch.zeros((8, 50), dtype=torch.int64)
    view = wide[:, 7:27]
    a = shardsum.launch_args([view, view.contiguous()], None, 433)
    assert a.ptrs[0] == view.data_ptr() and a.strides.tolist() == [50, 20]


def test_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(3)
    parts, masks = _partials(rng, 4, 8, 9, 27, P29)
    before = shardsum.shard_combine.launches
    got = shardsum.shard_combine(parts, masks, P29)
    want = shardsum.shard_combine_plain(parts, masks, P29)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert shardsum.shard_combine.launches == before


def test_barrett_reduction_of_the_kernel():
    """The kernel's reduction in Python ints: q = floor(v mu / 2^64) is
    floor(v / m) or one below, so one conditional subtract canonicalizes
    any v < 2^64, for every m <= 2^63 (m = 1, small, Solinas, generic,
    2^63)."""
    rng = np.random.default_rng(11)
    for m in (1, 2, 433, P29, (1 << 61) - 1, (1 << 62) + 1, 1 << 63):
        mu = ((1 << 64) - 1) // m
        vs = [0, 1, m - 1, m, (1 << 64) - 1, (1 << 63), 8 * (m - 1)
              if 8 * (m - 1) < 1 << 64 else 0]
        vs += [int(v) for v in rng.integers(0, 1 << 63, size=200,
                                            dtype=np.uint64)]
        for v in vs:
            r = (v - ((v * mu) >> 64) * m) % (1 << 64)
            assert r < 2 * m
            assert (r - m if r >= m else r) == v % m


# -- the pods through the rerouted combine ---------------------------------------

def fast_scheme(n=8):
    t, p, w2, w3 = numtheory.generate_packed_params(3, n, 28)
    return PackedShamirSharing(3, n, t, p, w2, w3)


def _ref(obj):
    if isinstance(obj, LinearMaskingScheme):
        return ref_proto.LinearMaskingScheme.from_obj(obj.to_obj())
    return ref_proto.LinearSecretSharingScheme.from_obj(obj.to_obj())


class _Calls(list):
    """``shard_combine``'s calls, and ``sums``: ``_sum_on``'s."""

    sums: list


@pytest.fixture
def k9_calls(monkeypatch):
    """Every ``shard_combine`` call: (p partials, their shape, masked)."""
    calls = _Calls()
    real = shardsum.shard_combine

    def spy(parts, mask_parts, modulus):
        calls.append((len(parts), tuple(parts[0].shape),
                      mask_parts is not None))
        return real(parts, mask_parts, modulus)

    monkeypatch.setattr(shardsum, "shard_combine", spy)
    sums = []
    real_sum = simpod._sum_on
    monkeypatch.setattr(simpod, "_sum_on",
                        lambda *a: sums.append(a) or real_sum(*a))
    calls.sums = sums
    return calls


@pytest.mark.parametrize("mesh_shape", [(1, 1), (4, 2)])
@pytest.mark.parametrize("masking", ["full", "chacha", "none"])
@pytest.mark.parametrize("pallas", [False, True])
def test_pod_one_k9_call_a_d_column(k9_calls, mesh_shape, masking, pallas):
    """``SimulatedPod`` reaches K9 once a d column, with every p shard's
    partial, and never the old ``_sum_on`` chain; the aggregate is the
    column sum and (plain lane, Full or no masks) the JAX pod's."""
    import jax

    s = fast_scheme()
    p = s.prime_modulus
    mask = {"full": FullMasking(p), "chacha": ChaChaMasking(p, 96, 128),
            "none": NoMasking()}[masking]
    inputs = np.random.default_rng(5).integers(0, 1 << 20, size=(16, 96))
    pod = SimulatedPod(s, mask, mesh=make_mesh(*mesh_shape,
                                               devices=["cpu"] * 8),
                       use_pallas=pallas)
    out = pod.aggregate(inputs, 1).numpy()
    np.testing.assert_array_equal(out, inputs.sum(axis=0) % p)
    ps, ds = mesh_shape
    assert k9_calls == [(ps, (8, 96 // ds // 3), masking != "none")] * ds
    assert k9_calls.sums == []
    if not pallas and masking != "chacha":
        ref = ref_mesh.SimulatedPod(_ref(s), _ref(mask),
                                    mesh=ref_mesh.make_mesh(*mesh_shape))
        np.testing.assert_array_equal(
            np.asarray(ref.aggregate(inputs, jax.random.PRNGKey(1))), out)


def test_pod_additive_and_quorum_through_k9(k9_calls):
    """Additive sharing (rows summed by the reveal) and a quorum reveal
    read K9's gathered rows as they read the old chain's."""
    rng = np.random.default_rng(8)
    inputs = rng.integers(0, 433, size=(8, 24))
    add = SimulatedPod(AdditiveSharing(share_count=8, modulus=433),
                       FullMasking(433), mesh=make_mesh(4, 2,
                                                        devices=["cpu"] * 8))
    np.testing.assert_array_equal(add.aggregate(inputs, 2).numpy(),
                                  inputs.sum(axis=0) % 433)
    s = fast_scheme()
    q = SimulatedPod(s, FullMasking(s.prime_modulus),
                     mesh=make_mesh(4, 2, devices=["cpu"] * 8),
                     use_pallas=True, surviving_clerks=(0, 1, 2, 3, 4, 6, 7))
    np.testing.assert_array_equal(q.aggregate(inputs, 3).numpy(),
                                  inputs.sum(axis=0) % s.prime_modulus)
    assert len(k9_calls) == 4 and k9_calls.sums == []


def test_streamed_pod_finale_one_k9_call_a_d_column_a_tile(k9_calls):
    s = fast_scheme()
    p = s.prime_modulus
    inputs = np.random.default_rng(6).integers(0, 1 << 20, size=(20, 200))
    pod = StreamedPod(s, FullMasking(p), mesh=make_mesh(4, 2,
                                                        devices=["cpu"] * 8),
                      participants_chunk=8, dim_chunk=96, use_pallas=True)
    np.testing.assert_array_equal(pod.aggregate(inputs, 4),
                                  inputs.sum(axis=0) % p)
    dim_tiles = -(-200 // pod.dim_chunk)
    assert len(k9_calls) == 2 * dim_tiles and k9_calls.sums == []
    assert {c[:1] + c[2:] for c in k9_calls} == {(4, True)}


def test_model_scale_round_one_k9_call_a_d_column_a_tile(k9_calls):
    """At 3 tiles a shard (the last ragged), K9 runs once a d column a
    tile; the round equals the JAX package's model-scale round."""
    import jax

    s = fast_scheme()
    p = s.prime_modulus
    x = np.random.default_rng(7).integers(0, 1 << 20, size=(16, 250))
    r = ModelScaleRound(s, FullMasking(p), mesh=make_mesh(
        4, 2, devices=["cpu"] * 8), dim_tile=96)
    out = r.aggregate(x, 5).numpy()
    np.testing.assert_array_equal(out, x.sum(axis=0) % p)
    assert len(k9_calls) == 2 * 3 and k9_calls.sums == []
    ref = ref_devscale.ModelScaleRound(
        _ref(s), _ref(FullMasking(p)), mesh=ref_mesh.make_mesh(4, 2),
        dim_tile=96)
    np.testing.assert_array_equal(
        np.asarray(ref.aggregate(x, jax.random.PRNGKey(5))), out)


def test_k9_ab_side_on_the_cpu():
    """``benchmarks.k9_ab``'s measuring side at small shapes on the CPU
    (no builds, no profiles): every round and fold it times is exact (a
    mismatch exits), and the summary's medians keep each number's key
    path."""
    from sda_tpu_torch.benchmarks import k9_ab

    rec = k9_ab.measure("cpu", (16, 3001), (8, 25_000), (12, 3000, 4, 800),
                        build=False)
    assert set(rec["pod"]) == {"1x1", "4x2"}
    assert rec["pod"]["4x2"]["device_events"] is None
    assert rec["devscale"]["tiles"] == 1
    assert rec["fold"]["tile"]["tiles"] == 4
    med = k9_ab._medians([{"a": {"x": 1.0, "s": "p"}},
                          {"a": {"x": 3.0, "s": "p"}}])
    assert med == {"a": {"x": 2.0, "s": "p"}}
