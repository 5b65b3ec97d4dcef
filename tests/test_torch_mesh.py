"""The port's mesh modes (``sda_tpu_torch.mesh.simpod``: ``Mesh``,
``make_mesh``, ``default_mesh_shape``, ``make_multislice_mesh``,
``SimulatedPod``) against the JAX package's, mirroring
``tests/test_mesh.py`` and the pod half of ``tests/test_pallas_pod.py``.

The same seeded numpy inputs go through the JAX pod (on the 8 virtual CPU
devices of ``tests/conftest.py``) and the port's pod (on a mesh of
``["cpu"] * 8``), and both are held equal to each other and to the int64
column sum mod m — tolerance 0: the algebra is exact, and each package
draws its own masks and share rows, which cancel within the round. The
port's K1 lane runs K1's plain version here; the JAX package's Pallas lane
is held through its XLA lane (the same exact aggregate).
"""

import jax
import numpy as np
import pytest
import torch

from sda_tpu import mesh as ref_mesh
from sda_tpu import protocol as ref_proto
from sda_tpu.fields.ops import FieldOps as RefFieldOps
from sda_tpu.mesh import simpod as ref_simpod

from sda_tpu_torch.fields import (chacha_device, fused_round, numtheory,
                                  shardsum)
from sda_tpu_torch.fields.ops import FieldOps
from sda_tpu_torch.mesh import (
    Mesh,
    SimulatedPod,
    StreamedPod,
    default_mesh_shape,
    make_mesh,
    make_multislice_mesh,
)
from sda_tpu_torch.mesh import simpod
from sda_tpu_torch.protocol import (
    AdditiveSharing,
    BasicShamirSharing,
    ChaChaMasking,
    FullMasking,
    LinearMaskingScheme,
    NoMasking,
    PackedShamirSharing,
)

GOLDEN = PackedShamirSharing(3, 8, 4, 433, 354, 150)
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many small tensor ops: with one intra-op thread
    they do not spin against the suite's other workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fast_scheme(n=8):
    t, p, w2, w3 = numtheory.generate_packed_params(3, n, 28)
    return PackedShamirSharing(3, n, t, p, w2, w3)


def _ref(obj):
    """The JAX package's twin of a port scheme (same wire object)."""
    if obj is None:
        return None
    if isinstance(obj, LinearMaskingScheme):
        return ref_proto.LinearMaskingScheme.from_obj(obj.to_obj())
    return ref_proto.LinearSecretSharingScheme.from_obj(obj.to_obj())


def lattice(name, dim):
    """masking x sharing point of the golden lattice, mod 433 (the port's
    twin of ``tests/util.py::scheme_lattice_config``)."""
    if name.startswith("add"):
        sharing = AdditiveSharing(share_count=8, modulus=433)
    elif name.startswith("basic"):
        sharing = BasicShamirSharing(share_count=8, privacy_threshold=4,
                                     prime_modulus=433)
    else:
        sharing = GOLDEN
    masking = {"none": None, "full": FullMasking(433),
               "chacha": ChaChaMasking(433, dim, 128)}[name.split("-")[1]]
    return sharing, masking


def port_pod(sharing, masking, shape, **kw):
    return SimulatedPod(sharing, masking, mesh=make_mesh(*shape,
                                                         devices=CPU8), **kw)


def ref_out(sharing, masking, shape, inputs, key=3, **kw):
    pod = ref_mesh.SimulatedPod(_ref(sharing), masking_scheme=_ref(masking),
                                mesh=ref_mesh.make_mesh(*shape), **kw)
    return np.asarray(pod.aggregate(inputs, key=jax.random.PRNGKey(key)))


def check(sharing, masking, shape, inputs, seed=3, ref=True, **kw):
    """Port pod == column sum mod m (== the JAX pod when ``ref``)."""
    m = getattr(sharing, "prime_modulus", None) or sharing.modulus
    out = port_pod(sharing, masking, shape, **kw).aggregate(inputs, seed)
    assert out.dtype == torch.int64 and out.shape == (inputs.shape[1],)
    expected = inputs.astype(np.int64).sum(axis=0) % m
    np.testing.assert_array_equal(out.numpy(), expected)
    if ref:
        np.testing.assert_array_equal(ref_out(sharing, masking, shape,
                                              inputs), out.numpy())
    return out


# -- the mesh ------------------------------------------------------------------

@pytest.mark.parametrize("n,share", [(8, 8), (6, 8), (5, 8), (1, 8), (8, 26),
                                     (4, 80), (16, 8), (12, 26)])
def test_default_mesh_shape_equals_reference(n, share):
    assert default_mesh_shape(n, share) == ref_mesh.default_mesh_shape(
        n, share)


def test_default_mesh_shape():
    assert default_mesh_shape(8, 8) == (8, 1)
    assert default_mesh_shape(6, 8) == (2, 3)
    assert default_mesh_shape(5, 8) == (1, 5)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_make_mesh_shape_and_axes(shape):
    mesh = make_mesh(*shape, devices=CPU8)
    ref = ref_mesh.make_mesh(*shape)
    assert isinstance(mesh, Mesh)
    assert mesh.devices.shape == ref.devices.shape == shape
    assert mesh.axis_names == tuple(ref.axis_names) == ("p", "d")
    assert mesh.shape == {"p": shape[0], "d": shape[1]}
    assert all(d == torch.device("cpu") for d in mesh.devices.reshape(-1))
    assert mesh.shards_per_device() == 8


def test_make_mesh_needs_enough_devices():
    with pytest.raises(ValueError) as ours:
        make_mesh(4, 4, devices=CPU8)
    with pytest.raises(ValueError) as theirs:
        ref_mesh.make_mesh(4, 4)
    assert str(ours.value) == str(theirs.value) == "need 16 devices, have 8"


def test_mesh_per_device_share():
    mesh = make_mesh(2, 2, devices=["cpu", "cpu", "cpu", "meta"])
    assert mesh.shards_per_device() == 3
    assert mesh.distinct_devices() == (torch.device("cpu"),
                                       torch.device("meta"))
    assert make_mesh(1, 1, devices=["cpu"]).shards_per_device() == 1


def test_multislice_mesh_layout():
    """Slice-major participant axis, ``d`` minor inside each slice's
    contiguous device block: the reference's layout rule."""
    devs = [f"cpu:{i}" for i in range(8)]
    mesh = make_multislice_mesh(2, 2, 2, devices=devs)
    ref = ref_mesh.make_multislice_mesh(2, 2, 2)
    assert mesh.devices.shape == ref.devices.shape == (4, 2)
    assert mesh.axis_names == ("p", "d")
    ours = [[d.index for d in row] for row in mesh.devices]
    theirs = [[d.id for d in row] for row in ref.devices]
    assert ours == theirs
    flat = mesh.devices.reshape(2, 2, 2).reshape(2, -1)
    for slice_devs in flat:
        ids = sorted(d.index for d in slice_devs)
        assert ids == list(range(ids[0], ids[0] + 4))
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        make_multislice_mesh(2, 4, 2, devices=devs)


@pytest.mark.parametrize("layout", [(2, 2, 2), (4, 1, 2), (2, 4, 1),
                                    (1, 1, 8)])
def test_multislice_mesh_pod_and_streamed_exact(layout):
    """The multislice layout is transparent to both pod modes."""
    mesh = make_multislice_mesh(*layout, devices=CPU8)
    rng = np.random.default_rng(3)
    inputs = rng.integers(0, 50, size=(8, 24))
    pod = SimulatedPod(GOLDEN, FullMasking(433), mesh=mesh)
    np.testing.assert_array_equal(pod.aggregate(inputs, 0).numpy(),
                                  inputs.sum(axis=0) % 433)
    streamed = StreamedPod(AdditiveSharing(share_count=8, modulus=433),
                           ChaChaMasking(433, 24, 128), mesh=mesh,
                           participants_chunk=4, dim_chunk=12)
    np.testing.assert_array_equal(streamed.aggregate(inputs, 1),
                                  inputs.sum(axis=0) % 433)


# -- SimulatedPod against the JAX package ---------------------------------------

@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_pod_aggregate_matches_sum(mesh_shape):
    rng = np.random.default_rng(0)
    inputs = rng.integers(0, 20, size=(16, 48))
    check(GOLDEN, None, mesh_shape, inputs)


def test_pod_with_full_masking():
    rng = np.random.default_rng(1)
    check(GOLDEN, FullMasking(433), (4, 2),
          rng.integers(0, 433, size=(8, 24)))


def test_pod_deterministic_given_seed():
    pod = port_pod(GOLDEN, FullMasking(433), (4, 2))
    inputs = np.ones((8, 24), dtype=np.int64)
    a = pod.aggregate(inputs, 7)
    assert torch.equal(a, pod.aggregate(inputs, 7))
    np.testing.assert_array_equal(a.numpy(), np.full(24, 8))


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("config", [
    "add-none", "add-full", "add-chacha", "shamir-none", "shamir-full",
    "shamir-chacha", "basic-none", "basic-full", "basic-chacha",
])
def test_pod_scheme_parity(mesh_shape, config):
    """Every masking x sharing point of the lattice runs in pod mode and
    aggregates exactly, off the grain on purpose (auto-padding)."""
    dim = 50
    sharing, masking = lattice(config, dim)
    rng = np.random.default_rng(11)
    # the JAX package's ChaCha pods compile slowly: held on one shape
    check(sharing, masking, mesh_shape, rng.integers(0, 433, size=(6, dim)),
          ref=mesh_shape == (4, 2) or not config.endswith("chacha"))


def test_pod_chacha_sharding_invariant():
    """Seed-compressed masks expand consistently across dim shards: the
    same round seed yields the same aggregate on (8,1) and (4,2) meshes,
    and every participant's mask window is the one its unsharded stream
    holds at that offset."""
    dim = 48
    sharing, masking = lattice("shamir-chacha", dim)
    rng = np.random.default_rng(14)
    inputs = rng.integers(0, 433, size=(8, dim))
    outs = [port_pod(sharing, masking, shape).aggregate(inputs, 6).numpy()
            for shape in [(8, 1), (4, 2), (2, 4)]]
    for out in outs:
        np.testing.assert_array_equal(out, inputs.sum(axis=0) % 433)
    np.testing.assert_array_equal(
        ref_out(sharing, masking, (4, 2), inputs, key=6), outs[1])
    f = FieldOps.create(433)
    zeros = torch.zeros((8, dim), dtype=torch.int64)
    whole, _ = simpod._mask_stage(masking, f, zeros, None, round_seed=6)
    for p_sh, d_sh in [(4, 2), (2, 2), (8, 1)]:
        P_loc, d_loc = 8 // p_sh, dim // d_sh
        for pi in range(p_sh):
            for di in range(d_sh):
                win, _ = simpod._mask_stage(
                    masking, f, zeros[:P_loc, :d_loc], None, round_seed=6,
                    pid_base=pi * P_loc, d_block0=di * d_loc // 8)
                assert torch.equal(win, whole[pi * P_loc:(pi + 1) * P_loc,
                                              di * d_loc:(di + 1) * d_loc])


def test_pod_large_committee_exact():
    """80-clerk Packed-Shamir committee: the clerk axis splits 10 rows per
    shard over the 8-way p axis."""
    t, p, w2, w3 = numtheory.generate_packed_params(3, 80, 20)
    s = PackedShamirSharing(3, 80, t, p, w2, w3)
    rng = np.random.default_rng(15)
    check(s, None, (8, 1), rng.integers(0, 433, size=(8, 24)))


def test_pod_auto_padding():
    """Shapes off the mesh/scheme grain are zero-padded, not rejected."""
    rng = np.random.default_rng(4)
    for P_total, dim in [(7, 24), (8, 25), (5, 7)]:
        check(GOLDEN, None, (4, 2), rng.integers(0, 433, size=(P_total, dim)))
    pod = port_pod(GOLDEN, ChaChaMasking(433, 50, 128), (4, 2))
    assert pod.padded_shape(7, 50) == ref_mesh.SimulatedPod(
        _ref(GOLDEN), _ref(ChaChaMasking(433, 50, 128)),
        mesh=ref_mesh.make_mesh(4, 2)).padded_shape(7, 50) == (8, 96)


def _messages(port_call, ref_call):
    with pytest.raises(ValueError) as ours:
        port_call()
    with pytest.raises(ValueError) as theirs:
        ref_call()
    return str(ours.value), str(theirs.value)


@pytest.mark.parametrize("case", ["bogus", "modulus", "committee", "pallas"])
def test_pod_scheme_validation(case):
    """The port refuses what the reference refuses, with its message."""
    masking, kw, shape = {
        "bogus": ("bogus", {}, (8, 1)),
        "modulus": (FullMasking(1000), {}, (8, 1)),
        "committee": (None, {}, (3, 1)),
        "pallas": (None, {"use_pallas": True}, (8, 1)),
    }[case]
    ours, theirs = _messages(
        lambda: port_pod(GOLDEN, masking, shape, **kw),
        lambda: ref_mesh.SimulatedPod(
            _ref(GOLDEN), masking_scheme=masking if isinstance(masking, str)
            else _ref(masking), mesh=ref_mesh.make_mesh(*shape), **kw))
    assert ours == theirs


def test_pod_noncanonical_inputs():
    """Unmasked inputs outside [0, p) are canonicalized before sharing
    (a 29-bit prime on the plain lane: its 4-way sums leave the Solinas
    lane; the flagship prime on K1's)."""
    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 29)
    inputs = np.full((4, 6), 1 << 40, dtype=np.int64)
    for s, pallas in ((PackedShamirSharing(3, 8, t, p, w2, w3), False),
                      (fast_scheme(), True)):
        out = port_pod(s, None, (4, 2), use_pallas=pallas).aggregate(inputs, 0)
        np.testing.assert_array_equal(
            out.numpy(), np.full(6, (4 * (1 << 40)) % s.prime_modulus))


@pytest.mark.parametrize("chunk", [1, 3, 8, 100])
@pytest.mark.parametrize("masking", ["none", "full", "chacha"])
def test_scan_combine_any_chunk_reveals_the_sum(chunk, masking):
    """The participant-chunked local fold: any chunk, ragged or not,
    reveals the exact column sum."""
    s = fast_scheme()
    p = s.prime_modulus
    mask = {"none": NoMasking(), "full": FullMasking(p),
            "chacha": ChaChaMasking(p, 48, 128)}[masking]
    f = FieldOps.create(p)
    M, L = simpod._build_matrices(s)
    x = np.random.default_rng(chunk).integers(0, p, size=(13, 48))
    shares, mask_sum = simpod._scan_combine(
        f, s, mask, M, torch.from_numpy(x), 5, 9, 0, 0, chunk)
    out = simpod._reveal(s, f, L, None, shares, mask_sum, 48)
    np.testing.assert_array_equal(out.numpy(), x.sum(axis=0) % p)
    assert (mask_sum is None) == (masking == "none")


@pytest.mark.parametrize("p_shards", [1, 2, 4, 8])
def test_collective_headroom_equals_reference(p_shards):
    """The generic lane refuses a modulus whose p-way sums pass int64, as
    the reference does and with its message; the Solinas lane falls back
    to the generic lane where p-way sums pass 32 bits."""
    for m in (433, (1 << 61) + 3, (1 << 62) - 57, (1 << 29) - 679):
        f, rf = (FieldOps.create(m, cross_terms=p_shards),
                 RefFieldOps.create(m, cross_terms=p_shards))
        assert (f.sp is None) == (rf.sp is None)
        try:
            ref_simpod._check_collective_headroom(rf, p_shards)
        except ValueError as exc:
            with pytest.raises(ValueError) as ours:
                simpod._check_collective_headroom(f, p_shards)
            assert str(ours.value) == str(exc)
        else:
            simpod._check_collective_headroom(f, p_shards)


def test_pod_refuses_overflowing_collectives():
    m = (1 << 62) - 57
    ours, theirs = _messages(
        lambda: port_pod(AdditiveSharing(share_count=8, modulus=m), None,
                         (4, 2)),
        lambda: ref_mesh.SimulatedPod(
            ref_proto.AdditiveSharing(share_count=8, modulus=m),
            mesh=ref_mesh.make_mesh(4, 2)))
    assert ours == theirs and "overflow int64" in ours
    # the Solinas lane under 8-way sums stays Solinas at p < 2^29
    assert port_pod(fast_scheme(), None, (8, 1))._sp is not None


def test_aggregate_fn_on_the_grain():
    pod = port_pod(GOLDEN, FullMasking(433), (8, 1))
    fn = pod.aggregate_fn(16, 24)
    x = np.random.default_rng(3).integers(0, 433, size=(16, 24))
    np.testing.assert_array_equal(fn(torch.from_numpy(x), 4).numpy(),
                                  x.sum(axis=0) % 433)
    ref_pod = ref_mesh.SimulatedPod(_ref(GOLDEN), _ref(FullMasking(433)),
                                    mesh=ref_mesh.make_mesh(8, 1))
    for shape in [(15, 24), (16, 25)]:
        with pytest.raises(ValueError) as ours:
            pod.aggregate_fn(*shape)
        with pytest.raises(ValueError) as theirs:
            ref_pod.aggregate_fn(*shape)
        assert str(ours.value) == str(theirs.value)


# -- the K1 lane -----------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("masking", ["none", "full", "chacha"])
def test_pod_k1_lane_matches_sum_and_reference(mesh_shape, masking):
    s = fast_scheme()
    p = s.prime_modulus
    mask = {"none": None, "full": FullMasking(p),
            "chacha": ChaChaMasking(p, 48, 128)}[masking]
    pod = port_pod(s, mask, mesh_shape, use_pallas=True)
    assert pod.pallas_active
    rng = np.random.default_rng(3)
    inputs = rng.integers(0, 1 << 20, size=(16, 48))
    out = pod.aggregate(inputs, 2).numpy()
    np.testing.assert_array_equal(out, inputs.sum(axis=0) % p)
    np.testing.assert_array_equal(
        out, port_pod(s, mask, mesh_shape).aggregate(inputs, 2).numpy())
    if mesh_shape == (4, 2) or masking != "chacha":
        np.testing.assert_array_equal(out, ref_out(s, mask, mesh_shape,
                                                   inputs))


@pytest.mark.parametrize("masking", ["full", "chacha"])
def test_pod_calls_each_kernel_once_a_shard(monkeypatch, masking):
    """The K1 lane calls K1's wrapper once a shard (a launch each on a
    card), and ChaCha masks call K3's mask op once a shard at that shard's
    participant ids and block counter (its derived mode: the seeds' keys
    from the round seed and the first id), writing the int32 words K1
    reads; the clerk combine calls K9's wrapper once a d column, with the
    4 p shards' share and mask partials."""
    s = fast_scheme()
    p = s.prime_modulus
    mask = FullMasking(p) if masking == "full" else ChaChaMasking(p, 96, 128)
    k1_shapes, k3_windows, k9_calls = [], [], []
    real_k1 = fused_round.fused_mask_share_combine
    real_k3 = chacha_device.mask_residues_derived
    real_k9 = shardsum.shard_combine

    def k1(x_cols, *args, **kw):
        k1_shapes.append(tuple(x_cols.shape))
        return real_k1(x_cols, *args, **kw)

    def k3(round_seed, pid_base, bits, counter0, x, **kw):
        k3_windows.append((pid_base, tuple(x.shape), counter0))
        assert kw["out_dtype"] == torch.int32 and bits == 128
        return real_k3(round_seed, pid_base, bits, counter0, x, **kw)

    def k9(parts, mask_parts, modulus):
        k9_calls.append((len(parts), tuple(parts[0].shape),
                         len(mask_parts), tuple(mask_parts[0].shape)))
        return real_k9(parts, mask_parts, modulus)

    monkeypatch.setattr(fused_round, "fused_mask_share_combine", k1)
    monkeypatch.setattr(chacha_device, "mask_residues_derived", k3)
    monkeypatch.setattr(shardsum, "shard_combine", k9)
    pod = port_pod(s, mask, (4, 2), use_pallas=True)
    inputs = np.random.default_rng(5).integers(0, 1 << 20, size=(16, 96))
    np.testing.assert_array_equal(pod.aggregate(inputs, 1).numpy(),
                                  inputs.sum(axis=0) % p)
    assert k1_shapes == [(4, 3, 16)] * 8
    assert k9_calls == [(4, (8, 16), 4, (48,))] * 2
    if masking == "chacha":
        assert sorted(k3_windows) == sorted(
            (4 * pi, (4, 48), di * 6) for pi in range(4) for di in range(2))
    else:
        assert k3_windows == []


# -- quorum reveals -----------------------------------------------------------------

@pytest.mark.parametrize("survivors", [(0, 1, 2, 3, 4, 5, 6),
                                       (1, 2, 3, 4, 5, 6, 7),
                                       (7, 0, 1, 2, 3, 4, 5)])
def test_pod_clerk_dropout_quorum_reveals_exact(survivors):
    """A lost shard's clerk rows never enter the finale; the quorum (r=7
    of n=8 for the golden scheme) reveals the exact aggregate."""
    rng = np.random.default_rng(6)
    check(GOLDEN, FullMasking(433), (4, 2),
          rng.integers(0, 433, size=(8, 24)), surviving_clerks=survivors)


def test_pod_26_clerk_committee_with_dropout():
    """26 clerks on a (2, 4) mesh — 13 clerk rows a p shard — with 19 of
    26 dropped: the quorum of 7 still reveals exactly, reading the
    survivors from the GATHERED clerk axis."""
    s = fast_scheme(26)
    assert s.reconstruction_threshold == 7
    survivors = (25, 0, 3, 7, 12, 18, 21)
    rng = np.random.default_rng(9)
    inputs = rng.integers(0, 1 << 20, size=(8, 48))
    for pallas in (False, True):
        check(s, FullMasking(s.prime_modulus), (2, 4), inputs,
              ref=not pallas, surviving_clerks=survivors, use_pallas=pallas)


def test_pod_quorum_validation_equals_reference():
    for bad in [(0, 1, 2), (0, 0, 1, 2, 3, 4, 5), (0, 1, 2, 3, 4, 5, 8)]:
        ours, theirs = _messages(
            lambda: port_pod(GOLDEN, None, (4, 2), surviving_clerks=bad),
            lambda: ref_mesh.SimulatedPod(
                _ref(GOLDEN), mesh=ref_mesh.make_mesh(4, 2),
                surviving_clerks=bad))
        assert ours == theirs
    pod = port_pod(AdditiveSharing(share_count=8, modulus=433), None, (4, 2),
                   surviving_clerks=range(8))
    assert pod.surviving_clerks is None
