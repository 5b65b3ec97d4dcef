"""The port's streamed pod (``sda_tpu_torch.mesh.streaming.StreamedPod``)
against the JAX package's, against the port's ``SimulatedPod`` and against
the int64 column sum mod m, on a mesh of ``["cpu"] * 8`` (the JAX pods on
the 8 virtual CPU devices of ``tests/conftest.py``). Tolerance 0: the
algebra is exact. Also the streamed pod's checkpoint resume (accumulators
re-placed onto the shards, bit-identical to an uninterrupted run) and the
``DeviceTileSink``-fed lane. K1's lane runs its plain version here.
"""

import os

import jax
import numpy as np
import pytest
import torch

from sda_tpu import mesh as ref_mesh
from sda_tpu import protocol as ref_proto

from sda_tpu_torch.fields import fused_round, numtheory
from sda_tpu_torch.mesh import (
    DeviceTileSink,
    SimulatedPod,
    StreamedPod,
    make_mesh,
    streaming,
    synthetic_block_provider32,
)
from sda_tpu_torch.protocol import (
    AdditiveSharing,
    BasicShamirSharing,
    ChaChaMasking,
    FullMasking,
    LinearMaskingScheme,
    PackedShamirSharing,
)
from sda_tpu_torch.utils import metrics

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


def fast_scheme():
    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    return PackedShamirSharing(3, 8, t, p, w2, w3)


def _ref(obj):
    if obj is None:
        return None
    if isinstance(obj, LinearMaskingScheme):
        return ref_proto.LinearMaskingScheme.from_obj(obj.to_obj())
    return ref_proto.LinearSecretSharingScheme.from_obj(obj.to_obj())


def spod(sharing, masking, shape=(4, 2), **kw):
    kw.setdefault("participants_chunk", 8)
    kw.setdefault("dim_chunk", 24)
    return StreamedPod(sharing, masking,
                       mesh=make_mesh(*shape, devices=CPU8), **kw)


SCHEMES = {
    "shamir": GOLDEN,
    "basic": BasicShamirSharing(share_count=8, privacy_threshold=4,
                                prime_modulus=433),
    "add": AdditiveSharing(share_count=8, modulus=433),
}


@pytest.mark.parametrize("sharing,masking,shape,ref", [
    ("shamir", "full", (4, 2), True),
    ("shamir", "none", (8, 1), True),
    ("shamir", "chacha", (2, 4), False),
    ("basic", "full", (2, 4), True),
    ("basic", "chacha", (4, 2), False),
    ("add", "chacha", (4, 2), True),
    ("add", "full", (8, 1), False),
    ("add", "none", (1, 8), False),
])
def test_streamed_pod_matches_sum_pod_and_reference(sharing, masking, shape,
                                                    ref):
    """Ragged tiles on both axes; the port's streamed pod equals the
    column sum, the port's one-shot pod and (where ``ref``) the JAX
    package's streamed pod on the same inputs."""
    s = SCHEMES[sharing]
    dim = 60
    mask = {"none": None, "full": FullMasking(433),
            "chacha": ChaChaMasking(433, dim, 128)}[masking]
    x = np.random.default_rng(4).integers(0, 433, size=(20, dim))
    expected = x.sum(axis=0) % 433
    pod = spod(s, mask, shape)
    out = pod.aggregate(x, 11)
    assert out.dtype == np.int64 and out.shape == (dim,)
    np.testing.assert_array_equal(out, expected)
    one_shot = SimulatedPod(s, mask, mesh=pod.mesh).aggregate(x, 11)
    np.testing.assert_array_equal(one_shot.numpy(), out)
    if ref:
        theirs = ref_mesh.StreamedPod(
            _ref(s), _ref(mask), mesh=ref_mesh.make_mesh(*shape),
            participants_chunk=8, dim_chunk=24)
        np.testing.assert_array_equal(
            np.asarray(theirs.aggregate(x, jax.random.PRNGKey(11))), out)


def test_chunks_round_up_to_the_mesh_grain():
    for shape in [(4, 2), (8, 1), (2, 4)]:
        for mask in (None, ChaChaMasking(433, 99, 128)):
            ours = spod(GOLDEN, mask, shape, participants_chunk=5,
                        dim_chunk=25)
            theirs = ref_mesh.StreamedPod(
                _ref(GOLDEN), _ref(mask), mesh=ref_mesh.make_mesh(*shape),
                participants_chunk=5, dim_chunk=25)
            assert (ours.participants_chunk, ours.dim_chunk, ours._grain) \
                == (theirs.participants_chunk, theirs.dim_chunk,
                    theirs._grain)


@pytest.mark.parametrize("masking", ["none", "full", "chacha"])
def test_streamed_pod_k1_lane_matches_plain_lane_and_sum(monkeypatch,
                                                         masking):
    """K1's lane (one call a shard a tile) against the plain lane and the
    sum: the aggregate is deterministic whatever either drew."""
    s = fast_scheme()
    p = s.prime_modulus
    dim = 96  # several dim tiles of 24, all ChaCha-block aligned
    mask = {"none": None, "full": FullMasking(p),
            "chacha": ChaChaMasking(p, dim, 128)}[masking]
    calls = []
    real = fused_round.fused_mask_share_combine

    def k1(x_cols, *args, **kw):
        calls.append(tuple(x_cols.shape))
        return real(x_cols, *args, **kw)

    monkeypatch.setattr(fused_round, "fused_mask_share_combine", k1)
    x = np.random.default_rng(8).integers(0, 1 << 20, size=(20, dim))
    k1_pod = spod(s, mask, use_pallas=True)
    plain = spod(s, mask)
    assert k1_pod.pallas_active and not plain.pallas_active
    out = k1_pod.aggregate(x, 3)
    np.testing.assert_array_equal(out, x.sum(axis=0) % p)
    # 20 rows in chunks of 8, dim tiles of 24 (48 with ChaCha's grain)
    dc = k1_pod.dim_chunk
    assert dc == (48 if masking == "chacha" else 24)
    assert calls == [(2, 3, dc // 6)] * (8 * 3 * (dim // dc))
    np.testing.assert_array_equal(plain.aggregate(x, 3), out)


def test_streamed_pod_clerk_dropout_exact():
    x = np.random.default_rng(7).integers(0, 433, size=(12, 48))
    out = spod(GOLDEN, FullMasking(433),
               surviving_clerks=(0, 2, 3, 4, 5, 6, 7)).aggregate(x, 3)
    np.testing.assert_array_equal(out, x.sum(axis=0) % 433)
    theirs = ref_mesh.StreamedPod(
        _ref(GOLDEN), _ref(FullMasking(433)), mesh=ref_mesh.make_mesh(4, 2),
        participants_chunk=8, dim_chunk=24,
        surviving_clerks=(0, 2, 3, 4, 5, 6, 7))
    np.testing.assert_array_equal(
        np.asarray(theirs.aggregate(x, jax.random.PRNGKey(3))), out)


def test_streamed_pod_chacha_with_dropout():
    """Mask seeds travel participant -> recipient, so losing clerk rows
    loses no mask data."""
    x = np.random.default_rng(10).integers(0, 433, size=(11, 48))
    out = spod(GOLDEN, ChaChaMasking(433, 48, 128),
               surviving_clerks=(0, 1, 2, 3, 4, 5, 6)).aggregate(x, 6)
    np.testing.assert_array_equal(out, x.sum(axis=0) % 433)


def test_streamed_pod_validation_equals_reference():
    for kw in [dict(masking="bogus"), dict(masking=FullMasking(1000)),
               dict(shape=(3, 1)), dict(use_pallas=True),
               dict(surviving_clerks=(0, 1))]:
        masking = kw.pop("masking", None)
        shape = kw.pop("shape", (4, 2))
        with pytest.raises(ValueError) as ours:
            spod(GOLDEN, masking, shape, **kw)
        with pytest.raises(ValueError) as theirs:
            ref_mesh.StreamedPod(
                _ref(GOLDEN), masking if isinstance(masking, str)
                else _ref(masking), mesh=ref_mesh.make_mesh(*shape), **kw)
        assert str(ours.value) == str(theirs.value)


def test_uint32_host_blocks_widen_on_the_device():
    s = fast_scheme()
    p = s.prime_modulus
    prov = synthetic_block_provider32(p, seed=5)
    assert prov(0, 2, 0, 3).dtype == np.uint32
    out = spod(s, FullMasking(p), use_pallas=True).aggregate_blocks(
        prov, 19, 100, 1)
    np.testing.assert_array_equal(
        out, prov(0, 19, 0, 100).astype(np.int64).sum(axis=0) % p)


# -- checkpoint / resume ---------------------------------------------------------

def _flaky(prov, fail_at):
    calls = {"n": 0}

    def get(*args):
        calls["n"] += 1
        if calls["n"] == fail_at:
            raise RuntimeError("feed died")
        return prov(*args)

    return get, calls


def test_host_accs_round_trip_to_the_shards():
    """The snapshot layout is the reference's global one (shares [p * n,
    B], masks [p, d_size]); restoring re-places every shard."""
    pod = spod(fast_scheme(), FullMasking(fast_scheme().prime_modulus))
    comm = streaming._ShardComm(pod.mesh)
    shares, masks = pod._new_accs(48, comm)
    rng = np.random.default_rng(0)
    for row_s, row_m in zip(shares, masks):
        for j in range(len(row_s)):
            row_s[j] = torch.from_numpy(rng.integers(0, 99, size=(8, 8)))
            row_m[j] = torch.from_numpy(rng.integers(0, 99, size=24))
    host_s, host_m = pod._host_accs(shares, masks)
    assert host_s.shape == (4 * 8, 16) and host_m.shape == (4, 48)
    back_s, back_m = pod._restore_accs(host_s, host_m)
    for a, b in zip(sum(shares, []) + sum(masks, []),
                    sum(back_s, []) + sum(back_m, [])):
        assert torch.equal(a, b)
    empty = np.zeros(0, np.int64)
    assert pod._host_accs(empty, empty) == (empty, empty)


@pytest.mark.parametrize("every", [1, 0])
def test_streamed_pod_checkpoint_resume_bit_identical(tmp_path, monkeypatch,
                                                      every):
    """A feed that dies mid-round resumes from the snapshot: the tile's
    accumulators at its finale equal an uninterrupted run's, the result is
    exact, fewer blocks are fed, and the snapshot is removed."""
    s = fast_scheme()
    p = s.prime_modulus
    prov = synthetic_block_provider32(p, seed=2, max_value=1 << 20)
    finals = []
    real_final = StreamedPod._final

    def spy(self, acc_shares, acc_mask, *, comm):
        finals.append([t.clone() for t in sum(acc_shares, [])])
        return real_final(self, acc_shares, acc_mask, comm=comm)

    monkeypatch.setattr(StreamedPod, "_final", spy)

    def pod():
        return spod(s, FullMasking(p), participants_chunk=4, dim_chunk=48)

    ref = pod().aggregate_blocks(prov, 12, 96, 3)
    np.testing.assert_array_equal(
        ref, prov(0, 12, 0, 96).astype(np.int64).sum(axis=0) % p)
    uninterrupted = list(finals)
    finals.clear()
    ck = str(tmp_path / "pod.ckpt.npz")
    flaky, _ = _flaky(prov, 5)  # the second chunk of dim tile 1
    with pytest.raises(RuntimeError, match="feed died"):
        pod().aggregate_blocks(flaky, 12, 96, 3, checkpoint_path=ck,
                               checkpoint_every_chunks=every)
    assert os.path.exists(ck)
    finals.clear()
    resumed = pod()
    counting, calls = _flaky(prov, -1)
    out = resumed.aggregate_blocks(counting, 12, 96, 3, checkpoint_path=ck,
                                   checkpoint_every_chunks=every)
    assert resumed.last_resumed
    np.testing.assert_array_equal(out, ref)
    assert len(finals) == 1  # dim tile 0 came from the snapshot
    for a, b in zip(finals[0], uninterrupted[1]):
        assert torch.equal(a, b)
    assert calls["n"] == (2 if every else 3)
    assert not os.path.exists(ck)


def test_streamed_pod_snapshot_pins_the_mesh(tmp_path):
    """A snapshot taken on another mesh shape is ignored, never mixed."""
    s = fast_scheme()
    p = s.prime_modulus
    prov = synthetic_block_provider32(p, seed=4, max_value=1 << 20)
    ck = str(tmp_path / "mesh.ckpt.npz")
    boom, _ = _flaky(prov, 3)
    with pytest.raises(RuntimeError):
        spod(s, FullMasking(p), (4, 2), participants_chunk=8,
             dim_chunk=48).aggregate_blocks(boom, 23, 96, 7,
                                            checkpoint_path=ck,
                                            checkpoint_every_chunks=1)
    assert os.path.exists(ck)
    other = spod(s, FullMasking(p), (8, 1), participants_chunk=8,
                 dim_chunk=48)
    out = other.aggregate_blocks(prov, 23, 96, 7, checkpoint_path=ck)
    assert not other.last_resumed
    np.testing.assert_array_equal(
        out, prov(0, 23, 0, 96).astype(np.int64).sum(axis=0) % p)


# -- the sink-fed lane -------------------------------------------------------------

@pytest.mark.parametrize("masking", ["none", "full", "chacha"])
def test_sink_fed_streamed_pod_bit_exact_and_prefetched(masking):
    s = fast_scheme()
    p = s.prime_modulus
    mask = {"none": None, "full": FullMasking(p),
            "chacha": ChaChaMasking(p, 250, 128)}[masking]
    host = synthetic_block_provider32(p, seed=9)

    def make():
        return spod(s, mask, participants_chunk=8, dim_chunk=96,
                    use_pallas=masking != "none")

    pod = make()
    metrics.reset_counters()
    sink = DeviceTileSink(host, 20, 250, pod.participants_chunk,
                          pod.dim_chunk, device="cpu")
    out_sink = pod.aggregate_blocks(sink.provider(), 20, 250, 11)
    out_direct = make().aggregate_blocks(host, 20, 250, 11)
    np.testing.assert_array_equal(out_sink, out_direct)
    np.testing.assert_array_equal(
        out_sink, host(0, 20, 0, 250).astype(np.int64).sum(axis=0) % p)
    counters = metrics.counter_report("devscale.sink.")
    assert counters.get("devscale.sink.hit", 0) == 9  # 3 p-chunks x 3 tiles
    assert counters.get("devscale.sink.miss", 0) == 0


def test_streamed_pod_stages_register_their_shapes():
    """Every step of a run registers under ``stream.pod.step`` (a ragged
    dim tail is its own signature), each finale under
    ``stream.pod.finale``."""
    from sda_tpu_torch import obs
    from sda_tpu_torch.obs import devprof

    obs.reset_all()
    try:
        x = np.random.default_rng(5).integers(0, 433, size=(19, 250))
        out = spod(GOLDEN, FullMasking(433), participants_chunk=8,
                   dim_chunk=96).aggregate(x, 7)
        np.testing.assert_array_equal(out, x.sum(axis=0) % 433)
        step = devprof.profile("stream.pod.step")
        assert step.calls == 3 * 3 and len(step.shapes) == 2
        assert devprof.profile("stream.pod.finale").calls == 3
        assert step.retraces == 0
    finally:
        obs.reset_all()
