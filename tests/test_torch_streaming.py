"""The port's streamed rounds (``sda_tpu_torch.mesh.StreamingAggregator``,
on the CPU) — the single-device recipes of ``tests/test_streaming.py``:
exact across tilings, lanes and maskings, against the plain column sum and
the JAX package's ``StreamingAggregator``; the ChaCha mask stage bit for
bit against the JAX stage on the same seed words; checkpoint resume
bit-identical. ``use_pallas=True`` runs K1 through its plain version (the
wrapper's CPU leg) and ChaCha masks through K3's."""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from sda_tpu import protocol as ref_proto
from sda_tpu.fields.ops import FieldOps as RefFieldOps
from sda_tpu.mesh import StreamingAggregator as RefStreamingAggregator
from sda_tpu.mesh import simpod as ref_simpod
from sda_tpu.mesh import streaming as ref_streaming

from sda_tpu_torch.fields import chacha_device, fastfield, numtheory
from sda_tpu_torch.fields.ops import FieldOps
from sda_tpu_torch.mesh import (
    StreamedPod,
    StreamingAggregator,
    array_block_provider,
    make_mesh,
    synthetic_block_provider,
    synthetic_block_provider32,
    synthetic_device_block_provider32,
)
from sda_tpu_torch.mesh import simpod
from sda_tpu_torch.protocol import (
    AdditiveSharing,
    ChaChaMasking,
    FullMasking,
    NoMasking,
    PackedShamirSharing,
)
from sda_tpu_torch.utils import metrics, phase_report, reset_phase_report

GOLDEN = PackedShamirSharing(3, 8, 4, 433, 354, 150)  # generic lane


def fast_scheme():
    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    assert fastfield.supported(p)
    return PackedShamirSharing(3, 8, t, p, w2, w3)


def _agg(*args, **kwargs):
    return StreamingAggregator(*args, device="cpu", **kwargs)


@pytest.mark.parametrize("lane,scheme_kind", [
    ("plain", "fast"), ("plain", "generic"), ("k1", "fast")])
@pytest.mark.parametrize("masking", ["none", "full", "chacha"])
@pytest.mark.parametrize("P,d,pc,dc", [
    (10, 60, 4, 30),    # remainder on the participant axis
    (8, 50, 8, 21),     # remainder on the dim axis
    (7, 33, 3, 12),     # remainders on both
    (5, 12, 64, 3 << 20),  # single block
])
def test_streaming_exact(lane, scheme_kind, masking, P, d, pc, dc):
    scheme = fast_scheme() if scheme_kind == "fast" else GOLDEN
    p = scheme.prime_modulus
    mask = {"none": NoMasking(), "full": FullMasking(p),
            "chacha": ChaChaMasking(p, d, 128)}[masking]
    agg = _agg(scheme, mask, participants_chunk=pc, dim_chunk=dc,
               use_pallas=lane == "k1")
    assert (agg._sp is not None) == (scheme_kind == "fast")
    assert agg.pallas_active == (lane == "k1")
    rng = np.random.default_rng(11)
    inputs = rng.integers(0, min(p, 1 << 20), size=(P, d))
    out = agg.aggregate(inputs, seed=2)
    assert out.dtype == np.int64
    np.testing.assert_array_equal(out, inputs.sum(axis=0) % p)


def test_streaming_matches_block_provider_forms():
    scheme = fast_scheme()
    agg = _agg(scheme, FullMasking(scheme.prime_modulus),
               participants_chunk=3, dim_chunk=9)
    rng = np.random.default_rng(13)
    inputs = rng.integers(0, 1 << 16, size=(7, 21))
    direct = agg.aggregate(inputs, seed=5)
    via_provider = _agg(
        scheme, FullMasking(scheme.prime_modulus),
        participants_chunk=3, dim_chunk=9,
    ).aggregate_blocks(array_block_provider(inputs), 7, 21, 5)
    np.testing.assert_array_equal(direct, via_provider)
    # a provider of CPU tensors reads the same as one of arrays
    tensors = _agg(scheme, FullMasking(scheme.prime_modulus),
                   participants_chunk=3, dim_chunk=9).aggregate_blocks(
        array_block_provider(torch.from_numpy(inputs)), 7, 21, 5)
    np.testing.assert_array_equal(direct, tensors)


def test_synthetic_provider_consistent_across_tilings():
    """The virtual matrix must not depend on the tiling used to read it."""
    prov = synthetic_block_provider(modulus=433, seed=9)
    whole = prov(0, 6, 0, 12)
    by_rows = np.concatenate([prov(0, 3, 0, 12), prov(3, 6, 0, 12)], axis=0)
    by_cols = np.concatenate([prov(0, 6, 0, 5), prov(0, 6, 5, 12)], axis=1)
    np.testing.assert_array_equal(whole, by_rows)
    np.testing.assert_array_equal(whole, by_cols)
    assert whole.min() >= 0 and whole.max() < 433
    np.testing.assert_array_equal(
        whole, ref_streaming.synthetic_block_provider(433, seed=9)(0, 6, 0, 12))
    agg = _agg(GOLDEN, participants_chunk=4, dim_chunk=6)
    out = agg.aggregate_blocks(prov, 6, 12, 0)
    np.testing.assert_array_equal(out, prov(0, 6, 0, 12).sum(axis=0) % 433)


@pytest.mark.parametrize("seed,max_value", [(0, None), (4, 1 << 20),
                                            (7, 0xFFFFFFFF)])
def test_device_block_provider_is_the_host_matrix(seed, max_value):
    """The torch twin of the coordinate hash gives the host provider's and
    the JAX package's values, at any offset."""
    p = fast_scheme().prime_modulus
    dev = synthetic_device_block_provider32(p, seed=seed, max_value=max_value,
                                            device="cpu")
    host = synthetic_block_provider32(p, seed=seed, max_value=max_value)
    ref = ref_streaming.synthetic_block_provider32(p, seed=seed,
                                                   max_value=max_value)
    for coords in [(0, 5, 0, 17), (3, 9, 1000, 1040),
                   ((1 << 32) - 3, (1 << 32) + 2, 7, 9)]:
        blk = dev(*coords)
        assert blk.dtype == torch.int64
        np.testing.assert_array_equal(blk.numpy(), host(*coords))
        np.testing.assert_array_equal(blk.numpy(), ref(*coords))


def test_dim_chunk_rounds_up_to_scheme_grain():
    # misaligned tile sizes round up to the packing (and, with ChaCha,
    # the 8-word block) grain instead of erroring
    assert _agg(GOLDEN, dim_chunk=10).dim_chunk == 12
    agg = _agg(GOLDEN, ChaChaMasking(433, 100, 128), dim_chunk=10)
    assert agg.dim_chunk == 24  # lcm(secret_count=3, chacha block 8)
    ref = RefStreamingAggregator(
        ref_proto.PackedShamirSharing(3, 8, 4, 433, 354, 150),
        ref_proto.ChaChaMasking(433, 100, 128), dim_chunk=10)
    assert ref.dim_chunk == agg.dim_chunk


def test_k1_lane_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="Solinas"):
        _agg(GOLDEN, use_pallas=True)
    with pytest.raises(ValueError, match="Solinas"):
        _agg(AdditiveSharing(share_count=8, modulus=433), use_pallas=True)


def test_streaming_aggregator_chacha_exact_across_tilings():
    """ChaCha seed masks in the streamed mode: exact for several tilings,
    including edge tiles not aligned to the 8-word ChaCha block grain."""
    s = PackedShamirSharing(3, 8, 4, 433, 354, 150)
    rng = np.random.default_rng(41)
    P, d = 13, 100  # d % 24 != 0: every tiling has a ragged edge tile
    x = rng.integers(0, 433, size=(P, d))
    expected = x.sum(axis=0) % 433
    for pc, dc in [(4, 24), (5, 48), (13, 120), (2, 25)]:
        agg = _agg(s, ChaChaMasking(433, d, 128),
                   participants_chunk=pc, dim_chunk=dc)
        out = agg.aggregate(x, seed=12)
        np.testing.assert_array_equal(out, expected, err_msg=f"tiling {pc}x{dc}")


def test_streaming_aggregator_additive_schemes():
    rng = np.random.default_rng(53)
    P, d = 11, 70
    x = rng.integers(0, 433, size=(P, d))
    expected = x.sum(axis=0) % 433
    s = AdditiveSharing(share_count=8, modulus=433)
    for masking in (NoMasking(), FullMasking(433), ChaChaMasking(433, d, 128)):
        agg = _agg(s, masking, participants_chunk=4, dim_chunk=30)
        out = agg.aggregate(x, seed=21)
        np.testing.assert_array_equal(out, expected,
                                      err_msg=type(masking).__name__)


@pytest.mark.parametrize("masking", ["none", "full", "chacha"])
@pytest.mark.parametrize("lane", ["plain", "k1"])
def test_streamed_round_equals_jax_streamed_round(masking, lane):
    """The JAX package's streamed round and the port's on the same inputs
    and chunking give the same aggregate (exact for any draws)."""
    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    masks = {"none": (NoMasking(), ref_proto.NoMasking()),
             "full": (FullMasking(p), ref_proto.FullMasking(p)),
             "chacha": (ChaChaMasking(p, 90, 128),
                        ref_proto.ChaChaMasking(p, 90, 128))}[masking]
    x = np.random.default_rng(3).integers(0, 1 << 20, size=(9, 90))
    ref = RefStreamingAggregator(
        ref_proto.PackedShamirSharing(3, 8, t, p, w2, w3), masks[1],
        participants_chunk=4, dim_chunk=48).aggregate(
        x, key=jax.random.PRNGKey(1))
    out = _agg(PackedShamirSharing(3, 8, t, p, w2, w3), masks[0],
               participants_chunk=4, dim_chunk=48,
               use_pallas=lane == "k1").aggregate(x, seed=1)
    np.testing.assert_array_equal(out, np.asarray(ref))


@pytest.mark.parametrize("scheme_kind", ["fast", "generic"])
@pytest.mark.parametrize("pid_base,d_block0", [(0, 0), (5, 3), (1000, 70)])
def test_chacha_mask_stage_matches_jax_on_fed_seed_words(
        monkeypatch, scheme_kind, pid_base, d_block0):
    """Fed the JAX round key's seed words, the port's ChaCha mask stage
    gives the JAX stage's masked rows and mask sum bit for bit (on the CPU
    K3's derived mode takes its keys from ``chacha_seed_words``, the plain
    version of the kernel's own derivation)."""
    scheme = fast_scheme() if scheme_kind == "fast" else GOLDEN
    m = scheme.prime_modulus
    S, d_loc = 6, 48
    round_key = jax.random.PRNGKey(17)
    x = np.random.default_rng(pid_base).integers(0, m, size=(S, d_loc))
    ref_f = RefFieldOps.create(m)
    masked, msum, _ = ref_simpod._mask_stage(
        ref_proto.ChaChaMasking(m, 4096, 96), ref_f,
        ref_f.to_residues(x), jax.random.PRNGKey(0), round_key,
        pid_base=pid_base, d_block0=d_block0)
    words = np.asarray(ref_simpod._chacha_seed_words(
        round_key, pid_base + np.arange(S), 96)).astype(np.int64)
    assert (words[:, 3:] == 0).all()
    fed = []

    def seed_words(round_seed, gids, bits):
        fed.append((round_seed, gids.tolist(), bits))
        return torch.from_numpy(words)

    monkeypatch.setattr(chacha_device, "chacha_seed_words", seed_words)
    f = FieldOps.create(m)
    got, got_sum = simpod._mask_stage(
        ChaChaMasking(m, 4096, 96), f, f.to_residues(torch.from_numpy(x)),
        None, round_seed=99, pid_base=pid_base, d_block0=d_block0)
    assert fed == [(99, list(range(pid_base, pid_base + S)), 96)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(masked, np.int64))
    np.testing.assert_array_equal(got_sum.numpy(), np.asarray(msum, np.int64))


@pytest.mark.parametrize("stage,scheme_kind", [
    ("mask", "fast"), ("mask", "generic"), ("pallas", "fast")])
def test_chacha_stages_give_the_bits_of_the_unfused_passes(stage,
                                                           scheme_kind):
    """K3's fused mask op gives the ChaCha stages the bits of the passes it
    replaces: the windows of ``stream_residues_at``, ``f.add`` and
    ``f.sum`` (``_mask_stage``), and, on the K1 lane, their int32 cast fed
    to K1 (``_pallas_stage``: the masked rows reach K1 as the int32 words
    the op writes, the mask sum comes back beside the shares)."""
    from sda_tpu_torch.fields import chacha_device, fused_round, sharing

    scheme = fast_scheme() if scheme_kind == "fast" else GOLDEN
    m = scheme.prime_modulus
    S, d_loc, round_seed, pid_base, d_block0 = 7, 48, 31, 9, 1234
    f = FieldOps.create(m)
    x = f.to_residues(torch.from_numpy(
        np.random.default_rng(8).integers(0, m, size=(S, d_loc))))
    seeds = simpod._chacha_seed_words(
        round_seed, pid_base + torch.arange(S), 128)
    masks = chacha_device.stream_residues_at(seeds, d_block0,
                                             dimension=d_loc, modulus=m)
    want_masked, want_sum = f.add(x, masks), f.sum(masks, axis=0)
    masking = ChaChaMasking(m, 4096, 128)
    if stage == "mask":
        got, got_sum = simpod._mask_stage(
            masking, f, x, None, round_seed=round_seed, pid_base=pid_base,
            d_block0=d_block0)
        assert got.dtype == torch.int64
        assert torch.equal(got, want_masked)
        assert torch.equal(got_sum, want_sum)
        return
    M_host, _ = simpod._build_matrices(scheme)
    shares, got_sum = simpod._pallas_stage(
        scheme, f, M_host, masking, x, 5, round_seed=round_seed,
        pid_base=pid_base, d_block0=d_block0)
    want_shares, _ = fused_round.fused_mask_share_combine(
        sharing.batch_columns(want_masked.to(torch.int32),
                              scheme.secret_count),
        5, f.sp, M_host, scheme.privacy_threshold, False)
    assert torch.equal(shares, want_shares)
    assert torch.equal(got_sum, want_sum)


@pytest.mark.parametrize("lane", ["plain", "k1"])
@pytest.mark.parametrize("P,d,pc,dc", [(11, 96, 4, 48), (13, 100, 5, 24)])
def test_streamed_chacha_round_stays_exact(lane, P, d, pc, dc):
    """A streamed ChaCha round at a small size, each tile's masks from K3's
    mask op (int64 rows on the plain lane, int32 into K1 on the K1 lane),
    is the column sum mod p."""
    scheme = fast_scheme()
    p = scheme.prime_modulus
    x = np.random.default_rng(P + d).integers(0, 1 << 20, size=(P, d))
    out = _agg(scheme, ChaChaMasking(p, d, 128), participants_chunk=pc,
               dim_chunk=dc, use_pallas=lane == "k1").aggregate(x, seed=3)
    np.testing.assert_array_equal(out, x.sum(axis=0) % p)


def test_chacha_seed_words_depend_on_round_seed_and_id_only():
    a = simpod._chacha_seed_words(7, torch.arange(10), 128)
    b = simpod._chacha_seed_words(7, torch.arange(4, 10), 128)
    assert a.shape == (10, 8) and (a[:, 4:] == 0).all()
    assert torch.equal(a[4:], b)
    assert int(a[:, :4].max()) < 1 << 32 and len(set(a[:, 0].tolist())) == 10
    assert not torch.equal(a, simpod._chacha_seed_words(8, torch.arange(10),
                                                        128))
    assert (simpod._chacha_seed_words(7, torch.arange(3), 256) != 0).all()
    with pytest.raises(ValueError, match="256"):
        simpod._chacha_seed_words(7, torch.arange(3), 257)


def test_tile_seeds_are_pure_and_distinct():
    seeds = {simpod._tile_seed(5, pi, di) for pi in range(20)
             for di in range(20)}
    assert len(seeds) == 400 and max(seeds) < 1 << 63
    assert simpod._tile_seed(5, 1, 2) == simpod._tile_seed(5, 1, 2)
    assert simpod._tile_seed(5, 1, 2) != simpod._tile_seed(6, 1, 2)


def _flaky(prov, fail_at):
    calls = {"n": 0}

    def get(p0, p1, d0, d1):
        calls["n"] += 1
        if calls["n"] == fail_at:
            raise RuntimeError("simulated crash")
        return prov(p0, p1, d0, d1)

    return get, calls


@pytest.mark.parametrize("masking", ["full", "chacha"])
@pytest.mark.parametrize("lane", ["plain", "k1"])
def test_streaming_checkpoint_resume_bit_identical(tmp_path, masking, lane):
    """A crash mid-round resumes from the snapshot and produces the exact
    bytes of an uninterrupted run (tile seeds are pure functions of the
    round seed and tile indices), skipping already-folded chunks."""
    s = fast_scheme()
    p = s.prime_modulus
    prov = synthetic_block_provider32(p, seed=4, max_value=1 << 20)
    ck = str(tmp_path / "round.ckpt.npz")
    mask = FullMasking(p) if masking == "full" else ChaChaMasking(p, 100, 128)

    def agg():
        return _agg(s, mask, participants_chunk=4, dim_chunk=24,
                    use_pallas=lane == "k1")

    ref = agg().aggregate_blocks(prov, 23, 100, 7)
    np.testing.assert_array_equal(
        ref, prov(0, 23, 0, 100).astype(np.int64).sum(axis=0) % p)
    flaky, _ = _flaky(prov, 13)
    with pytest.raises(RuntimeError):
        agg().aggregate_blocks(flaky, 23, 100, 7, checkpoint_path=ck,
                               checkpoint_every_chunks=2)
    assert os.path.exists(ck)
    counting, calls = _flaky(prov, -1)
    resumed = agg()
    out = resumed.aggregate_blocks(counting, 23, 100, 7, checkpoint_path=ck,
                                   checkpoint_every_chunks=2)
    assert resumed.last_resumed
    np.testing.assert_array_equal(out, ref)
    assert not os.path.exists(ck)  # removed on completion
    total_chunks = (-(-23 // 4)) * (-(-100 // 24))
    assert calls["n"] < total_chunks  # resume skipped folded chunks


@pytest.mark.parametrize("driver,masking", [
    ("single", "chacha"), ("single", "full"), ("pod", "chacha"),
    ("pod", "full")])
@pytest.mark.parametrize("lane", ["plain", "k1"])
def test_checkpointed_every_chunk_and_resumed_is_bit_identical(
        tmp_path, driver, masking, lane):
    """The steps add into their accumulators in place (on the K1 lane K3's
    mask op and K1 write them, as the reference's donated buffers are): a
    round snapshotted after every chunk, crashed twice and resumed each
    time gives the bytes of an uninterrupted run, and its sum is the JAX
    package's streamed round's exact sum at the same sizes (masks cancel,
    so any draws give it). ``StreamingAggregator`` and ``StreamedPod``
    (2x2 mesh of the CPU)."""
    from sda_tpu import mesh as ref_mesh

    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    P, d, pc, dc = 22, 144, 4, 48
    prov = synthetic_block_provider32(p, seed=6, max_value=1 << 20)
    ck = str(tmp_path / "round.ckpt.npz")

    def agg():
        scheme = PackedShamirSharing(3, 8, t, p, w2, w3)
        mask = (FullMasking(p) if masking == "full"
                else ChaChaMasking(p, d, 128))
        if driver == "single":
            return _agg(scheme, mask, participants_chunk=pc, dim_chunk=dc,
                        use_pallas=lane == "k1")
        return StreamedPod(scheme, mask, mesh=make_mesh(
            2, 2, devices=["cpu"] * 4), participants_chunk=pc,
            dim_chunk=dc, use_pallas=lane == "k1")

    ref = agg().aggregate_blocks(prov, P, d, 11)
    for fail_at in (4, 7):   # two crashes, each resumed from its snapshot
        flaky, _ = _flaky(prov, fail_at)
        with pytest.raises(RuntimeError):
            agg().aggregate_blocks(flaky, P, d, 11, checkpoint_path=ck,
                                   checkpoint_every_chunks=1)
        assert os.path.exists(ck)
    resumed = agg()
    out = resumed.aggregate_blocks(prov, P, d, 11, checkpoint_path=ck,
                                   checkpoint_every_chunks=1)
    assert resumed.last_resumed and not os.path.exists(ck)
    np.testing.assert_array_equal(out, ref)
    ref_scheme = ref_proto.PackedShamirSharing(3, 8, t, p, w2, w3)
    ref_mask = (ref_proto.FullMasking(p) if masking == "full"
                else ref_proto.ChaChaMasking(p, d, 128))
    ref_cls = (RefStreamingAggregator if driver == "single" else
               functools.partial(ref_mesh.StreamedPod,
                                 mesh=ref_mesh.make_mesh(2, 2)))
    want = ref_cls(ref_scheme, ref_mask, participants_chunk=pc,
                   dim_chunk=dc).aggregate_blocks(
        ref_streaming.synthetic_block_provider32(p, seed=6,
                                                 max_value=1 << 20),
        P, d, jax.random.PRNGKey(11))
    np.testing.assert_array_equal(out, np.asarray(want))
    np.testing.assert_array_equal(
        out, prov(0, P, 0, d).astype(np.int64).sum(axis=0) % p)


def test_resumed_accumulators_are_the_interrupted_ones(tmp_path, monkeypatch):
    """Bit identity below the aggregate: the share accumulators a resumed
    round finishes a tile with equal an uninterrupted run's (the same
    Full masks and share rows were drawn for every tile)."""
    from sda_tpu_torch.mesh import streaming

    s = fast_scheme()
    p = s.prime_modulus
    prov = synthetic_block_provider32(p, seed=2, max_value=1 << 20)
    finals = []
    real_final = StreamingAggregator._final

    def spy(self, acc_shares, acc_mask):
        finals.append((acc_shares.clone(), acc_mask.clone()))
        return real_final(self, acc_shares, acc_mask)

    monkeypatch.setattr(StreamingAggregator, "_final", spy)

    def agg():
        return _agg(s, FullMasking(p), participants_chunk=4, dim_chunk=48)

    agg().aggregate_blocks(prov, 12, 96, 3)
    ref = list(finals)
    finals.clear()
    ck = str(tmp_path / "acc.ckpt.npz")
    flaky, _ = _flaky(prov, 5)
    with pytest.raises(RuntimeError):
        agg().aggregate_blocks(flaky, 12, 96, 3, checkpoint_path=ck,
                               checkpoint_every_chunks=1)
    finals.clear()
    agg().aggregate_blocks(prov, 12, 96, 3, checkpoint_path=ck,
                           checkpoint_every_chunks=1)
    assert len(finals) == 1  # tile 0 was restored from its snapshot
    assert torch.equal(finals[0][0], ref[1][0])
    assert torch.equal(finals[0][1], ref[1][1])
    assert streaming._checkpoint_load(ck, "x") is None


def test_streaming_checkpoint_rejects_foreign_snapshot(tmp_path):
    """A snapshot from a different round (another seed) is ignored: the
    fingerprint mismatch forces a clean fresh run, never a silent mix."""
    s = fast_scheme()
    p = s.prime_modulus
    prov = synthetic_block_provider32(p, seed=4, max_value=1 << 20)
    ck = str(tmp_path / "round.ckpt.npz")

    def agg():
        return _agg(s, FullMasking(p), participants_chunk=4, dim_chunk=24)

    boom, _ = _flaky(prov, 3)
    with pytest.raises(RuntimeError):
        agg().aggregate_blocks(boom, 23, 100, 7, checkpoint_path=ck,
                               checkpoint_every_chunks=1)
    assert os.path.exists(ck)  # a seed-7 snapshot exists
    fresh = agg()
    out = fresh.aggregate_blocks(prov, 23, 100, 8, checkpoint_path=ck)
    assert not fresh.last_resumed
    exp = agg().aggregate_blocks(prov, 23, 100, 8)
    np.testing.assert_array_equal(out, exp)


def test_checkpoint_boundary_only_cadence_resumes_exact(tmp_path):
    """checkpoint_every_chunks=0 snapshots at dim-tile boundaries only: a
    crash mid-tile resumes from the last completed tile and the round
    stays bit-exact."""
    s = fast_scheme()
    p = s.prime_modulus
    prov = synthetic_block_provider32(p, seed=21, max_value=1 << 20)
    ck = str(tmp_path / "boundary.ckpt.npz")

    def agg():
        return _agg(s, FullMasking(p), participants_chunk=4, dim_chunk=24)

    ref = agg().aggregate_blocks(prov, 23, 100, 19)
    # 6 participant chunks per dim tile: call 15 is the third chunk of dim
    # tile 2, whose partial fold must be DISCARDED on resume
    flaky, _ = _flaky(prov, 15)
    with pytest.raises(RuntimeError):
        agg().aggregate_blocks(flaky, 23, 100, 19, checkpoint_path=ck,
                               checkpoint_every_chunks=0)
    assert os.path.exists(ck)
    resumed = agg()
    counting, calls = _flaky(prov, -1)
    out = resumed.aggregate_blocks(counting, 23, 100, 19, checkpoint_path=ck,
                                   checkpoint_every_chunks=0)
    assert resumed.last_resumed
    np.testing.assert_array_equal(out, ref)
    assert not os.path.exists(ck)
    # dim tiles 0 and 1 (12 chunks) restored; tiles 2..4 re-fed in full
    assert calls["n"] == 18


# -- ragged tails: the dim tail pads only to the grain, the participant
# tail keeps its rows (the reference's uniform_tail recipes without the
# flag, which only shares one compiled shape between tiles under jit) ------

def _step_shapes(monkeypatch):
    """Record the block shape of every accumulate step."""
    shapes = []
    real = StreamingAggregator._step

    def step(self, block, *args):
        shapes.append(tuple(block.shape))
        return real(self, block, *args)

    monkeypatch.setattr(StreamingAggregator, "_step", step)
    return shapes


@pytest.mark.parametrize("masking", ["none", "full"])
def test_ragged_tails_exact_and_step_shapes(monkeypatch, masking):
    scheme = fast_scheme()
    p = scheme.prime_modulus
    x = np.random.default_rng(71).integers(0, 1 << 16, size=(9, 100))
    shapes = _step_shapes(monkeypatch)
    # tails: 9 - 8 = 1 row; 100 - 72 = 28 columns -> 30 (grain 3)
    agg = _agg(scheme, {"none": NoMasking(), "full": FullMasking(p)}[masking],
               participants_chunk=4, dim_chunk=36)
    np.testing.assert_array_equal(agg.aggregate(x, seed=3),
                                  x.sum(axis=0) % p)
    assert sorted(set(shapes)) == [(1, 30), (1, 36), (4, 30), (4, 36)]
    assert len(shapes) == 9


@pytest.mark.parametrize("scheme,masking", [
    ("packed", "chacha"), ("additive", "chacha"), ("additive", "full")])
def test_ragged_tails_chacha_and_additive_exact(scheme, masking):
    P, d = 11, 100
    x = np.random.default_rng(73).integers(0, 433, size=(P, d))
    s = (GOLDEN if scheme == "packed"
         else AdditiveSharing(share_count=8, modulus=433))
    mk = ChaChaMasking(433, d, 128) if masking == "chacha" \
        else FullMasking(433)
    agg = _agg(s, mk, participants_chunk=4, dim_chunk=48)
    np.testing.assert_array_equal(agg.aggregate(x, seed=9),
                                  x.sum(axis=0) % 433)


def test_single_tile_keeps_its_grain_rounded_size(monkeypatch):
    scheme = fast_scheme()
    x = np.random.default_rng(77).integers(0, 1 << 16, size=(5, 29))
    shapes = _step_shapes(monkeypatch)
    a = _agg(scheme, FullMasking(scheme.prime_modulus), participants_chunk=8,
             dim_chunk=3 << 20)
    np.testing.assert_array_equal(a.aggregate(x, seed=1),
                                  x.sum(axis=0) % scheme.prime_modulus)
    assert shapes == [(5, 30)]  # dim 29 < dim_chunk: padded to grain 3


@pytest.mark.parametrize("masking", ["full", "chacha"])
def test_ragged_tails_k1_lane_exact(monkeypatch, masking):
    """The K1 lane over ragged tails on both axes: exact; the Full tail's
    28 columns are read in place (K8 writes the tile's 2 zero columns); a
    ChaCha tile's grain is lcm(3, 8) = 24, and the 4-column dim tail, not
    whole ChaCha blocks, pads to 24."""
    scheme = fast_scheme()
    p = scheme.prime_modulus
    x = np.random.default_rng(91).integers(0, 1 << 16, size=(10, 100))
    shapes = _step_shapes(monkeypatch)
    mk = FullMasking(p) if masking == "full" else ChaChaMasking(p, 100, 128)
    agg = _agg(scheme, mk, participants_chunk=4, dim_chunk=36,
               use_pallas=True)
    assert agg.pallas_active
    np.testing.assert_array_equal(agg.aggregate(x, seed=7),
                                  x.sum(axis=0) % p)
    tail = {"full": (2, 28), "chacha": (2, 24)}[masking]
    assert shapes[-1] == tail


# -- the ragged tile read in place: on the K1 lane the kernel that first
# reads a ragged block (K8, or K3's mask op) writes the tile's zero
# columns, so the feed makes no padded copy --------------------------------

def _in_place_round(monkeypatch, masking, d, padded=False):
    """A K1-lane round over P=10 x ``d`` (chunks of 4 rows, dim tiles of
    48): (aggregate, x, {dim tile start: [(block shape, acc_shares,
    acc_mask) after each step]}, phase_report, stream.feed counters).
    ``padded`` forces today's padded copy of every ragged block."""
    scheme = fast_scheme()
    p = scheme.prime_modulus
    x = np.random.default_rng(113).integers(0, 1 << 16, size=(10, d))
    mk = FullMasking(p) if masking == "full" else ChaChaMasking(p, d, 128)
    agg = _agg(scheme, mk, participants_chunk=4, dim_chunk=48,
               use_pallas=True)
    if padded:
        monkeypatch.setattr(agg, "_reads_in_place", lambda cols: False)
    steps = {}
    real = agg._step

    def step(block, tile_seed, round_seed, pid0, dblk0, *accs):
        out = real(block, tile_seed, round_seed, pid0, dblk0, *accs)
        steps.setdefault(dblk0 * 8, []).append(
            (tuple(block.shape), *(a.clone() for a in out)))
        return out

    monkeypatch.setattr(agg, "_step", step)
    metrics.reset_counters()
    reset_phase_report()
    out = agg.aggregate(x, seed=29)
    return (out, x, steps, phase_report(),
            metrics.counter_report("stream.feed"))


@pytest.mark.parametrize("masking,d_size", [("full", 18), ("chacha", 24)])
def test_ragged_tile_read_in_place_on_the_k1_lane(monkeypatch, masking,
                                                  d_size):
    """d=112 in tiles of 48: a 16-column tail, whole ChaCha blocks but no
    multiple of the grain (3 under Full, 24 under ChaCha). Its three
    chunks reach the step unpadded, counted, with no pad range; the
    accumulators after each tail step are those of the padded round, bit
    for bit, and the aggregate is exact."""
    out, x, steps, report, counters = _in_place_round(monkeypatch, masking,
                                                      112)
    p = fast_scheme().prime_modulus
    np.testing.assert_array_equal(out, x.sum(axis=0) % p)
    assert [s[0] for s in steps[96]] == [(4, 16), (4, 16), (2, 16)]
    assert all(s[0][1] == 48 for d0 in (0, 48) for s in steps[d0])
    assert counters == {"stream.feed.in_place": 3}
    assert "stream.feed.pad" not in report
    assert report["stream.feed"]["count"] == 9
    padded, _, padded_steps, padded_report, padded_counters = \
        _in_place_round(monkeypatch, masking, 112, padded=True)
    np.testing.assert_array_equal(padded, out)
    assert padded_counters == {}
    assert padded_report["stream.feed.pad"]["count"] == 3
    assert [s[0] for s in padded_steps[96]] == [
        (4, d_size), (4, d_size), (2, d_size)]
    for (_, shares, mask), (_, want_shares, want_mask) in zip(
            steps[96], padded_steps[96], strict=True):
        assert mask.shape == (d_size,)
        assert torch.equal(shares, want_shares)
        assert torch.equal(mask, want_mask)


def test_chacha_tail_off_the_chacha_block_still_pads(monkeypatch):
    """A ChaCha tail whose width is no multiple of 8 (d=100: 4 columns)
    cannot go to K3's mask op unpadded: the feed pads it to the grain in
    a ``stream.feed.pad`` range once a chunk, and the round stays exact."""
    out, x, steps, report, counters = _in_place_round(monkeypatch, "chacha",
                                                      100)
    p = fast_scheme().prime_modulus
    np.testing.assert_array_equal(out, x.sum(axis=0) % p)
    assert [s[0] for s in steps[96]] == [(4, 24), (4, 24), (2, 24)]
    assert counters == {}
    assert report["stream.feed.pad"]["count"] == 3


@pytest.mark.parametrize("masking", ["none", "full", "chacha"])
def test_plain_lane_pads_the_ragged_tile(masking):
    """Off the K1 lane no kernel writes the zero columns: the plain lane
    pads a ragged tile's every chunk and counts no block read in place."""
    scheme = fast_scheme()
    p = scheme.prime_modulus
    x = np.random.default_rng(117).integers(0, 1 << 16, size=(10, 112))
    mk = {"none": NoMasking(), "full": FullMasking(p),
          "chacha": ChaChaMasking(p, 112, 128)}[masking]
    agg = _agg(scheme, mk, participants_chunk=4, dim_chunk=48)
    metrics.reset_counters()
    reset_phase_report()
    np.testing.assert_array_equal(agg.aggregate(x, seed=31),
                                  x.sum(axis=0) % p)
    assert metrics.counter_report("stream.feed") == {}
    assert phase_report()["stream.feed.pad"]["count"] == 3


def test_ragged_tail_checkpoint_resume_and_fingerprint(tmp_path):
    """A crash inside the ragged tail tile resumes bit-identically; a
    snapshot of another chunking is never resumed."""
    scheme = fast_scheme()
    p = scheme.prime_modulus
    prov = synthetic_block_provider32(p, seed=5, max_value=1 << 16)
    P, d = 10, 100

    def agg(dc=36):
        return _agg(scheme, FullMasking(p), participants_chunk=4,
                    dim_chunk=dc)

    ref = agg().aggregate_blocks(prov, P, d, 8)
    np.testing.assert_array_equal(
        ref, prov(0, P, 0, d).astype(np.int64).sum(axis=0) % p)
    ck = str(tmp_path / "tail.ckpt.npz")
    flaky, calls = _flaky(prov, 8)  # 3 dim tiles x 3 chunks: tile 2, chunk 1
    with pytest.raises(RuntimeError):
        agg().aggregate_blocks(flaky, P, d, 8, checkpoint_path=ck,
                               checkpoint_every_chunks=1)
    assert os.path.exists(ck)
    resumed = agg()
    out = resumed.aggregate_blocks(prov, P, d, 8, checkpoint_path=ck,
                                   checkpoint_every_chunks=1)
    assert resumed.last_resumed
    np.testing.assert_array_equal(out, ref)
    # a snapshot of dim_chunk 36 must not be resumed at dim_chunk 48
    calls["n"] = 0
    with pytest.raises(RuntimeError):
        agg().aggregate_blocks(flaky, P, d, 8, checkpoint_path=ck,
                               checkpoint_every_chunks=1)
    fresh = agg(48)
    out2 = fresh.aggregate_blocks(prov, P, d, 8, checkpoint_path=ck,
                                  checkpoint_every_chunks=1)
    assert not fresh.last_resumed  # foreign snapshot rejected, clean round
    np.testing.assert_array_equal(out2, ref)


def test_surviving_clerks_reveal_exact():
    """Clerk dropout: the finale reconstructs from a quorum's rows."""
    s = fast_scheme()
    p = s.prime_modulus
    x = np.random.default_rng(5).integers(0, 1 << 20, size=(6, 48))
    r = s.reconstruction_threshold
    for lane in (False, True):
        agg = _agg(s, FullMasking(p), participants_chunk=4, dim_chunk=24,
                   use_pallas=lane, surviving_clerks=[7, 1, 5, 3, 0, 2, 4])
        assert agg.surviving_clerks == (7, 1, 5, 3, 0, 2, 4)[:r]
        np.testing.assert_array_equal(agg.aggregate(x, seed=1),
                                      x.sum(axis=0) % p)
    with pytest.raises(ValueError, match="reconstruction_threshold"):
        _agg(s, surviving_clerks=[0, 1])
    with pytest.raises(ValueError, match="every clerk row"):
        _agg(AdditiveSharing(share_count=4, modulus=433),
             surviving_clerks=[0, 1])


def test_streaming_aggregator_resolves_the_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingAggregator(GOLDEN)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic_device_block_provider32(433)
