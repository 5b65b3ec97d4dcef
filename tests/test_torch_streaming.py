"""The port's streamed rounds (``sda_tpu_torch.mesh.StreamingAggregator``,
on the CPU) — the single-device recipes of ``tests/test_streaming.py``:
exact across tilings, lanes and maskings, against the plain column sum and
the JAX package's ``StreamingAggregator``; the ChaCha mask stage bit for
bit against the JAX stage on the same seed words; checkpoint resume
bit-identical. ``use_pallas=True`` runs K1 through its plain version (the
wrapper's CPU leg) and ChaCha masks through K3's."""

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

from sda_tpu_torch.fields import fastfield, numtheory
from sda_tpu_torch.fields.ops import FieldOps
from sda_tpu_torch.mesh import (
    StreamingAggregator,
    array_block_provider,
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
    gives the JAX stage's masked rows and mask sum bit for bit."""
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

    monkeypatch.setattr(simpod, "_chacha_seed_words", seed_words)
    f = FieldOps.create(m)
    got, got_sum = simpod._mask_stage(
        ChaChaMasking(m, 4096, 96), f, f.to_residues(torch.from_numpy(x)),
        None, round_seed=99, pid_base=pid_base, d_block0=d_block0)
    assert fed == [(99, list(range(pid_base, pid_base + S)), 96)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(masked, np.int64))
    np.testing.assert_array_equal(got_sum.numpy(), np.asarray(msum, np.int64))


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
    """The K1 lane over ragged tails on both axes: exact; a ChaCha tile's
    grain is lcm(3, 8) = 24, so the 4-column dim tail pads to 24."""
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
    tail = {"full": (2, 30), "chacha": (2, 24)}[masking]
    assert shapes[-1] == tail


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
