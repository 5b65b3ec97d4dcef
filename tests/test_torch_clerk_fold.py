"""K10, the clerk's device-tile fold (``sda_tpu_torch.fields.residues.
fold_columns``), and ``DeviceTileCombiner`` around it, on the CPU: the
plain version against numpy's floor mod and sum and against the JAX
package's ``FieldOps`` fold step; the kernel's constants and reduction in
Python ints; the wrapper's checks and its in-place update; the port's
``DeviceTileCombiner(device="cpu", dim_tile=...)`` against the reference's
``DeviceTileCombiner`` on JAX's CPU, on the same bundles (at least 4 tiles,
a ragged last tile, negative and >= m words); and the card's staging
order (tile j+1's copy issued before tile j's fold, a slot's buffers
reused only after their copy and fold, the ragged tile at its own width)
through a stand-in stager that runs on the CPU. Tolerance 0: every result
is exact."""

import numpy as np
import pytest
import torch

from sda_tpu.crypto.sharing import mod_combine as ref_mod_combine
from sda_tpu.fields.ops import FieldOps as RefFieldOps
from sda_tpu.mesh import devscale as ref_devscale

from sda_tpu_torch.crypto.sharing import mod_combine
from sda_tpu_torch.fields import numtheory, residues
from sda_tpu_torch.mesh import DeviceTileCombiner, devscale

T, P29, W2, W3 = numtheory.generate_packed_params(3, 8, 28)
#: Solinas (the flagship's, 433) and generic moduli FieldOps.create takes
MODULI = (433, P29, (1 << 31) - 1, (1 << 61) - 1, (1 << 62) - 57)


def _words(rng, shape, m):
    """int64 bundle words: canonical residues, negatives, values >= m and
    both ends of int64 (Paillier-premixed bundles decrypt to unreduced
    sums)."""
    x = rng.integers(-(1 << 63), (1 << 63) - 1, size=shape, dtype=np.int64)
    x[..., ::3] = rng.integers(0, m, size=x[..., ::3].shape)
    x[..., 1::7] = rng.integers(-m, 0, size=x[..., 1::7].shape)
    x.flat[0], x.flat[-1] = -(1 << 63), (1 << 63) - 1
    return x


def _oracle(acc, blk, m):
    return (np.asarray(acc, dtype=object)
            + (np.asarray(blk, dtype=object) % m).sum(axis=0)) % m


@pytest.mark.parametrize("m", MODULI)
@pytest.mark.parametrize("rows", [1, 3, 25])
def test_plain_equals_numpy_and_the_jax_fold_step(m, rows):
    rng = np.random.default_rng(rows)
    blk = _words(rng, (rows, 301), m)
    acc = rng.integers(0, m, size=301, dtype=np.int64)
    got = residues.fold_columns_plain(torch.from_numpy(acc),
                                      torch.from_numpy(blk), m)
    assert got.dtype == torch.int64
    assert (got.numpy().astype(object) == _oracle(acc, blk, m)).all()
    # the reference's jitted step: acc + sum_rows to_residues(bundle)
    f = RefFieldOps.create(m)
    ref = f.add(np.asarray(acc).astype(f.dtype),
                f.sum(f.to_residues(blk), axis=0))
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  got.numpy())


@pytest.mark.parametrize("m", MODULI)
def test_fold_columns_on_cpu_updates_in_place(m):
    rng = np.random.default_rng(2)
    blk = torch.from_numpy(_words(rng, (7, 130), m))
    acc = torch.from_numpy(rng.integers(0, m, size=130, dtype=np.int64))
    want = residues.fold_columns_plain(acc, blk, m)
    before = residues.fold_columns.launches
    same = residues.fold_columns(acc, blk, m)
    assert same is acc and torch.equal(acc, want)
    assert residues.fold_columns.launches == before
    # a strided column window of a wider bundle, into a window of acc
    wide = torch.from_numpy(_words(rng, (5, 200), m))
    acc2 = torch.zeros(200, dtype=torch.int64)
    residues.fold_columns(acc2[:90], wide[:, 10:100], m)
    assert (acc2[:90].numpy().astype(object)
            == _oracle(np.zeros(90, np.int64), wide[:, 10:100].numpy(),
                       m)).all()
    assert not acc2[90:].any()


def test_fold_columns_checks():
    acc = torch.zeros(8, dtype=torch.int64)
    blk = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match=r"\(0, 2\^63\]"):
        residues.fold_columns(acc, blk, 0)
    with pytest.raises(ValueError, match=r"\(0, 2\^63\]"):
        residues.fold_columns(acc, blk, (1 << 63) + 1)
    with pytest.raises(ValueError, match="int64"):
        residues.fold_columns(acc, blk.to(torch.int32), 433)
    with pytest.raises(ValueError, match="accumulator"):
        residues.fold_columns(acc[:7], blk, 433)
    with pytest.raises(ValueError, match="accumulator"):
        residues.fold_columns(torch.zeros(16, dtype=torch.int64)[::2], blk,
                              433)
    with pytest.raises(ValueError, match="accumulator"):
        residues.fold_columns(acc.to(torch.int32), blk, 433)


def test_kernel_reduction_in_python_ints():
    """K10's arithmetic as ``csrc/residues.cu`` does it: a word's sign bit
    flipped, Barrett with mu = floor((2^64 - 1) / m) and one conditional
    subtract, the fold constant -2^63 mod m added back mod m, and the
    column sum kept canonical after every row: the floor mod and sum for
    every m in (0, 2^63]."""
    rng = np.random.default_rng(9)
    for m in (1, 2, 433, P29, (1 << 61) - 1, (1 << 62) + 1, (1 << 63) - 25,
              1 << 63):
        mu, fold = residues.fold_constants(m)
        assert mu == ((1 << 64) - 1) // m and fold == -(1 << 63) % m

        def reduce(v):
            r = (v - ((v * mu) >> 64) * m) % (1 << 64)
            assert r < 2 * m
            return r - m if r >= m else r

        def add(a, b):
            s = a + b
            assert s < 1 << 64
            return s - m if s >= m else s

        xs = [-(1 << 63), -1, 0, 1, m - 1, (1 << 63) - 1]
        xs += [int(v) for v in rng.integers(-(1 << 63), (1 << 63) - 1,
                                            size=300)]
        s = 0
        for x in xs:
            word = (x + (1 << 64)) % (1 << 64) ^ (1 << 63)
            r = add(reduce(word), fold)
            assert r == x % m
            s = add(s, r)
        assert s == sum(xs) % m


# -- DeviceTileCombiner ---------------------------------------------------------------

@pytest.mark.parametrize("m", [433, P29, (1 << 61) - 1])
def test_combiner_equals_the_reference_combiner(m):
    """4 full tiles of 192 and a ragged one of 40, three bundles (one a
    single vector), words negative and >= m: the port's combiner on the CPU
    equals the reference's on JAX's CPU, mod_combine and numpy."""
    rng = np.random.default_rng(13)
    rows = _words(rng, (9, 808), m)
    bundles = [rows[:4], rows[4:8], rows[8]]
    c = DeviceTileCombiner(m, dim_tile=192, device="cpu")
    ref = ref_devscale.DeviceTileCombiner(m, dim_tile=192)
    for b in bundles:
        c.fold(b)
        ref.fold(b)
    assert c.folded == 3 and c._plan_t.n_tiles == 5 and c._plan_t.pad == 152
    got = c.result()
    np.testing.assert_array_equal(got, ref.result())
    assert (got.astype(object) == _oracle(np.zeros(808, np.int64), rows,
                                          m)).all()
    canon = [r % m for r in rows]
    np.testing.assert_array_equal(got, mod_combine(canon, m, "cpu"))
    np.testing.assert_array_equal(got, ref_mod_combine(canon, m))


def test_combiner_folds_tiles_at_their_width_without_padding(monkeypatch):
    """One K10 call a tile a bundle, each on the bundle's own columns: the
    ragged last tile at its own width into the head of its accumulator,
    no padded copy of the bundle."""
    calls = []
    real = residues.fold_columns

    def spy(acc, blk, m):
        calls.append((acc.shape[0], tuple(blk.shape)))
        return real(acc, blk, m)

    monkeypatch.setattr(devscale, "fold_columns", spy)
    monkeypatch.setattr(np, "pad", None)   # the old path padded the bundle
    c = DeviceTileCombiner(433, dim_tile=128, device="cpu")
    rows = np.arange(3 * 300, dtype=np.int64).reshape(3, 300)
    c.fold(rows)
    c.fold(rows)
    assert calls == [(128, (3, 128)), (128, (3, 128)), (44, (3, 44))] * 2
    np.testing.assert_array_equal(c.result(), 2 * rows.sum(0) % 433)


class _CpuStager:
    """``_TileStager``'s interface on the CPU: two staging slots used in
    turn, with a log of every call, and checks of the card's ordering (a
    slot is refilled only after the fold that read it was released)."""

    def __init__(self):
        self.log = []
        self._slot = 0
        self._busy = [False, False]

    def land(self, tile):
        s = self._slot
        self._slot ^= 1
        assert not self._busy[s], "a slot refilled before its fold"
        self._busy[s] = True
        self.log.append(("land", s, tile.shape, tile.strides))
        return s, torch.from_numpy(np.ascontiguousarray(tile))

    def wait(self, slot):
        self.log.append(("wait", slot))

    def release(self, slot):
        self._busy[slot] = False
        self.log.append(("release", slot))

    def done(self):
        self.log.append(("done",))

    def wait_done(self):
        self.log.append(("wait_done",))


def test_card_pipeline_order(monkeypatch):
    """The card's fold loop, with its stager on the CPU: tile j+1 lands
    before tile j's fold is queued (the copy overlaps the fold), each fold
    waits for its own slot's copy and releases it, the strided column
    slices land as they are (no padded copy), the ragged last tile at its
    own width, and ``result`` waits for the last fold."""
    folds = []
    real = residues.fold_columns

    def spy(acc, blk, m):
        folds.append(len(stager.log))
        return real(acc, blk, m)

    monkeypatch.setattr(devscale, "fold_columns", spy)
    rng = np.random.default_rng(4)
    c = DeviceTileCombiner(P29, dim_tile=128, device="cpu")
    stager = c._stager = _CpuStager()
    rows = _words(rng, (6, 600), P29)
    c.fold(rows[:5])
    c.fold(rows[5])
    log = stager.log
    tiles = 5                                    # 4 x 128 + 88
    lands = [e for e in log if e[0] == "land"]
    assert [e[2] for e in lands] == ([(5, 128)] * 4 + [(5, 88)]
                                     + [(1, 128)] * 4 + [(1, 88)])
    assert all(e[3] == (600 * 8, 8) for e in lands[:tiles])  # views
    assert [e[1] for e in lands] == [0, 1] * tiles
    for b in range(2):
        part = log[b * (3 * tiles + 1):(b + 1) * (3 * tiles + 1)]
        slot = [(b * tiles + j) % 2 for j in range(tiles)]
        want = [("land", slot[0])]
        for j in range(tiles):
            want += ([("land", slot[j + 1])] if j + 1 < tiles else []) + [
                ("wait", slot[j]), ("release", slot[j])]
        assert [e[:2] for e in part] == want + [("done",)]
    # each fold ran right after its wait
    assert all(log[i - 1][0] == "wait" for i in folds)
    got = c.result()
    assert log[-1] == ("wait_done",)
    assert (got.astype(object) == _oracle(np.zeros(600, np.int64), rows,
                                          P29)).all()


def test_card_tile_is_capped_by_the_staging_buffers(monkeypatch):
    """On a card the watermark tile is also held to one staging buffer's
    rows x tile int64 (``STAGE_BYTES``); the CPU plans by the watermark
    alone."""
    monkeypatch.setenv("SDA_HBM_WATERMARK", str(1 << 40))
    cpu = DeviceTileCombiner(P29, device="cpu")
    cpu.fold(np.ones((4, 1000), dtype=np.int64))
    assert cpu._dim_tile == (1 << 40) // int((2 * 4 + 2) * 8 * 1.25)
    card = DeviceTileCombiner(P29, device="cpu")
    card._stager = _CpuStager()
    card.fold(np.ones((4, 1000), dtype=np.int64))
    assert card._dim_tile == devscale.STAGE_BYTES // (8 * 4)
    np.testing.assert_array_equal(card.result(), np.full(1000, 4))


def test_combiner_refuses_a_modulus_k10_cannot_fold():
    with pytest.raises(ValueError, match=r"\(0, 2\^63\]"):
        DeviceTileCombiner((1 << 64) - 59, device="cpu")
