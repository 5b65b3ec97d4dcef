"""K7, the reveal (``sda_tpu_torch/fields/reveal.py``, ``csrc/reveal.cu``),
on the CPU: its plain version bit for bit against the JAX package's
``packed_reconstruct32`` + ``modsub32`` + ``to_int64`` and against the
jitted streamed finale (``StreamingAggregator._final_fn``); a numpy
emulation of the kernel's in-register arithmetic (the uint64 sums, the
Solinas fold, the unmask, the unbatched write) held to the plain version;
the wrapper's CPU leg and its launch arguments; the bound; and whole
rounds through the rerouted callers (single device, streamed, 1x1 and 4x2
pods on ``["cpu"] * 8``), exact. Every tolerance is exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu import protocol as ref_proto
from sda_tpu.fields import fastfield as ref_ff
from sda_tpu.fields import sharing as ref_sharing
from sda_tpu.mesh import StreamingAggregator as RefStreamingAggregator

from sda_tpu_torch.benchmarks import bounds
from sda_tpu_torch import fields
from sda_tpu_torch.fields import fused_round, numtheory, reveal, sharing
from sda_tpu_torch.fields.fastfield import SolinasPrime
from sda_tpu_torch.fields.ops import FieldOps
from sda_tpu_torch.mesh import (SimulatedPod, StreamedPod,
                                StreamingAggregator, make_mesh,
                                single_chip_round, simpod)
from sda_tpu_torch.protocol import (BasicShamirSharing, ChaChaMasking,
                                    FullMasking, NoMasking,
                                    PackedShamirSharing)

FLAGSHIP = numtheory.generate_packed_params(3, 8, 28)    # (t, p, w2, w3)
P29 = FLAGSHIP[1]
#: (k, clerks) -> (t, p, w2, w3) of the wider committees: the 26-clerk
#: k=7, t=8 and sda-sim's ``--clerks 80`` (k=3, t=4 over 2^29 - 2263: more
#: rows than the kernel sums between two folds)
WIDE = {(k, n): numtheory.generate_packed_params(k, n, 28)
        for k, n in ((7, 26), (3, 80))}


def _schemes(kind):
    """(port scheme, reference scheme) of a case."""
    if kind == "k3r8":
        args = (3, 8, *FLAGSHIP)
        return PackedShamirSharing(*args), ref_proto.PackedShamirSharing(*args)
    if kind == "k1r8":
        return (BasicShamirSharing(8, 3, P29),
                ref_proto.BasicShamirSharing(8, 3, P29))
    k, n = {"k7r26": (7, 26), "k3r80": (3, 80)}[kind]
    args = (k, n, *WIDE[k, n])
    return PackedShamirSharing(*args), ref_proto.PackedShamirSharing(*args)


#: (scheme kind, surviving clerks or None, B, d): the flagship k=3 at 8
#: clerks with d a multiple of k and not, BasicShamir k=1 at 8, the
#: 26-clerk committee k=7, t=8, quorum subsets, the 80-clerk committee
#: (r = 80 and a quorum of 65), and k = 20 secrets (more than a thread
#: sums) from 40 rows of a random matrix
CASES = [("k3r8", None, 40, 120), ("k3r8", None, 41, 121),
         ("k1r8", None, 37, 37), ("k7r26", None, 19, 130),
         ("k3r8", (0, 1, 2, 3, 4, 6, 7), 23, 68),
         ("k7r26", tuple(range(1, 26, 2)) + (0, 4), 11, 75),
         ("k3r80", None, 9, 27),
         ("k3r80", tuple(range(0, 80, 2)) + tuple(range(1, 50, 2)), 11, 31),
         ("k20rand", None, 9, 175)]
MASKS = ["none", "batched", "flat"]


def _case(kind, survivors, B, d, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "k20rand":
        scheme = ref_scheme = None
        n, p = 40, P29
        L = rng.integers(0, p, size=(20, n + 1))
    else:
        scheme, ref_scheme = _schemes(kind)
        n, p = scheme.share_count, scheme.prime_modulus
        L = numtheory.reconstruct_matrix_for(
            scheme, tuple(range(n)) if survivors is None else survivors)
    k = L.shape[0]
    rows = rng.integers(0, p, size=(n, B))
    mask = {"none": None, "batched": rng.integers(0, p, size=(k, B)),
            "flat": rng.integers(0, p, size=d)}[mask_kind]
    return scheme, ref_scheme, L, SolinasPrime.try_from(p), rows, mask


def _jax_reveal(rows, L, p, d, mask, survivors):
    """The JAX package's reveal: ``packed_reconstruct32`` of the surviving
    rows, ``modsub32`` of the (unbatched) mask, ``to_int64``."""
    sp = ref_ff.SolinasPrime.try_from(p)
    if survivors is not None:
        rows = rows[list(survivors)]
    total = ref_sharing.packed_reconstruct32(
        jnp.asarray(rows, jnp.uint32), L, sp, dimension=d)
    if mask is not None:
        m = jnp.asarray(mask, jnp.uint32)
        if m.ndim == 2:
            m = ref_sharing.unbatch_columns(m, d)
        total = ref_ff.modsub32(total, m, sp)
    return np.asarray(total.astype(jnp.int64))


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a, np.int64))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("kind,survivors,B,d", CASES)
def test_reveal_plain_is_the_jax_reveal(kind, survivors, B, d, mask_kind):
    """``reveal_plain`` (and the wrapper's CPU leg) gives the JAX package's
    reveal bit for bit, at every scheme, layout, quorum and ragged d."""
    scheme, _, L, sp, rows, mask = _case(kind, survivors, B, d, mask_kind)
    want = _jax_reveal(rows, L, sp.p, d, mask, survivors)
    kw = dict(dimension=d, mask=_t(mask), rows_index=survivors)
    got = reveal.reveal_plain(_t(rows), L, sp, **kw)
    assert got.dtype == torch.int64 and got.shape == (d,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(reveal.reveal(_t(rows), L, sp, **kw).numpy(),
                                  want)


@pytest.mark.parametrize("masked,survivors", [
    (False, None), (True, None), (True, (0, 2, 3, 4, 5, 6, 7)),
    (False, (7, 6, 5, 4, 3, 2, 1))])
def test_streamed_finale_is_the_jitted_finale(masked, survivors):
    """The port's streamed finale (now K7's) equals the JAX package's jitted
    ``_final_fn`` on the same accumulators, exact."""
    scheme, ref_scheme = _schemes("k3r8")
    p, d = scheme.prime_modulus, 96
    masking = FullMasking(p) if masked else NoMasking()
    ref_masking = ref_proto.FullMasking(p) if masked else ref_proto.NoMasking()
    rng = np.random.default_rng(5)
    acc_shares = rng.integers(0, p, size=(8, d // 3))
    acc_mask = rng.integers(0, p, size=d)
    ref = RefStreamingAggregator(ref_scheme, ref_masking,
                                 participants_chunk=4, dim_chunk=d,
                                 surviving_clerks=survivors)
    want = np.asarray(ref._final_fn(d)(jnp.asarray(acc_shares, jnp.uint32),
                                       jnp.asarray(acc_mask, jnp.uint32)))
    port = StreamingAggregator(scheme, masking, participants_chunk=4,
                               dim_chunk=d, surviving_clerks=survivors,
                               device="cpu")
    got = port._final(_t(acc_shares), _t(acc_mask))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# ---------------------------------------------------------------------------
# The kernel's arithmetic, emulated in numpy

U64 = np.uint64


def _mod_p_np(x, sp: SolinasPrime):
    """``columns.cuh::mod_p``: fold the bits above e down (2^e = c mod p)
    while there are any, then one conditional subtract."""
    x = np.asarray(x, dtype=U64).copy()
    e, low = U64(sp.b), U64((1 << sp.b) - 1)
    while (x >> e).any():
        x = np.where(x >> e, (x >> e) * U64(sp.delta) + (x & low), x)
    return np.where(x >= U64(sp.p), x - U64(sp.p), x)


#: reveal.cu's constants: threads a block, rows loaded together, row
#: groups between two folds
THREADS, ROWS, FOLD_GROUPS = 256, 8, 7


def _k7_np(rows, L, sp, d, mask=None, survivors=None, threads=THREADS):
    """K7 from its launch arguments: each column's r row values as 32-bit
    words in groups of ROWS, each secret's uint64 sum of products (checked
    never to wrap) folded in place every FOLD_GROUPS groups and at the end,
    the unmask (a mask value read at (i, b) through the kernel's strides),
    and the staged write of each block of ``threads`` columns and chunk of
    KC secrets (4 for k <= 4, else 16) to its output indices."""
    table, idx = reveal.launch_args(L, sp, survivors, rows.shape[0])
    k, r = table.shape
    B = rows.shape[1]
    v = np.asarray(rows, dtype=np.int64)[idx].astype(U64) & U64(0xFFFFFFFF)
    acc = np.zeros((k, B), dtype=U64)
    for g, j0 in enumerate(range(0, r, ROWS)):
        for j in range(j0, min(j0 + ROWS, r)):
            new = acc + U64(1) * table[:, j:j + 1].astype(U64) * v[j]
            assert (new >= acc).all(), "a uint64 sum wrapped"
            acc = new
        if g % FOLD_GROUPS == FOLD_GROUPS - 1:
            acc = _mod_p_np(acc, sp)
    s = _mod_p_np(acc, sp)
    if mask is not None:
        mt = torch.from_numpy(np.asarray(mask, np.int64))
        ms_i, ms_b = reveal._mask_strides(mt, k, B, d)
        flat = mt.reshape(-1).numpy().astype(U64)
        ii, bb = np.meshgrid(np.arange(k), np.arange(B), indexing="ij")
        live = bb * k + ii < d
        m = np.zeros((k, B), dtype=U64)
        m[live] = flat[(ii * ms_i + bb * ms_b)[live]]
        s = np.where(s >= m, s - m, s + U64(sp.p) - m)
    out = np.full(d, -1, dtype=np.int64)
    KC = 4 if k <= 4 else 16
    for i0 in range(0, k, KC):               # blockIdx.y
        kc = min(KC, k - i0)
        for b0 in range(0, B, threads):      # blockIdx.x
            stage = s[i0:i0 + kc, b0:b0 + threads].T.reshape(-1)
            e = np.arange(stage.size)
            o = (e + b0 * k if kc == k
                 else (b0 + e // kc) * k + i0 + e % kc)
            live = o < d
            assert (out[o[live]] == -1).all(), "an output written twice"
            out[o[live]] = stage[live].astype(np.int64)
    assert (out >= 0).all(), "an output never written"
    return out


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("kind,survivors,B,d", CASES)
def test_kernel_arithmetic_emulated_is_the_plain_reveal(kind, survivors, B,
                                                        d, mask_kind):
    """The kernel's sums fit uint64 and its fold, unmask and staged write
    give ``reveal_plain``'s bits (blocks of 4 columns here, so the cases
    span several blocks)."""
    _, _, L, sp, rows, mask = _case(kind, survivors, B, d, mask_kind, seed=3)
    want = reveal.reveal_plain(_t(rows), L, sp, dimension=d, mask=_t(mask),
                               rows_index=survivors)
    np.testing.assert_array_equal(
        _k7_np(rows, L, sp, d, mask, survivors, threads=4), want.numpy())


@pytest.mark.parametrize("k,r", [(16, 56), (20, 57), (3, 120)])
def test_kernel_sums_fit_uint64_between_folds(k, r):
    """At r rows of p - 1 and a matrix of p - 1 (the largest products), on
    either side of an in-place fold (56 rows) and across two, the sums do
    not wrap and the folds give the residue."""
    sp = SolinasPrime.try_from(P29)
    L = np.full((k, r + 1), P29 - 1, dtype=np.int64)
    rows = np.full((r, 5), P29 - 1, dtype=np.int64)
    want = np.full(5 * k, (r * (P29 - 1) * (P29 - 1)) % P29, dtype=np.int64)
    np.testing.assert_array_equal(_k7_np(rows, L, sp, 5 * k), want)
    np.testing.assert_array_equal(
        reveal.reveal_plain(_t(rows), L, sp, dimension=5 * k).numpy(), want)


# ---------------------------------------------------------------------------
# The wrapper

def test_wrapper_cpu_leg_counts_no_launch():
    """On CPU tensors the wrapper, and ``reconstruct`` through it, run the
    plain version and count no launch."""
    scheme, _, L, sp, rows, mask = _case("k3r8", None, 40, 120, "batched")
    before = reveal.reveal.launches
    reveal.reveal(_t(rows), L, sp, dimension=120, mask=_t(mask))
    reveal.reconstruct(_t(rows), L, prime=sp.p, dimension=120, mask=_t(mask))
    assert reveal.reveal.launches == before


@pytest.mark.parametrize("shape,rows_index,match", [
    ((3, 1), None, "reconstruction matrix"),
    ((0, 9), None, "reconstruction matrix"),
    ((3, 9), (0, 1, 2, 3, 4, 5, 6, 8), "rows"),
    ((3, 9), (0, 1, 2), "rows")])
def test_launch_args_refuse_what_the_kernel_cannot_take(shape, rows_index,
                                                         match):
    sp = SolinasPrime.try_from(P29)
    with pytest.raises(ValueError, match=match):
        reveal.launch_args(np.ones(shape, dtype=np.int64), sp, rows_index, 8)


def test_launch_args_drop_column_zero_and_keep_the_rows():
    sp = SolinasPrime.try_from(P29)
    L = np.arange(3 * 8).reshape(3, 8) + P29   # column 0 and a wrap mod p
    table, idx = reveal.launch_args(L, sp, (6, 0, 2, 3, 4, 5, 1), 8)
    assert table.dtype == np.uint32 and table.flags.c_contiguous
    np.testing.assert_array_equal(table, (L[:, 1:] % P29).astype(np.uint32))
    np.testing.assert_array_equal(idx, [6, 0, 2, 3, 4, 5, 1])
    table, idx = reveal.launch_args(np.ones((40, 81), np.int64), sp, None, 80)
    assert table.shape == (40, 80) and idx.tolist() == list(range(80))


def test_reveal_bound_at_the_flagship_tile():
    """The bytes of the flagship tile's reveal: 8 rows and the [3, B] mask
    read, d outputs written, ~37 MB (0.0111 ms at 3.35 TB/s)."""
    B, d = 333_333, 999_999
    ms, by, detail = bounds.reveal_bound(8, B, 3, d, "batched")
    assert by == "bytes" and ms == pytest.approx(0.011144, abs=1e-6)
    assert detail.startswith(f"{(8 * B + 3 * B + d) * 8} bytes")
    assert bounds.reveal_bound(8, B, 3, d, "flat")[2].startswith(
        f"{(8 * B + 2 * d) * 8} bytes")
    assert bounds.reveal_bound(8, B, 3, d)[0] < ms
    with pytest.raises(ValueError, match="mask layout"):
        bounds.reveal_bound(8, B, 3, d, "rows")


# ---------------------------------------------------------------------------
# The recipient's reconstruct and the rounds through the rerouted callers

@pytest.mark.parametrize("prime_kind", ["solinas", "generic"])
def test_packed_reconstruct_over_either_prime(prime_kind):
    """``fields.reconstruct`` (the recipient's device route) takes K7 over
    a Solinas prime and ``sharing.packed_reconstruct``'s ``modmatmul``
    otherwise; both give the canonical residues of the JAX package's
    jitted ``packed_reconstruct``, from a host or a tensor matrix."""
    if prime_kind == "solinas":
        scheme = PackedShamirSharing(3, 8, *FLAGSHIP)
    else:
        scheme = PackedShamirSharing(3, 8, 4, 433, 354, 150)
    p = scheme.prime_modulus
    idx = (0, 1, 3, 4, 5, 6, 7)
    L = numtheory.reconstruct_matrix_for(scheme, idx)
    rows = np.random.default_rng(9).integers(0, p, size=(7, 50))
    want = np.asarray(ref_sharing.packed_reconstruct(
        jnp.asarray(rows), jnp.asarray(L), prime=p, dimension=149))
    for matrix in (L, torch.from_numpy(np.array(L))):
        got = fields.reconstruct(_t(rows), matrix, prime=p, dimension=149)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        got = sharing.packed_reconstruct(_t(rows), matrix, prime=p,
                                         dimension=149)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("mask_kind", MASKS)
def test_reconstruct_over_a_generic_prime_unmasks_a_quorum(mask_kind):
    """Over a prime K7 does not take, ``reconstruct`` reads the quorum's
    rows, unbatches a batched mask and subtracts it mod p: the JAX
    package's ``packed_reconstruct`` of the quorum minus the mask, exact."""
    scheme = PackedShamirSharing(3, 8, 4, 433, 354, 150)
    p, d, B = 433, 58, 20
    survivors = (7, 0, 1, 3, 4, 5, 6)
    L = numtheory.reconstruct_matrix_for(scheme, survivors)
    rng = np.random.default_rng(21)
    rows = rng.integers(0, p, size=(8, B))
    mask = {"none": None, "batched": rng.integers(0, p, size=(3, B)),
            "flat": rng.integers(0, p, size=d)}[mask_kind]
    want = np.asarray(ref_sharing.packed_reconstruct(
        jnp.asarray(rows[list(survivors)]), jnp.asarray(L), prime=p,
        dimension=d)).astype(np.int64)
    if mask is not None:
        flat = mask.T.reshape(-1)[:d] if mask.ndim == 2 else mask
        want = (want - flat) % p
    got = reveal.reconstruct(_t(rows), L, prime=p, dimension=d,
                             mask=_t(mask), rows_index=survivors)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("masking,pallas,want_dtype", [
    ("chacha", False, torch.int64), ("chacha", True, torch.int64),
    ("full", True, torch.int32), ("full", False, torch.int64),
    ("none", True, torch.int32)])
def test_fold_input_folds_the_residue_pass(masking, pallas, want_dtype):
    """ChaCha masks take the raw block (K3 reduces it), the K1 lane K8's
    int32 residues, the plain lane ``to_residues``' int64 ones."""
    p = P29
    mask = {"chacha": ChaChaMasking(p, 16, 128), "full": FullMasking(p),
            "none": NoMasking()}[masking]
    f = FieldOps.create(p)
    block = torch.tensor([[-5, 1 << 40, p, 7], [0, -(1 << 62), 3, p + 1]],
                         dtype=torch.int64)
    x = simpod._fold_input(f, mask, pallas, block)
    assert x.dtype == want_dtype
    want = block if masking == "chacha" else torch.remainder(block, p)
    np.testing.assert_array_equal(x.to(torch.int64).numpy(), want.numpy())


MESH_CASES = [(shape, mask, pallas) for shape in ("1x1", "4x2")
              for mask in ("full", "chacha", "none")
              for pallas in (True, False)]


@pytest.mark.parametrize("shape,mask,pallas", MESH_CASES)
def test_pod_rounds_stay_exact(shape, mask, pallas):
    """SimulatedPod on ``["cpu"] * 8`` through ``_fold_input`` and K7's
    reveal (its plain version here), exact; int64 inputs with negatives."""
    torch.set_num_threads(1)
    scheme = PackedShamirSharing(3, 8, *FLAGSHIP)
    p = scheme.prime_modulus
    masking = {"full": FullMasking(p), "chacha": ChaChaMasking(p, 96, 128),
               "none": NoMasking()}[mask]
    mesh = (make_mesh(1, 1, devices=["cpu"]) if shape == "1x1"
            else make_mesh(4, 2, devices=["cpu"] * 8))
    inputs = np.random.default_rng(12).integers(-(1 << 40), 1 << 40,
                                                size=(8, 96))
    pod = SimulatedPod(scheme, masking, mesh=mesh, use_pallas=pallas)
    out = pod.aggregate(torch.from_numpy(inputs), seed=4)
    np.testing.assert_array_equal(out.numpy(), inputs.sum(axis=0) % p)


@pytest.mark.parametrize("mask", ["full", "chacha", "none"])
def test_streamed_rounds_stay_exact(mask):
    """The streamed aggregator (K1 lane) and a 4x2 streamed pod (plain
    lane), both through K7's finale, with a quorum on the pod, exact."""
    torch.set_num_threads(1)
    scheme = PackedShamirSharing(3, 8, *FLAGSHIP)
    p = scheme.prime_modulus
    masking = {"full": FullMasking(p), "chacha": ChaChaMasking(p, 96, 128),
               "none": NoMasking()}[mask]
    inputs = np.random.default_rng(13).integers(0, 1 << 32, size=(10, 96),
                                                dtype=np.uint32)
    want = inputs.astype(np.int64).sum(axis=0) % p
    agg = StreamingAggregator(scheme, masking, participants_chunk=4,
                              dim_chunk=48, use_pallas=True, device="cpu")
    np.testing.assert_array_equal(agg.aggregate(inputs, seed=3), want)
    pod = StreamedPod(scheme, masking, mesh=make_mesh(4, 2,
                                                      devices=["cpu"] * 8),
                      participants_chunk=4, dim_chunk=48,
                      surviving_clerks=(0, 1, 2, 4, 5, 6, 7))
    np.testing.assert_array_equal(pod.aggregate(inputs, seed=3), want)


@pytest.mark.parametrize("mask", ["full", "chacha", "none"])
def test_single_device_rounds_stay_exact(mask):
    """``single_chip_round`` (plain lane) and, but for ChaCha,
    ``single_chip_round_pallas`` (K1, K8 for int64 inputs, K7 on the
    batched mask) on the CPU, exact."""
    scheme = PackedShamirSharing(3, 8, *FLAGSHIP)
    p = scheme.prime_modulus
    masking = {"full": FullMasking(p), "chacha": ChaChaMasking(p, 1003, 128),
               "none": NoMasking()}[mask]
    inputs = np.random.default_rng(14).integers(-(1 << 62), 1 << 62,
                                                size=(6, 1003 if mask !=
                                                      "chacha" else 1000))
    x = torch.from_numpy(inputs)
    want = np.array([int(v) % p for v in inputs.astype(object).sum(axis=0)])
    out = single_chip_round(scheme, masking, device="cpu")(
        x, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(out.numpy(), want)
    if mask != "chacha":
        out = fused_round.single_chip_round_pallas(
            scheme, masking, device="cpu")(x, torch.Generator().manual_seed(1))
        np.testing.assert_array_equal(out.numpy(), want)
