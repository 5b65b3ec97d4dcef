"""Component-isolation probe of K1: where does the fused round's time go?

Port of ``benchmarks/kernel_probe.py``. It times stripped variants of the
fused mask-share-combine kernel (K1, ``fields/csrc/fused_round.cu``), each
exercising some of its components on K1's own structure (one thread a
column, raw uint64 sums over the participants, one reduction and one share
contraction a column). The variants are K5, a hand-written CUDA kernel for
Hopper (``fields/csrc/kernel_probe.cu``):

    fold_only   read the inputs + participant fold (device-memory bytes)
    prng_only   per-participant mask/randomness draws + fold (no inputs)
    no_matmul   fold + draws (the full round minus the share contraction)
    full        fold + draws + contraction (== K1's shares, same seed)
    fold_tree, full_tree   the same with 4 threads a column (``tree=True``)

Each variant pays the launch/loop overhead O once, so ``solve_budget``
solves matmul = full - no_matmul, prng = no_matmul - fold_only,
overhead = prng_only - prng, fold = fold_only - overhead. Two fold
experiments ride along on the same [P, d] inputs: ``xla_fold`` (``modsum32``
over the participants) and ``mxu_fold`` (base-128 int8 limbs contracted
with a ones vector by ``torch._int_mm``: can the tensor cores take an
exact share of the fold?).

Differences from the JAX probe: the TPU knobs (``tile``, ``p_block``,
``p_tile``) have no counterpart; the inputs are the round's own layout,
the strided ``batch_columns`` view of [P, d] canonical residues from
``np.random.default_rng(7)``, at the flagship's full width by default
(P = 100, d = 999,999) rather than at the TPU knob shapes; and with draws
but no contraction, rows [k, k+t) hold the randomness sums (see the
kernel's header comment: on CUDA unstored draws are compiled away).

    python -m sda_tpu_torch.benchmarks.kernel_probe        # on the card
    python -m sda_tpu_torch.benchmarks.kernel_probe --device cpu \\
        --participants 8 --dim 3000    # exactness gates only, plain versions

Prints one JSON line per stage, under the JAX probe's stage names:
``probe_env``, ``mxu_exact``, ``fold_exact``, ``fold_tree_exact``,
``full_matches_library``, then on the card ``component`` (one a variant),
``tree_ab``, ``budget``, ``fold_ab`` (one a fold), and ``probe_done``. The
exactness gates run before any timing; on the CPU nothing is timed.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..fields import _build, numtheory
from ..fields.fastfield import (
    SolinasPrime,
    canon32,
    matrix_limbs,
    modadd32,
    modmatmul32_limbs,
    modsum32,
    mulmod32_const,
)
from ..fields.fused_round import (
    _words64,
    draw_sum,
    fused_mask_share_combine,
    kernel_operands,
    philox_bits,
)
from ..fields.sharing import batch_columns
from ..utils.benchtime import median_ms

#: the timed variants, under the JAX probe's names
VARIANTS = {
    "fold_only": dict(do_x=True, do_prng=False, do_matmul=False),
    "prng_only": dict(do_x=False, do_prng=True, do_matmul=False),
    "no_matmul": dict(do_x=True, do_prng=True, do_matmul=False),
    "full": dict(do_x=True, do_prng=True, do_matmul=True),
    "fold_tree": dict(do_x=True, do_prng=False, do_matmul=False, tree=True),
    "full_tree": dict(do_x=True, do_prng=True, do_matmul=True, tree=True),
}
#: the x-only contraction: checked, not timed
X_MATMUL = dict(do_x=True, do_prng=False, do_matmul=True)
#: threads a column with ``tree=True``
TREE_GROUP = 4
N_LIMBS = 5  # ceil(29 bits / 7): base-128 keeps limbs in int8's [0, 127]


def _emit(stage: str, **kw) -> None:
    print(json.dumps({"stage": stage, **kw}), flush=True)


def solve_budget(secs: dict) -> dict:
    """Solve the component system from the four variant timings (seconds).

    Every variant pays the grid/init/loop overhead O once:
        fold_only = O+F, prng_only = O+R, no_matmul = O+F+R,
        full = O+F+R+M
    => M = full - no_matmul, R = no_matmul - fold_only,
       O = prng_only - R, F = fold_only - O. Pure host math, unit-tested
    off-chip (tests/test_kernel_probe_budget.py) so a scarce window's
    budget line can't be wrong by algebra.
    """
    matmul_s = secs["full"] - secs["no_matmul"]
    prng_s = secs["no_matmul"] - secs["fold_only"]
    overhead_s = secs["prng_only"] - prng_s
    fold_s = secs["fold_only"] - overhead_s
    return {"fold_s": fold_s, "prng_s": prng_s, "matmul_s": matmul_s,
            "overhead_s": overhead_s}


# ---------------------------------------------------------------------------
# K5: plain version and kernel wrapper

def _check(x_cols, m_host, t, do_x, do_prng, do_matmul):
    P, k, B = x_cols.shape
    n, m2 = np.shape(m_host)
    if m2 != 1 + k + t:
        raise ValueError(f"share matrix width {m2} != 1+k+t={1 + k + t}")
    if not (do_x or do_prng):
        raise ValueError("a probe variant reads the inputs, draws, or both")
    if not do_matmul and n < (k + t if do_prng else k):
        raise ValueError(f"{n} output rows cannot hold the uncontracted fold")
    return P, k, B, n


def probe_call_plain(x_cols, seed, sp: SolinasPrime, m_host, t: int, *,
                     do_x: bool, do_prng: bool, do_matmul: bool,
                     tree: bool = False):
    """What :func:`probe_call` computes, in plain torch int64 on any device:
    [P, k, B] 32-bit words -> [n, B] canonical residues. ``tree`` changes
    how the kernel folds, never the output, and is accepted for symmetry.

    Values are the inputs' fold (``do_x``) plus the mask draws
    (``do_prng``, K1's masked Philox words for ``seed``); the randomness is
    the share-randomness draws, or without draws the value rows repeated.
    With ``do_matmul`` the output is the share contraction, else rows
    [0, k) hold the values, rows [k, k+t) the randomness sums when drawn,
    and the rest zero.
    """
    P, k, B, n = _check(x_cols, m_host, t, do_x, do_prng, do_matmul)
    dev = x_cols.device
    values = None
    if do_x:
        values = modsum32(canon32(_words64(x_cols), sp), sp, axis=0)
    if do_prng:
        bits = philox_bits(seed, P, k, t, B, True, dev)
        masksum = draw_sum(bits, k, 0, sp)
        randsum = draw_sum(bits, t, k, sp)
        del bits
        values = masksum if values is None else modadd32(values, masksum, sp)
    else:
        randsum = torch.cat([values] * -(-t // k))[:t]
    if do_matmul:
        mh, ml = matrix_limbs(np.asarray(m_host)[:, 1:], sp, dev)
        return modadd32(
            modmatmul32_limbs(mh[:, :k], ml[:, :k], values, sp),
            modmatmul32_limbs(mh[:, k:], ml[:, k:], randsum, sp), sp)
    out = torch.zeros((n, B), dtype=torch.int64, device=dev)
    out[:k] = values
    if do_prng:
        out[k:k + t] = randsum
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("kernel_probe").sda_kernel_probe
    ptr, i64, i32, u64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_ulonglong)
    fn.argtypes = [ptr, i64, i64, i64, ptr, i32, i32, i32, i32, i64, u64,
                   u64, ptr, i32, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def probe_call(x_cols, seed, sp: SolinasPrime, m_host, t: int, *,
               do_x: bool, do_prng: bool, do_matmul: bool,
               tree: bool = False):
    """K1 running only the selected components: [P, k, B] 32-bit words
    (uint32 or int32 storage, any strides) -> [n, B] int64 canonical
    residues, as :func:`probe_call_plain` defines them. ``tree=True`` folds
    each column with 4 threads and a shared-memory tree instead of one
    thread (bit-identical).

    A CUDA tensor launches K5 (errors raise) and counts the launch in
    ``probe_call.launches``; a CPU tensor runs :func:`probe_call_plain`.
    """
    P, k, B, n = _check(x_cols, m_host, t, do_x, do_prng, do_matmul)
    if x_cols.device.type == "cpu":
        return probe_call_plain(x_cols, seed, sp, m_host, t, do_x=do_x,
                                do_prng=do_prng, do_matmul=do_matmul)
    m_active = kernel_operands(x_cols, sp, m_host, t)
    dev = x_cols.device
    out = torch.empty((n, B), dtype=torch.int64, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x_cols.data_ptr(), *x_cols.stride(), out.data_ptr(), P, k,
                 t, n, B, int(seed) & ((1 << 64) - 1), sp.p,
                 m_active.ctypes.data, int(do_x), int(do_prng),
                 int(do_matmul), TREE_GROUP if tree else 1, stream)
    if err != 0:
        raise RuntimeError(f"probe_call kernel launch failed: CUDA error {err}")
    probe_call.launches += 1
    return out


probe_call.launches = 0


# ---------------------------------------------------------------------------
# Fold experiments on [P, d] canonical residues

def xla_fold(x, sp: SolinasPrime):
    """``modsum32`` over the participant axis: the plain-torch fold."""
    return modsum32(_words64(x), sp, axis=0)


def _limbs_guard(P: int) -> None:
    if P * 127 >= (1 << 31):
        raise ValueError("participant axis too large for int32 limb sums")


def _recombine(sums, sp: SolinasPrime):
    """[d, N_LIMBS] limb sums (< 2^31) -> Σ_i s_i·128^i mod p, canonical."""
    acc = None
    for i in range(N_LIMBS):
        term = mulmod32_const(canon32(sums[:, i].to(torch.int64), sp),
                              (1 << (7 * i)) % sp.p, sp)
        acc = term if acc is None else modadd32(acc, term, sp)
    return acc


def mxu_fold(x, sp: SolinasPrime):
    """Participant fold as an int8 product with a ones vector (exact, mod p).

    x: [P, d] canonical residues (< p < 2^29) in uint32, int32 or int64
    storage. Splits them into base-128 int8 limbs, laid out [d·5, P'] with
    P padded by zero columns to P' = 8·ceil(P/8), and sums each row with
    ``torch._int_mm`` against a [P', 8] ones matrix in int32 (limb sums
    <= P·127 < 2^31), then recombines Σ_i s_i·128^i mod p. A library call,
    the counterpart of the JAX probe's ``dot_general`` (``_int_mm`` wants
    more than 16 rows and both other sizes multiples of 8).
    """
    P, d = x.shape
    _limbs_guard(P)
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    xt = x.to(torch.int32).t()                                    # [d, P]
    p_pad = -(-P // 8) * 8
    limbs = torch.zeros((d, N_LIMBS, p_pad), dtype=torch.int8,
                        device=x.device)
    for i in range(N_LIMBS):
        limbs[:, i, :P] = ((xt >> (7 * i)) & 0x7F).to(torch.int8)
    ones = torch.ones((8, p_pad), dtype=torch.int8, device=x.device).t()
    sums = torch._int_mm(limbs.view(d * N_LIMBS, p_pad), ones)[:, 0]
    return _recombine(sums.view(d, N_LIMBS), sp)


def mxu_fold_plain(x, sp: SolinasPrime):
    """:func:`mxu_fold` with int64 limb sums in place of the int8 product."""
    P, d = x.shape
    _limbs_guard(P)
    w = _words64(x)
    sums = torch.stack([((w >> (7 * i)) & 0x7F).sum(0)
                        for i in range(N_LIMBS)], dim=1)         # [d, 5]
    return _recombine(sums, sp)


# ---------------------------------------------------------------------------

def flagship():
    """(sp, share matrix, k, t) of the flagship: packed Shamir k=3, n=8,
    t=4 over p = 2^29 - 679."""
    from ..protocol import PackedShamirSharing

    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    s = PackedShamirSharing(3, 8, t, p, w2, w3)
    return (SolinasPrime.try_from(p), numtheory.share_matrix_for(s),
            s.secret_count, s.privacy_threshold)


def probe_inputs(P: int, d: int, sp: SolinasPrime, device):
    """[P, d] uint32 canonical residues from ``np.random.default_rng(7)``."""
    rng = np.random.default_rng(7)
    return torch.from_numpy(
        rng.integers(0, sp.p, size=(P, d), dtype=np.uint32)).to(device)


def main(argv=None, emit=_emit) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sda_tpu_torch.benchmarks.kernel_probe",
        description="Time K1's components (K5 variants) on the card.")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: exactness gates only")
    ap.add_argument("--participants", type=int, default=100)
    ap.add_argument("--dim", type=int, default=999_999)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    sp, m_host, k, t = flagship()
    P, d = args.participants, args.dim
    x = probe_inputs(P, d, sp, dev)                              # [P, d]
    x_cols = batch_columns(x.view(torch.int32), k)               # [P, k, B]
    B = x_cols.shape[-1]
    emit("probe_env", device=str(dev),
         kind=torch.cuda.get_device_name(dev) if on_card else "cpu",
         participants=P, dim=d, batch_cols=B, secrets=k, threshold=t,
         shares=int(np.shape(m_host)[0]), prime=sp.p)
    elements = P * d

    def call(name, seed=1):
        return probe_call(x_cols, seed, sp, m_host, t, **VARIANTS[name])

    # -- exactness gates before any timing ----------------------------------
    ref_fold = xla_fold(x, sp)
    mxu_exact = torch.equal(mxu_fold(x, sp), ref_fold)
    emit("mxu_exact", ok=mxu_exact)
    if not mxu_exact:
        return 1
    exp = torch.remainder(_words64(x_cols).sum(0), sp.p)
    for stage, name in (("fold_exact", "fold_only"),
                        ("fold_tree_exact", "fold_tree")):
        got = call(name)
        exact = torch.equal(got[:k], exp) and not got[k:].any()
        emit(stage, ok=exact)
        if not exact:
            return 1
    lib_shares, _ = fused_mask_share_combine(x_cols, 3, sp, m_host, t, True)
    full_exact = torch.equal(call("full", seed=3), lib_shares)
    emit("full_matches_library", ok=full_exact)
    if not full_exact:
        return 1

    ok = True
    if on_card:
        secs = {}
        for name, flags in VARIANTS.items():
            ms = median_ms(functools.partial(call, name, 100), dev)
            secs[name] = ms / 1e3
            emit("component", name=name, ms=ms,
                 el_per_s=elements / secs[name], **flags)
        same = torch.equal(call("full", 7), call("full_tree", 7))
        emit("tree_ab", full_ms=secs["full"] * 1e3,
             full_tree_ms=secs["full_tree"] * 1e3,
             fold_ms=secs["fold_only"] * 1e3,
             fold_tree_ms=secs["fold_tree"] * 1e3, bit_identical=same)
        ok = ok and same
        b = solve_budget(secs)
        emit("budget", fold_ms=b["fold_s"] * 1e3, prng_ms=b["prng_s"] * 1e3,
             matmul_ms=b["matmul_s"] * 1e3,
             overhead_ms=b["overhead_s"] * 1e3, full_ms=secs["full"] * 1e3,
             full_el_per_s=elements / secs["full"])
        # the fold A/B on the same [P, d] inputs
        for name, fn in (("xla_fold", xla_fold), ("mxu_fold", mxu_fold)):
            ms = median_ms(functools.partial(fn, x, sp), dev)
            emit("fold_ab", name=name, ms=ms, el_per_s=elements / (ms / 1e3))
        emit("fold_ab", name="fold_only", ms=secs["fold_only"] * 1e3,
             el_per_s=elements / secs["fold_only"])

    emit("probe_done", ok=ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
