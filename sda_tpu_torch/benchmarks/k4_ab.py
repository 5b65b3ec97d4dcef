"""K4 against another commit's K4, on the same inputs, on the card.

    python -m sda_tpu_torch.benchmarks.k4_ab --parent DIR

DIR holds another commit's ``fields/csrc/montgomery.cu``, as ``git show``
gives it, in a directory outside the checkout::

    d=${TMPDIR:-/tmp}/k4_parent; mkdir -p $d && git show \\
      <commit>:sda_tpu_torch/fields/csrc/montgomery.cu > $d/montgomery.cu

The parent is built by ``nvcc`` with the port's flags into a temporary
directory. Its C entries must be K4's first version's (``sda_montmul`` for
L in {32, 64, 128} with the modulus in host memory, ``sda_montmul_wide``
for any other L with a workspace), and it is driven by that version's
launch sequence, copied here: the [P, B, L] rows transposed to limb-major
[P, L, B], one launch a level of a tree over the rows (the odd row of a
level passing through), one launch for the fix-up, and the result
transposed back. This checkout's K4 is built as the port builds it and
called as the port calls it.

Both fold the same clerk column, P=100 rows x B=7,408 lanes of random
limbs below m (from ``np.random.default_rng(0)``), for an odd modulus of
4096 bits (n^2 of a 2048-bit key: L=128) and of 6144 bits (a 3072-bit
key: L=192). Each build's product must equal ``premix_plain`` exactly.
Times, median of 20 by ``utils.benchtime.median_ms``, in turns (parent,
this checkout, this checkout, parent): each build's launches alone (the
parent's on rows already limb-major) and each build's whole call (the
parent's with its transposes, this checkout's ``premix_limbs``). Prints
one JSON line a case with both builds' times, this checkout's launches,
the least time the card could take for the fold
(``benchmarks/bounds.py::k4_bound``) and the card's name and power limit;
exits non-zero on a failed build or a mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..crypto import paillier_tpu as pt
from ..device import resolve_device
from ..fields import _build
from ..utils.benchtime import median_ms
from .bounds import k4_bound

P_AB, B_AB = 100, 7408
#: bits of the moduli: n^2 of 2048- and 3072-bit Paillier keys
MODULUS_BITS = (4096, 6144)
#: the first version's instances and its wide workspace's threads at most
PARENT_UNROLLED = (32, 64, 128)
PARENT_WIDE_THREADS = 1 << 16


def build_parent(src_dir: Path, out_dir: Path) -> ctypes.CDLL:
    """nvcc ``src_dir/montgomery.cu`` with the port's flags into
    ``out_dir``; the library, its C entries declared."""
    out = out_dir / "libmontgomery_parent.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                          str(src_dir / "montgomery.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the parent:\n{res.stdout}"
                           f"{res.stderr}")
    lib = ctypes.CDLL(str(out))
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    operands = [ptr, i64, ptr, i64, i64, i64, ptr, i64, i64, i64, ptr,
                ctypes.c_int, ctypes.c_uint32]
    lib.sda_montmul.argtypes = operands + [ptr]
    lib.sda_montmul_wide.argtypes = operands + [ptr, i64, ptr]
    lib.sda_montmul.restype = lib.sda_montmul_wide.restype = ctypes.c_int
    return lib


def _parent_launch(lib, ctx, wide, a, a_pair, b, b_pair, b_limb, b_lane,
                   out, out_pair, lanes, pairs, stream):
    args = (a.data_ptr(), a_pair, b.data_ptr(), b_pair, b_limb, b_lane,
            out.data_ptr(), out_pair, lanes, pairs)
    if wide is None:
        m = (ctypes.c_uint32 * ctx.L)(*ctx.m_words)
        err = lib.sda_montmul(*args, ctypes.cast(m, ctypes.c_void_p), ctx.L,
                              ctx.n_prime, stream)
    else:
        m, work = wide
        err = lib.sda_montmul_wide(*args, m.data_ptr(), ctx.L, ctx.n_prime,
                                   work.data_ptr(), work.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"parent K4 launch failed: CUDA error {err}")


def parent_fold(lib, stream, ctx, rows, fix):
    """The first version's fold on limb-major rows [P, L, B] and the [L]
    fix-up constant -> [L, B]: one launch a tree level, then the fix-up."""
    L, dev, B = ctx.L, rows.device, rows.shape[2]
    wide = None
    if ctx.L not in PARENT_UNROLLED:
        n = max(1, rows.shape[0] // 2) * B
        wide = (pt._modulus(ctx, dev),
                torch.empty((L + 2, max(1, min(n, PARENT_WIDE_THREADS))),
                            dtype=torch.int32, device=dev))
    while rows.shape[0] > 1:
        n = rows.shape[0]
        pairs = n // 2
        nxt = torch.empty((pairs + n % 2, L, B), dtype=torch.int32,
                          device=dev)
        _parent_launch(lib, ctx, wide, rows, 2 * L * B, rows[1], 2 * L * B,
                       B, 1, nxt, L * B, B, pairs, stream)
        if n % 2:
            nxt[pairs].copy_(rows[n - 1])
        rows = nxt
    out = torch.empty((L, B), dtype=torch.int32, device=dev)
    _parent_launch(lib, ctx, wide, rows[0], 0, fix.contiguous(), 0, 1, 0,
                   out, 0, B, 1, stream)
    return out


def parent_premix(lib, stream, ctx, x, fix):
    """The first version's whole call: [P, B, L] -> limb-major, the fold,
    and the result back to [B, L]."""
    rows = x.transpose(1, 2).contiguous()
    return parent_fold(lib, stream, ctx, rows, fix).t().contiguous()


def column(ctx, dev, seed=0):
    """[P_AB, B_AB, L] int32 limbs of random values below m (the top limb
    below m's) on ``dev``."""
    words = np.random.default_rng(seed).integers(
        0, 1 << 32, size=(P_AB, B_AB, ctx.L), dtype=np.uint32)
    words[..., -1] %= np.uint32(ctx.m_words[-1])
    return torch.from_numpy(words.view(np.int32)).to(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sda_tpu_torch.benchmarks.k4_ab",
        description="Time K4 against another commit's K4 on the same "
                    "inputs.")
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory with another commit's montgomery.cu")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    rng = np.random.default_rng(1)
    with tempfile.TemporaryDirectory() as tmp:
        parent = build_parent(args.parent, Path(tmp))
        ours = pt._library()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        stream = torch.cuda.current_stream(dev).cuda_stream
        for bits in MODULUS_BITS:
            m = int.from_bytes(rng.bytes(bits // 8), "little") | (
                1 << (bits - 1)) | 1
            ctx = pt.MontgomeryContext(m)
            x = column(ctx, dev)
            fix = torch.from_numpy(ctx.fold_fix(P_AB)).to(dev)
            rows_lm = x.transpose(1, 2).contiguous()
            want = pt.premix_plain(ctx, x, fix)
            k4 = pt.montgomery_kernel
            before = k4.launches
            got = {"parent": parent_premix(parent, stream, ctx, x, fix),
                   "ours": ctx.premix_limbs(x)}
            launches = k4.launches - before
            torch.cuda.synchronize()
            for who, out in got.items():
                if not torch.equal(out, want):
                    print(json.dumps({"stage": "k4_ab", "L": ctx.L,
                                      "build": who, "exact": False}),
                          flush=True)
                    return 1
            del want, got
            calls = {
                "parent": lambda: parent_fold(parent, stream, ctx, rows_lm,
                                              fix),
                "ours": lambda: pt._fold_launches(ours, stream, ctx, x, fix),
                "parent_wrapper": lambda: parent_premix(parent, stream, ctx,
                                                        x, fix),
                "ours_wrapper": lambda: ctx.premix_limbs(x),
            }
            times = {who: [] for who in calls}
            for pair in (("parent", "ours"),
                         ("parent_wrapper", "ours_wrapper")):
                for who in (pair[0], pair[1], pair[1], pair[0]):
                    times[who].append(median_ms(calls[who], dev, reps=20))
            bound_ms, bound_by, detail = k4_bound(P_AB * B_AB, ctx.L, P_AB,
                                                  B_AB)
            print(json.dumps({
                "stage": "k4_ab", "P": P_AB, "B": B_AB, "L": ctx.L,
                "modulus_bits": bits, "exact": True,
                "instance": pt.fold_shape(ours, ctx.L)[:2],
                "launches": launches,
                "parent_ms": times["parent"], "ms": times["ours"],
                "parent_wrapper_ms": times["parent_wrapper"],
                "wrapper_ms": times["ours_wrapper"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_detail": detail, "card": smi}), flush=True)
            del x, rows_lm
    return 0


if __name__ == "__main__":
    sys.exit(main())
