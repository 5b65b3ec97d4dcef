"""K1 against another commit's K1, on the same inputs, on the card.

    python -m sda_tpu_torch.benchmarks.k1_ab --parent DIR

DIR holds another commit's ``fields/csrc/fused_round.cu`` and the headers
it includes, as ``git show`` gives them, in a directory outside the
checkout::

    d=${TMPDIR:-/tmp}/k1_parent; mkdir -p $d && for f in fused_round.cu philox.cuh; do
      git show <commit>:sda_tpu_torch/fields/csrc/$f > $d/$f; done

The parent is built by ``nvcc`` with the port's flags into a temporary
directory; its C entry must take the 64-bit seed and p, as K1's first CUDA
version did. This checkout's K1 is built as the port builds it. Both run
the calls users make at the flagship width, P=100 x d=999,999 uint32
inputs below 2^20 from ``np.random.default_rng(0)``, internal draws from
one seed:

- ``flagship``: packed Shamir k=3, t=4, n=8 over p = 2^29 - 679 on the
  strided ``batch_columns`` view, masked (the round with full masking)
  and unmasked (without masking), and masked on external bits;
- ``basic``: BasicShamir k=1, t=3, n=8 over the same p, masked and not.

Each call of each build must give the plain version's shares and mask
totals exactly. The calls are timed in turns (parent, this checkout,
this checkout, parent) by ``utils.benchtime.median_ms``, median of 20
each. Prints one JSON line a case (the instance this checkout ran, both
builds' times, the card's name and power limit) and exits non-zero on a
failed build or a mismatch.
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

from ..device import resolve_device
from ..fields import _build, fused_round, numtheory
from ..fields.fastfield import SolinasPrime
from ..fields.sharing import batch_columns
from ..protocol import BasicShamirSharing, PackedShamirSharing
from ..utils.benchtime import median_ms

P_AB, D_AB = 100, 999_999
SEED = 7


def build_parent(src_dir: Path, out_dir: Path) -> ctypes.CDLL:
    """nvcc ``src_dir/fused_round.cu`` with the port's flags into
    ``out_dir``; the library, its C entry declared."""
    out = out_dir / "libfused_round_parent.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                          str(src_dir / "fused_round.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the parent:\n{res.stdout}"
                           f"{res.stderr}")
    lib = ctypes.CDLL(str(out))
    ptr, i64, i32, u64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_ulonglong)
    lib.sda_fused_mask_share_combine.argtypes = [
        ptr, i64, i64, i64, ptr, ptr, ptr, i32, i32, i32, i32, i64, i32, u64,
        u64, ptr, ptr]
    lib.sda_fused_mask_share_combine.restype = ctypes.c_int
    return lib


def cases(dev):
    """name -> (K1's arguments as the wrapper takes them, bits or None)."""
    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    flagship = PackedShamirSharing(3, 8, t, p, w2, w3)
    basic = BasicShamirSharing(share_count=8, privacy_threshold=3,
                               prime_modulus=p)
    sp = SolinasPrime.try_from(p)
    inputs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1 << 20, size=(P_AB, D_AB), dtype=np.uint32)).to(dev)
    words = inputs.view(torch.int32)
    out = {}
    for name, scheme in (("flagship", flagship), ("basic", basic)):
        k, ts = scheme.secret_count, scheme.privacy_threshold
        x = batch_columns(words, k)
        m_host = numtheory.share_matrix_for(scheme)
        for masked in (True, False):
            out[f"{name} {'masked' if masked else 'unmasked'}"] = (
                (x, SEED, sp, m_host, ts, masked), None)
    x = batch_columns(words, 3)
    draws = 3 + t
    bits = torch.from_numpy(np.random.default_rng(1).integers(
        0, 1 << 32, size=(P_AB, 2 * draws, x.shape[-1]),
        dtype=np.uint32)).to(dev)
    out["flagship masked, external bits"] = (
        (x, SEED, sp, numtheory.share_matrix_for(flagship), t, True), bits)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sda_tpu_torch.benchmarks.k1_ab",
        description="Time K1 against another commit's K1 on the same "
                    "inputs.")
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory with another commit's fused_round.cu "
                         "and its headers")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    with tempfile.TemporaryDirectory() as tmp:
        parent = build_parent(args.parent, Path(tmp))
        ours = fused_round.bind_library(_build.load("fused_round"))
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name, (kargs, bits) in cases(dev).items():
            x, seed, sp, m_host, t, masked = kargs
            P, k, B = x.shape
            n = m_host.shape[0]
            m_active = fused_round.kernel_operands(x, sp, m_host, t)
            keys, p, e, c = fused_round.kernel_scalars(sp, seed)
            want = fused_round.fused_mask_share_combine_plain(
                *kargs, external_bits=bits)
            shares = torch.empty((n, B), dtype=torch.int64, device=dev)
            mask_tot = torch.empty((k, B), dtype=torch.int64, device=dev)
            head = (x.data_ptr(), *x.stride(),
                    None if bits is None else bits.data_ptr(),
                    shares.data_ptr(), mask_tot.data_ptr(), P, k, t, n, B,
                    int(masked))
            instance = ctypes.c_int()
            calls = {
                "parent": (parent.sda_fused_mask_share_combine,
                           head + (seed, p, m_active.ctypes.data, stream)),
                "ours": (ours.sda_fused_mask_share_combine,
                         head + (keys.ctypes.data, p, e, c,
                                 m_active.ctypes.data,
                                 ctypes.byref(instance), stream)),
            }
            for who, (fn, fargs) in calls.items():
                shares.fill_(-1)
                mask_tot.fill_(-1)
                err = fn(*fargs)
                torch.cuda.synchronize()
                if err != 0 or not (torch.equal(shares, want[0]) and
                                    torch.equal(mask_tot, want[1])):
                    print(json.dumps({"stage": "k1_ab", "case": name,
                                      "build": who, "error": err,
                                      "exact": False}), flush=True)
                    return 1
            del want
            times = {who: [] for who in calls}
            for who in ("parent", "ours", "ours", "parent"):
                fn, fargs = calls[who]
                times[who].append(median_ms(lambda: fn(*fargs), dev, reps=20))
            print(json.dumps({
                "stage": "k1_ab", "case": name, "P": P, "k": k, "B": B,
                "exact": True,
                "instance": fused_round.INSTANCES[instance.value],
                "parent_ms": times["parent"], "ms": times["ours"],
                "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
