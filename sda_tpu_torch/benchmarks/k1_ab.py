"""K1 against another commit's K1, on the same inputs, on the card.

    python -m sda_tpu_torch.benchmarks.k1_ab --parent DIR

DIR holds another commit's ``fields/csrc/fused_round.cu`` and the headers
it includes, as ``git show`` gives them, in a directory outside the
checkout::

    d=${TMPDIR:-/tmp}/k1_parent; mkdir -p $d
    for f in fused_round.cu columns.cuh philox.cuh; do
      git show <commit>:sda_tpu_torch/fields/csrc/$f > $d/$f; done

Both builds are made by ``nvcc`` with the port's flags into a temporary
directory, one after the other, and timed (one JSON line: nvcc's seconds
and ptxas's registers and spills by kernel of each), then bound by
``fused_round.bind_library``: the parent's C entry must be this
checkout's (round keys, p = 2^e - c, the matrix, the instance and the
stream), as it has been since the column skeleton. Both run the calls
users make at the flagship width, P=100 x d=999,999 uint32 inputs below
2^20 from
``np.random.default_rng(0)``, internal draws from one seed:

- ``flagship``: packed Shamir k=3, t=4, n=8 over p = 2^29 - 679 on the
  strided ``batch_columns`` view, masked (the round with full masking)
  and unmasked (without masking), and masked on external bits;
- ``basic``: BasicShamir k=1, t=3, n=8 over the same p, masked and not;
- ``basic sim``: the same scheme over ``sda-sim --sharing basic``'s
  p = 2^29 - 3, masked and not;
- ``packed26``: ``sda-sim --secrets-per-batch 7 --clerks 26``'s packed
  Shamir k=7, t=8, n=26 over p = 2^29 - 2479, masked and not.

Each call of each build must give the plain version's shares and mask
totals exactly. The calls are timed in turns (parent, this checkout,
this checkout, parent) by ``utils.benchtime.median_ms``, median of 20
each. Prints one JSON line a case (the instance this checkout ran, both
builds' times, the least time the card could take for the call's work as
``benchmarks/bounds.py`` counts it, the card's name and power limit) and
exits non-zero on a failed build or a mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..fields import _build, fused_round, numtheory
from ..fields.fastfield import SolinasPrime
from ..fields.sharing import batch_columns
from ..protocol import BasicShamirSharing, PackedShamirSharing
from ..utils import sass
from ..utils.benchtime import median_ms
from .bounds import k1_bound, philox_ops

P_AB, D_AB = 100, 999_999
SEED = 7


def build(src_dir: Path, out: Path):
    """nvcc ``src_dir/fused_round.cu`` with the port's flags into ``out``:
    (the library with its C interface declared, nvcc's seconds, ptxas's
    lines by kernel)."""
    t0 = time.perf_counter()
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                          str(src_dir / "fused_round.cu")],
                         capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src_dir}:\n{res.stdout}"
                           f"{res.stderr}")
    return (fused_round.bind_library(ctypes.CDLL(str(out))), seconds,
            sass.ptxas_info(res.stdout + res.stderr))


def schemes():
    """name -> the scheme of a case."""
    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    t26, p26, w2_26, w3_26 = numtheory.generate_packed_params(7, 26, 28)
    return {
        "flagship": PackedShamirSharing(3, 8, t, p, w2, w3),
        "basic": BasicShamirSharing(share_count=8, privacy_threshold=3,
                                    prime_modulus=p),
        "basic sim": BasicShamirSharing(
            share_count=8, privacy_threshold=3,
            prime_modulus=numtheory.find_prime_with_orders(1, 1, 28)),
        "packed26": PackedShamirSharing(7, 26, t26, p26, w2_26, w3_26),
    }


def cases(dev):
    """name -> (K1's arguments as the wrapper takes them, bits or None)."""
    inputs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1 << 20, size=(P_AB, D_AB), dtype=np.uint32)).to(dev)
    words = inputs.view(torch.int32)
    out = {}
    for name, scheme in schemes().items():
        k, ts = scheme.secret_count, scheme.privacy_threshold
        x = batch_columns(words, k)
        sp = SolinasPrime.try_from(scheme.prime_modulus)
        m_host = numtheory.share_matrix_for(scheme)
        for masked in (True, False):
            out[f"{name} {'masked' if masked else 'unmasked'}"] = (
                (x, SEED, sp, m_host, ts, masked), None)
        if name == "flagship":
            bits = torch.from_numpy(np.random.default_rng(1).integers(
                0, 1 << 32, size=(P_AB, 2 * (k + ts), x.shape[-1]),
                dtype=np.uint32)).to(dev)
            out["flagship masked, external bits"] = (
                (x, SEED, sp, m_host, ts, True), bits)
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
        # one after the other, so that neither build slows the other
        parent, parent_s, parent_ptxas = build(args.parent,
                                               Path(tmp) / "parent.so")
        ours, ours_s, ours_ptxas = build(_build.CSRC, Path(tmp) / "ours.so")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(json.dumps({"stage": "k1_ab_build", "parent_nvcc_s": parent_s,
                          "nvcc_s": ours_s, "parent_ptxas": parent_ptxas,
                          "ptxas": ours_ptxas, "card": smi}), flush=True)
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
            fargs = (x.data_ptr(), *x.stride(),
                     None if bits is None else bits.data_ptr(),
                     shares.data_ptr(), mask_tot.data_ptr(), P, k, t, n, B,
                     int(masked), keys.ctypes.data, p, e, c,
                     m_active.ctypes.data)
            instance = {who: ctypes.c_int() for who in ("parent", "ours")}
            calls = {
                who: (lambda fn=lib.sda_fused_mask_share_combine, who=who:
                      fn(*fargs, ctypes.byref(instance[who]), stream))
                for who, lib in (("parent", parent), ("ours", ours))}
            for who, fn in calls.items():
                shares.fill_(-1)
                mask_tot.fill_(-1)
                err = fn()
                torch.cuda.synchronize()
                if err != 0 or not (torch.equal(shares, want[0]) and
                                    torch.equal(mask_tot, want[1])):
                    print(json.dumps({"stage": "k1_ab", "case": name,
                                      "build": who, "error": err,
                                      "exact": False}), flush=True)
                    return 1
            del want
            draws = (k if masked else 0) + t
            bound_ms, bound_by, detail = k1_bound(
                P, B, k, draws, True, n + (k if masked else 0),
                *philox_ops(k, t, masked), external_bits=bits is not None)
            times = {who: [] for who in calls}
            for who in ("parent", "ours", "ours", "parent"):
                times[who].append(median_ms(calls[who], dev, reps=20))
            print(json.dumps({
                "stage": "k1_ab", "case": name, "P": P, "k": k, "t": t,
                "n": n, "B": B, "exact": True,
                "instance": fused_round.INSTANCES[instance["ours"].value],
                "parent_ms": times["parent"], "ms": times["ours"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_detail": detail, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
