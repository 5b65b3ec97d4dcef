"""K3 against another commit's K3, on the same inputs, on the card.

    python -m sda_tpu_torch.benchmarks.k3_ab --parent DIR

DIR holds another commit's ``fields/csrc/chacha.cu``, as ``git show``
gives it, in a directory outside the checkout (or one ``.gitignore``
lists)::

    d=${TMPDIR:-/tmp}/k3_parent; mkdir -p $d
    git show <commit>:sda_tpu_torch/fields/csrc/chacha.cu > $d/chacha.cu

Both builds are made by ``nvcc`` with the port's flags into a temporary
directory, one after the other (one JSON line: nvcc's seconds and
ptxas's registers and spills by kernel of each), and called through
their own C interface: ``sda_chacha_expand`` is the same in both; a build
with ``sda_chacha_chunks`` chunks its combine's seeds into a scratch the
caller allocates, one without it takes none; only such a build has the
mask op (``sda_chacha_mask``). The cases, V1 streams over the flagship's
p = 2^29 - 679 from ``np.random.default_rng`` seeds:

- ``expand`` at [250, 3,145,728] from block 12,345 without flags (the
  streamed round's tile, as ``stream_residues_at`` asks) and at
  [1, 999,999] from block 0 with flags (a participant's ``expand_mask``);
- ``combine`` at S=100 and S=10,000 x 1,000,008 with flags (the
  recipient's ``combine_masks``);
- ``mask`` at [250, 3,145,728] from block 12,345, int32 out (the K1
  lane's mask stage): this build's mask op against the parent's path,
  its ``expand`` then ``fastfield.modadd32``, ``modsum32`` and the cast to
  int32 that ``simpod._pallas_stage`` made.

Every call of each build must give the plain version's outputs exactly
(``chacha_device.*_plain``). The calls are timed in turns (parent, this
checkout, this checkout, parent) by ``utils.benchtime.median_ms``. Prints
one JSON line a case (both builds' times, the least time the card could
take for the case's work as ``benchmarks/bounds.py`` counts it, the
card's name and power limit) and exits non-zero on a failed build or a
mismatch.
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
from ..fields import _build, chacha, chacha_device as cd, fastfield
from ..utils import sass
from ..utils.benchtime import median_ms
from .bounds import k3_bound

P = (1 << 29) - 679
V1 = chacha.CHACHA_PRG_V1
#: the streamed round's tile ([participants chunk, dim tile]) and a block
#: counter inside the stream
S_TILE, D_TILE, COUNTER = 250, 3_145_728, 12_345
D_FLAG, S_COMBINE, S_BIG = 1_000_008, 100, 10_000
D_PARTICIPANT = 999_999


class Build:
    """One build of ``chacha.cu``, called through its own C interface on
    the current stream."""

    def __init__(self, lib: ctypes.CDLL):
        ptr, i64, i32, u32, u64 = (ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_uint32,
                                   ctypes.c_ulonglong)
        self.lib = lib
        self.chunked = hasattr(lib, "sda_chacha_chunks")
        lib.sda_chacha_expand.argtypes = [ptr, i32, u32, i64, u64, u64, u64,
                                          i32, ptr, ptr, ptr]
        lib.sda_chacha_combine.argtypes = (
            [ptr, i32, i64, u64, u64, u64, i32, ptr, ptr]
            + ([i32, ptr] if self.chunked else []) + [ptr])
        fns = [lib.sda_chacha_expand, lib.sda_chacha_combine]
        if self.chunked:
            lib.sda_chacha_chunks.argtypes = [i32, i32, i64, u64, ptr]
            lib.sda_chacha_mask.argtypes = [ptr, i32, u32, i64, u64, u64, ptr,
                                            i64, i32, ptr, ptr, i32, ptr, ptr]
            fns += [lib.sda_chacha_chunks, lib.sda_chacha_mask]
        for fn in fns:
            fn.restype = ctypes.c_int

    @staticmethod
    def _stream():
        return torch.cuda.current_stream().cuda_stream

    @staticmethod
    def _ok(err, what):
        if err != 0:
            raise RuntimeError(f"K3 {what}: CUDA error {err}")

    def _scratch(self, op, S, d):
        chunks = cd._chunks(self.lib, op, S, d, P)
        return chunks, cd._scratch(chunks, d, torch.device("cuda"))

    def expand(self, keys, counter0, out, flags):
        S, d = out.shape
        self._ok(self.lib.sda_chacha_expand(
            keys.data_ptr(), S, counter0, d, P, cd._U64_MAX // P,
            cd._zone(V1, P), 0, out.data_ptr(), cd._ptr(flags),
            self._stream()), "expand")

    def combine(self, keys, total, flags, plan):
        args = [keys.data_ptr(), keys.shape[0], total.shape[0], P,
                cd._U64_MAX // P, cd._zone(V1, P), 0, total.data_ptr(),
                flags.data_ptr()]
        if self.chunked:
            chunks, partials = plan
            args += [chunks, cd._ptr(partials)]
        self._ok(self.lib.sda_chacha_combine(*args, self._stream()),
                 "combine")

    def mask(self, keys, counter0, x, out, sums, plan):
        S, d = x.shape
        chunks, partials = plan
        self._ok(self.lib.sda_chacha_mask(
            keys.data_ptr(), S, counter0, d, P, cd._U64_MAX // P,
            x.data_ptr(), x.stride(0), 1, out.data_ptr(), sums.data_ptr(),
            chunks, cd._ptr(partials), self._stream()), "mask")


def build(src_dir: Path, out: Path, flags=()):
    """nvcc ``src_dir/chacha.cu`` with the port's flags (and ``flags``)
    into ``out``: (its Build, nvcc's seconds, ptxas's lines by kernel)."""
    t0 = time.perf_counter()
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                          str(out), str(src_dir / "chacha.cu")],
                         capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src_dir}:\n{res.stdout}"
                           f"{res.stderr}")
    return (Build(ctypes.CDLL(str(out))), seconds,
            sass.ptxas_info(res.stdout + res.stderr))


def _keys(S, seed, dev):
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(S, 8))
    return torch.from_numpy(words).to(dev)


def _cases(builds, dev):
    """Yields each case as (name, (the call of each build (a closure over
    its outputs), the outputs each call fills, the plain outputs, the
    bound)), made when asked for: one case's tensors live at a time."""

    def expand_case(S, d, counter0, flags, seed):
        words = _keys(S, seed, dev)
        keys = cd._u32_storage(words)
        masks, rej = cd.expand_plain(words, counter0, d, P, V1)
        calls, outs = {}, {}
        for who, b in builds.items():
            out = torch.empty((S, d), dtype=torch.int64, device=dev)
            fl = torch.zeros(S, dtype=torch.int32, device=dev) if flags \
                else None
            calls[who] = (lambda b=b, out=out, fl=fl:
                          b.expand(keys, counter0, out, fl))
            outs[who] = (out,) if fl is None else (out, fl)
        want = (masks,) if not flags else (masks, rej.to(torch.int32))
        return calls, outs, want, k3_bound(S, d, "expand")

    def combine_case(S, d, seed):
        words = _keys(S, seed, dev)
        keys = cd._u32_storage(words)
        total, rej = cd.combine_plain(words, d, P, V1)
        calls, outs = {}, {}
        for who, b in builds.items():
            out = torch.empty(d, dtype=torch.int64, device=dev)
            fl = torch.zeros(S, dtype=torch.int32, device=dev)
            plan = b._scratch("combine", S, d) if b.chunked else None
            calls[who] = (lambda b=b, out=out, fl=fl, plan=plan:
                          b.combine(keys, out, fl, plan))
            outs[who] = (out, fl)
        return (calls, outs, (total, rej.to(torch.int32)),
                k3_bound(S, d, "combine"))

    def mask_case(S, d, counter0, seed):
        words = _keys(S, seed, dev)
        keys = cd._u32_storage(words)
        x = torch.randint(0, P, (S, d), dtype=torch.int64, device=dev,
                          generator=torch.Generator(dev).manual_seed(seed))
        want = cd.mask_plain(words, counter0, x, P, torch.int32)
        sp = fastfield.SolinasPrime.try_from(P)
        calls, outs = {}, {}
        for who, b in builds.items():
            if b.chunked:
                out = torch.empty((S, d), dtype=torch.int32, device=dev)
                sums = torch.empty(d, dtype=torch.int64, device=dev)
                plan = b._scratch("mask32", S, d)
                calls[who] = (lambda b=b, out=out, sums=sums, plan=plan:
                              b.mask(keys, counter0, x, out, sums, plan))
                outs[who] = (out, sums)
            else:  # the parent's path: expand, then three torch passes
                masks = torch.empty((S, d), dtype=torch.int64, device=dev)
                res = {}

                def chain(b=b, masks=masks, res=res):
                    b.expand(keys, counter0, masks, None)
                    res["out"] = fastfield.modadd32(x, masks, sp).to(
                        torch.int32)
                    res["sums"] = fastfield.modsum32(masks, sp, axis=0)

                calls[who] = chain
                outs[who] = res
        return calls, outs, want, k3_bound(S, d, "mask", 4)

    yield "mask", mask_case(S_TILE, D_TILE, COUNTER, 1)
    yield "expand tile", expand_case(S_TILE, D_TILE, COUNTER, False, 2)
    yield "expand participant", expand_case(1, D_PARTICIPANT, 0, True, 3)
    yield "combine", combine_case(S_COMBINE, D_FLAG, 4)
    yield "combine big", combine_case(S_BIG, D_FLAG, 5)


def run(builds: dict, dev, smi: str, reps: int = 20) -> int:
    """Hold each build to plain and time them in turns on every case
    (``builds``: name -> Build, timed in order, then in reverse, ...).
    Prints one JSON line a case; returns 1 on a mismatch."""
    order = list(builds) + list(builds)[::-1]
    for name, (calls, outs, want, bound) in _cases(builds, dev):
        for who, call in calls.items():
            call()
            torch.cuda.synchronize()
            got = outs[who]
            got = (got["out"], got["sums"]) if isinstance(got, dict) else got
            exact = all(torch.equal(g, w) for g, w in zip(got, want))
            if not exact:
                print(json.dumps({"stage": "k3_ab", "case": name,
                                  "build": who, "exact": False}), flush=True)
                return 1
        times = {who: [] for who in builds}
        n = 5 if "big" in name else reps
        for who in order:
            times[who].append(median_ms(calls[who], dev, reps=n))
        print(json.dumps({
            "stage": "k3_ab", "case": name, "exact": True,
            **{f"{who}_ms": t for who, t in times.items()},
            "bound_ms": bound[0], "bound_by": bound[1],
            "bound_detail": bound[2], "card": smi}), flush=True)
        del calls, outs, want
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sda_tpu_torch.benchmarks.k3_ab",
        description="Time K3 against another commit's K3 on the same "
                    "inputs.")
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory with another commit's chacha.cu")
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
        print(json.dumps({"stage": "k3_ab_build", "parent_nvcc_s": parent_s,
                          "nvcc_s": ours_s, "parent_ptxas": parent_ptxas,
                          "ptxas": ours_ptxas, "card": smi}), flush=True)
        return run({"parent": parent, "ours": ours}, dev, smi)


if __name__ == "__main__":
    sys.exit(main())
