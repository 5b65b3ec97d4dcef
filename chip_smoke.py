#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sda_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout (one ``nvcc``
each, side by side), holds each against its plain PyTorch version on the
card, drives the flagship secure-aggregation round (packed Shamir k=3,
n=8, t=4 over p = 2^29 - 679, full masking, 100 participants x 999,999
uint32 inputs below 2^20) through the port's entry points, checks every
output exactly, and times the fused kernel K1 and both rounds. Then it
runs the kernel probe's entry point (``sda_tpu_torch.benchmarks.
kernel_probe``) at the same width: K5's variants of K1, timed, with the
component budget of K1. K1 has three instances, the main path's (the
``batch_columns`` layout, internal draws, k=3, t=4), masked and unmasked,
and the generic one (every other call); each is held to the plain version
and its registers, spills and resident warps an SM are printed. Each kernel's
operation bound is counted from the algorithm's work
(``sda_tpu_torch/benchmarks/bounds.py``), beside the count K1's first
CUDA version used; the participant loop's SASS opcode mix (``cuobjdump
-sass``) is printed as a diagnostic. Then the protocol path: the role
crypto (``CryptoModule`` on the card) at the flagship width, P=100,
without transport; and, where libsodium is present, one round through
``SdaClient``s on the card over the in-process memory server (P=20 at
the same width) and the README walkthrough's round over the HTTP server,
each revealed exactly, with the port's field ops counted by the device
they ran on. Then ChaCha seed masks on K3 (``csrc/chacha.cu``): K3 held
to its plain version and to the host spec (``fields.chacha``) for both
PRGs, four moduli (one that forces the host replay), several widths and
stream windows, and timed beside its bound; the role crypto with ChaCha
masks (P=100 x 1,000,008); ``single_chip_round`` with ChaCha masks; the
streamed round (``StreamingAggregator(use_pallas=True)``, P=10,000 x
10,000,008 from the device block provider) on K1 and K3, and the
device-tile clerk fold, each exact, with K3's windows at the shapes and
block counters the two ChaCha rounds launched it with held to the plain
version (their masks cancel, so the rounds' sums cannot show them). Then
the Paillier premix on K4 (``csrc/montgomery.cu``): each instance's
ptxas line and resident warps (a spill fails), K4 held to its plain
version and to Python ints at 512-, 2048- and 3072-bit keys, several row
counts and a split small clerk, the flagship clerk column (P=100 x 7,408
ciphertexts of a 2048-bit key) through ``paillier_combine`` with
``SDA_PREMIX_DEVICE=1`` in at most two K4 launches, byte-identical to the
host fold, a homomorphic check on real encryptions, and K4's time beside
its bound, the wrapper's, the plain version's and the host fold's, and
on the same column shape at a 3072-bit key.
Prints the card's name and power
limit, one JSON line of kernel measurements, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises and exits non-zero; without CUDA, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

#: K1's instances in the SASS: the main path's, masked and unmasked, and
#: the generic one with internal draws and at most 8 value rows
K1_KERNELS = {"columns": "fused_round_columnsILi3ELi4ELb1EE",
              "columns_unmasked": "fused_round_columnsILi3ELi4ELb0EE",
              "generic": "fused_round_kernelILi8ELb0EE"}
#: participants a loop iteration of the main path's instances and of K5
#: (fields/csrc/columns.cuh)
UNROLL = 2

DEVICE = "cuda"
P_MAIN, D_MAIN = 100, 999_999
DIM_TILE = 262_144
#: participants of the protocol round over the in-process server (phase
#: 10): cut from P_MAIN for time only, since the host's sealing and ChaCha
#: draws cost about a second a participant at D_MAIN
P_PROTOCOL = 20
#: the port's field ops that the role crypto calls (sda_tpu_torch.fields,
#: looked up there at each call), counted by the device of their inputs
ROLE_OPS = ("combine", "packed_share_from_randomness", "packed_reconstruct",
            "modadd", "modsub", "additive_share_from_randomness")
#: K3's checks (phase 12): moduli (the flagship p is added at run time;
#: 3 * 2^60 + 1 rejects 1 draw in 16, so the host replays every seed) and
#: dimensions of the expansion, seeds of the combine and its timing
K3_MODULI = (433, (1 << 61) - 1, 3 * (1 << 60) + 1)
K3_DIMS = (1, 7, 9, 1000, 1_000_008)
S_COMBINE, S_BIG = 100, 10_000
#: the ChaCha phases' width (13-14): a whole number of ChaCha blocks
D_CHACHA = 1_000_008
#: the streamed round (phase 15): participants, dimension, participant
#: chunk, from the device block provider (values below 2^20)
P_STREAM, D_STREAM, STREAM_CHUNK = 10_000, 10_000_008, 250
#: rows and bundles of the device-tile clerk fold (phase 15)
FOLD_ROWS, FOLD_BUNDLES = 100, 4
#: K4's checks (phase 16): Paillier key sizes (n^2 of 32, 128 and 192
#: limbs, each filling a group instance), premix row counts (at 256 lanes
#: the larger ones split a lane's rows) and lanes; the split path of a small
#: clerk (33 rows of 4 lanes)
K4_KEY_BITS = (512, 2048, 3072)
K4_ROWS = (1, 2, 3, 16, 33)
K4_LANES = 256
K4_SPLIT_CASE = (33, 4)
#: the wide instance's check: an odd modulus of 513 limbs (above the
#: group instances' 512), folds of these row counts at K4_LANES lanes and
#: the split path
K4_WIDE_LIMBS, K4_WIDE_ROWS = 513, (3, 33)
#: the key of K4's second timed column (n^2 of 192 limbs)
WIDE_KEY_BITS = 3072
#: the flagship clerk column (phase 16): P=100 participants, each sending a
#: clerk B = ceil(333,333 / 45) ciphertexts of a 2048-bit key (packed
#: Shamir k=3 of d=999,999 gives a clerk 333,333 shares; the CLI packs 45
#: windows of 29 + 16 bits a plaintext)
P_PREMIX, B_PREMIX, PREMIX_KEY_BITS = 100, 7408, 2048
SHARES_PREMIX, PREMIX_WINDOW, PREMIX_VALUE_BITS = 333_333, 45, 29
#: the README walkthrough's round: three participants' 10-dim inputs
WALKTHROUGH = ([0, 0, 0, 1, 1, 1, 2, 2, 2, 3], [0, 1, 1, 1, 1, 2, 2, 3, 3, 3],
               [0, 1, 1, 2, 2, 3, 2, 3, 3, 4])


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def _median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median wall time of ``fn()`` in ms, each run ended by a synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _profile(label: str, fn, reps: int = 3) -> None:
    """Print the device time by operation over ``reps`` calls of ``fn()``
    (torch.profiler; the profiler's own cost inflates the wall time), and
    the device's busy share of the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # device-side entries only (kernels, copies): an operator's row
        # repeats the time of the kernels it launched
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"  profile of {label}: wall {wall_us / reps / 1e3:.3f} ms/round "
          f"under the profiler, device busy {busy / reps / 1e3:.3f} "
          f"ms/round, busy share {busy / wall_us:.3f}")
    for dev_us, count, key in rows[:8]:
        print(f"    {dev_us / reps / 1e3:9.4f} ms/round {count / reps:6.1f}"
              f" calls/round  {key[:100]}")


class DeviceCounts:
    """While entered, wraps the port's field ops ``ROLE_OPS`` to count
    their calls by the device type of their tensor arguments."""

    def __init__(self):
        from sda_tpu_torch import fields

        self.fields = fields
        self.calls = {name: collections.Counter() for name in ROLE_OPS}

    def _wrap(self, name, fn):
        import torch

        def counted(*args, **kwargs):
            self.calls[name].update(
                {a.device.type for a in list(args) + list(kwargs.values())
                 if isinstance(a, torch.Tensor)})
            return fn(*args, **kwargs)
        return counted

    def __enter__(self):
        self._saved = {n: getattr(self.fields, n) for n in ROLE_OPS}
        for name, fn in self._saved.items():
            setattr(self.fields, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.fields, name, fn)

    def check(self, label, device_type, required):
        """Each op of ``required`` ran on ``device_type`` and no op ran on
        another device."""
        for name in required:
            _check(self.calls[name][device_type] > 0,
                   f"{label}: {name} never ran on {device_type}")
        for name, by_dev in self.calls.items():
            other = {d: c for d, c in by_dev.items() if d != device_type}
            _check(not other, f"{label}: {name} ran on {other}")
        return {name: dict(c) for name, c in self.calls.items() if c}


def _flagship():
    from sda_tpu_torch.fields import numtheory
    from sda_tpu_torch.protocol import FullMasking, PackedShamirSharing

    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    return PackedShamirSharing(3, 8, t, p, w2, w3), FullMasking(p), p


def _phases(utils):
    return {name: stat["total_s"]
            for name, stat in utils.phase_report().items()}


def role_crypto(dev, P, D, seed=0, masking=None):
    """Phases 9 and 13: the role crypto at the flagship width, no
    transport, with Full masking or the given one. Each of P participants
    masks and shares, the n clerk combiners and the mask combiner fold, the
    recipient reconstructs from all shares and from a dropout's survivors
    and unmasks; both reveals must equal the column sum. ChaCha masks go
    through K3 on a CUDA device, which must have launched. Returns the
    phase's JSON record."""
    import numpy as np

    from sda_tpu_torch import utils
    from sda_tpu_torch.crypto import CryptoModule, MemoryKeystore, rand
    from sda_tpu_torch.protocol import ChaChaMasking
    from sda_tpu_torch.utils import timed_phase

    scheme, full, p = _flagship()
    masking = masking or full
    seeded = isinstance(masking, ChaChaMasking)
    n = scheme.share_count
    cm = CryptoModule(MemoryKeystore(), device=dev)
    inputs = np.random.default_rng(seed).integers(0, 1 << 20, size=(P, D))
    expect = inputs.sum(0) % p
    utils.reset_phase_report()
    per_clerk, masks = [[] for _ in range(n)], []
    k3 = _k3_reset()
    with DeviceCounts() as counts:
        t0 = time.perf_counter()
        for x in inputs:   # a masker and a generator a call, as a client
            with timed_phase("participant.mask"):
                mask, masked = cm.new_secret_masker(masking).mask(x)
            with timed_phase("participant.share"):
                shares = cm.new_share_generator(scheme).generate(masked)
            masks.append(mask)
            for clerk, share in zip(per_clerk, shares):
                clerk.append(share)
        combined = []
        for clerk in per_clerk:
            with timed_phase("clerk.combine"):
                combined.append(cm.new_share_combiner(scheme).combine(clerk))
        del per_clerk
        with timed_phase("recipient.combine_masks"):
            mask_total = cm.new_mask_combiner(masking).combine(masks)
        reveals = {}
        for label, survivors in (("all", range(n)),
                                 ("dropout", [i for i in range(n) if i != 2])):
            with timed_phase("recipient.reconstruct"):
                total = cm.new_secret_reconstructor(scheme, D).reconstruct(
                    [(i, combined[i]) for i in survivors])
            with timed_phase("recipient.unmask"):
                out = cm.new_secret_unmasker(masking).unmask(mask_total, total)
            _check(out.dtype == np.int64 and out.shape == (D,),
                   f"role crypto ({label}): output {out.dtype}{out.shape}")
            _check(np.array_equal(out, expect),
                   f"role crypto ({label}): != column sum mod p")
            reveals[label] = len(list(survivors))
        wall = time.perf_counter() - t0
    # a ChaCha masker adds and subtracts on the host, as the reference's
    calls = counts.check("role crypto", dev.type,
                         ROLE_OPS[:3] if seeded else ROLE_OPS[:5])
    k3_launches = dict(k3.op_launches)
    if seeded and dev.type == "cuda":
        _check(k3_launches["expand"] >= P and k3_launches["combine"] >= 1,
               f"role crypto (ChaCha): K3 launches {k3_launches}")
    return {"stage": "role_crypto", "participants": P, "dim": D,
            "masking": type(masking).__name__,
            "rand_mode": rand.get_mode(), "survivors": reveals, "exact": True,
            "wall_s": wall, "phases_s": _phases(utils), "device_calls": calls,
            "k3_launches": k3_launches}


def _k3_reset():
    from sda_tpu_torch.fields import chacha_device

    k3 = chacha_device.chacha_kernel
    k3.launches = 0
    k3.op_launches.update(dict.fromkeys(chacha_device.OPS, 0))
    return k3


def _host_window(seed, counter0, d, m):
    """The CHACHA_PRG_V1 draws [8*counter0, 8*counter0 + d) mod m of the
    host spec's block function (numpy), without rejection."""
    import numpy as np

    from sda_tpu_torch.fields import chacha

    words = chacha.chacha_block_words(seed, counter0, d // 8).reshape(-1)
    v = (words[1::2].astype(np.uint64) << np.uint64(32)) | words[0::2]
    return (v % np.uint64(m)).astype(np.int64)


def _k3_window(case, dev, round_seed, p0, rows, counter0, width, modulus,
               seed_bits=128):
    """K3's windowed stream at a shape and block counter a round launched
    it with, on the seed words that round derived (``simpod``'s, from
    ``round_seed`` and participant ids ``p0 ..``), held to the plain
    version with ``torch.equal``. ChaCha masks cancel inside a round, so
    the round's exact sum cannot see a wrong window; this check can.
    Returns the max |error| (0 when equal)."""
    import torch

    from sda_tpu_torch.fields import chacha, chacha_device as cd
    from sda_tpu_torch.mesh import simpod

    ids = p0 + torch.arange(rows, dtype=torch.int64, device=dev)
    sw = simpod._chacha_seed_words(round_seed, ids, seed_bits)
    got = cd.stream_residues_at(sw, counter0, dimension=width,
                                modulus=modulus)
    want = cd.expand_plain(sw, counter0, width, modulus,
                           chacha.CHACHA_PRG_V1)[0]
    _check(got.shape == want.shape,
           f"{case}: K3 window {tuple(got.shape)} vs {tuple(want.shape)}")
    equal = torch.equal(got, want)
    err = 0 if equal else int((got - want).abs().max())
    _check(equal, f"{case}: K3 window [{rows}, {width}] of participants "
           f"{p0}.. at counter0={counter0} != plain (max |err| {err})")
    print(f"  {case}: K3 window [{rows}, {width}] of participants {p0}.. "
          f"at counter0={counter0}: equal to plain")
    return err


def chacha_kernels(dev, p, lib_path, ptxas_log, cuobjdump, dims=K3_DIMS,
                   s_combine=S_COMBINE, s_big=S_BIG, d_big=D_CHACHA):
    """Phase 12: K3 against its plain version (on the same device) and the
    host spec (numpy ``fields.chacha``, or the native C++ for the combine
    at full width), exactly, for both PRGs; then K3's times beside its
    bound. Returns the kernel's record and the max abs error."""
    import numpy as np
    import torch

    from sda_tpu_torch import native
    from sda_tpu_torch.benchmarks.bounds import k3_bound
    from sda_tpu_torch.fields import chacha, chacha_device as cd
    from sda_tpu_torch.utils import sass
    from sda_tpu_torch.utils.benchtime import median_ms

    on_card = dev.type == "cuda"
    if on_card:
        info = sass.ptxas_info(ptxas_log)
        for kernel in ("chacha_blocks_kernel", "chacha_expand_kernelILb0EE",
                       "chacha_expand_kernelILb1EE",
                       "chacha_combine_kernelILb0EE",
                       "chacha_combine_kernelILb1EE"):
            ptx = next((v for key, v in info.items() if kernel in key), None)
            _check(ptx is not None, f"{kernel}: no ptxas line")
            _check(not sass.spills(ptx), f"{kernel} spills: {'; '.join(ptx)}")
            print(f"  K3 {kernel}: {'; '.join(ptx)}")
        try:
            lines = sass.loop_instructions(lib_path, cuobjdump,
                                           "chacha_combine_kernelILb0EE")
            mix = collections.Counter(op for op, _ in lines)
            print(f"  K3 combine seed loop (one block a seed): "
                  f"{sum(mix.values())} instructions: "
                  + ", ".join(f"{op} {c}" for op, c in mix.most_common(12)))
        except (LookupError, ValueError) as exc:
            print(f"  K3 combine seed loop: not found ({exc})")
    rng = np.random.default_rng(12)
    max_err = 0
    k3 = _k3_reset()

    def equal(case, got, want):
        nonlocal max_err
        got = torch.as_tensor(got).cpu().to(torch.int64)
        want = torch.as_tensor(want).cpu().to(torch.int64)
        _check(got.shape == want.shape, f"{case}: {tuple(got.shape)} vs "
               f"{tuple(want.shape)}")
        if got.numel():
            max_err = max(max_err, int((got - want).abs().max()))
        _check(torch.equal(got, want), f"{case}: not equal")

    def seed_words(S):
        return [list(map(int, r)) for r in rng.integers(0, 1 << 32, (S, 4))]

    moduli = (K3_MODULI[0], p) + K3_MODULI[1:]
    for prg in (chacha.CHACHA_PRG_V1, chacha.CHACHA_PRG_RAND03):
        for m in moduli:
            replayed = 0
            for d in dims:
                seed = seed_words(1)[0]
                sw = cd._seed_matrix([seed], dev)
                got = cd.chacha_kernel("expand", sw, dimension=d, modulus=m,
                                       prg=prg)
                want = cd.expand_plain(sw, 0, d, m, prg)
                equal(f"expand {prg} m={m} d={d} vs plain", got[0], want[0])
                equal(f"expand {prg} m={m} d={d} flags", got[1], want[1])
                replayed += int(got[1][0])
                equal(f"expand_mask {prg} m={m} d={d} vs host spec",
                      cd.expand_mask(seed, d, m, prg=prg, device=dev),
                      chacha.expand_mask_for(prg, seed, d, m))
            print(f"  expand {prg} m={m}: d in {list(dims)} equal to plain "
                  f"and host spec; {replayed} of {len(dims)} seeds replayed")
            # the combine's replay (and the fold at 2^61 - 1's width)
            seeds = seed_words(9)
            cd.chacha_kernel.replayed = 0
            want = np.zeros(1000, dtype=object)
            for sd in seeds:
                want = (want + chacha.expand_mask_for(prg, sd, 1000, m)) % m
            equal(f"combine_masks {prg} m={m} S=9 d=1000 vs host spec",
                  cd.combine_masks(seeds, 1000, m, prg=prg, device=dev),
                  want.astype(np.int64))
            print(f"  combine_masks {prg} m={m} S=9 d=1000: equal to host "
                  f"spec, {cd.chacha_kernel.replayed} seeds replayed")
    # windows of the V1 stream at nonzero block counters (one wraps 2^32)
    seeds = seed_words(5)
    sw = cd._seed_matrix(seeds, dev)
    for c0 in (1, 12_345, (1 << 32) - 2):
        got = cd.stream_residues_at(sw, c0, dimension=d_big, modulus=p)
        equal(f"window counter0={c0} vs plain", got,
              cd.expand_plain(sw, c0, d_big, p, chacha.CHACHA_PRG_V1)[0])
        equal(f"window counter0={c0} vs host spec", got[0],
              _host_window(seeds[0], c0, d_big, p))
    print(f"  windows S=5 x d={d_big} at counter0 1, 12345, 2^32 - 2: "
          "equal to plain and host spec")
    # the recipient's combine at the flagship width
    seeds = seed_words(s_combine)
    sw = cd._seed_matrix(seeds, dev)
    host_combine = (native.chacha_combine_masks if native.available()
                    else None)
    for prg in (chacha.CHACHA_PRG_V1, chacha.CHACHA_PRG_RAND03):
        got = cd.combine_masks(seeds, d_big, p, prg=prg, device=dev)
        equal(f"combine {prg} S={s_combine} d={d_big} vs plain", got,
              cd.combine_plain(sw, d_big, p, prg)[0])
        if host_combine is not None:
            equal(f"combine {prg} S={s_combine} d={d_big} vs native host",
                  got, host_combine(np.asarray(seeds, dtype=np.int64), d_big,
                                    p, prg=prg))
    print(f"  combine_masks S={s_combine} x d={d_big}, both PRGs: equal to "
          f"plain{' and native host' if host_combine else ''}")
    launches = dict(k3.op_launches)
    print(f"  K3 launches in phase 12: {launches}")

    prg = chacha.CHACHA_PRG_V1
    ms = median_ms(lambda: cd.chacha_kernel(
        "combine", sw, dimension=d_big, modulus=p, prg=prg), dev)
    plain_ms = median_ms(lambda: cd.combine_plain(sw, d_big, p, prg), dev,
                         reps=3, warmup=1)
    big = cd._seed_matrix(seed_words(s_big), dev)
    big_ms = median_ms(lambda: cd.chacha_kernel(
        "combine", big, dimension=d_big, modulus=p, prg=prg), dev, reps=5,
        warmup=1)
    del big
    host_ms = None
    if host_combine is not None:
        stacked = np.asarray(seeds, dtype=np.int64)
        t0 = time.perf_counter()
        host_combine(stacked, d_big, p, prg=prg)
        host_ms = (time.perf_counter() - t0) * 1e3
    bound_ms, bound_by, detail = k3_bound(s_combine, d_big, True)
    big_bound, _, big_detail = k3_bound(s_big, d_big, True)
    print(f"K3 combine at S={s_combine} x d={d_big}: {ms:.4f} ms median of 20 "
          f"(CUDA events); plain {plain_ms:.3f} ms; native host "
          f"{'not available' if host_ms is None else f'{host_ms:.3f} ms'}; "
          f"bound {bound_ms:.4f} ms ({detail})")
    print(f"K3 combine at S={s_big} x d={d_big}: {big_ms:.4f} ms median of 5; "
          f"bound {big_bound:.4f} ms ({big_detail})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "ms_s_big": big_ms,
            "bound_ms_s_big": big_bound, "host_ms": host_ms,
            "max_abs_err": max_err, "check_launches": launches}


def chacha_round(dev, P, D, seed=0):
    """Phase 14: ``single_chip_round`` with ChaCha masking on the flagship
    scheme, exact against the column sum mod p; K3 must have launched.
    Returns the phase's JSON record."""
    import numpy as np
    import torch

    from sda_tpu_torch.mesh import single_chip_round
    from sda_tpu_torch.protocol import ChaChaMasking

    scheme, _, p = _flagship()
    inputs = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 1 << 20, size=(P, D), dtype=np.uint32)).to(dev)
    expect = inputs.to(torch.int64).sum(0) % p
    fn = single_chip_round(scheme, ChaChaMasking(p, D, 128), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    k3 = _k3_reset()
    out = fn(inputs, gen)
    launches = dict(k3.op_launches)
    _check(out.dtype == torch.int64 and out.shape == (D,),
           f"ChaCha round: output {out.dtype}{tuple(out.shape)}")
    _check(torch.equal(out, expect), "ChaCha round: != column sum mod p")
    on_card = dev.type == "cuda"
    _check(not on_card or launches["expand"] > 0,
           f"ChaCha round: K3 launches {launches}")
    # the window the round expanded: its round seed is the generator's
    # first draw, its participants 0..P-1, its counter 0
    from sda_tpu_torch.mesh import simpod

    round_seed = simpod._round_seed(
        torch.Generator(device=dev).manual_seed(seed))
    err = _k3_window("ChaCha round", dev, round_seed, 0, P, 0, D, p)
    ms = _median_ms(lambda: fn(inputs, gen), reps=5, warmup=1) \
        if on_card else None
    return {"stage": "chacha_round", "participants": P, "dim": D,
            "exact": True, "k3_launches": launches,
            "k3_window_max_abs_err": err, "round_ms": ms,
            "elements_per_s": None if ms is None else P * D / (ms / 1e3)}


def streamed_round(dev, P, D, chunk, fold_rows=FOLD_ROWS,
                   fold_dim=D_CHACHA, fold_bundles=FOLD_BUNDLES):
    """Phase 15: ``StreamingAggregator(use_pallas=True)`` with ChaCha
    masking over the device block provider, exact against the plain column
    sum recomputed on the device chunk by chunk from the same provider; K1
    and K3 must have launched on every tile. Then ``DeviceTileCombiner``
    folds ``fold_rows`` rows in ``fold_bundles`` bundles, exact against
    ``mod_combine``. Returns the phase's JSON record."""
    import numpy as np
    import torch

    from sda_tpu_torch import utils
    from sda_tpu_torch.crypto.sharing import mod_combine
    from sda_tpu_torch.fields import fused_round
    from sda_tpu_torch.mesh import (DeviceTileCombiner, StreamingAggregator,
                                    synthetic_device_block_provider32)
    from sda_tpu_torch.protocol import ChaChaMasking

    scheme, _, p = _flagship()
    round_seed = 15
    prov = synthetic_device_block_provider32(p, seed=15, max_value=1 << 20,
                                             device=dev)
    agg = StreamingAggregator(scheme, ChaChaMasking(p, D, 128),
                              participants_chunk=chunk, use_pallas=True,
                              device=dev)
    K1 = fused_round.fused_mask_share_combine
    k3 = _k3_reset()
    K1.launches = 0
    K1.instance_launches.update(dict.fromkeys(fused_round.INSTANCES, 0))
    utils.reset_phase_report()
    t0 = time.perf_counter()
    out = agg.aggregate_blocks(prov, P, D, seed=round_seed)
    wall = time.perf_counter() - t0
    phases = _phases(utils)
    k1_launches, k3_launches = dict(K1.instance_launches), dict(k3.op_launches)
    dc = agg.dim_chunk
    tiles = -(-P // chunk) * -(-D // dc)
    _check(out.dtype == np.int64 and out.shape == (D,),
           f"streamed round: output {out.dtype}{out.shape}")
    for d0 in range(0, D, dc):
        d1 = min(d0 + dc, D)
        want = torch.zeros(d1 - d0, dtype=torch.int64, device=dev)
        for p0 in range(0, P, chunk):
            want += prov(p0, min(p0 + chunk, P), d0, d1).sum(0)
        _check(torch.equal(torch.from_numpy(out[d0:d1]).to(dev), want % p),
               f"streamed round: dims [{d0}, {d1}) != column sum mod p")
    on_card = dev.type == "cuda"
    if on_card:
        unmasked = k1_launches["columns_unmasked"]
        _check(K1.launches == tiles and unmasked == tiles,
               f"streamed round: K1 instances {k1_launches}, want {tiles} "
               "on columns_unmasked")
        _check(k3_launches["expand"] == tiles,
               f"streamed round: K3 launches {k3_launches}, want {tiles}")
    print(f"streamed round: P={P} x d={D}, chunks {chunk} x {dc}, {tiles} "
          f"tiles: exact, wall {wall:.3f} s, {P * D / wall:.4e} "
          f"shared-elements/s; K1 {k1_launches}, K3 {k3_launches}")
    # K3 at the round's own window shapes: the first participant chunk of
    # dim tile 0, the last chunk of dim tile 1, and the ragged dim tail
    d_starts = range(0, D, dc)
    last_p0 = (P - 1) // chunk * chunk
    err = 0
    for p0, d0 in sorted({(0, d_starts[0]), (0, d_starts[-1]),
                          (last_p0, d_starts[min(1, len(d_starts) - 1)])}):
        width = -(-(min(d0 + dc, D) - d0) // agg._grain) * agg._grain
        err = max(err, _k3_window("streamed round", dev, round_seed, p0,
                                  min(chunk, P - p0), d0 // 8, width, p))
    # the device-tile clerk fold
    rng = np.random.default_rng(15)
    rows = rng.integers(0, p, size=(fold_rows, fold_dim))
    comb = DeviceTileCombiner(p, device=dev)
    t1 = time.perf_counter()
    for bundle in np.array_split(rows, fold_bundles):
        comb.fold(bundle)
    folded = comb.result()
    fold_s = time.perf_counter() - t1
    _check(np.array_equal(folded, mod_combine(list(rows), p,
                                              torch.device("cpu"))),
           "DeviceTileCombiner != mod_combine")
    print(f"DeviceTileCombiner: {fold_rows} rows x d={fold_dim} in "
          f"{fold_bundles} bundles (tile {comb._dim_tile}) == mod_combine, "
          f"{fold_s:.3f} s")
    return {"stage": "streamed_round", "participants": P, "dim": D,
            "participants_chunk": chunk, "dim_chunk": dc, "tiles": tiles,
            "exact": True, "wall_s": wall, "elements_per_s": P * D / wall,
            "phases_s": phases,
            "k1_launches": k1_launches, "k3_launches": k3_launches,
            "k3_window_max_abs_err": err,
            "fold": {"rows": fold_rows, "dim": fold_dim,
                     "bundles": fold_bundles, "tile": comb._dim_tile,
                     "exact": True, "wall_s": fold_s}}


def _k4_reset():
    from sda_tpu_torch.crypto import paillier_tpu

    k4 = paillier_tpu.montgomery_kernel
    k4.launches = 0
    k4.op_launches = dict.fromkeys(paillier_tpu.OPS, 0)
    return k4


def premix_phase(dev, ptxas_log, key_bits=K4_KEY_BITS, rows=K4_ROWS,
                 lanes=K4_LANES, P=P_PREMIX, B=B_PREMIX,
                 flagship_bits=PREMIX_KEY_BITS, shares=SHARES_PREMIX,
                 split_case=K4_SPLIT_CASE, wide_bits=WIDE_KEY_BITS,
                 wide_limbs=K4_WIDE_LIMBS, wide_rows=K4_WIDE_ROWS):
    """Phase 16: K4 against its plain version (on the same device) and
    Python ints, for ``mont_mul`` and the premix fold, at each key size and
    row count, and ``paillier_combine``'s device leg at each key size
    byte-identical to the host fold; the same checks of the wide instance
    on a random odd modulus of ``wide_limbs`` limbs; the flagship clerk column (P x B random units mod n^2,
    framed as participants' encryptions) through ``paillier_combine`` with
    ``SDA_PREMIX_DEVICE=1``, byte-identical to the host fold; a homomorphic
    check on real encryptions; K4's time (its launches alone, on the rows
    as ``to_limbs`` lays them out) beside its bound, the wrapper's
    (``premix_limbs``), the plain version's and the host fold's, and its
    time on a column of the same shape at a ``wide_bits`` key. Fails on a
    spill in any group instance. Returns the kernel's record."""
    import os

    import numpy as np
    import torch

    from sda_tpu_torch.benchmarks.bounds import k4_bound
    from sda_tpu_torch.crypto import encryption, paillier
    from sda_tpu_torch.crypto import paillier_tpu as pt
    from sda_tpu_torch.protocol import (Binary, Encryption, EncryptionKey,
                                        PackedPaillierEncryption)
    from sda_tpu_torch.utils import sass
    from sda_tpu_torch.utils.benchtime import median_ms

    on_card = dev.type == "cuda"
    instances = {}
    if on_card:
        info = sass.ptxas_info(ptxas_log)
        lib = pt._library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        groups = sorted({(int(g[1]), int(g[2])) for g in (
            re.search(r"montfoldILi(\d+)ELi(\d+)EE", key) for key in info)
            if g})
        for limbs in (32, 64, 128, 192):
            _check(pt.fold_shape(lib, limbs)[:2] in groups,
                   f"L={limbs} takes no group instance")
        for tpi, lpt in groups + [(1, 0)]:
            kernel = (f"montfoldILi{tpi}ELi{lpt}EE" if lpt
                      else "montfold_wide")
            ptx = next((v for key, v in info.items() if kernel in key), None)
            _check(ptx is not None, f"{kernel}: no ptxas line")
            # the smallest L of the instance's capacity picks it
            shape = pt.fold_shape(lib, tpi * lpt if lpt else 513)
            _check(shape[:2] == (tpi, lpt),
                   f"{kernel}: the C entry picks {shape[:2]}")
            warps = shape[3] * 128 // 32
            # the wide instance keeps its accumulator in device memory
            if lpt:
                _check(not sass.spills(ptx),
                       f"K4 {kernel} spills: {'; '.join(ptx)}")
            print(f"  K4 {kernel}: {'; '.join(ptx)}; resident warps an SM: "
                  f"{warps} (128-thread blocks, "
                  f"cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
            instances[kernel] = {"ptxas": ptx, "resident_warps": warps}
    rng = np.random.default_rng(16)
    bad = 0

    def shape_of(limbs):
        """(threads a group, limbs a thread) of L's instance on the card"""
        return pt.fold_shape(lib, limbs)[:2] if on_card else "plain"

    def below(m, n):
        w = (m.bit_length() + 64) // 8
        raw = rng.bytes(w * n)
        return [int.from_bytes(raw[i * w:(i + 1) * w], "little") % m
                for i in range(n)]

    def limbs_on(ctx, vals, shape):
        return torch.from_numpy(ctx.to_limbs(vals)).reshape(
            *shape, ctx.L).to(dev)

    def equal(case, got, want):
        nonlocal bad
        got, want = got.cpu(), want.cpu()
        _check(got.shape == want.shape,
               f"{case}: {tuple(got.shape)} vs {tuple(want.shape)}")
        bad = max(bad, int((got != want).any(dim=-1).sum()))
        _check(torch.equal(got, want), f"{case}: kernel != plain version")

    def frames(pk, column, count):
        """[P][B] ciphertext ints -> P framed encryptions of ``count``
        shares each, as participants send them"""
        head = encryption.leb128(count) + encryption.leb128(1)
        encs = []
        for row in column:
            frame = [head]
            for c in row:
                raw = c.to_bytes((c.bit_length() + 7) // 8 or 1, "big")
                frame.append(encryption.leb128(len(raw)) + raw)
            encs.append(Encryption("PackedPaillier", Binary(b"".join(frame))))
        return encs

    def combine(ek, scheme, encs, on_device):
        os.environ["SDA_PREMIX_DEVICE"] = "1" if on_device else "0"
        try:
            return encryption.paillier_combine(ek, scheme, encs)
        finally:
            if old_env is None:
                os.environ.pop("SDA_PREMIX_DEVICE")
            else:
                os.environ["SDA_PREMIX_DEVICE"] = old_env

    def product(ctx, vals, P_):
        out = []
        for b in range(len(vals) // P_):
            acc = 1
            for p_ in range(P_):
                acc = acc * vals[p_ * (len(vals) // P_) + b] % ctx.modulus
            out.append(acc)
        return out

    def hold(ctx, label, rows_):
        """mont_mul at ``lanes`` lanes, the fold at each of ``rows_`` x
        ``lanes`` and the split path at ``split_case`` on ``ctx``'s
        modulus: equal to the plain version and to Python ints"""
        m = ctx.modulus
        r_inv = pow(1 << (32 * ctx.L), -1, m)
        a, b = below(m, lanes), below(m, lanes)
        a[:2], b[:2] = [m - 1, 1], [m - 1, m - 1]
        ta, tb = limbs_on(ctx, a, (lanes,)), limbs_on(ctx, b, (lanes,))
        got = ctx.mont_mul(ta, tb)
        equal(f"mont_mul {label}", got, pt.mont_mul_plain(ctx, ta, tb))
        _check(ctx.from_limbs(got) == [x * y * r_inv % m
                                       for x, y in zip(a, b)],
               f"mont_mul {label} != Python ints")
        for P_ in rows_:
            vals = below(m, P_ * lanes)
            for p_ in range(P_):  # lane 0 all m - 1, lane 1 all 1
                vals[p_ * lanes], vals[p_ * lanes + 1] = m - 1, 1
            x = limbs_on(ctx, vals, (P_, lanes))
            got = ctx.premix_limbs(x)
            fix = torch.from_numpy(ctx.fold_fix(P_)).to(dev)
            equal(f"premix {label} P={P_}", got, pt.premix_plain(ctx, x, fix))
            _check(ctx.from_limbs(got) == product(ctx, vals, P_),
                   f"premix {label} P={P_} != Python ints")
        # a small clerk: its lanes cannot fill the card, so the rows of a
        # lane are split among groups and a second launch folds them
        P_, B_ = split_case
        vals = below(m, P_ * B_)
        x = limbs_on(ctx, vals, (P_, B_))
        before = pt.montgomery_kernel.op_launches["partials"]
        got = ctx.premix_limbs(x)
        if on_card:
            _check(pt.montgomery_kernel.op_launches["partials"] > before,
                   f"premix {label} P={P_} x B={B_}: no split")
        equal(f"premix {label} P={P_} x B={B_} (split)", got,
              pt.premix_plain(ctx, x, torch.from_numpy(
                  ctx.fold_fix(P_)).to(dev)))
        _check(ctx.from_limbs(got) == product(ctx, vals, P_),
               f"premix {label} P={P_} x B={B_} != Python ints")

    old_env = os.environ.get("SDA_PREMIX_DEVICE")
    encryption.PREMIX_DEVICE = dev
    keys = {}
    for bits in key_bits:
        keys[bits] = paillier.keygen(bits)
        ctx = pt.MontgomeryContext(keys[bits][0].n_squared)
        m = ctx.modulus
        hold(ctx, f"{bits}-bit key", rows)
        # paillier_combine's device leg at this key: 8 x 16 random units
        # (128 modmuls, above the floor of 64)
        pk = keys[bits][0]
        scheme = PackedPaillierEncryption(1, 32, 16, bits)
        ek = EncryptionKey("PackedPaillier", Binary(pk.to_bytes()))
        encs = frames(pk, [below(m, 16) for _ in range(8)], 16)
        before = pt.montgomery_kernel.launches
        mixed = combine(ek, scheme, encs, True)
        if on_card:
            _check(pt.montgomery_kernel.launches > before,
                   f"paillier_combine at a {bits}-bit key missed K4")
        host = combine(ek, scheme, encs, False)
        bad = max(bad, int(mixed.value.data != host.value.data))
        _check(mixed.value.data == host.value.data,
               f"paillier_combine at a {bits}-bit key: device leg frames "
               f"differ from the host fold")
        print(f"  {bits}-bit key (m = n^2 of {m.bit_length()} bits, "
              f"L={ctx.L}, instance {shape_of(ctx.L)}): "
              f"mont_mul at B={lanes}, premix at P in {list(rows)} x "
              f"B={lanes} and the split path at P={split_case[0]} x "
              f"B={split_case[1]} equal to plain and Python ints; "
              f"paillier_combine of 8 x 16 on the device leg byte-identical "
              f"to the host fold")
    # the wide instance (L above the group instances'): no Paillier key
    # this size is made, so a random odd modulus of wide_limbs limbs
    big = (1 << (32 * wide_limbs - 16)) | (
        int.from_bytes(rng.bytes(4 * wide_limbs - 2), "little") | 1)
    ctx = pt.MontgomeryContext(big)
    _check(ctx.L == wide_limbs, f"wide modulus has {ctx.L} limbs")
    if on_card:
        _check(pt.fold_shape(lib, ctx.L)[1] == 0,
               f"L={ctx.L} does not take the wide instance")
    before = pt.montgomery_kernel.launches
    hold(ctx, f"{big.bit_length()}-bit modulus", wide_rows)
    if on_card:
        _check(pt.montgomery_kernel.launches > before,
               f"L={ctx.L} checks missed K4")
    print(f"  {big.bit_length()}-bit odd modulus (L={ctx.L}, instance "
          f"{shape_of(ctx.L)}): mont_mul at B={lanes}, premix at P in "
          f"{list(wide_rows)} x B={lanes} and the split path at "
          f"P={split_case[0]} x B={split_case[1]} equal to plain and Python "
          f"ints")
    checks = dict(pt.montgomery_kernel.op_launches)

    # the flagship clerk column, framed as the participants' encryptions
    pk, sk = keys.get(flagship_bits) or paillier.keygen(flagship_bits)
    n2 = pk.n_squared
    components = min(PREMIX_WINDOW, (flagship_bits - 1) // PREMIX_WINDOW)
    scheme = PackedPaillierEncryption(components, PREMIX_WINDOW,
                                      PREMIX_VALUE_BITS, flagship_bits)
    ek = EncryptionKey("PackedPaillier", Binary(pk.to_bytes()))
    count = min(shares, B * components)
    t0 = time.perf_counter()
    # random units mod n^2
    encs = frames(pk, [below(n2, B) for _ in range(P)], count)
    make_s = time.perf_counter() - t0
    k4 = _k4_reset()
    t0 = time.perf_counter()
    mixed = combine(ek, scheme, encs, True)
    combine_s = time.perf_counter() - t0
    launches = k4.launches
    by_op = dict(k4.op_launches)
    if on_card:
        _check(0 < launches <= 2 and by_op["fold"] == 1,
               f"the premix did not fold in one or two K4 launches: {by_op}")
    print(f"  paillier_combine (SDA_PREMIX_DEVICE=1) of P={P} x B={B} at a "
          f"{flagship_bits}-bit key: {combine_s:.3f} s wall; K4 launches "
          f"{by_op} (inputs made in {make_s:.3f} s)")

    # the same fold split into its host and device parts
    ctx = encryption._mont_ctx(n2)
    t0 = time.perf_counter()
    ints = [encryption._unframe_paillier(e.value.data)[2] for e in encs]
    unframe_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_limbs = ctx.to_limbs([c for row in ints for c in row])
    to_limbs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = torch.from_numpy(host_limbs).reshape(P, B, ctx.L).to(dev)
    if on_card:
        torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    fix = torch.from_numpy(ctx.fold_fix(P)).to(dev)
    # K4's time: its launches alone, on the rows as they are; the
    # wrapper's adds its checks and the output's allocation (the fix-up
    # constant is cached; the CPU rehearsal has no kernel to time alone)
    wrapper_ms = ms = median_ms(lambda: ctx.premix_limbs(x), dev)
    if on_card:
        ms = median_ms(lambda: pt._fold_launches(lib, stream, ctx, x, fix),
                       dev)
    got = ctx.premix_limbs(x)
    t0 = time.perf_counter()
    got_ints = ctx.from_limbs(got)
    from_limbs_s = time.perf_counter() - t0
    mixed_ints = encryption._unframe_paillier(mixed.value.data)[2]
    _check(got_ints == mixed_ints, "premix_limbs != paillier_combine")
    t0 = time.perf_counter()
    want = pt.premix_plain(ctx, x, fix)
    if on_card:
        torch.cuda.synchronize()
    plain_flagship_ms = (time.perf_counter() - t0) * 1e3
    equal(f"premix P={P} x B={B} vs plain", got, want)
    del want
    bound_ms, bound_by, detail = k4_bound(P * B, ctx.L, P, B)

    # the host fold over the whole column
    t0 = time.perf_counter()
    host = combine(ek, scheme, encs, False)
    host_ms = (time.perf_counter() - t0) * 1e3
    host_ints = encryption._unframe_paillier(host.value.data)[2]
    differ = sum(a != b for a, b in zip(host_ints, mixed_ints))
    _check(differ == 0 and host.value.data == mixed.value.data,
           f"device premix frames differ from the host fold ({differ} "
           f"lanes)")
    bad = max(bad, differ)

    # plain version at [16 x 256] on the flagship key
    x16 = x[:16, :256].contiguous()
    fix16 = torch.from_numpy(ctx.fold_fix(x16.shape[0])).to(dev)
    plain_ms = median_ms(lambda: pt.premix_plain(ctx, x16, fix16), dev,
                         reps=3, warmup=1)
    del x

    # the same column shape at a wide_bits key: random limbs below m (the
    # top limb below m's), every lane held to the plain version
    wctx = pt.MontgomeryContext(
        (keys.get(wide_bits) or paillier.keygen(wide_bits))[0].n_squared)
    words = rng.integers(0, 1 << 32, size=(P, B, wctx.L), dtype=np.uint32)
    words[..., -1] %= np.uint32(wctx.m_words[-1])
    xw = torch.from_numpy(words.view(np.int32)).to(dev)
    del words
    fixw = torch.from_numpy(wctx.fold_fix(P)).to(dev)
    k4w = _k4_reset()
    gotw = wctx.premix_limbs(xw)
    wide_launches = dict(k4w.op_launches)
    equal(f"premix P={P} x B={B} at a {wide_bits}-bit key", gotw,
          pt.premix_plain(wctx, xw, fixw))
    if on_card:
        ms_wide = median_ms(
            lambda: pt._fold_launches(lib, stream, wctx, xw, fixw), dev)
    else:
        ms_wide = median_ms(lambda: wctx.premix_limbs(xw), dev, reps=1,
                            warmup=0)
    bound_wide, _, detail_wide = k4_bound(P * B, wctx.L, P, B)
    del xw, gotw
    print(f"K4 premix at P={P} x B={B}, {wide_bits}-bit key (L={wctx.L}, "
          f"instance {shape_of(wctx.L)}): {ms_wide:.4f} "
          f"ms median of 20 (CUDA events, its launches {wide_launches}); "
          f"bound {bound_wide:.4f} ms ({detail_wide}); every lane equal to "
          f"plain")

    # homomorphic check: real encryptions of known packed vectors
    encryptor = encryption.PackedPaillierEncryptor(ek, scheme)
    vectors = rng.integers(0, 1 << PREMIX_VALUE_BITS,
                           size=(8, 4 * components))
    batches = [encryption._unframe_paillier(
        encryptor.encrypt(v).value.data)[2] for v in vectors]
    before = k4.launches
    sums = []
    for c in encryption._device_premix_rows(pk, batches):
        sums.extend(paillier.unpack(paillier.decrypt(sk, c), components,
                                    PREMIX_WINDOW))
    if on_card:
        _check(k4.launches > before, "the homomorphic check missed K4")
    _check(sums == vectors.sum(axis=0).tolist(),
           "homomorphic premix does not decrypt to the plaintext sums")
    print(f"  homomorphic check: 8 participants x 4 real encryptions at a "
          f"{flagship_bits}-bit key premixed through K4 decrypt to the "
          f"plaintext sums")
    print(f"K4 premix at P={P} x B={B} (L={ctx.L}): {ms:.4f} ms median of "
          f"20 (CUDA events; its launches on the [P, B, L] rows), the "
          f"wrapper (premix_limbs) {wrapper_ms:.4f} ms "
          f"({wrapper_ms / ms - 1:+.1%}); bound {bound_ms:.4f} "
          f"ms ({detail}); plain at the same shape {plain_flagship_ms:.1f} "
          f"ms (one call), at 16 x 256 {plain_ms:.3f} ms; host fold "
          f"{host_ms:.1f} ms (whole column, paillier_combine on the host); "
          f"host parts: unframe {unframe_s:.3f} s, to_limbs "
          f"{to_limbs_s:.3f} s, upload {upload_s:.3f} s, from_limbs "
          f"{from_limbs_s:.3f} s; paillier_combine {combine_s:.3f} s")
    encryption.PREMIX_DEVICE = None
    return {"launches": launches, "launches_by_op": by_op,
            "check_launches": checks, "instances": instances,
            "max_abs_err": bad, "ms": ms,
            "ms_of": f"K4's launches on the [P, B, L] rows, P={P} x B={B}, "
                     f"L={ctx.L}",
            "wrapper_ms": wrapper_ms,
            "wrapper_ms_of": "premix_limbs: the checks, the launches and "
                             "the output's allocation (fix-up cached)",
            "ms_wide": ms_wide, "bound_ms_wide": bound_wide,
            "ms_wide_of": f"P={P} x B={B}, {wide_bits}-bit key, "
                          f"L={wctx.L}",
            "launches_wide": wide_launches,
            "plain_ms": plain_ms, "plain_ms_of": "16 x 256",
            "plain_ms_flagship": plain_flagship_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "host_ms": host_ms,
            "host_of": "whole column, paillier_combine on the host",
            "combine_wall_s": combine_s, "unframe_s": unframe_s,
            "to_limbs_s": to_limbs_s, "upload_s": upload_s,
            "from_limbs_s": from_limbs_s}


def _round(service, dev, aggregation, inputs, clerks):
    """``tests/test_full_loop.py``'s flow through ``SdaClient``s on
    ``dev``; returns the revealed values."""
    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.crypto import MemoryKeystore

    def client():
        keystore = MemoryKeystore()
        return SdaClient(SdaClient.new_agent(keystore), keystore, service,
                         device=dev)

    recipient = client()
    key = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(key)
    aggregation = aggregation.replace(recipient=recipient.agent.id,
                                      recipient_key=key)
    recipient.upload_aggregation(aggregation)
    workers = [client() for _ in range(clerks)]
    for clerk in workers:
        clerk_key = clerk.new_encryption_key()
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk_key)
    recipient.begin_aggregation(aggregation.id)
    for x in inputs:
        participant = client()
        participant.upload_agent()
        participant.participate(x, aggregation.id)
    recipient.end_aggregation(aggregation.id)
    for worker in [recipient] + workers:
        worker.run_chores(-1)
    return recipient.reveal_aggregation(aggregation.id).positive().values


def _aggregation(dim, modulus, masking, sharing):
    from sda_tpu_torch.protocol import (Aggregation, AggregationId, AgentId,
                                        EncryptionKeyId, SodiumEncryption)

    return Aggregation(
        id=AggregationId.random(), title="chip smoke", vector_dimension=dim,
        modulus=modulus, recipient=AgentId.random(),
        recipient_key=EncryptionKeyId.random(), masking_scheme=masking,
        committee_sharing_scheme=sharing,
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption())


def protocol_round(dev, P, D, seed=0):
    """Phase 10: one round over the in-process memory server at the
    flagship width, every role an ``SdaClient`` on ``dev``: one recipient,
    n clerks, P participants. Returns the phase's JSON record."""
    import numpy as np

    from sda_tpu_torch import utils
    from sda_tpu_torch.server import new_memory_server

    scheme, masking, p = _flagship()
    inputs = np.random.default_rng(seed).integers(0, 1 << 20, size=(P, D))
    utils.reset_phase_report()
    with DeviceCounts() as counts:
        t0 = time.perf_counter()
        out = _round(new_memory_server(), dev,
                     _aggregation(D, p, masking, scheme), inputs,
                     scheme.share_count)
        wall = time.perf_counter() - t0
    _check(np.array_equal(out, inputs.sum(0) % p),
           "protocol round: reveal != column sum mod p")
    calls = counts.check("protocol round", dev.type, ROLE_OPS[:5])
    return {"stage": "protocol_round", "run": True, "participants": P,
            "clerks": scheme.share_count, "dim": D, "exact": True,
            "wall_s": wall, "elements_per_s": P * D / wall,
            "phases_s": _phases(utils), "device_calls": calls}


def http_round(dev, host_path_max):
    """Phase 11: the README walkthrough's round (additive sharing over 3
    clerks, mod 433, d=10, 3 participants) over the threaded HTTP server,
    with the sharing module's ``HOST_PATH_MAX`` set as given (0 sends even
    this round's algebra to ``dev``). Returns the phase's JSON record."""
    import numpy as np

    from sda_tpu_torch.crypto import sharing
    from sda_tpu_torch.http import SdaHttpClient, SdaHttpServer
    from sda_tpu_torch.protocol import AdditiveSharing, NoMasking
    from sda_tpu_torch.server import new_memory_server
    from sda_tpu_torch.store import Filebased

    saved = sharing.HOST_PATH_MAX
    sharing.HOST_PATH_MAX = host_path_max
    server = SdaHttpServer(new_memory_server(), bind="127.0.0.1:0")
    server.start_background()
    try:
        with tempfile.TemporaryDirectory() as tokens, \
                DeviceCounts() as counts:
            proxy = SdaHttpClient(server.address, store=Filebased(tokens))
            t0 = time.perf_counter()
            out = _round(proxy, dev, _aggregation(
                10, 433, NoMasking(), AdditiveSharing(3, 433)),
                WALKTHROUGH, 3)
            wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        sharing.HOST_PATH_MAX = saved
    want = [0, 2, 2, 4, 4, 6, 6, 8, 8, 10]
    _check(np.array_equal(out, want), f"HTTP round: reveal {out} != {want}")
    on_device = host_path_max == 0
    calls = counts.check(
        f"HTTP round (HOST_PATH_MAX={host_path_max})", dev.type,
        ("combine", "additive_share_from_randomness") if on_device else ())
    _check(on_device or not calls,
           f"HTTP round: device work below HOST_PATH_MAX: {calls}")
    return {"stage": "http_round", "run": True,
            "host_path_max": host_path_max, "reveal": [int(v) for v in out],
            "exact": True, "wall_s": wall, "device_calls": calls}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "sda_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: sda_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))

    import numpy as np

    from sda_tpu_torch.benchmarks import kernel_probe
    from sda_tpu_torch.benchmarks.bounds import (INSTR_PER_S,
                                                 WHOLE_ROUND_MULS,
                                                 WHOLE_ROUND_XORS)
    from sda_tpu_torch.benchmarks.bounds import k1_bound as _bound
    from sda_tpu_torch.fields import _build, fused_round, numtheory
    from sda_tpu_torch.fields.dimtile import tile_plan
    from sda_tpu_torch.fields.sharing import batch_columns
    from sda_tpu_torch.fields.fastfield import SolinasPrime
    from sda_tpu_torch.mesh import single_chip_round
    from sda_tpu_torch.protocol import (BasicShamirSharing, FullMasking,
                                        PackedShamirSharing)
    from sda_tpu_torch.utils import sass
    from sda_tpu_torch.utils.benchtime import median_ms

    K1 = fused_round.fused_mask_share_combine
    K5 = kernel_probe.probe_call
    dev = torch.device(DEVICE)

    # -- 1. the card -------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, Python {sys.version.split()[0]}")

    # -- 2. build K1, K5, K3 and K4, one nvcc each, side by side ----------
    t0 = time.perf_counter()
    names = ("fused_round", "kernel_probe", "chacha", "montgomery")
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(_build.build, names)))
    print(f"build: {', '.join(built[n][0].name for n in names)} in "
          f"{time.perf_counter() - t0:.2f} s")
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"

    def report(label, lib, info, kernel):
        """Print a kernel's ptxas line and the SASS opcode mix of its
        participant loop; fail on a spill. Returns the loop's opcode mix
        and its count of Philox multiplies."""
        ptx = next((v for key, v in info.items() if kernel in key), None)
        _check(ptx is not None, f"{kernel}: no ptxas line")
        _check(not sass.spills(ptx), f"{kernel} spills: {'; '.join(ptx)}")
        lines = sass.loop_instructions(lib, cuobjdump, kernel)
        mix = collections.Counter(op for op, _ in lines)
        muls = sass.philox_muls(lines)
        print(f"  {label} ({kernel}): {'; '.join(ptx)}; participant loop "
              f"{sum(mix.values())} instructions, {muls} Philox multiplies: "
              + ", ".join(f"{op} {c}" for op, c in mix.most_common()))
        return mix, muls

    lib_path, log = built["fused_round"]
    k1_ptxas = sass.ptxas_info(log)
    k1_mix = {}
    for instance, kernel in K1_KERNELS.items():
        k1_mix[instance], muls = report(f"K1 {instance}", lib_path,
                                        k1_ptxas, kernel)
        warps = fused_round.resident_blocks(instance) * 256 // 32
        print(f"    resident warps an SM: {warps} (256-thread blocks, "
              "cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
        if instance == "columns":
            k1_mul = muls
    loop_mix = k1_mix["columns"]
    probe_lib, probe_log = built["kernel_probe"]
    probe_ptxas = sass.ptxas_info(probe_log)
    probe_mix, probe_muls = {}, {}
    for name, flags in kernel_probe.VARIANTS.items():
        inst = "probe_kernelI" + "".join(
            f"Lb{int(bool(flags.get(f)))}E"
            for f in ("do_x", "do_prng", "do_matmul", "tree")) + "E"
        probe_mix[name], probe_muls[name] = report(
            f"K5 {name}", probe_lib, probe_ptxas, inst)
    prng_mul = probe_muls["prng_only"]
    print(f"  Philox multiplies a compiled participant: prng_only "
          f"{prng_mul / UNROLL}, K1 {k1_mul / UNROLL}")
    _check(prng_mul == k1_mul and k1_mul > 0,
           f"prng_only's loop holds {prng_mul} Philox multiplies, K1's "
           f"{k1_mul}: draws were compiled away")
    loops = {name: sum(probe_mix[name].values())
             for name in ("no_matmul", "full")}
    _check(loops["no_matmul"] == loops["full"],
           f"the loops of no_matmul and full differ: {loops}")

    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    flagship = PackedShamirSharing(3, 8, t, p, w2, w3)
    basic = BasicShamirSharing(share_count=8, privacy_threshold=3,
                               prime_modulus=p)
    sp = SolinasPrime.try_from(p)
    _check(sp is not None and p == (1 << 29) - 679,
           f"flagship prime {p} is not 2^29 - 679")
    rng = np.random.default_rng(0)
    max_err = {"K1": 0, "K5": 0}

    def hold(case, got, want, kernel="K1"):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            _check(g.dtype == w.dtype and g.shape == w.shape,
                   f"{case}: {g.dtype}{tuple(g.shape)} vs "
                   f"{w.dtype}{tuple(w.shape)}")
            err = int((g - w).abs().max()) if g.numel() else 0
            max_err[kernel] = max(max_err[kernel], err)
            _check(torch.equal(g, w), f"{case}: kernel != plain version")
        print(f"  {case}: equal")

    def words(shape):
        return torch.from_numpy(
            rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)).to(dev)

    def k1_hold(case, instance, args, **kw):
        """K1 against its plain version on the same arguments; the call
        must run the given instance."""
        before = dict(K1.instance_launches)
        got = K1(*args, **kw)
        ran = [i for i in fused_round.INSTANCES
               if K1.instance_launches[i] != before[i]]
        _check(ran == [instance], f"{case}: ran {ran}, want {instance}")
        hold(f"{case} [{instance}]", got,
             fused_round.fused_mask_share_combine_plain(*args, **kw))

    def batch_view(P, d):
        """The main path's layout: the batch_columns view of [P, d] words."""
        return batch_columns(words((P, d)).view(torch.int32), 3)

    # -- 3. K1 vs its plain version, external bits --------------------------
    print("K1 vs plain, external bits (tolerance: exact, torch.equal):")
    for scheme in (flagship, basic):
        k, ts = scheme.secret_count, scheme.privacy_threshold
        m_host = numtheory.share_matrix_for(scheme)
        for P, B, strided in ((7, 1000, False), (P_MAIN, D_MAIN // 3, True)):
            for masked in (True, False):
                draws = (k + ts) if masked else ts
                if strided:  # the main path's layout: a view of [P, d]
                    x_cols = batch_columns(words((P, k * B)).view(torch.int32), k)
                else:
                    x_cols = words((P, k, B))
                bits = words((P, 2 * draws, B))
                k1_hold(f"{type(scheme).__name__} P={P} B={B} "
                        f"masked={masked}", "generic",
                        (x_cols, 0, sp, m_host, ts, masked),
                        external_bits=bits)
                del x_cols, bits
                torch.cuda.synchronize()

    # -- 4. K1 internal Philox draws ---------------------------------------
    # every instance: the main path's take the strided view, masked or
    # not; P=33 x d=3003 makes every participant's run start at another
    # word offset mod 4 and leaves a ragged last block
    print("K1 vs plain, internal Philox draws (tolerance: exact):")
    m_flag = numtheory.share_matrix_for(flagship)
    for P, d, strided, masked in (
            (7, 3000, False, True), (7, 3000, False, False),
            (7, 3000, True, True), (7, 3000, True, False),
            (33, 3003, True, True), (33, 3003, True, False),
            (P_MAIN, D_MAIN, False, True), (P_MAIN, D_MAIN, True, True),
            (P_MAIN, D_MAIN, True, False)):
        x_cols = batch_view(P, d) if strided else words((P, 3, d // 3))
        instance = ("generic" if not strided else
                    "columns" if masked else "columns_unmasked")
        k1_hold(f"PackedShamir P={P} d={d} "
                f"{'strided' if strided else 'contiguous'} masked={masked}",
                instance,
                (x_cols, 12345 + P, sp, m_flag, t, masked))
        del x_cols
        torch.cuda.synchronize()
    small = torch.from_numpy(
        rng.integers(0, 1 << 20, size=(7, 3001), dtype=np.uint32)).to(dev)
    small_fn = fused_round.single_chip_round_pallas(flagship, FullMasking(p),
                                                        device=dev)
    out = small_fn(small, torch.Generator().manual_seed(4))
    _check(torch.equal(out, small.to(torch.int64).sum(0) % p),
           "internal-mode round (P=7, d=3001) != plain sum")
    print("  round on internal draws (P=7, d=3001) == plain sum")

    # -- 5. the main path at full width -------------------------------------
    inputs = torch.from_numpy(rng.integers(
        0, 1 << 20, size=(P_MAIN, D_MAIN), dtype=np.uint32)).to(dev)
    expect = inputs.to(torch.int64).sum(0) % p
    gen = torch.Generator()     # seeds K1 on the host: no wait on the card
    for label, dim_tile, want_launches in (
            ("fused round", None, 1),
            (f"fused round, dim_tile={DIM_TILE}", DIM_TILE,
             tile_plan(D_MAIN, 24, DIM_TILE).n_tiles)):   # grain lcm(3, 8)
        fn = fused_round.single_chip_round_pallas(
            flagship, FullMasking(p), dim_tile=dim_tile, device=dev)
        gen.manual_seed(0)
        K1.launches = K5.launches = 0
        K1.instance_launches.update(dict.fromkeys(fused_round.INSTANCES, 0))
        out = fn(inputs, gen)
        torch.cuda.synchronize()
        launches, round_k5_launches = K1.launches, K5.launches
        _check(K1.instance_launches["columns"] == launches,
               f"{label}: K1 instances {K1.instance_launches}, want every "
               "launch on the main path's")
        _check(out.dtype == torch.int64 and out.shape == (D_MAIN,),
               f"{label}: output {out.dtype}{tuple(out.shape)}")
        _check(torch.equal(out, expect), f"{label}: != plain sum mod p")
        _check(launches == want_launches,
               f"{label}: K1 launched {launches} times, want {want_launches}")
        ms = _median_ms(lambda: fn(inputs, gen), reps=10)
        _check(round_k5_launches == 0, f"{label}: K5 launched on the round")
        if dim_tile is None:
            main_launches = launches
        print(f"{label}: exact, K1 launches {launches}, round {ms:.3f} ms "
              f"median of 10, {P_MAIN * D_MAIN / (ms / 1e3):.4e} "
              f"shared-elements/s")
        _profile(label, lambda: fn(inputs, gen))

    # K1 alone at the main path's shapes and mode (internal draws)
    x_main = batch_columns(inputs.view(torch.int32), 3)
    B_main = x_main.shape[-1]
    k1_args = (x_main, 7, sp, m_flag, t, True)
    k1_ms = median_ms(lambda: K1(*k1_args), dev, reps=20)
    plain_ms = median_ms(
        lambda: fused_round.fused_mask_share_combine_plain(*k1_args),
        dev, reps=3, warmup=1)
    # the work these inputs need (3 input rows, 3 + t drawn rows, shares
    # and mask totals out), counted from the algorithm
    n = flagship.share_count
    bound_ms, bound_by, detail = _bound(P_MAIN, B_main, 3, 3 + t, True,
                                        n + 3)
    whole_ms, _, whole_detail = _bound(P_MAIN, B_main, 3, 3 + t, True,
                                       n + 3, WHOLE_ROUND_MULS,
                                       WHOLE_ROUND_XORS)
    loop_ms = (sum(loop_mix.values()) / UNROLL * P_MAIN * B_main
               / INSTR_PER_S * 1e3)
    print(f"K1 at P={P_MAIN} B={B_main} (internal draws, main path's "
          f"instance): {k1_ms:.4f} ms median of 20 (CUDA events); plain "
          f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({detail}); with the "
          f"whole-round count {whole_ms:.4f} ms ({whole_detail}); its "
          f"compiled loop of {sum(loop_mix.values())} instructions ({UNROLL} "
          f"participants) needs {loop_ms:.4f} ms to issue")

    # -- 6. the plain-torch round on the card -------------------------------
    plain_fn = single_chip_round(flagship, FullMasking(p), device=dev)
    dev_gen = torch.Generator(device=dev).manual_seed(0)
    out = plain_fn(inputs, dev_gen)
    _check(torch.equal(out, expect), "plain single_chip_round != plain sum")
    plain_round_ms = _median_ms(lambda: plain_fn(inputs, dev_gen), reps=5,
                                warmup=1)
    print(f"plain single_chip_round: exact, {plain_round_ms:.3f} ms median "
          f"of 5, {P_MAIN * D_MAIN / (plain_round_ms / 1e3):.4e} "
          f"shared-elements/s")
    _profile("plain single_chip_round", lambda: plain_fn(inputs, dev_gen))

    # -- 7. K5, the kernel probe, at the main path's width -----------------
    print("K5 vs plain (tolerance: exact, torch.equal):")
    checked = dict(kernel_probe.VARIANTS, x_matmul=kernel_probe.X_MATMUL)
    for P, B, x_cols in ((7, 1000, batch_view(7, 3000)),
                         (33, 1001, batch_view(33, 3003)),
                         (P_MAIN, B_main, x_main)):
        args = (x_cols, 4321 + P, sp, m_flag, t)
        got = {}
        for name, flags in checked.items():
            got[name] = K5(*args, **flags)
            hold(f"{name} P={P} B={B}", [got[name]],
                 [kernel_probe.probe_call_plain(*args, **flags)], "K5")
        hold(f"full == K1 shares, same seed, P={P} B={B}", [got["full"]],
             [K1(*args, True)[0]], "K5")
        for tree, twin in (("fold_tree", "fold_only"), ("full_tree", "full")):
            hold(f"{tree} == {twin} P={P} B={B}", [got[tree]], [got[twin]],
                 "K5")
        del got
    hold(f"mxu_fold == xla_fold P={P_MAIN} d={D_MAIN}",
         [kernel_probe.mxu_fold(inputs, sp)],
         [kernel_probe.xla_fold(inputs, sp)], "K5")

    # the probe's entry point, as a user runs it, at the flagship width
    records = []

    def emit(stage, **kw):
        records.append({"stage": stage, **kw})
        print(json.dumps(records[-1]), flush=True)

    K1.launches = K5.launches = 0
    rc = kernel_probe.main(["--participants", str(P_MAIN),
                            "--dim", str(D_MAIN)], emit=emit)
    torch.cuda.synchronize()
    probe_launches = K5.launches
    _check(rc == 0, f"kernel probe exited {rc}")
    _check(probe_launches > 0, "the kernel probe never launched K5")
    print(f"kernel probe: exit 0, K5 launches {probe_launches}, K1 "
          f"launches {K1.launches}")
    comp = {r["name"]: r for r in records if r["stage"] == "component"}
    _check(set(comp) == set(kernel_probe.VARIANTS),
           f"component lines for {sorted(comp)}")

    # plain versions, bounds and the library fold on the probe's inputs
    x_probe = batch_columns(kernel_probe.probe_inputs(
        P_MAIN, D_MAIN, sp, dev).view(torch.int32), 3)
    lib_ms = median_ms(
        lambda: torch.remainder(x_probe.to(torch.int64).sum(0), p), dev)
    k5 = {}
    for name, flags in kernel_probe.VARIANTS.items():
        args = (x_probe, 100, sp, m_flag, t)
        v_plain_ms = median_ms(
            lambda: kernel_probe.probe_call_plain(*args, **flags), dev,
            reps=3, warmup=1)
        v_bound, v_by, v_detail = _bound(
            P_MAIN, B_main, 3, 3 + t if flags["do_prng"] else 0,
            flags["do_x"], n)
        k5[name] = {"ms": comp[name]["ms"], "plain_ms": v_plain_ms,
                    "bound_ms": v_bound, "bound_by": v_by,
                    "library_ms": lib_ms if name == "fold_only" else None}
        loop = sum(probe_mix[name].values())
        print(json.dumps({"stage": "component_bound", "name": name,
                          **k5[name], "loop_instructions": loop,
                          "issue_ms": loop / UNROLL
                          * (kernel_probe.TREE_GROUP if flags.get("tree")
                             else 1)
                          * P_MAIN * B_main / INSTR_PER_S * 1e3,
                          "detail": v_detail}))
    del x_probe
    print(f"library fold (torch.remainder(x.to(int64).sum(0), p)) at "
          f"P={P_MAIN} B={B_main}: {lib_ms:.4f} ms median of 20 "
          f"(CUDA events); fold_only kernel {k5['fold_only']['ms']:.4f} ms")

    # -- 9. the role crypto at the flagship width, no transport -----------
    print(f"role crypto: flagship scheme, Full masking, P={P_MAIN} x "
          f"d={D_MAIN} ({smi}):")
    print(json.dumps(role_crypto(dev, P_MAIN, D_MAIN)), flush=True)

    # -- 10-11. protocol rounds through SdaClient (need libsodium) ----------
    from sda_tpu_torch.crypto import sharing, sodium

    if not sodium.available():
        print(json.dumps({"stage": "protocol_round", "run": False,
                          "why": "libsodium not found on this machine"}))
    else:
        print(f"protocol round: memory server, P={P_PROTOCOL} x d={D_MAIN} "
              f"({smi}):")
        print(json.dumps(protocol_round(dev, P_PROTOCOL, D_MAIN)), flush=True)
        for host_path_max in (sharing.HOST_PATH_MAX, 0):
            print(json.dumps(http_round(dev, host_path_max)), flush=True)

    # -- 12. K3 vs its plain version and the host spec, timed --------------
    print(f"K3 vs plain and host spec (tolerance: exact, torch.equal; {smi}):")
    k3_rec = chacha_kernels(dev, p, *built["chacha"], cuobjdump)

    # -- 13. the role crypto with ChaCha masks through K3 ------------------
    from sda_tpu_torch.protocol import ChaChaMasking

    print(f"role crypto: flagship scheme, ChaCha masking, P={P_MAIN} x "
          f"d={D_CHACHA} ({smi}):")
    rec13 = role_crypto(dev, P_MAIN, D_CHACHA,
                        masking=ChaChaMasking(p, D_CHACHA, 128))
    print(json.dumps(rec13), flush=True)

    # -- 14. single_chip_round with ChaCha masks ---------------------------
    print(f"ChaCha single_chip_round: P={P_MAIN} x d={D_CHACHA} ({smi}):")
    rec14 = chacha_round(dev, P_MAIN, D_CHACHA)
    print(json.dumps(rec14), flush=True)

    # -- 15. the streamed round on K1 and K3, and the device-tile fold -----
    print(f"streamed round: ChaCha masking, use_pallas=True ({smi}):")
    t15 = time.perf_counter()
    rec15 = streamed_round(dev, P_STREAM, D_STREAM, STREAM_CHUNK)
    rec15["phase_s"] = time.perf_counter() - t15
    print(json.dumps(rec15), flush=True)
    k3_launches = {"role_crypto": sum(rec13["k3_launches"].values()),
                   "chacha_round": sum(rec14["k3_launches"].values()),
                   "streamed_round": sum(rec15["k3_launches"].values())}

    # -- 16. K4: the Paillier premix, against plain, Python ints, host -----
    print(f"K4 vs plain, Python ints and the host fold (tolerance: exact, "
          f"torch.equal and byte-identical frames; {smi}):")
    t16 = time.perf_counter()
    k4_rec = premix_phase(dev, built["montgomery"][1])
    k4_rec["phase_s"] = time.perf_counter() - t16
    print(json.dumps(k4_rec), flush=True)

    # -- 8. the record ------------------------------------------------------
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_mask_share_combine",
        "route": "cuda",
        "source": "sda_tpu_torch/fields/csrc/fused_round.cu",
        "replaces": "sda_tpu/fields/pallas_round.py:95",
        "launches": main_launches,
        "launches_streamed": sum(rec15["k1_launches"].values()),
        "max_abs_err": max_err["K1"],
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "bound_ms_whole_rounds": whole_ms,
    }, {
        "name": "probe_call",
        "route": "cuda",
        "source": "sda_tpu_torch/fields/csrc/kernel_probe.cu",
        "replaces": "benchmarks/kernel_probe.py:82",
        "launches": round_k5_launches,
        "probe_launches": probe_launches,
        "max_abs_err": max_err["K5"],
        **{key: k5["full"][key] for key in ("ms", "plain_ms", "bound_ms",
                                            "bound_by")},
        "ms_of": "full",
        "library_ms": lib_ms,
        "library_of": "fold_only",
        "variants": k5,
    }, {
        "name": "combine_masks",
        "route": "cuda",
        "source": "sda_tpu_torch/fields/csrc/chacha.cu",
        "replaces": "sda_tpu/fields/chacha_jax.py:170",
        "launches": sum(k3_launches.values()),
        "launches_by_phase": k3_launches,
        "max_abs_err": max(k3_rec["max_abs_err"],
                           rec14["k3_window_max_abs_err"],
                           rec15["k3_window_max_abs_err"]),
        "ms": k3_rec["ms"],
        "plain_ms": k3_rec["plain_ms"],
        "bound_ms": k3_rec["bound_ms"],
        "bound_by": k3_rec["bound_by"],
        "library_ms": None,
        "ms_of": f"combine, S={S_COMBINE} x d={D_CHACHA}",
        f"ms_s{S_BIG}": k3_rec["ms_s_big"],
        f"bound_ms_s{S_BIG}": k3_rec["bound_ms_s_big"],
        "host_ms": k3_rec["host_ms"],
    }, {
        "name": "premix",
        "route": "cuda",
        "source": "sda_tpu_torch/fields/csrc/montgomery.cu",
        "replaces": "sda_tpu/crypto/paillier_tpu.py:137",
        **{key: k4_rec[key] for key in (
            "launches", "launches_by_op", "max_abs_err", "ms", "ms_of",
            "wrapper_ms", "ms_wide", "bound_ms_wide", "ms_wide_of",
            "plain_ms", "plain_ms_of", "plain_ms_flagship", "bound_ms",
            "bound_by", "host_ms", "host_of")},
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
