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
component budget of K1. Each kernel's operation bound is counted in the
instruction forms of its own participant loop, read from ``cuobjdump
-sass`` of the build. Prints the card's name and power limit, one JSON line
of kernel measurements, and as its last line
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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

#: H100 SXM (NVIDIA data sheet, dense, 700 W): device memory rate; 132 SMs
#: whose fp32 peak of 67 TFLOP/s (an FMA counted as 2, 128 lanes an SM)
#: implies the SM clock. Integer work goes to two pipes of 64 lanes an SM
#: that issue side by side: multiplies (IMAD*) to the FMA pipe, logic and
#: adds (LOP3, IADD3) to the ALU pipe; carry-in adds may go to either.
#: Each SM issues at most 128 thread instructions a clock (4 x 32).
HBM_BYTES_PER_S = 3.35e12
SMS = 132
SM_CLOCK_HZ = 67e12 / (SMS * 128 * 2)
PIPE_OPS_PER_S = SMS * 64 * SM_CLOCK_HZ
INSTR_PER_S = SMS * 128 * SM_CLOCK_HZ
#: the K1 instance on the main path: 8 value rows, internal Philox draws
MAIN_KERNEL = "fused_round_kernelILi8ELb0E"
#: wide-multiply instruction forms (Philox's multiplies)
MUL_OPS = ("IMAD.WIDE", "IMAD.HI", "UIMAD.WIDE", "UIMAD.HI")

DEVICE = "cuda"
P_MAIN, D_MAIN = 100, 999_999
DIM_TILE = 262_144


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


_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
    r"(?:\s+0x([0-9a-f]+))?")


def _loop_mix(lib_path: Path, cuobjdump: Path, kernel: str):
    """Opcode counts of the participant loop of ``kernel`` in the built
    library (``cuobjdump -sass``): the instructions between a backward
    branch and its target, for the branch whose body holds the most global
    loads and wide multiplies (the inputs and Philox), the longest among
    equals. Returns the Counter and the kernel's compiled row count (its
    MAXR template argument)."""
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    body = None
    for chunk in sass.split("Function : ")[1:]:
        if kernel in chunk.split("\n", 1)[0]:
            body = chunk
    _check(body is not None, f"{kernel} not in the SASS of {lib_path.name}")
    instrs = [(int(m[1], 16), m[2], m[3]) for m in _SASS_LINE.finditer(body)]

    def weight(loop):
        work = sum(op.startswith(("LDG",) + MUL_OPS) for addr, op, _ in instrs
                   if loop[0] <= addr <= loop[1])
        return work, loop[1] - loop[0]

    lo, hi = max(((int(tgt, 16), addr) for addr, op, tgt in instrs
                  if op.split(".")[0] == "BRA" and tgt
                  and int(tgt, 16) < addr), key=weight)
    mix = collections.Counter(op for addr, op, _ in instrs if lo <= addr <= hi)
    return mix, int(re.search(r"ILi(\d+)E", kernel)[1])


def _muls(mix) -> int:
    """Wide multiplies (Philox's, and address arithmetic's) in a loop mix."""
    return sum(c for op, c in mix.items() if op.startswith(MUL_OPS))


def _ptxas(log: str) -> dict:
    """``nvcc -Xptxas -v`` log -> {mangled kernel: its register, stack and
    spill lines}."""
    info, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = info.setdefault(m[1], [])
        elif cur is not None and ("registers" in line or "spill" in line):
            cur.append(line.split("ptxas info    :")[-1].strip())
    return info


def _bound(P, B, k, draws, do_x, out_rows, mix, compiled_rows):
    """Least time (ms) the card could take for the work of a kernel of K1's
    shape at these shapes, and what bounds it: the larger of its bytes
    (input words once, int64 outputs once) at the memory rate and its
    integer operations, in the instruction forms of its own participant
    loop (``mix``, compiled for ``compiled_rows`` value rows).

    The operations are 2*draws Philox words per participant and column, 4
    to a block of 10 rounds (a half block is 2 words), and one 64-bit
    accumulate per input word and drawn word: an IADD3 (ALU pipe) plus a
    carry-in add, which the compiler puts on the FMA pipe (IMAD.X). A
    Philox round costs the loop's multiplies and xors per compiled round,
    rounded to whole instructions: the loop also holds a few wide
    multiplies of its address arithmetic, which are not work on the data,
    nor is the key schedule, which depends on the seed alone. The
    per-column epilogue (one reduction and contraction a column, not a
    participant) is left out. Returns (bound_ms, bound_by, detail)."""
    compiled_rounds = compiled_rows // 2 * 10
    mul = _muls(mix)
    xor = mix["LOP3.LUT"]
    mul_round = round(mul / compiled_rounds)
    xor_round = round(xor / compiled_rounds)
    rounds_needed = 2 * draws / 4 * 10
    fold_words = (k if do_x else 0) + 2 * draws
    fma_ops = P * B * (rounds_needed * mul_round + fold_words)
    alu_ops = P * B * (rounds_needed * xor_round + fold_words)
    ops_ms = max(max(fma_ops, alu_ops) / PIPE_OPS_PER_S,
                 (fma_ops + alu_ops) / INSTR_PER_S) * 1e3
    # the same work if a wide multiply took two FMA-pipe issue slots
    fma_half = fma_ops + P * B * rounds_needed * mul_round
    half_ms = max(max(fma_half, alu_ops) / PIPE_OPS_PER_S,
                  (fma_half + alu_ops) / INSTR_PER_S) * 1e3
    bytes_moved = (P * k * B * 4 if do_x else 0) + out_rows * B * 8
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    detail = (f"{bytes_moved} bytes -> {bytes_ms:.4f} ms; {fma_ops:.0f} "
              f"FMA-pipe + {alu_ops:.0f} ALU-pipe ops, {mul}/{xor} "
              f"multiplies/xors in the loop's {compiled_rounds} compiled "
              f"Philox rounds ({mul_round}/{xor_round} a round) -> "
              f"{ops_ms:.4f} ms ({half_ms:.4f} ms with wide multiplies at "
              f"half rate)")
    return (max(bytes_ms, ops_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", detail)


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
    from sda_tpu_torch.fields import _build, fused_round, numtheory
    from sda_tpu_torch.fields.dimtile import tile_plan
    from sda_tpu_torch.fields.sharing import batch_columns
    from sda_tpu_torch.fields.fastfield import SolinasPrime
    from sda_tpu_torch.mesh import single_chip_round
    from sda_tpu_torch.protocol import (BasicShamirSharing, FullMasking,
                                        PackedShamirSharing)
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

    # -- 2. build K1 and K5, one nvcc each, side by side --------------------
    t0 = time.perf_counter()
    names = ("fused_round", "kernel_probe")
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(_build.build, names)))
    print(f"build: {', '.join(built[n][0].name for n in names)} in "
          f"{time.perf_counter() - t0:.2f} s")
    lib_path, log = built["fused_round"]
    for kernel, lines in _ptxas(log).items():
        print(f"  nvcc: {kernel}: {'; '.join(lines)}")
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    loop_mix, compiled_rows = _loop_mix(lib_path, cuobjdump, MAIN_KERNEL)
    print(f"  participant loop of {MAIN_KERNEL} (cuobjdump -sass), "
          f"{sum(loop_mix.values())} instructions: "
          + ", ".join(f"{op} {c}" for op, c in loop_mix.most_common()))
    k1_mul = _muls(loop_mix)
    probe_lib, probe_log = built["kernel_probe"]
    probe_ptxas = _ptxas(probe_log)
    probe_mix = {}
    for name, flags in kernel_probe.VARIANTS.items():
        inst = "probe_kernelILi8E" + "".join(
            f"Lb{int(bool(flags.get(f)))}E"
            for f in ("do_x", "do_prng", "do_matmul", "tree"))
        probe_mix[name], _ = _loop_mix(probe_lib, cuobjdump, inst)
        mix = probe_mix[name]
        ptx = next((v for key, v in probe_ptxas.items() if inst in key), [])
        print(f"  K5 {name} ({inst}): {'; '.join(ptx)}; participant loop "
              f"{sum(mix.values())} instructions: "
              + ", ".join(f"{op} {c}" for op, c in mix.most_common()))
    prng_mul = _muls(probe_mix["prng_only"])
    print(f"  Philox multiplies in the loop: prng_only {prng_mul}, "
          f"K1 {k1_mul}")
    _check(prng_mul == k1_mul and k1_mul > 0,
           f"prng_only's loop holds {prng_mul} Philox multiplies, K1's "
           f"{k1_mul}: draws were compiled away")

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
                args = (x_cols, 0, sp, m_host, ts, masked)
                hold(f"{type(scheme).__name__} P={P} B={B} masked={masked}",
                     K1(*args, external_bits=bits),
                     fused_round.fused_mask_share_combine_plain(
                         *args, external_bits=bits))
                del x_cols, bits
                torch.cuda.synchronize()

    # -- 4. K1 internal Philox draws ---------------------------------------
    print("K1 vs plain, internal Philox draws (tolerance: exact):")
    m_flag = numtheory.share_matrix_for(flagship)
    for P, B, masked in ((7, 1000, True), (7, 1000, False),
                         (P_MAIN, D_MAIN // 3, True)):
        x_cols = words((P, 3, B))
        args = (x_cols, 12345 + P, sp, m_flag, t, masked)
        hold(f"PackedShamir P={P} B={B} masked={masked}", K1(*args),
             fused_round.fused_mask_share_combine_plain(*args))
    del x_cols
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
        out = fn(inputs, gen)
        torch.cuda.synchronize()
        launches, round_k5_launches = K1.launches, K5.launches
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
    # and mask totals out), in the instruction forms of K1's own loop
    n = flagship.share_count
    bound_ms, bound_by, detail = _bound(P_MAIN, B_main, 3, 3 + t, True,
                                        n + 3, loop_mix, compiled_rows)
    loop_ms = sum(loop_mix.values()) * P_MAIN * B_main / INSTR_PER_S * 1e3
    print(f"K1 at P={P_MAIN} B={B_main} (internal draws): {k1_ms:.4f} ms "
          f"median of 20 (CUDA events); plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms ({detail}); the loop's own "
          f"{sum(loop_mix.values())} instructions a participant and column "
          f"need {loop_ms:.4f} ms to issue")

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
    for P, B, x_cols in ((7, 1000, words((7, 3, 1000))),
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
            flags["do_x"], n, probe_mix[name], 8)
        k5[name] = {"ms": comp[name]["ms"], "plain_ms": v_plain_ms,
                    "bound_ms": v_bound, "bound_by": v_by,
                    "library_ms": lib_ms if name == "fold_only" else None}
        loop = sum(probe_mix[name].values())
        print(json.dumps({"stage": "component_bound", "name": name,
                          **k5[name], "loop_instructions": loop,
                          "issue_ms": loop * P_MAIN * B_main / INSTR_PER_S
                          * 1e3, "detail": v_detail}))
    del x_probe
    print(f"library fold (torch.remainder(x.to(int64).sum(0), p)) at "
          f"P={P_MAIN} B={B_main}: {lib_ms:.4f} ms median of 20 "
          f"(CUDA events); fold_only kernel {k5['fold_only']['ms']:.4f} ms")

    # -- 8. the record ------------------------------------------------------
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_mask_share_combine",
        "route": "cuda",
        "source": "sda_tpu_torch/fields/csrc/fused_round.cu",
        "replaces": "sda_tpu/fields/pallas_round.py:95",
        "launches": main_launches,
        "max_abs_err": max_err["K1"],
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
