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
operation bound is counted from the algorithm's work (``MULS``, ``XORS``,
``ACCUMULATES``), beside the count K1's first CUDA version used; the
participant loop's SASS opcode mix (``cuobjdump -sass``) is printed as a
diagnostic. Prints the card's name and power limit, one JSON line of
kernel measurements, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises and exits non-zero; without CUDA, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import json
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
#: K1's instances in the SASS: the main path's, masked and unmasked, and
#: the generic one with internal draws and at most 8 value rows
K1_KERNELS = {"columns": "fused_round_columnsILi3ELi4ELb1EE",
              "columns_unmasked": "fused_round_columnsILi3ELi4ELb0EE",
              "generic": "fused_round_kernelILi8ELb0EE"}
#: participants a loop iteration of the main path's instances and of K5
#: (fields/csrc/columns.cuh)
UNROLL = 2
#: The work of one participant and column on the main path (masked
#: internal draws, k=3, t=4, a column index below 2^32), counted from the
#: algorithm and not from a compiled loop: 7 drawn rows take 3.5 Philox
#: blocks of 10 rounds (2 wide multiplies and 2 three-input xors a round),
#: 80 and 80 in all. The counter (column, participant, row pair) makes 20
#: multiplies and 12 xors of rounds 1-3 invariant in the participant or
#: the column (fields/csrc/columns.cuh), and the half-used block's last
#: multiply and xor are dead: 60 wide multiplies (FMA pipe) and 68 LOP3
#: (ALU pipe) stay. Each input word (3) and drawn word (14) is one 64-bit
#: accumulate, an IADD3 (ALU pipe) and a carry-in add (FMA pipe).
MULS, XORS, ACCUMULATES = 60, 68, 17
#: the count of K1's first CUDA version: 35 whole Philox rounds, nothing
#: factored
WHOLE_ROUND_MULS, WHOLE_ROUND_XORS = 70, 70

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


def _bound(P, B, k, draws, do_x, out_rows, muls=MULS, xors=XORS):
    """Least time (ms) the card could take for the work of a kernel of K1's
    shape at these shapes, and what bounds it: the larger of its bytes
    (input words once, int64 outputs once) at the memory rate and its
    integer operations: a participant and column takes ``muls`` wide
    multiplies (FMA pipe) and ``xors`` LOP3 (ALU pipe) when it draws, and
    one 64-bit accumulate (an IADD3 on the ALU pipe and a carry-in add on
    the FMA pipe) per input word and drawn word. The per-column epilogue
    (one reduction and contraction a column, not a participant) is left
    out. Returns (bound_ms, bound_by, detail)."""
    fold_words = (k if do_x else 0) + 2 * draws
    if not draws:
        muls = xors = 0
    fma_ops = P * B * (muls + fold_words)
    alu_ops = P * B * (xors + fold_words)
    ops_ms = max(max(fma_ops, alu_ops) / PIPE_OPS_PER_S,
                 (fma_ops + alu_ops) / INSTR_PER_S) * 1e3
    # the same work if a wide multiply took two FMA-pipe issue slots
    fma_half = fma_ops + P * B * muls
    half_ms = max(max(fma_half, alu_ops) / PIPE_OPS_PER_S,
                  (fma_half + alu_ops) / INSTR_PER_S) * 1e3
    bytes_moved = (P * k * B * 4 if do_x else 0) + out_rows * B * 8
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    detail = (f"{bytes_moved} bytes -> {bytes_ms:.4f} ms; {fma_ops:.0f} "
              f"FMA-pipe + {alu_ops:.0f} ALU-pipe ops ({muls} multiplies, "
              f"{xors} xors, {fold_words} accumulates a participant and "
              f"column) -> {ops_ms:.4f} ms ({half_ms:.4f} ms with wide "
              f"multiplies at half rate)")
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

    # -- 2. build K1 and K5, one nvcc each, side by side --------------------
    t0 = time.perf_counter()
    names = ("fused_round", "kernel_probe")
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
