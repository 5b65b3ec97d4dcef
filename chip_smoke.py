#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sda_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from the sources in this checkout, holds it against
its plain PyTorch version on the card, drives the flagship secure-
aggregation round (packed Shamir k=3, n=8, t=4 over p = 2^29 - 679, full
masking, 100 participants x 999,999 uint32 inputs below 2^20) through the
port's entry points, checks every output exactly, and times the kernel and
both rounds. K1's operation bound is counted in the instruction forms of
its own participant loop, read from ``cuobjdump -sass`` of the build. Prints the card's name and power limit, one JSON line of
kernel measurements, and as its last line
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


def _median_event_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms from CUDA events, one pair per
    call (inputs larger than the 50 MB L2, so no flush is needed)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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
    library (``cuobjdump -sass``): the instructions between the target of
    the longest backward branch and that branch. Returns the Counter and
    the kernel's compiled row count (its MAXR template argument)."""
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    body = None
    for chunk in sass.split("Function : ")[1:]:
        if kernel in chunk.split("\n", 1)[0]:
            body = chunk
    _check(body is not None, f"{kernel} not in the SASS of {lib_path.name}")
    instrs = [(int(m[1], 16), m[2], m[3]) for m in _SASS_LINE.finditer(body)]
    lo, hi = max(((int(tgt, 16), addr) for addr, op, tgt in instrs
                  if op.split(".")[0] == "BRA" and tgt
                  and int(tgt, 16) < addr),
                 key=lambda r: r[1] - r[0])
    mix = collections.Counter(op for addr, op, _ in instrs if lo <= addr <= hi)
    return mix, int(re.search(r"ILi(\d+)E", kernel)[1])


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

    from sda_tpu_torch.fields import _build, fused_round, numtheory
    from sda_tpu_torch.fields.dimtile import tile_plan
    from sda_tpu_torch.fields.sharing import batch_columns
    from sda_tpu_torch.fields.fastfield import SolinasPrime
    from sda_tpu_torch.mesh import single_chip_round
    from sda_tpu_torch.protocol import (BasicShamirSharing, FullMasking,
                                        PackedShamirSharing)

    K1 = fused_round.fused_mask_share_combine
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

    # -- 2. build K1 -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = _build.build("fused_round")
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  nvcc: {line.strip()}")
    loop_mix, compiled_rows = _loop_mix(
        lib_path, Path(_build._nvcc()).parent / "cuobjdump", MAIN_KERNEL)
    print(f"  participant loop of {MAIN_KERNEL} (cuobjdump -sass), "
          f"{sum(loop_mix.values())} instructions: "
          + ", ".join(f"{op} {c}" for op, c in loop_mix.most_common()))

    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    flagship = PackedShamirSharing(3, 8, t, p, w2, w3)
    basic = BasicShamirSharing(share_count=8, privacy_threshold=3,
                               prime_modulus=p)
    sp = SolinasPrime.try_from(p)
    _check(sp is not None and p == (1 << 29) - 679,
           f"flagship prime {p} is not 2^29 - 679")
    rng = np.random.default_rng(0)
    max_err = 0

    def hold(case, got, want):
        nonlocal max_err
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            _check(g.dtype == w.dtype and g.shape == w.shape,
                   f"{case}: {g.dtype}{tuple(g.shape)} vs "
                   f"{w.dtype}{tuple(w.shape)}")
            max_err = max(max_err, int((g - w).abs().max()) if g.numel() else 0)
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
        K1.launches = 0
        out = fn(inputs, gen)
        torch.cuda.synchronize()
        launches = K1.launches
        _check(out.dtype == torch.int64 and out.shape == (D_MAIN,),
               f"{label}: output {out.dtype}{tuple(out.shape)}")
        _check(torch.equal(out, expect), f"{label}: != plain sum mod p")
        _check(launches == want_launches,
               f"{label}: K1 launched {launches} times, want {want_launches}")
        ms = _median_ms(lambda: fn(inputs, gen), reps=10)
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
    k1_ms = _median_event_ms(lambda: K1(*k1_args), reps=20)
    plain_ms = _median_event_ms(
        lambda: fused_round.fused_mask_share_combine_plain(*k1_args),
        reps=3, warmup=1)
    # The bound counts the work these inputs need, in the instruction
    # forms of the kernel's own participant loop (the SASS mix above):
    # 2*draws Philox words per participant and column, 4 to a block of 10
    # rounds (a half block is 2 words), and one 64-bit accumulate per
    # input word and drawn word: an IADD3 (ALU) plus a carry-in add, which
    # the compiler puts on the FMA pipe (IMAD.X). The key schedule depends
    # on the seed alone and is not work on the data.
    compiled_rounds = compiled_rows // 2 * 10
    mul = sum(c for op, c in loop_mix.items()
              if op.startswith(("IMAD.WIDE", "IMAD.HI", "UIMAD.WIDE",
                                "UIMAD.HI")))
    xor = loop_mix["LOP3.LUT"]
    draws = 3 + t
    n = flagship.share_count
    rounds_needed = 2 * draws / 4 * 10
    fold_words = 3 + 2 * draws
    fma_ops = P_MAIN * B_main * (rounds_needed * mul / compiled_rounds
                                 + fold_words)
    alu_ops = P_MAIN * B_main * (rounds_needed * xor / compiled_rounds
                                 + fold_words)
    ops_ms = max(max(fma_ops, alu_ops) / PIPE_OPS_PER_S,
                 (fma_ops + alu_ops) / INSTR_PER_S) * 1e3
    bytes_moved = P_MAIN * 3 * B_main * 4 + (n + 3) * B_main * 8
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    loop_ms = sum(loop_mix.values()) * P_MAIN * B_main / INSTR_PER_S * 1e3
    print(f"K1 at P={P_MAIN} B={B_main} (internal draws): {k1_ms:.4f} ms "
          f"median of 20 (CUDA events); plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms ({bytes_moved} bytes -> {bytes_ms:.4f} ms; "
          f"{fma_ops:.0f} FMA-pipe + {alu_ops:.0f} ALU-pipe ops, "
          f"{mul}/{xor} multiplies/xors in {compiled_rounds} compiled "
          f"Philox rounds -> {ops_ms:.4f} ms); the loop's own "
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

    # -- 7. the record ------------------------------------------------------
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_mask_share_combine",
        "route": "cuda",
        "source": "sda_tpu_torch/fields/csrc/fused_round.cu",
        "replaces": "sda_tpu/fields/pallas_round.py:95",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
