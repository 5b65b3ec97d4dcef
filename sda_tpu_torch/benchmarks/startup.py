"""Where a role process's start-up goes, on the machine it runs on.

    python -m sda_tpu_torch.benchmarks.startup [--device cuda] [--at-once 8]

Times ``python`` processes started from this checkout as the deployment
starts its roles (``PYTHONPATH`` the checkout, one shared
``PYTHONPYCACHEPREFIX`` warmed first): an empty process, ``import numpy``,
``import torch``, with ``--device cuda`` also ``torch.cuda.is_available()``
and a first CUDA tensor, the import of the ``sda`` command line
(``cli/main.py``), and ``sda agent create`` against a local ``sdad`` on a
sqlite file. Each is run ``--reps`` times alone; then ``import torch`` and
``sda agent create`` run ``--at-once`` at a time. Every process's wall,
user and system CPU and peak resident memory come from ``os.wait4``. The
import of ``cli/main.py`` is also split by ``python -X importtime``: torch's
share of it (0 where it imports no torch: torch is imported at the first
device use). Prints one line a measurement and, last, one JSON object;
exits non-zero when a process fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "sda_tpu_torch"


def _env(pycache: Path) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           "PYTHONPYCACHEPREFIX": str(pycache)}
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    return env


def measure(argv, env) -> dict:
    """One process to its end: its wall, user and system CPU and peak
    resident memory, read from the kernel by ``os.wait4``; raises with
    its stderr when it exits non-zero."""
    with tempfile.TemporaryFile() as out, tempfile.TemporaryFile() as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, env=env, cwd=ROOT, stdout=out,
                                stderr=err)
        _, status, usage = os.wait4(proc.pid, 0)
        wall = time.perf_counter() - t0
        proc.returncode = code = os.waitstatus_to_exitcode(status)
        out.seek(0)
        err.seek(0)
        if code != 0:
            raise RuntimeError(f"{' '.join(map(str, argv[:6]))} exited "
                               f"{code}:\n{err.read().decode()[-3000:]}")
        return {"wall_s": wall, "user_s": usage.ru_utime,
                "sys_s": usage.ru_stime, "maxrss_mb": usage.ru_maxrss / 1024,
                "stdout": out.read().decode()}


def _summary(runs) -> dict:
    walls = [r["wall_s"] for r in runs]
    return {"n": len(runs), "wall_s_median": statistics.median(walls),
            "wall_s_min": min(walls), "wall_s_max": max(walls),
            "user_s_median": statistics.median(r["user_s"] for r in runs),
            "sys_s_median": statistics.median(r["sys_s"] for r in runs),
            "maxrss_mb_max": max(r["maxrss_mb"] for r in runs)}


def _print(label, s):
    print(f"{label}: wall {s['wall_s_median']:.2f} s median of {s['n']} "
          f"({s['wall_s_min']:.2f}-{s['wall_s_max']:.2f}), user "
          f"{s['user_s_median']:.2f} s, system {s['sys_s_median']:.2f} s, "
          f"peak resident {s['maxrss_mb_max']:.0f} MB", flush=True)


def import_split(env) -> dict:
    """Cumulative seconds of ``cli/main.py``'s import and of torch's
    within it (0 when it imports no torch), from ``python -X
    importtime``."""
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-c",
         f"import {PACKAGE}.cli.main"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    cumulative = {m[2].strip(): int(m[1]) for m in re.finditer(
        r"import time:\s+\d+ \|\s+(\d+) \|(.*)", res.stderr)}
    return {"cli_main_s": cumulative[f"{PACKAGE}.cli.main"] / 1e6,
            "torch_s": cumulative.get("torch", 0) / 1e6}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--at-once", type=int, default=8)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    py = sys.executable
    record = {"device": args.device, "at_once": args.at_once}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        env = _env(tmp / "pycache")
        warm = measure([py, "-c", f"import {PACKAGE}.cli.main, "
                        f"{PACKAGE}.cli.serverd"], env)
        record["warm_cache"] = _summary([warm])
        _print("warm the bytecode cache", record["warm_cache"])
        codes = {"python": "pass", "import numpy": "import numpy",
                 "import torch": "import torch"}
        if args.device.startswith("cuda"):
            codes["torch.cuda.is_available()"] = \
                "import torch; assert torch.cuda.is_available()"
            codes["a first CUDA tensor"] = \
                "import torch; torch.zeros(1, device='cuda'); " \
                "torch.cuda.synchronize()"
        codes["import the sda command line"] = f"import {PACKAGE}.cli.main"
        record["alone"] = {}
        for label, code in codes.items():
            s = _summary([measure([py, "-c", code], env)
                          for _ in range(args.reps)])
            record["alone"][label] = s
            _print(label, s)
        record["import_split"] = split = import_split(env)
        print(f"importtime: the sda command line {split['cli_main_s']:.3f} "
              f"s, torch {split['torch_s']:.3f} s of it", flush=True)

        sdad = subprocess.Popen(
            [py, "-m", f"{PACKAGE}.cli.serverd", "--device", args.device,
             "--sqlite", str(tmp / "sda.db"), "httpd", "--bind",
             "127.0.0.1:0"], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        try:
            line = sdad.stdout.readline()
            match = re.fullmatch(r"sdad listening on (\S+)\n", line)
            if match is None:
                raise RuntimeError(f"sdad did not start: {line!r}")
            sda = [py, "-m", f"{PACKAGE}.cli.main", "--device", args.device,
                   "-s", match[1]]

            def agent_create(name):
                return measure([*sda, "-i", str(tmp / name), "agent",
                                "create"], env)

            s = _summary([agent_create(f"alone-{i}")
                          for i in range(args.reps)])
            record["alone"]["sda agent create"] = s
            _print("sda agent create", s)
            record["at_once_runs"] = {}
            for label, fn in (
                    ("import torch", lambda i: measure(
                        [py, "-c", "import torch"], env)),
                    ("sda agent create",
                     lambda i: agent_create(f"at-once-{i}"))):
                t0 = time.perf_counter()
                with ThreadPoolExecutor(args.at_once) as pool:
                    runs = list(pool.map(fn, range(args.at_once)))
                s = _summary(runs)
                s["all_s"] = time.perf_counter() - t0
                record["at_once_runs"][label] = s
                _print(f"{label}, {args.at_once} at once", s)
        finally:
            sdad.kill()
            sdad.wait(timeout=60)
    record["cpus"] = os.cpu_count()
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
