"""`sda-bench` of the port — bench runner front-end + regression gate
(``python -m sda_tpu_torch.cli.bench``).

Two jobs:

- ``sda-bench --check [records...]`` — the regression gate
  (``sda_tpu_torch.obs.regress``): compare the newest committed bench record
  against its trailing window with noise-aware thresholds and exit
  nonzero on a confirmed regression. Defaults to the repo's
  ``BENCH_r*.json`` trajectory. ``--advisory`` reports without gating
  (the CI CPU rung), ``--json`` emits the verdict as one JSON line.
- ``sda-bench --run [bench arguments]`` — run the port's bench
  (``python -m sda_tpu_torch.benchmarks.bench``) in a subprocess with the
  other arguments passed through (``--device cpu``, ``--participants``,
  ...), and forward its single JSON line and its exit code.

Every future perf PR is judged by this gate, so the flags mirror
``python -m sda_tpu_torch.obs.regress`` exactly — one implementation, two
spellings. A copy of ``sda_tpu/cli/bench.py`` except ``_run_bench``
and ``main``, whose ``--run`` passes the rest of the command line through
(the reference's parser would reject the bench's own flags).
"""

from __future__ import annotations

import subprocess
import sys
from typing import List, Optional

from ..obs import regress


def build_parser():
    parser = regress.build_parser()
    parser.prog = "sda-bench"
    parser.add_argument("--check", action="store_true",
                        help="run the regression gate (default action)")
    parser.add_argument("--run", action="store_true",
                        help="run the repo's bench.py driver benchmark "
                             "instead and forward its JSON line")
    return parser


def _run_bench(bench_args: List[str]) -> int:
    return subprocess.run(
        [sys.executable, "-m", "sda_tpu_torch.benchmarks.bench",
         *bench_args],
        cwd=regress.repo_root()).returncode


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--run" in argv:
        return _run_bench([a for a in argv if a not in ("--run", "--check")])
    return regress.run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
