"""``docs/walkthrough.sh`` through the port: the script (the JAX
package's, read and not edited) with each ``python -m sda_tpu.cli.*``
turned into the port's ``python -m sda_tpu_torch.cli.* --device cpu``. It
starts the port's ``sdad`` on a sqlite store, registers a recipient and
three clerks, runs three participants through ``sda participate`` and
prints the reveal as its last line: ``0 2 2 4 4 6 6 8 8 10``.
"""

import os
import re
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def test_walkthrough_script_through_the_port():
    script = (ROOT / "docs" / "walkthrough.sh").read_text()
    ported, n = re.subn(r"python -m sda_tpu\.cli\.(main|serverd)",
                        r"python -m sda_tpu_torch.cli.\1 --device cpu",
                        script)
    assert n == 3  # sdad, the readiness ping, and the sda() helper
    res = subprocess.run(["bash", "-c", ported], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().splitlines()[-1] == "0 2 2 4 4 6 6 8 8 10"
