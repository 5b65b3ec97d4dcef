"""Put the repository's root on the path, so that ``aggbench`` and the
program import as they do under ``python3 aggbench/run.py``."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
