"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on CUDA unless asked for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sda_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "sda_tpu")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_and_reference_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_source_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


def _entry_points():
    from sda_tpu_torch.convert import matrices_from_numpy
    from sda_tpu_torch.fields import numtheory
    from sda_tpu_torch.fields.fused_round import single_chip_round_pallas
    from sda_tpu_torch.mesh import single_chip_round
    from sda_tpu_torch.protocol import FullMasking, PackedShamirSharing

    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    s = PackedShamirSharing(3, 8, t, p, w2, w3)
    m = numtheory.share_matrix_for(s)
    l_ = numtheory.reconstruct_matrix_for(s, tuple(range(8)))
    return {
        "single_chip_round": lambda **kw: single_chip_round(
            s, FullMasking(p), **kw),
        "single_chip_round_pallas": lambda **kw: single_chip_round_pallas(
            s, FullMasking(p), **kw),
        "matrices_from_numpy": lambda **kw: matrices_from_numpy(
            m, l_, scheme=s, **kw),
    }


@pytest.mark.parametrize("name", ["single_chip_round",
                                  "single_chip_round_pallas",
                                  "matrices_from_numpy"])
def test_entry_points_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    entry = _entry_points()[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(device="cuda")
    assert entry(device="cpu") is not None

