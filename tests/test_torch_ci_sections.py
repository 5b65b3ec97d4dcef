"""Phase 24 of ``chip_smoke.py`` on the CPU: the sections of ``ci.sh`` that
no other phase runs, each through the port's ``sda-sim`` with ``--device
cpu`` at ``ci.sh``'s sizes and checked by the phase's own ``ci_section``
(``ci.sh``'s assertions and its advisory gates, in one place).

Three differences from the card: the connection storm holds 200
connections here (``tests/test_torch_async_plane.py``'s size), 10,000 on
the card; the device perf plane's ``--pallas`` leg needs CUDA (K1) and runs
on the card only, as does the assertion of a device-memory peak; and the
recorder bench runs without its 400% overhead bar, a bar on the ratio of
two timed runs that holds only on an unloaded host (on the card's host,
serially, and in ``ci.sh``), not beside other test workers. No section
masks with ChaCha, so none asks K3 for a mask.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from sda_tpu.crypto import sodium as ref_sodium

ROOT = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(
    not ref_sodium.available(), reason="the reference's libsodium not present")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _chip_smoke()


@pytest.mark.parametrize("name", chip_smoke.CI_SECTIONS)
def test_ci_section_on_the_cpu(name, monkeypatch):
    monkeypatch.setattr(chip_smoke, "RECORDER_BENCH",
                        chip_smoke.RECORDER_BENCH[:2])   # --spans 20000
    with chip_smoke.K3Calls() as k3:
        rec = chip_smoke.ci_section(torch.device("cpu"), name,
                                    connections=200)
    assert k3.calls == []
    assert rec["wall_s"] > 0
    assert all(n == {"k1": 0, "k3": 0} for n in rec["launches"].values())
    legs = set(chip_smoke.CI_LEGS.get(name, ())) - {"pallas"}
    assert set(rec["launches"]) == legs


def _ci_sh():
    """``ci.sh`` as one line a command: continuations joined, the
    poisoning drill's argument array spelled out, spaces collapsed."""
    text = (ROOT / "ci.sh").read_text().replace("\\\n", " ")
    text = text.replace('"${POISON_ARGS[@]}"',
                        "--fl --participants 5 --fl-rounds 2 --fl-seed 3")
    return " ".join(text.split())


@pytest.mark.parametrize("name,leg", [
    (name, leg) for name, legs in chip_smoke.CI_LEGS.items()
    for leg in legs])
def test_ci_legs_are_ci_sh_argv(name, leg):
    """Each leg of phase 24 is ``ci.sh``'s own command line for the
    port's ``sda-sim`` (the storm at ``ci.sh``'s 10,000 connections, the
    trace smoke's file at ``ci.sh``'s variable); the perf plane's
    ``--pallas`` leg is ``ci.sh:688``'s with ``--pallas`` added."""
    argv = chip_smoke.CI_LEGS[name][leg]
    if leg == "pallas":
        assert argv == [*chip_smoke.CI_LEGS[name]["plain"], "--pallas"]
        return
    assert chip_smoke.STORM_CONNECTIONS == 10_000
    args = [a.format(connections=chip_smoke.STORM_CONNECTIONS,
                     tmp="").replace("/trace.json", '"$TRACE_OUT"')
            for a in argv]
    assert f"python -m sda_tpu.cli.sim {' '.join(args)})" in _ci_sh()


def test_recorder_bench_is_ci_sh_argv():
    assert ("python -m sda_tpu.loadgen.recorderbench "
            + " ".join(chip_smoke.RECORDER_BENCH)) in _ci_sh()
    assert chip_smoke.CI_SECTIONS[-1] == "recorder"
