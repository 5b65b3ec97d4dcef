"""The repo's ``examples/`` scripts against their port
(``sda_tpu_torch/examples/``) on the CPU: ``federated_http``,
``streamed_checkpoint`` and ``embedded_participant``.

Each script runs as it stands, in a subprocess from the repo root
(``runpy.run_path``), and saves the globals the comparison needs to an
``.npz``. Meanwhile the port's ``main(["--device", "cpu"])`` runs in this
process, its ``run`` record kept. The results are held equal to the
script's exactly, and the printed lines to the script's (the serving
address by its form: each run binds a free port). LeNet's example is in
``test_torch_example_fedavg.py``.
"""

import contextlib
import io
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from sda_tpu_torch import examples
from sda_tpu_torch.examples import (embedded_participant, federated_http,
                                    streamed_checkpoint)

ROOT = Path(__file__).resolve().parent.parent

#: the globals each script leaves that the comparison reads
SAVED = {
    "federated_http": "mean=g['mean'], deltas=g['deltas']",
    "streamed_checkpoint": "out=g['out'], fresh=g['fresh'], "
                           "calls=g['calls']['n'], resumed=g['resumed']['n']",
    "embedded_participant": "out=g['out']",
}
PORTS = {"federated_http": federated_http,
         "streamed_checkpoint": streamed_checkpoint,
         "embedded_participant": embedded_participant}


def start_reference(name, npz):
    """The script ``examples/<name>.py`` as it stands, in a subprocess
    from the repo root, saving ``SAVED[name]`` to ``npz``."""
    code = textwrap.dedent(f"""
        import runpy
        import numpy as np
        g = runpy.run_path("examples/{name}.py", run_name="__main__")
        np.savez({str(npz)!r}, {SAVED[name]})
    """)
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def run_both(name, tmp_path):
    """The script in a subprocess and the port's ``main`` here at once.
    Returns (the script's globals, its lines, the port's ``run`` record,
    its lines)."""
    proc = start_reference(name, tmp_path / "ref.npz")
    module, records, printed = PORTS[name], [], io.StringIO()
    run = module.run
    try:
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(printed):
            mp.setattr(module, "run", lambda *a, **k:
                       records.append(run(*a, **k)) or records[-1])
            assert module.main(["--device", "cpu"]) == 0
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    ref = dict(np.load(tmp_path / "ref.npz"))
    return ref, out.splitlines(), records[0], printed.getvalue().splitlines()


@pytest.fixture(scope="module")
def federated(tmp_path_factory):
    return run_both("federated_http", tmp_path_factory.mktemp("fed"))


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    return run_both("streamed_checkpoint", tmp_path_factory.mktemp("str"))


@pytest.fixture(scope="module")
def embedded(tmp_path_factory):
    return run_both("embedded_participant", tmp_path_factory.mktemp("emb"))


def test_federated_http_mean_is_the_references(federated):
    ref, _, rec, _ = federated
    np.testing.assert_array_equal(rec["deltas"], ref["deltas"])
    assert np.array_equal(rec["mean"], ref["mean"])
    assert rec["exact"] and np.array_equal(rec["mean"], rec["oracle"])


def test_federated_http_prints_the_references_lines(federated):
    _, ref_lines, rec, port_lines = federated
    assert len(port_lines) == len(ref_lines) == 3
    assert ref_lines[0].startswith("serving on http://127.0.0.1:")
    assert port_lines[0] == f"serving on {rec['address']}"
    assert rec["address"].startswith("http://127.0.0.1:")
    assert port_lines[1:] == ref_lines[1:]


def test_streamed_checkpoint_resumes_as_the_reference(streamed):
    ref, _, rec, _ = streamed
    assert rec["calls"] == int(ref["calls"]) == 6
    assert rec["resumed"] == int(ref["resumed"]) == 20
    assert rec["blocks"] == 24
    assert np.array_equal(rec["out"], ref["out"])
    assert np.array_equal(rec["fresh"], ref["fresh"])
    assert np.array_equal(rec["out"], rec["column_sum"])


def test_streamed_checkpoint_prints_the_references_lines(streamed):
    _, ref_lines, _, port_lines = streamed
    assert port_lines == ref_lines
    assert port_lines[-2] == ("resumed run streamed 20 blocks (a fresh run "
                              "would stream 24)")


def test_embedded_participant_reveals_as_the_reference(embedded):
    ref, _, rec, _ = embedded
    assert np.array_equal(rec["out"], ref["out"])
    assert [int(v) for v in rec["out"]] == [5, 8, 5, 9, 7, 17, 3, 14]


def test_embedded_participant_prints_the_references_lines(embedded):
    _, ref_lines, _, port_lines = embedded
    assert port_lines == ref_lines


def test_embedded_participant_exits_loudly_without_the_native_core(
        monkeypatch, capsys):
    """The script's exit 1 when the sealed boxes or the native core are
    missing is kept; there is no other path."""
    from sda_tpu_torch import native

    monkeypatch.setattr(native, "available", lambda: False)
    assert embedded_participant.main(["--device", "cpu"]) == 1
    assert "native build is unavailable" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="unavailable"):
        embedded_participant.run("cpu")


@pytest.mark.parametrize("name", examples.EXAMPLES)
def test_example_without_device_asks_for_cuda(name):
    """Without ``--device`` an example asks for CUDA and raises here."""
    import importlib

    module = importlib.import_module(f"sda_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])


@pytest.mark.parametrize("name", ["federated_http", "embedded_participant"])
def test_example_runs_as_a_module(name):
    """``python -m sda_tpu_torch.examples.<name> --device cpu`` exits 0
    with the script's last line."""
    res = subprocess.run(
        [sys.executable, "-m", f"sda_tpu_torch.examples.{name}", "--device",
         "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    last = {"federated_http": "exact vs plaintext quantized oracle: OK",
            "embedded_participant": "C-core participation revealed exactly "
                                    "alongside the Python one: OK"}[name]
    assert res.stdout.strip().splitlines()[-1] == last
