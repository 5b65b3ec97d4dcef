"""``examples/fedavg_lenet.py`` against its port
(``sda_tpu_torch/examples/fedavg_lenet.py``) on the CPU.

The script runs as it stands in a subprocess from the repo root and saves
its flax LeNet's initial weights (``PRNGKey(0)``) and its last global's.
The port's ``main(["--device", "cpu"])`` runs meanwhile from those same
initial weights (``convert.family_params_from_flax``). The training is
float32 convolutions under XLA and under ATen, quantized at 2^-16 each
round, so each round's loss agrees within 2e-4 (the script prints four
decimals) and the last global within 1e-4. The secure round itself is
exact: the reference's ``pod_fedavg_round`` on the port's round-1 client
vectors gives the port's new global bit for bit.
"""

import contextlib
import functools
import io
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from sda_tpu_torch.convert import (family_params_from_flax,
                                   family_params_to_flax)
from sda_tpu_torch.examples import fedavg_lenet
from sda_tpu_torch.models import LeNet

ROOT = Path(__file__).resolve().parent.parent
ROUND = re.compile(r"round (\d): loss (\d+\.\d{4})(.*)")

REFERENCE = """
import runpy
import jax
import numpy as np
g = runpy.run_path("examples/fedavg_lenet.py", run_name="__main__")
init = g["model"].init(jax.random.PRNGKey(0),
                       np.zeros((1, 28, 28, 1), np.float32))
flat = {}
def walk(node, path):
    for key, value in node.items():
        if hasattr(value, "items"):
            walk(value, path + (key,))
        else:
            flat["/".join(path + (key,))] = np.asarray(value)
walk(init["params"], ("init",))
walk(g["params"]["params"], ("final",))
np.savez(NPZ, **flat)
"""


def _tree(flat, prefix):
    """``{"a/b/c": x}`` -> ``{"b": {"c": x}}`` for keys under ``prefix``."""
    tree = {}
    for key, value in flat.items():
        head, *path = key.split("/")
        if head != prefix:
            continue
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the script's saved weights, its lines, the port's ``run`` record
    from the script's initial weights, the port's lines)."""
    npz = tmp_path_factory.mktemp("fedavg") / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c",
         textwrap.dedent(REFERENCE).replace("NPZ", repr(str(npz)))],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # the script's init is a pure function of PRNGKey(0)
        from sda_tpu.models import LeNet as FlaxLeNet

        init = FlaxLeNet().init(jax.random.PRNGKey(0),
                                np.zeros((1, 28, 28, 1), np.float32))
        start = family_params_from_flax(LeNet(device="cpu"),
                                        jax.tree_util.tree_map(np.asarray,
                                                               init))
        run, records, printed = fedavg_lenet.run, [], io.StringIO()
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(printed):
            mp.setattr(fedavg_lenet, "run", lambda *a, **k: records.append(
                functools.partial(run, params=start)(*a, **k))
                or records[-1])
            assert fedavg_lenet.main(["--device", "cpu"]) == 0
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    ref = dict(np.load(npz))
    for key, value in _tree(ref, "init").items():
        for leaf, x in value.items():
            np.testing.assert_array_equal(np.asarray(init["params"][key][leaf]),
                                          x)
    return ref, out.splitlines(), records[0], printed.getvalue().splitlines()


def test_losses_agree_with_the_reference(both):
    _, ref_lines, rec, port_lines = both
    assert port_lines[0] == ref_lines[0] == "LeNet: 61706 parameters"
    assert len(port_lines) == len(ref_lines) == 2 + fedavg_lenet.ROUNDS
    for r, (got, want) in enumerate(zip(port_lines[1:], ref_lines[1:])):
        g, w = ROUND.fullmatch(got), ROUND.fullmatch(want)
        assert g and w, (got, want)
        assert int(g[1]) == int(w[1]) == r
        assert g[3] == w[3]
        assert abs(float(g[2]) - float(w[2])) <= 2e-4, (got, want)
        assert abs(rec["losses"][r] - float(w[2])) <= 2e-4, (rec, want)
    assert rec["param_count"] == 61_706


def test_last_global_agrees_with_the_reference(both):
    ref, _, rec, _ = both
    got = family_params_to_flax(rec["params"])["params"]
    want = _tree(ref, "final")
    assert set(got) == set(want)
    worst = 0.0
    for layer, leaves in want.items():
        assert set(got[layer]) == set(leaves)
        for leaf, x in leaves.items():
            assert got[layer][leaf].shape == x.shape
            worst = max(worst, float(np.abs(got[layer][leaf] - x).max()))
    assert worst <= 1e-4, worst


def test_secure_round_is_the_references_bit_for_bit(both):
    """The reference's pod round (8 virtual devices, additive sharing over
    8 clerks mod 2^31 - 1) on the port's round-1 cohort gives the port's
    new global exactly: only the shares' draws differ, and they cancel."""
    from sda_tpu.mesh import SimulatedPod, make_mesh
    from sda_tpu.models import FixedPointCodec, pod_fedavg_round
    from sda_tpu.protocol import AdditiveSharing

    _, _, rec, _ = both
    fl = fedavg_lenet
    pod = SimulatedPod(AdditiveSharing(share_count=fl.CLERKS, modulus=fl.M31),
                       mesh=make_mesh(4, 2))
    codec = FixedPointCodec(fl.M31, fractional_bits=fl.FRACTIONAL_BITS,
                            max_summands=fl.N_CLIENTS, clip=fl.CLIP)
    for r in range(fl.ROUNDS):
        got = pod_fedavg_round(pod, codec, rec["globals"][r],
                               rec["cohorts"][r], jax.random.PRNGKey(r + 1))
        assert np.array_equal(got, rec["globals"][r + 1]), r


def test_runs_as_a_module_from_its_own_init():
    """``python -m sda_tpu_torch.examples.fedavg_lenet --device cpu``
    starts from ``LeNet``'s own init (a torch generator seeded 0), so its
    losses are its own; it exits 0 with the script's lines."""
    res = subprocess.run(
        [sys.executable, "-m", "sda_tpu_torch.examples.fedavg_lenet",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.strip().splitlines()
    assert lines[0] == "LeNet: 61706 parameters"
    for r, line in enumerate(lines[1:]):
        m = ROUND.fullmatch(line)
        assert m and int(m[1]) == r and np.isfinite(float(m[2]))
    assert lines[-1].endswith("(secure mesh round over 4 encoded deltas)")
