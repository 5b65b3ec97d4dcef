"""Phase 23 of ``chip_smoke.py``, the deployment as processes, on the CPU
at d=64, P=3, with 8 clerks of which one is absent.

- The port's ``sdad`` runs as a subprocess on ``--device cpu``, is
  SIGKILLed after the participations and restarted on its sqlite file.
- Participant 0 is a subprocess, killed once its journal entry exists and
  resumed with ``sda resume``. Its traffic goes through a relay that stops
  once the entry exists, so the upload cannot land before the kill.
- The other roles run through ``sda_tpu_torch.cli.main.main`` in this
  process.

The revealed mean must equal, bit for bit, the mean that the reference's
``sdad`` and ``sda`` reveal from the same ``.npy`` files, and the oracle of
the reference's codec. The Paillier leg runs through ``sdad
--premix-paillier`` with the premix on the CPU (K4's plain version).
"""

import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from sda_tpu.cli.main import main as ref_main
from sda_tpu.crypto import sodium as ref_sodium
from sda_tpu.models import FixedPointCodec as RefCodec
from sda_tpu_torch.cli.main import main as port_main

ROOT = Path(__file__).resolve().parent.parent
P, D = 3, 64

pytestmark = pytest.mark.skipif(
    not ref_sodium.available(), reason="the reference's libsodium not present")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _chip_smoke()


def _reference_round(root, files):
    """The same round through the reference's ``sdad`` (a subprocess) and
    ``sda`` (in this process), without crashes; returns the printed
    mean."""
    cs = chip_smoke
    roles = cs.Processes(root, None, package="sda_tpu", main=ref_main,
                         env={"JAX_PLATFORMS": "cpu"})
    try:
        roles.start_sdad("--sqlite", root / "sda.db")
        clerks = [f"clerk-{i}" for i in range(cs.DEPLOY_CLERKS)]
        ids = {}
        for who in ["recipient", *clerks]:
            ids[who] = roles.sda(who, "agent", "create")
            roles.sda(who, "agent", "keys", "create")
        agg = roles.sda("recipient", "aggregations", "create", "deployment",
                        "--dimension", D, "--modulus", cs.M_DEPLOY, "--mask",
                        "chacha", "--sharing", "shamir", "--shares",
                        cs.DEPLOY_CLERKS, "--secrets-per-batch", 3)
        roles.sda("recipient", "aggregations", "begin", agg,
                  *[x for c in clerks for x in ("--clerk", ids[c])])
        for i, f in enumerate(files):
            roles.sda(f"p-{i}", "participate", agg, "--model", f,
                      "--journal", "--max-summands", P)
        roles.sda("recipient", "aggregations", "end", agg)
        for i, clerk in enumerate(clerks):
            if i != cs.DEPLOY_ABSENT:
                roles.sda(clerk, "clerk", "--once")
        roles.sda("recipient", "clerk", "--once")
        out = roles.sda("recipient", "aggregations", "reveal", agg,
                        "--fixed-point-bits", cs.DEPLOY_BITS, "--mean")
        roles.stop_sdad()
    finally:
        roles.close()
    return np.array(out.split(), dtype=np.float64)


def test_deployment_round_matches_the_reference(tmp_path):
    cs = chip_smoke
    rec = cs.deployment_phase(torch.device("cpu"), P=P, D=D,
                              root=tmp_path / "port", main=port_main)
    assert rec["exact"] and rec["max_abs_err"] == 0
    assert rec["k3_max_abs_err"] == 0
    assert rec["sdad_drained"]["leaked"] == 0
    # the CLI's flagship packed Shamir prime, 2^29 - 679
    assert rec["prime"] == (1 << 29) - 679

    files = [tmp_path / "port" / f"update-{i}.npy" for i in range(P)]
    ref = _reference_round(tmp_path / "ref", files)
    codec = RefCodec(cs.M_DEPLOY, cs.DEPLOY_BITS, P)
    total = np.zeros(D, dtype=np.int64)
    for f in files:
        total = (total + codec.encode(np.load(f))) % cs.M_DEPLOY
    oracle = codec.decode_mean(total, P)
    assert np.array_equal(ref, oracle)
    assert hashlib.sha256(ref.tobytes()).hexdigest() == rec["mean_sha256"]


def test_paillier_deployment_premixes_in_sdad():
    """Phase 23 (b) at 3 participants x 500 values and 512-bit keys: each
    clerk column (3 x 25 ciphertexts, above the floor of 64) premixed in
    the ``sdad`` process, the reveal exact."""
    rec = chip_smoke.paillier_deployment_phase(
        torch.device("cpu"), P=3, D=500, key_bits=512, main=port_main)
    assert rec["exact"]
    assert rec["premix_counters"]["inputs"] == 3 * 3
    assert rec["premix_counters"]["outputs"] > 0
    assert rec["statusz_store"] == "sqlite"
