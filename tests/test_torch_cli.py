"""The CLI recipes of ``tests/test_cli.py`` against the port's ``sda``
(``sda_tpu_torch.cli.main``, every call with ``--device cpu``), then the
``docs/walkthrough.sh`` round through the port's ``sda`` and ``sdad``, one
cross-package round each way, and ``sdad --premix-paillier`` with the
device premix on the CPU.

The reference file's two ``sda-sim`` recipes wait for the port's
``cli/sim.py`` (ROADMAP item 14).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from sda_tpu.crypto import sodium as ref_sodium
from sda_tpu_torch.http import SdaHttpServer
from sda_tpu_torch.server import new_jsonfs_server

from sda_tpu_torch.cli.main import main as sda_main

ROOT = Path(__file__).resolve().parent.parent

needs_ref_sodium = pytest.mark.skipif(
    not ref_sodium.available(), reason="the reference's libsodium not present")


@pytest.fixture
def httpd(tmp_path):
    server = SdaHttpServer(new_jsonfs_server(tmp_path / "server"), bind="127.0.0.1:0")
    server.start_background()
    yield server
    server.shutdown()


def test_simple_cli_walkthrough(httpd, tmp_path, capsys):
    url = httpd.address

    def sda(identity, *args):
        rc = sda_main(["--device", "cpu", "-s", url, "-i", str(tmp_path / "agent" / identity), *args])
        assert rc == 0
        return capsys.readouterr().out.strip()

    # recipient + three clerks, all with encryption keys
    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        sda(who, "agent", "create")
        sda(who, "agent", "keys", "create")

    # participants don't need encryption keys
    for who in ("part-1", "part-2", "part-3"):
        sda(who, "agent", "create")

    assert sda("recipient", "ping") == '{"running": true}'

    agg_id = sda(
        "recipient", "aggregations", "create", "aggro",
        "--dimension", "10", "--modulus", "433", "--shares", "3",
    )
    sda("recipient", "aggregations", "begin", agg_id)

    sda("part-1", "participate", agg_id, "0", "1", "2", "3", "4", "5", "6", "7", "8", "9")
    sda("part-2", "participate", agg_id, "0", "0", "0", "0", "0", "0", "0", "0", "0", "0")
    sda("part-3", "participate", agg_id, "0", "1", "0", "1", "0", "1", "0", "1", "0", "1")

    sda("recipient", "aggregations", "end", agg_id)

    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        sda(who, "clerk", "--once")

    # the reference walkthrough's expected final reveal (README.md)
    assert sda("recipient", "aggregations", "reveal", agg_id) == "0 2 2 4 4 6 6 8 8 10"

    listed = sda("recipient", "aggregations", "list")
    assert agg_id in listed


def test_cli_journal_participate_and_resume(httpd, tmp_path, capsys):
    """`participate --journal` + `sda resume`: a journaled upload reaps
    its entry; a journal entry left by a 'crash' resumes to the SAME
    bytes (deduped server-side), and the round reveals exactly."""
    url = httpd.address

    def sda(identity, *args, rc_expected=0):
        rc = sda_main(["--device", "cpu", "-s", url, "-i", str(tmp_path / "agent" / identity),
                       *args])
        assert rc == rc_expected
        return capsys.readouterr().out.strip()

    sda("recipient", "agent", "create")
    sda("recipient", "agent", "keys", "create")
    for who in ("clerk-1", "clerk-2", "clerk-3"):
        sda(who, "agent", "create")
        sda(who, "agent", "keys", "create")
    agg_id = sda(
        "recipient", "aggregations", "create", "journaled",
        "--dimension", "4", "--modulus", "433", "--shares", "3",
    )
    sda("recipient", "aggregations", "begin", agg_id)

    # the happy path: journal written before the upload, reaped after
    sda("part-1", "participate", agg_id, "1", "2", "3", "4", "--journal")
    journal_dir = tmp_path / "agent" / "part-1" / "journal"
    assert list(journal_dir.glob("*.json")) == []  # reaped on confirm
    assert sda("part-1", "resume") == \
        "nothing journaled; all participations confirmed"

    # the crash path: seal + journal WITHOUT uploading (a device that
    # died mid-participate), then `sda resume` re-uploads the same bytes
    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.client.journal import ParticipationJournal
    from sda_tpu_torch.cli.main import load_client
    from sda_tpu_torch.protocol import AggregationId

    class _Args:
        identity = str(tmp_path / "agent" / "part-2")
        server = url
        device = "cpu"

    crashed = load_client(_Args)
    crashed.upload_agent()
    sealed = crashed.new_participation([4, 3, 2, 1],
                                       AggregationId(agg_id))
    ParticipationJournal(tmp_path / "agent" / "part-2"
                         / "journal").record(sealed)
    out = sda("part-2", "resume")
    assert out == "resumed 1 of 1 journaled participation(s); 0 still pending"

    sda("recipient", "aggregations", "end", agg_id)
    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        sda(who, "clerk", "--once")
    assert sda("recipient", "aggregations", "reveal", agg_id) == "5 5 5 5"


def test_cli_shamir_aggregation(httpd, tmp_path, capsys):
    url = httpd.address

    def sda(identity, *args):
        rc = sda_main(["--device", "cpu", "-s", url, "-i", str(tmp_path / "agent" / identity), *args])
        assert rc == 0
        return capsys.readouterr().out.strip()

    sda("recipient", "agent", "create")
    sda("recipient", "agent", "keys", "create")
    for i in range(8):
        sda(f"clerk-{i}", "agent", "create")
        sda(f"clerk-{i}", "agent", "keys", "create")
    agg_id = sda(
        "recipient", "aggregations", "create", "shamir-run",
        "--dimension", "4", "--modulus", "433",
        "--sharing", "shamir", "--shares", "8", "--mask", "chacha",
    )
    sda("recipient", "aggregations", "begin", agg_id)
    sda("p", "participate", agg_id, "1", "2", "3", "4")
    sda("q", "participate", agg_id, "1", "2", "3", "4")
    sda("recipient", "aggregations", "end", agg_id)
    for i in range(8):
        sda(f"clerk-{i}", "clerk", "--once")
    sda("recipient", "clerk", "--once")
    assert sda("recipient", "aggregations", "reveal", agg_id) == "2 4 6 8"


def test_cli_paillier_aggregation(httpd, tmp_path, capsys):
    """--encryption paillier: homomorphic-capable encryption in both slots,
    Paillier keys via `keys create --encryption paillier` (512-bit keys to
    keep the test fast; default is 2048)."""
    url = httpd.address

    def sda(identity, *args):
        rc = sda_main(["--device", "cpu", "-s", url, "-i", str(tmp_path / "agent" / identity), *args])
        assert rc == 0
        return capsys.readouterr().out.strip()

    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        sda(who, "agent", "create")
        sda(who, "agent", "keys", "create",
            "--encryption", "paillier", "--paillier-modulus-bits", "512")

    agg_id = sda(
        "recipient", "aggregations", "create", "paillier-run",
        "--dimension", "4", "--modulus", "433", "--shares", "3",
        "--mask", "full", "--encryption", "paillier",
        "--paillier-modulus-bits", "512",
    )
    sda("recipient", "aggregations", "begin", agg_id)
    sda("p", "participate", agg_id, "1", "2", "3", "4")
    sda("q", "participate", agg_id, "10", "20", "30", "40")
    sda("recipient", "aggregations", "end", agg_id)
    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        sda(who, "clerk", "--once")
    assert sda("recipient", "aggregations", "reveal", agg_id) == "11 22 33 44"


def test_cli_paillier_errors_are_friendly(httpd, tmp_path, capsys):
    """Misconfigured Paillier options exit 1 with an actionable message,
    never a traceback (round-2 advisor findings)."""
    url = httpd.address

    def sda(identity, *args):
        rc = sda_main(["--device", "cpu", "-s", url, "-i", str(tmp_path / "agent" / identity), *args])
        out = capsys.readouterr()
        return rc, out.out.strip(), out.err

    # keys create with a modulus too small for even one window: friendly error
    rc, _, _ = sda("tiny", "agent", "create")
    assert rc == 0
    rc, _, err = sda("tiny", "agent", "keys", "create",
                     "--encryption", "paillier", "--paillier-modulus-bits", "32")
    assert rc == 1
    assert "error:" in err and "--paillier-modulus-bits" in err

    # aggregations create --encryption paillier over a Sodium primary key:
    # caught at create time with a pointer to the fix, not at participation
    rc, _, _ = sda("mismatched", "agent", "create")
    assert rc == 0
    rc, _, _ = sda("mismatched", "agent", "keys", "create")  # Sodium key
    assert rc == 0
    rc, _, err = sda(
        "mismatched", "aggregations", "create", "bad-run",
        "--dimension", "4", "--modulus", "433", "--shares", "3",
        "--encryption", "paillier", "--paillier-modulus-bits", "512",
    )
    assert rc == 1
    assert "Sodium" in err and "keys create --encryption paillier" in err


def test_cli_model_participation_fixed_point(httpd, tmp_path, capsys):
    """`participate --model file.npy` + `reveal --fixed-point-bits --mean`:
    the secure mean of float model vectors through the real CLI equals the
    plaintext quantized oracle exactly."""
    import numpy as np

    from sda_tpu_torch.models import FixedPointCodec

    url = httpd.address
    m31 = (1 << 31) - 1

    def sda(identity, *args):
        rc = sda_main(["--device", "cpu", "-s", url, "-i", str(tmp_path / "agent" / identity),
                       *args])
        assert rc == 0
        return capsys.readouterr().out.strip()

    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        sda(who, "agent", "create")
        sda(who, "agent", "keys", "create")
    agg_id = sda(
        "recipient", "aggregations", "create", "fedavg",
        "--dimension", "6", "--modulus", str(m31), "--shares", "3",
    )
    sda("recipient", "aggregations", "begin", agg_id)

    rng = np.random.default_rng(0)
    vecs = rng.normal(0, 1, size=(2, 6))
    for i, vec in enumerate(vecs):
        path = tmp_path / f"update{i}.npy"
        np.save(path, vec)
        # NO prior `agent create`: --model as a fresh identity's first
        # command must self-register before its service reads
        sda(f"part-{i}", "participate", agg_id, "--model", str(path),
            "--clip", "4.0")

    sda("recipient", "aggregations", "end", agg_id)

    # a straggler arriving AFTER the snapshot froze the set: counted by
    # the aggregation status but not in the revealed sum — the decoded
    # mean must divide by the snapshot's 2, not the status's 3
    late = tmp_path / "late.npy"
    np.save(late, rng.normal(0, 1, size=6))
    sda("part-late", "participate", agg_id, "--model", str(late),
        "--clip", "4.0")

    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        sda(who, "clerk", "--once")

    out = sda("recipient", "aggregations", "reveal", agg_id,
              "--fixed-point-bits", "16", "--mean")
    got = np.array([float(v) for v in out.split()])
    codec = FixedPointCodec(m31, 16, 1024, clip=4.0)
    oracle = np.stack([codec.quantize(v) for v in vecs]).sum(0) \
        / codec.scale / 2
    np.testing.assert_array_equal(got, oracle)

    # --mean without --fixed-point-bits is a usage error, not raw ints
    rc = sda_main(["--device", "cpu", "-s", url, "-i", str(tmp_path / "agent" / "recipient"),
                   "aggregations", "reveal", agg_id, "--mean"])
    assert rc == 1
    assert "--fixed-point-bits" in capsys.readouterr().err

    # guard rails: both values and --model, and a wrong-dimension model
    rc = sda_main(["--device", "cpu", "-s", url, "-i", str(tmp_path / "agent" / "part-0"),
                   "participate", agg_id, "1", "2",
                   "--model", str(tmp_path / "update0.npy")])
    assert rc == 1
    assert "not both" in capsys.readouterr().err
    bad = tmp_path / "bad.npy"
    np.save(bad, np.zeros(5))
    rc = sda_main(["--device", "cpu", "-s", url, "-i", str(tmp_path / "agent" / "part-0"),
                   "participate", agg_id, "--model", str(bad)])
    assert rc == 1
    assert "6" in capsys.readouterr().err


def test_cli_profile_and_chosen_committee(httpd, tmp_path, capsys):
    """`agent profile set/show` and `aggregations begin --clerk ...` — the
    reference README's 'Doing more' aspirations (external-trust profiles,
    recipient-chosen committees) at the CLI surface."""
    import json as _json

    url = httpd.address

    def sda(identity, *args, rc=0):
        got = sda_main(["--device", "cpu", "-s", url, "-i", str(tmp_path / "agent" / identity),
                        *args])
        assert got == rc, capsys.readouterr()
        return capsys.readouterr()

    sda("recipient", "agent", "create")
    sda("recipient", "agent", "keys", "create")

    # profile publish + public read-back through REST
    sda("clerk-0", "agent", "create")
    sda("clerk-0", "agent", "profile", "set", "--name", "Clerk Zero",
        "--keybase", "clerk0", "--website", "https://clerk0.example")
    own = _json.loads(sda("clerk-0", "agent", "profile", "show").out)
    assert own["name"] == "Clerk Zero" and own["keybase_id"] == "clerk0"
    clerk0_id = _json.loads(sda("clerk-0", "agent", "show").out)["id"]
    seen = _json.loads(
        sda("recipient", "agent", "profile", "show", clerk0_id).out)
    assert seen["website"] == "https://clerk0.example"

    # recipient-chosen committee: exact clerks, in the chosen order
    clerk_ids = [clerk0_id]
    sda("clerk-0", "agent", "keys", "create")
    for i in range(1, 4):
        sda(f"clerk-{i}", "agent", "create")
        sda(f"clerk-{i}", "agent", "keys", "create")
        clerk_ids.append(
            _json.loads(sda(f"clerk-{i}", "agent", "show").out)["id"])

    agg_id = sda("recipient", "aggregations", "create", "chosen",
                 "--dimension", "4", "--modulus", "433",
                 "--shares", "3").out.strip()
    chosen = [clerk_ids[2], clerk_ids[0], clerk_ids[3]]
    sda("recipient", "aggregations", "begin", agg_id,
        "--clerk", chosen[0], "--clerk", chosen[1], "--clerk", chosen[2])

    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.crypto import MemoryKeystore
    from sda_tpu_torch.http import SdaHttpClient
    from sda_tpu_torch.protocol import AggregationId
    from sda_tpu_torch.store import Filebased

    proxy = SdaHttpClient(url, store=Filebased(tmp_path / "probe"))
    ks = MemoryKeystore()
    probe = SdaClient(SdaClient.new_agent(ks), ks, proxy, device="cpu")
    probe.upload_agent()
    committee = proxy.get_committee(probe.agent, AggregationId(agg_id))
    assert [str(c) for c, _ in committee.clerks_and_keys] == chosen

    # full round still reveals exactly with the chosen committee
    sda("p1", "participate", agg_id, "1", "2", "3", "4")
    sda("p2", "participate", agg_id, "4", "3", "2", "1")
    sda("recipient", "aggregations", "end", agg_id)
    for i in range(4):
        sda(f"clerk-{i}", "clerk", "--once")
    assert sda("recipient", "aggregations", "reveal",
               agg_id).out.strip() == "5 5 5 5"

    # guard rails: wrong count, keyless clerk
    err = sda("recipient", "aggregations", "begin", agg_id,
              "--clerk", chosen[0], rc=1).err
    assert "exactly 3" in err
    sda("nokey", "agent", "create")
    nokey_id = _json.loads(sda("nokey", "agent", "show").out)["id"]
    err = sda("recipient", "aggregations", "begin", agg_id,
              "--clerk", chosen[0], "--clerk", chosen[1],
              "--clerk", nokey_id, rc=1).err
    assert "not a committee candidate" in err


def test_cli_embedded_participation(httpd, tmp_path, capsys):
    """`participate --embedded`: the C-core participation over real REST,
    mixed with a Python participant — the walkthrough sum must still be
    exact (the embeddable-client path, reference README.md:196-204)."""
    from sda_tpu_torch import native

    if not native.available():
        pytest.skip("native library not built")
    url = httpd.address

    def sda(identity, *args):
        rc = sda_main(["--device", "cpu", "-s", url, "-i", str(tmp_path / "agent" / identity),
                       *args])
        assert rc == 0
        return capsys.readouterr().out.strip()

    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        sda(who, "agent", "create")
        sda(who, "agent", "keys", "create")
    for who in ("part-1", "part-2"):
        sda(who, "agent", "create")

    agg_id = sda(
        "recipient", "aggregations", "create", "embedded-round",
        "--dimension", "4", "--modulus", "433", "--shares", "3",
        "--mask", "chacha",
    )
    sda("recipient", "aggregations", "begin", agg_id)
    sda("part-1", "participate", agg_id, "1", "2", "3", "4", "--embedded")
    sda("part-2", "participate", agg_id, "10", "20", "30", "40")
    sda("recipient", "aggregations", "end", agg_id)
    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        sda(who, "clerk", "--once")
    assert sda("recipient", "aggregations", "reveal", agg_id) == "11 22 33 44"


def test_cli_embedded_shamir_participation(httpd, tmp_path, capsys):
    """`participate --embedded` over a packed-Shamir committee via REST."""
    from sda_tpu_torch import native

    if not native.available():
        pytest.skip("native library not built")
    url = httpd.address

    def sda(identity, *args):
        rc = sda_main(["--device", "cpu", "-s", url, "-i", str(tmp_path / "agent" / identity),
                       *args])
        assert rc == 0
        return capsys.readouterr().out.strip()

    for who in ("recipient",) + tuple(f"clerk-{i}" for i in range(8)):
        sda(who, "agent", "create")
        sda(who, "agent", "keys", "create")
    sda("part", "agent", "create")
    agg_id = sda(
        "recipient", "aggregations", "create", "shamir-embedded",
        "--dimension", "4", "--modulus", "433",
        "--sharing", "shamir", "--shares", "8",
    )
    sda("recipient", "aggregations", "begin", agg_id)
    sda("part", "participate", agg_id, "1", "2", "3", "4", "--embedded")
    sda("recipient", "aggregations", "end", agg_id)
    for who in ("recipient",) + tuple(f"clerk-{i}" for i in range(8)):
        sda(who, "clerk", "--once")
    assert sda("recipient", "aggregations", "reveal", agg_id) == "1 2 3 4"


def test_cli_embedded_rejects_paillier_cleanly(httpd, tmp_path, capsys):
    """`participate --embedded` on a Paillier aggregation: clear error,
    exit 1, no traceback (the embedded core is Sodium-only)."""
    from sda_tpu_torch import native

    if not native.available():
        pytest.skip("native library not built")
    url = httpd.address

    def sda(identity, *args, expect_rc=0):
        rc = sda_main(["--device", "cpu", "-s", url, "-i", str(tmp_path / "agent" / identity),
                       *args])
        assert rc == expect_rc
        return capsys.readouterr()

    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        sda(who, "agent", "create")
        sda(who, "agent", "keys", "create",
            "--encryption", "paillier", "--paillier-modulus-bits", "512")
    sda("part", "agent", "create")
    agg_id = sda(
        "recipient", "aggregations", "create", "paillier-round",
        "--dimension", "4", "--modulus", "433", "--shares", "3",
        "--encryption", "paillier", "--paillier-modulus-bits", "512",
    ).out.strip()
    sda("recipient", "aggregations", "begin", agg_id)
    captured = sda("part", "participate", agg_id, "1", "2", "3", "4",
                   "--embedded", expect_rc=1)
    assert "embedded participation failed" in captured.err
    assert "Sodium" in captured.err


# ---------------------------------------------------------------------------
# the port's sdad as a process, and rounds across the two packages

def _sdad(tmp_path, *flags, env=None, device="cpu"):
    """Start the port's ``sdad`` (``--device cpu`` unless told otherwise,
    a sqlite store) on a free port; returns the process and its URL."""
    log = open(tmp_path / "sdad.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sda_tpu_torch.cli.serverd", "--device", device,
         *flags, "--sqlite", str(tmp_path / "sdad.db"), "httpd", "--bind",
         "127.0.0.1:0"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})},
        stdout=subprocess.PIPE, stderr=log, text=True)
    line = proc.stdout.readline()
    match = re.fullmatch(r"sdad listening on (\S+)\n", line)
    if match is None:
        proc.kill()
        raise AssertionError(f"sdad did not start: {line!r}; log: "
                             f"{(tmp_path / 'sdad.log').read_text()}")
    return proc, match[1]


def _stop(proc):
    """SIGTERM: the daemon drains and prints its summary as its last line."""
    proc.terminate()
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out
    assert out.strip().splitlines()[-1].startswith("sdad drained {")


def _walkthrough(main, url, root, capsys, device=()):
    """The README walkthrough's round through an ``sda`` main: additive
    3-way sharing of 10-dim mod-433 vectors; returns the reveal."""
    def sda(who, *args):
        rc = main([*device, "-s", url, "-i", str(root / who), *args])
        assert rc == 0
        return capsys.readouterr().out.strip()

    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        sda(who, "agent", "create")
        sda(who, "agent", "keys", "create")
    agg = sda("recipient", "aggregations", "create", "demo", "--dimension",
              "10", "--modulus", "433", "--sharing", "add", "--shares", "3")
    sda("recipient", "aggregations", "begin", agg)
    for who, values in (("participant-1", "0 0 0 1 1 1 2 2 2 3"),
                        ("participant-2", "0 1 1 1 1 2 2 3 3 3"),
                        ("participant-3", "0 1 1 2 2 3 2 3 3 4")):
        sda(who, "agent", "create")
        sda(who, "participate", agg, *values.split())
    sda("recipient", "aggregations", "end", agg)
    for who in ("clerk-1", "clerk-2", "clerk-3", "recipient"):
        sda(who, "clerk", "--once")
    return sda("recipient", "aggregations", "reveal", agg)


@needs_ref_sodium
def test_port_sda_against_reference_server(tmp_path, capsys):
    """The port's ``sda`` against the reference's HTTP server (the server
    the reference's ``sdad`` runs) over its jsonfs store."""
    from sda_tpu.http import SdaHttpServer as RefServer
    from sda_tpu.server import new_jsonfs_server as ref_jsonfs

    server = RefServer(ref_jsonfs(tmp_path / "server"), bind="127.0.0.1:0")
    server.start_background()
    try:
        assert _walkthrough(sda_main, server.address, tmp_path / "agents",
                            capsys, ("--device", "cpu")) == \
            "0 2 2 4 4 6 6 8 8 10"
    finally:
        server.shutdown()


@needs_ref_sodium
def test_reference_sda_against_port_sdad(tmp_path, capsys):
    """The reference's ``sda`` against the port's ``sdad`` process."""
    from sda_tpu.cli.main import main as ref_main

    proc, url = _sdad(tmp_path)
    try:
        assert _walkthrough(ref_main, url, tmp_path / "agents", capsys) == \
            "0 2 2 4 4 6 6 8 8 10"
    finally:
        _stop(proc)


def _paillier_round(url, root, capsys, dimension, vectors):
    def sda(who, *args):
        rc = sda_main(["--device", "cpu", "-s", url, "-i", str(root / who),
                       *args])
        assert rc == 0
        return capsys.readouterr().out.strip()

    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        sda(who, "agent", "create")
        sda(who, "agent", "keys", "create", "--encryption", "paillier",
            "--paillier-modulus-bits", "512")
    agg = sda("recipient", "aggregations", "create", "premixed",
              "--dimension", str(dimension), "--modulus", "433", "--shares",
              "3", "--mask", "full", "--encryption", "paillier",
              "--paillier-modulus-bits", "512")
    sda("recipient", "aggregations", "begin", agg)
    for i, v in enumerate(vectors):
        sda(f"p-{i}", "participate", agg, *map(str, v))
    sda("recipient", "aggregations", "end", agg)
    for who in ("recipient", "clerk-1", "clerk-2", "clerk-3"):
        sda(who, "clerk", "--once")
    return sda("recipient", "aggregations", "reveal", agg)


def test_sdad_premix_paillier_on_the_device_leg(tmp_path, capsys):
    """``sdad --premix-paillier`` with ``SDA_PREMIX_DEVICE=1``: each clerk
    column (3 participations x 25 ciphertexts of a 512-bit key, above the
    floor of 64 modmuls) folds on ``--device cpu`` through K4's plain
    version, and the round reveals exactly. The daemon's metrics count
    the premixed columns."""
    import urllib.request

    import numpy as np

    vectors = np.random.default_rng(6).integers(0, 433, size=(3, 500))
    proc, url = _sdad(tmp_path, "--premix-paillier", "--metrics",
                      env={"SDA_PREMIX_DEVICE": "1"})
    try:
        got = _paillier_round(url, tmp_path / "agents", capsys, 500, vectors)
        assert got == " ".join(map(str, vectors.sum(axis=0) % 433))
        with urllib.request.urlopen(f"{url}/metrics") as resp:
            metrics = resp.read().decode()
        inputs = re.search(
            r'^sda_events_total\{name="server\.premix\.inputs"\} (\d+)$',
            metrics, re.MULTILINE)
        assert inputs is not None and int(inputs[1]) == 3 * 3, metrics
    finally:
        _stop(proc)


def test_sdad_premix_device_failure_is_not_hidden(tmp_path, capsys):
    """Without a card, ``sdad --device cuda`` with ``SDA_PREMIX_DEVICE=1``
    cannot premix: closing the round fails loudly instead of folding on
    the host (the reference falls back with a warning)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the device leg would run")
    import numpy as np

    from sda_tpu_torch.protocol.errors import ServerError

    vectors = np.random.default_rng(6).integers(0, 433, size=(3, 500))
    proc, url = _sdad(tmp_path, "--premix-paillier",
                      env={"SDA_PREMIX_DEVICE": "1"}, device="cuda")
    try:
        with pytest.raises(ServerError, match="CUDA is not available"):
            _paillier_round(url, tmp_path / "agents", capsys, 500, vectors)
    finally:
        _stop(proc)
    assert "CUDA is not available" in (tmp_path / "sdad.log").read_text()
