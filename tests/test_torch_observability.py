"""Twin of ``tests/test_observability.py`` on the port: phase timing,
counters and logging setup.

The reference file's recipes run against ``sda_tpu_torch``, the round's
clients on ``device="cpu"``. Where both packages produce a result, the two
are held equal: the round's revealed output, the set of protocol phases it
timed with their call counts, and the server counters the reference pins;
the HTTP server's per-status counters and log lines for the same requests.
"""

import logging

import numpy as np
import pytest

from sda_tpu import utils as ref_utils
from sda_tpu.crypto import sodium
from sda_tpu_torch.utils import (
    configure_logging,
    count,
    counter_report,
    phase_report,
    reset_counters,
    reset_phase_report,
    timed_phase,
)

#: the protocol phases a full round times (the reference file's list)
PHASES = (
    "participant.mask", "participant.share", "participant.encrypt",
    "server.snapshot_freeze", "server.transpose", "server.enqueue_jobs",
    "clerk.decrypt", "clerk.combine", "clerk.encrypt",
    "recipient.combine_masks", "recipient.decrypt_results",
    "recipient.reconstruct", "recipient.unmask",
)


def test_counter_registry_basics():
    reset_counters()
    count("unit.a")
    count("unit.a", 2)
    count("unit.b")
    count("other.c")
    assert counter_report()["unit.a"] == 3
    assert counter_report("unit.") == {"unit.a": 3, "unit.b": 1}
    reset_counters()
    assert counter_report() == {}


def test_timed_phase_accumulates():
    reset_phase_report()
    for _ in range(3):
        with timed_phase("unit.test_phase"):
            pass
    report = phase_report()
    stat = report["unit.test_phase"]
    assert stat["count"] == 3
    assert stat["total_s"] >= 0.0
    assert stat["min_s"] <= stat["mean_s"] <= stat["max_s"]


def test_timed_phase_records_on_exception():
    reset_phase_report()
    with pytest.raises(RuntimeError):
        with timed_phase("unit.failing_phase"):
            raise RuntimeError("boom")
    assert phase_report()["unit.failing_phase"]["count"] == 1


def _full_round(pkg, **client_kw):
    """The reference file's round (3 additive clerks, Full masks, two
    participants over the memory server) through ``pkg`` (``sda_tpu`` or
    ``sda_tpu_torch``); returns the revealed values, the phase report and
    the ``server.`` counters."""
    import importlib

    client_mod = importlib.import_module(f"{pkg}.client")
    crypto = importlib.import_module(f"{pkg}.crypto")
    protocol = importlib.import_module(f"{pkg}.protocol")
    server = importlib.import_module(f"{pkg}.server")
    utils = importlib.import_module(f"{pkg}.utils")
    utils.reset_phase_report()
    utils.reset_counters()
    service = server.new_memory_server()

    def new_client():
        keystore = crypto.MemoryKeystore()
        agent = client_mod.SdaClient.new_agent(keystore)
        client = client_mod.SdaClient(agent, keystore, service, **client_kw)
        client.upload_agent()
        return client

    recipient = new_client()
    recipient_key = recipient.new_encryption_key()
    recipient.upload_encryption_key(recipient_key)
    clerks = []
    for _ in range(3):
        clerk = new_client()
        clerk.upload_encryption_key(clerk.new_encryption_key())
        clerks.append(clerk)

    aggregation = protocol.Aggregation(
        id=protocol.AggregationId.random(), title="timing",
        vector_dimension=4, modulus=433,
        recipient=recipient.agent.id, recipient_key=recipient_key,
        masking_scheme=protocol.FullMasking(433),
        committee_sharing_scheme=protocol.AdditiveSharing(share_count=3,
                                                          modulus=433),
        recipient_encryption_scheme=protocol.SodiumEncryption(),
        committee_encryption_scheme=protocol.SodiumEncryption(),
    )
    recipient.upload_aggregation(aggregation)
    recipient.begin_aggregation(aggregation.id)
    for offset in range(2):
        new_client().participate([1 + offset, 2, 3, 4], aggregation.id)
    recipient.end_aggregation(aggregation.id)
    for clerk in clerks + [recipient]:
        clerk.run_chores(-1)
    output = recipient.reveal_aggregation(aggregation.id)
    return (output.positive().values, utils.phase_report(),
            utils.counter_report("server."))


@pytest.mark.skipif(not sodium.available(), reason="libsodium not present")
def test_full_round_populates_all_protocol_phases():
    values, report, counters = _full_round("sda_tpu_torch", device="cpu")
    np.testing.assert_array_equal(values, [3, 4, 6, 8])
    for phase in PHASES:
        assert phase in report, f"missing phase {phase}"
        assert report[phase]["count"] >= 1
    assert report["participant.share"]["count"] == 2  # one per participant
    assert report["clerk.combine"]["count"] == 3      # one per committee clerk

    assert counters["server.participation.created"] == 2
    assert counters["server.snapshot.created"] == 1
    assert counters["server.clerking_result.created"] == 3
    assert counters["server.job.polled"] == 3
    assert counters["server.job.poll_empty"] >= 1  # run_chores drains to empty

    # the reference's round: the same output, the same phases with the
    # same call counts, the same pinned counters
    ref_values, ref_report, ref_counters = _full_round("sda_tpu")
    np.testing.assert_array_equal(ref_values, values)
    assert {name: stat["count"] for name, stat in ref_report.items()} == \
        {name: stat["count"] for name, stat in report.items()}
    for key in ("server.participation.created", "server.snapshot.created",
                "server.clerking_result.created", "server.job.polled"):
        assert ref_counters[key] == counters[key], key
    ref_utils.reset_phase_report()
    ref_utils.reset_counters()


def _status_lines(pkg):
    """Two requests (a ping, an unknown route) against ``pkg``'s HTTP
    server; returns its status counts, ``http.`` counters and log lines."""
    import importlib
    import io
    import urllib.request

    http_server = importlib.import_module(f"{pkg}.http.server")
    server = importlib.import_module(f"{pkg}.server")
    utils = importlib.import_module(f"{pkg}.utils")
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    http_log = logging.getLogger(f"{pkg}.http.server")
    http_log.addHandler(handler)
    old_level = http_log.level
    http_log.setLevel(logging.INFO)
    utils.reset_counters()
    srv = http_server.SdaHttpServer(server.new_memory_server(),
                                    bind="127.0.0.1:0").start_background()
    try:
        urllib.request.urlopen(srv.address + "/v1/ping").read()
        try:
            urllib.request.urlopen(srv.address + "/v1/nonexistent")
        except urllib.error.HTTPError:
            pass
        return (dict(srv.status_counts), utils.counter_report("http."),
                buf.getvalue().strip().splitlines())
    finally:
        srv.shutdown()
        http_log.removeHandler(handler)
        http_log.setLevel(old_level)
        utils.reset_counters()


def test_http_request_status_logging_and_counters():
    """Per-request status lines + status counters (reference analog:
    server-http/src/lib.rs:105-122 logs method/path/status per request)."""
    counts, globals_, lines = _status_lines("sda_tpu_torch")
    assert counts.get(200) == 1
    assert counts.get(401) == 1  # unknown route without auth -> 401
    assert globals_["http.request"] == 2
    assert globals_["http.status.200"] == 1
    assert globals_["http.status.401"] == 1
    assert any("GET /v1/ping -> 200" in line for line in lines)
    assert any("-> 401" in line for line in lines)
    ref_counts, ref_globals, ref_lines = _status_lines("sda_tpu")
    assert ref_counts == counts
    assert {k: v for k, v in ref_globals.items() if "seconds" not in k} == \
        {k: v for k, v in globals_.items() if "seconds" not in k}
    assert len(ref_lines) == len(lines)


def test_configure_logging_levels():
    configure_logging(0)
    assert logging.getLogger().level == logging.WARNING
    logging.getLogger().setLevel(logging.DEBUG)
    configure_logging(2)  # basicConfig won't reconfigure, but must not raise
    logging.getLogger().setLevel(logging.WARNING)
