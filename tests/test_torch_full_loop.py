"""The golden end-to-end conformance suite of tests/test_full_loop.py, run
through the port's protocol stack (``sda_tpu_torch``): real crypto, 1
recipient + 8 clerks + 2 participants, every reveal exactly [2, 4, 6, 8].

Every role is an ``SdaClient(..., device="cpu")``. Each test runs over the
memory, jsonfs, sqlite, fake-mongo and HTTP services, and at the sharing
module's ``HOST_PATH_MAX`` default (these tiny vectors take the numpy
oracle) and at 0 (every share, combine, reconstruct and mask op takes the
torch path).
"""

import numpy as np
import pytest

from sda_tpu_torch.client import SdaClient
from sda_tpu_torch.crypto import MemoryKeystore, sharing
from sda_tpu_torch.protocol import (
    AdditiveSharing,
    Aggregation,
    AggregationId,
    AgentId,
    BasicShamirSharing,
    ChaChaMasking,
    EncryptionKeyId,
    FullMasking,
    NoMasking,
    PackedShamirSharing,
    SodiumEncryption,
)
from sda_tpu_torch.server import (
    new_jsonfs_server,
    new_memory_server,
    new_mongo_server,
    new_sqlite_server,
)
from sda_tpu_torch.store import Filebased


def agg_default() -> Aggregation:
    return Aggregation(
        id=AggregationId.random(),
        title="foo",
        vector_dimension=4,
        modulus=433,
        recipient=AgentId.random(),
        recipient_key=EncryptionKeyId.random(),
        masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )


def new_client(service):
    keystore = MemoryKeystore()
    agent = SdaClient.new_agent(keystore)
    return SdaClient(agent, keystore, service, device="cpu")


def _prepare(aggregation, service):
    """Recipient with its aggregation uploaded, and 8 clerks with keys."""
    recipient = new_client(service)
    recipient_key = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(recipient_key)
    aggregation = aggregation.replace(
        recipient=recipient.agent.id, recipient_key=recipient_key
    )
    recipient.upload_aggregation(aggregation)
    clerks = [new_client(service) for _ in range(8)]
    for clerk in clerks:
        clerk_key = clerk.new_encryption_key()
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk_key)
    recipient.begin_aggregation(aggregation.id)
    return aggregation, recipient, clerks


def _participate(aggregation, service, count=2):
    for _ in range(count):
        participant = new_client(service)
        participant.upload_agent()
        participant.participate([1, 2, 3, 4], aggregation.id)


def check_full_aggregation(aggregation: Aggregation, service):
    aggregation, recipient, clerks = _prepare(aggregation, service)
    _participate(aggregation, service)
    recipient.end_aggregation(aggregation.id)

    status = service.get_aggregation_status(recipient.agent, aggregation.id)
    assert status.aggregation == aggregation.id
    assert status.number_of_participations == 2
    assert len(status.snapshots) == 1
    assert status.snapshots[0].number_of_clerking_results == 0
    assert not status.snapshots[0].result_ready

    # the recipient registered a key too, so it may sit on the committee
    recipient.run_chores(-1)
    for clerk in clerks:
        clerk.run_chores(-1)

    status = service.get_aggregation_status(recipient.agent, aggregation.id)
    committee_size = aggregation.committee_sharing_scheme.output_size
    assert status.snapshots[0].number_of_clerking_results == committee_size
    assert status.snapshots[0].result_ready

    output = recipient.reveal_aggregation(aggregation.id)
    np.testing.assert_array_equal(output.positive().values, [2, 4, 6, 8])


@pytest.fixture(params=["default", "zero"])
def host_path_max(request, monkeypatch):
    """``HOST_PATH_MAX`` at its default, or 0 so the torch path runs."""
    if request.param == "zero":
        monkeypatch.setattr(sharing, "HOST_PATH_MAX", 0)
    return sharing.HOST_PATH_MAX


@pytest.fixture(params=["memory", "jsonfs", "sqlite", "mongo", "http"])
def service(request, tmp_path, host_path_max):
    if request.param == "memory":
        yield new_memory_server()
    elif request.param == "mongo":
        from fake_mongo import FakeDatabase

        yield new_mongo_server(FakeDatabase())
    elif request.param == "sqlite":
        yield new_sqlite_server(tmp_path / "sda.db")
    elif request.param == "jsonfs":
        yield new_jsonfs_server(tmp_path)
    else:
        from sda_tpu_torch.http import SdaHttpClient, SdaHttpServer

        http_server = SdaHttpServer(new_memory_server(), bind="127.0.0.1:0")
        http_server.start_background()
        yield SdaHttpClient(http_server.address,
                            store=Filebased(tmp_path / "tokens"))
        http_server.shutdown()


def test_simple(service):
    check_full_aggregation(agg_default(), service)


def test_with_fullmask(service):
    check_full_aggregation(
        agg_default().replace(masking_scheme=FullMasking(modulus=433)), service
    )


def test_with_chachamask(service):
    check_full_aggregation(
        agg_default().replace(
            masking_scheme=ChaChaMasking(modulus=433, dimension=4,
                                         seed_bitsize=128)
        ),
        service,
    )


def test_with_packedshamir(service):
    check_full_aggregation(
        agg_default().replace(
            committee_sharing_scheme=PackedShamirSharing(
                secret_count=3,
                share_count=8,
                privacy_threshold=4,
                prime_modulus=433,
                omega_secrets=354,
                omega_shares=150,
            )
        ),
        service,
    )


def test_with_basicshamir(service):
    """BasicShamir 3-of-5 with ChaCha masking through the whole stack."""
    check_full_aggregation(
        agg_default().replace(
            committee_sharing_scheme=BasicShamirSharing(
                share_count=5, privacy_threshold=2, prime_modulus=433,
            ),
            masking_scheme=ChaChaMasking(433, 4, 128),
        ),
        service,
    )


def test_packedshamir_with_clerk_dropout(service):
    """One committee member never does its job: the recipient reconstructs
    from the 7 of 8 survivors (threshold t+k = 7)."""
    aggregation, recipient, clerks = _prepare(
        agg_default().replace(
            committee_sharing_scheme=PackedShamirSharing(3, 8, 4, 433, 354, 150)
        ),
        service,
    )
    _participate(aggregation, service)
    recipient.end_aggregation(aggregation.id)

    committee = service.get_committee(recipient.agent, aggregation.id)
    committee_ids = {cid for cid, _ in committee.clerks_and_keys}
    workers = [recipient] + clerks
    dropped = next(w for w in workers if w.agent.id in committee_ids)
    for worker in workers:
        if worker is not dropped:
            worker.run_chores(-1)

    status = service.get_aggregation_status(recipient.agent, aggregation.id)
    assert status.snapshots[0].number_of_clerking_results == 7
    assert status.snapshots[0].result_ready

    output = recipient.reveal_aggregation(aggregation.id)
    np.testing.assert_array_equal(output.positive().values, [2, 4, 6, 8])


def test_clerk_device_tiles_not_ported(monkeypatch):
    """``SDA_CLERK_DEVICE_TILES=1`` folds every clerk's bundles into a
    ``DeviceTileCombiner`` on the clerk's device (here the CPU), and the
    round reveals what the share combiner's fold reveals."""
    from sda_tpu_torch.utils import metrics

    monkeypatch.setenv("SDA_CLERK_DEVICE_TILES", "1")
    metrics.reset_counters()
    check_full_aggregation(agg_default(), new_memory_server())
    assert metrics.counter_report("clerk.device_tiles.").get(
        "clerk.device_tiles.bundle") == 3