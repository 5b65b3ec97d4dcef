"""The recipes of ``tests/test_crash_resume.py`` against the port: the
"durable the moment it exists" claim of the port's server
(``sda_tpu_torch/server/core.py``), the roles ``SdaClient(...,
device="cpu")``.

A round is started on a durable backend (sqlite / jsonfs), the server
"process" is dropped MID-ROUND — after participations landed, before the
snapshot — by discarding every live server object (and closing the sqlite
handle), then the store is reopened by a brand-new server and the round
must complete bit-exactly. The reference's checkpoint/resume story
(SURVEY.md §5.4) is exactly this: restart resumes from the store tree.
"""

import numpy as np
import pytest

from sda_tpu_torch.client import SdaClient
from sda_tpu_torch.crypto import MemoryKeystore
from sda_tpu_torch.protocol import (
    Aggregation,
    AggregationId,
    FullMasking,
    PackedShamirSharing,
    SodiumEncryption,
)
from sda_tpu_torch.server import new_jsonfs_server, new_sqlite_server

from torch_util import to_reference

GOLDEN = PackedShamirSharing(
    secret_count=3, share_count=8, privacy_threshold=4,
    prime_modulus=433, omega_secrets=354, omega_shares=150,
)


def _open_server(backend, tmp_path):
    if backend == "sqlite":
        return new_sqlite_server(tmp_path / "server.db")
    return new_jsonfs_server(tmp_path / "store")


def _drop_server(service):
    """Simulate losing the server process: every in-memory handle dies.
    For sqlite, close the connection so nothing survives but the file."""
    db = getattr(service.server.agents_store, "db", None)
    if db is not None:
        db.conn.close()


@pytest.mark.parametrize("backend", ["sqlite", "jsonfs"])
def test_round_survives_server_crash_between_participation_and_snapshot(
    backend, tmp_path
):
    # --- life 1: setup + participations --------------------------------
    service = _open_server(backend, tmp_path)

    def new_client(svc):
        keystore = MemoryKeystore()
        client = SdaClient(SdaClient.new_agent(keystore), keystore, svc,
                           device="cpu")
        client.upload_agent()
        return client

    recipient = new_client(service)
    recipient_key = recipient.new_encryption_key()
    recipient.upload_encryption_key(recipient_key)

    # client objects (and their keystores) survive: the CRASH is server-side
    clients = {recipient.agent.id: recipient}
    for _ in range(GOLDEN.share_count):
        clerk = new_client(service)
        clerk.upload_encryption_key(clerk.new_encryption_key())
        clients[clerk.agent.id] = clerk

    agg = Aggregation(
        id=AggregationId.random(), title="crash-resume",
        vector_dimension=4, modulus=433,
        recipient=recipient.agent.id, recipient_key=recipient_key,
        masking_scheme=FullMasking(433),
        committee_sharing_scheme=GOLDEN,
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    recipient.upload_aggregation(agg)
    recipient.begin_aggregation(agg.id)

    for offset in range(3):
        participant = new_client(service)
        participant.participate(
            [1 + offset, 2 + offset, 3 + offset, 4 + offset], agg.id
        )

    # --- the crash: between participation and snapshot ------------------
    _drop_server(service)
    del service

    # --- life 2: reopen the store, finish the round ---------------------
    resumed = _open_server(backend, tmp_path)
    for client in clients.values():
        client.service = resumed  # same agents, new server process

    status = resumed.get_aggregation_status(recipient.agent, agg.id)
    assert status.number_of_participations == 3  # durable the moment it existed
    assert status.to_obj() == to_reference(status).to_obj()

    recipient.end_aggregation(agg.id)  # snapshot on the resumed server
    committee = resumed.get_committee(recipient.agent, agg.id)
    for clerk_id, _ in committee.clerks_and_keys:
        clients[clerk_id].run_chores(-1)

    output = recipient.reveal_aggregation(agg.id)
    # sum over participants of [1+o, 2+o, 3+o, 4+o], o in 0..2
    np.testing.assert_array_equal(output.positive().values, [6, 9, 12, 15])


@pytest.mark.parametrize("backend", ["sqlite", "jsonfs"])
def test_round_survives_server_crash_after_snapshot(backend, tmp_path):
    """Second crash point: snapshot (and its job queue) already durable;
    the resumed server only serves clerking and the reveal."""
    service = _open_server(backend, tmp_path)

    def new_client(svc):
        keystore = MemoryKeystore()
        client = SdaClient(SdaClient.new_agent(keystore), keystore, svc,
                           device="cpu")
        client.upload_agent()
        return client

    recipient = new_client(service)
    recipient_key = recipient.new_encryption_key()
    recipient.upload_encryption_key(recipient_key)
    clients = {recipient.agent.id: recipient}
    for _ in range(GOLDEN.share_count):
        clerk = new_client(service)
        clerk.upload_encryption_key(clerk.new_encryption_key())
        clients[clerk.agent.id] = clerk

    agg = Aggregation(
        id=AggregationId.random(), title="crash-after-snapshot",
        vector_dimension=4, modulus=433,
        recipient=recipient.agent.id, recipient_key=recipient_key,
        masking_scheme=FullMasking(433),
        committee_sharing_scheme=GOLDEN,
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    recipient.upload_aggregation(agg)
    recipient.begin_aggregation(agg.id)
    for offset in range(2):
        participant = new_client(service)
        participant.participate(
            [1 + offset, 2 + offset, 3 + offset, 4 + offset], agg.id
        )
    recipient.end_aggregation(agg.id)  # snapshot enqueued in life 1

    _drop_server(service)
    del service

    resumed = _open_server(backend, tmp_path)
    for client in clients.values():
        client.service = resumed

    committee = resumed.get_committee(recipient.agent, agg.id)
    for clerk_id, _ in committee.clerks_and_keys:
        clients[clerk_id].run_chores(-1)
    output = recipient.reveal_aggregation(agg.id)
    np.testing.assert_array_equal(output.positive().values, [3, 5, 7, 9])
