"""The recipe of ``tests/test_pipelining.py`` against the port, the roles
``SdaClient(..., device="cpu")`` over the port's memory server.

Snapshot pipelining: several rounds of one aggregation, independently.

SURVEY §2.4: the reference server supports multiple snapshots per
aggregation (server/src/server.rs:104-129) but its client never drives
them. Here the recipient can freeze successive participation sets with
``snapshot_aggregation`` and reveal each round by snapshot id: round A
(first two participants) and round B (all four) clerked and revealed
independently, each bit-exact for its own frozen set.
"""

import numpy as np
import pytest

from sda_tpu_torch.client import SdaClient
from sda_tpu_torch.crypto import MemoryKeystore
from sda_tpu_torch.protocol import (
    AdditiveSharing,
    Aggregation,
    AggregationId,
    FullMasking,
    SodiumEncryption,
)
from sda_tpu_torch.server import new_memory_server


def _client(service):
    ks = MemoryKeystore()
    c = SdaClient(SdaClient.new_agent(ks), ks, service, device="cpu")
    c.upload_agent()
    return c


def test_two_pipelined_snapshots_reveal_their_own_sets():
    service = new_memory_server()
    recipient = _client(service)
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    clerks = [_client(service) for _ in range(3)]
    for c in clerks:
        c.upload_encryption_key(c.new_encryption_key())

    agg = Aggregation(
        id=AggregationId.random(), title="pipeline", vector_dimension=4, modulus=433,
        recipient=recipient.agent.id, recipient_key=rkey,
        masking_scheme=FullMasking(433),
        committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    recipient.upload_aggregation(agg)
    recipient.begin_aggregation(agg.id)

    # round A: two participants
    for offset in (0, 1):
        _client(service).participate([1 + offset, 2, 3, 4], agg.id)
    snap_a = recipient.snapshot_aggregation(agg.id)
    for c in clerks + [recipient]:
        c.run_chores(-1)
    out_a = recipient.reveal_aggregation(agg.id, snapshot_id=snap_a)
    np.testing.assert_array_equal(out_a.positive().values, [3, 4, 6, 8])

    # round B: two more participants join; B's frozen set is all four
    for offset in (2, 3):
        _client(service).participate([1 + offset, 2, 3, 4], agg.id)
    snap_b = recipient.snapshot_aggregation(agg.id)
    for c in clerks + [recipient]:
        c.run_chores(-1)
    out_b = recipient.reveal_aggregation(agg.id, snapshot_id=snap_b)
    np.testing.assert_array_equal(out_b.positive().values, [10, 8, 12, 16])

    # round A's result is still addressable after B completed
    out_a2 = recipient.reveal_aggregation(agg.id, snapshot_id=snap_a)
    np.testing.assert_array_equal(out_a2.positive().values, [3, 4, 6, 8])

    # unknown snapshot id fails closed
    from sda_tpu_torch.protocol import NotFound, SnapshotId

    with pytest.raises(NotFound):
        recipient.reveal_aggregation(agg.id, snapshot_id=SnapshotId.random())
