"""The recipes of ``tests/test_service.py`` (the server's scheduling
machine with mocked ciphertexts: 100 participants, the snapshot's
transpose into each clerk's column, the job queue's drain, result_ready
at the threshold, late arrivals, ACLs) against the port's server on the
memory, jsonfs, sqlite and fake mongo backends. Each clerking job and
snapshot result the port serves is held to the reference's wire object of
the same resource."""

import pytest

from sda_tpu_torch.protocol import (
    AdditiveSharing,
    Aggregation,
    AggregationId,
    ClerkingResult,
    Committee,
    FullMasking,
    NoMasking,
    NotFound,
    Participation,
    ParticipationId,
    PermissionDenied,
    Snapshot,
    SnapshotId,
    SodiumEncryption,
)
from torch_util import (mock_encryption, new_agent, new_full_agent,
                        open_service, to_reference)

N_PARTICIPANTS = 100
N_CLERKS = 3


@pytest.fixture(params=["memory", "jsonfs", "sqlite", "mongo"])
def service(request, tmp_path):
    return open_service(request.param, tmp_path)


def build_world(service, masking=False):
    recipient, recipient_key = new_full_agent(service)
    clerks = [new_full_agent(service) for _ in range(N_CLERKS)]
    agg = Aggregation(
        id=AggregationId.random(),
        title="scale-test",
        vector_dimension=4,
        modulus=433,
        recipient=recipient.id,
        recipient_key=recipient_key.body.id,
        masking_scheme=FullMasking(433) if masking else NoMasking(),
        committee_sharing_scheme=AdditiveSharing(share_count=N_CLERKS, modulus=433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    service.create_aggregation(recipient, agg)
    committee = Committee(
        aggregation=agg.id,
        clerks_and_keys=[(a.id, k.body.id) for (a, k) in clerks],
    )
    service.create_committee(recipient, committee)
    return recipient, clerks, agg, committee


def participate_all(service, agg, masking=False):
    participants = []
    for i in range(N_PARTICIPANTS):
        p_agent = new_agent()
        service.create_agent(p_agent, p_agent)
        participation = Participation(
            id=ParticipationId.random(),
            participant=p_agent.id,
            aggregation=agg.id,
            recipient_encryption=(
                mock_encryption(f"mask-{i}".encode()) if masking else None
            ),
            clerk_encryptions=[
                (None, mock_encryption(f"p{i}-c{c}".encode())) for c in range(N_CLERKS)
            ],
        )
        # clerk ids in clerk_encryptions are positional on the server side;
        # fill with the participant id (the transpose never reads them)
        participation.clerk_encryptions = [
            (p_agent.id, e) for (_, e) in participation.clerk_encryptions
        ]
        service.create_participation(p_agent, participation)
        participants.append(p_agent)
    return participants


def test_snapshot_transpose_and_drain(service):
    recipient, clerks, agg, committee = build_world(service)
    participate_all(service, agg)

    status = service.get_aggregation_status(recipient, agg.id)
    assert status.number_of_participations == N_PARTICIPANTS

    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    service.create_snapshot(recipient, snap)

    # each clerk's job holds exactly its own column of the matrix
    # (reference assertion: service.rs:89-92)
    for c, (clerk, _) in enumerate(clerks):
        job = service.get_clerking_job(clerk, clerk.id)
        assert job is not None and job.clerk == clerk.id and job.snapshot == snap.id
        assert job.to_obj() == to_reference(job).to_obj()
        payloads = {bytes(e.value.data) for e in job.encryptions}
        assert payloads == {f"p{i}-c{c}".encode() for i in range(N_PARTICIPANTS)}

        # posting the result drains the queue
        service.create_clerking_result(
            clerk,
            ClerkingResult(job=job.id, clerk=clerk.id, encryption=mock_encryption(b"sum")),
        )
        assert service.get_clerking_job(clerk, clerk.id) is None

        status = service.get_aggregation_status(recipient, agg.id)
        snap_status = status.snapshots[0]
        assert snap_status.number_of_clerking_results == c + 1
        # ready exactly when reconstruction_threshold (= n for additive) reached
        assert snap_status.result_ready == (c + 1 >= N_CLERKS)

    result = service.get_snapshot_result(recipient, agg.id, snap.id)
    assert result.to_obj() == to_reference(result).to_obj()
    assert result.number_of_participations == N_PARTICIPANTS
    assert len(result.clerk_encryptions) == N_CLERKS
    assert {str(r.clerk) for r in result.clerk_encryptions} == {
        str(c.id) for c, _ in clerks
    }
    assert result.recipient_encryptions is None  # no masking


def test_snapshot_collects_masks(service):
    recipient, clerks, agg, _ = build_world(service, masking=True)
    participate_all(service, agg, masking=True)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    service.create_snapshot(recipient, snap)
    result = service.get_snapshot_result(recipient, agg.id, snap.id)
    masks = {bytes(e.value.data) for e in result.recipient_encryptions}
    assert masks == {f"mask-{i}".encode() for i in range(N_PARTICIPANTS)}


def test_late_participation_excluded_from_snapshot(service):
    """The snapshot freezes its set; late arrivals join the next round."""
    recipient, clerks, agg, _ = build_world(service)
    participate_all(service, agg)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    service.create_snapshot(recipient, snap)

    late = new_agent()
    service.create_agent(late, late)
    service.create_participation(
        late,
        Participation(
            id=ParticipationId.random(),
            participant=late.id,
            aggregation=agg.id,
            recipient_encryption=None,
            clerk_encryptions=[(late.id, mock_encryption(b"late")) for _ in range(N_CLERKS)],
        ),
    )
    result = service.get_snapshot_result(recipient, agg.id, snap.id)
    assert result.number_of_participations == N_PARTICIPANTS  # frozen set

    snap2 = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    service.create_snapshot(recipient, snap2)
    result2 = service.get_snapshot_result(recipient, agg.id, snap2.id)
    assert result2.number_of_participations == N_PARTICIPANTS + 1


def test_snapshot_result_requires_matching_snapshot(service):
    """Regression: a snapshot id from another aggregation (or a bogus one)
    must not leak artifacts — the result is None unless the snapshot belongs
    to the queried aggregation."""
    recipient, clerks, agg, _ = build_world(service)
    participate_all(service, agg)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    service.create_snapshot(recipient, snap)

    assert service.get_snapshot_result(recipient, agg.id, SnapshotId.random()) is None

    # second aggregation owned by someone else; its recipient must not read
    # the first aggregation's snapshot through their own aggregation id
    other_recipient, other_key = new_full_agent(service)
    other_agg = Aggregation(
        id=AggregationId.random(),
        title="other",
        vector_dimension=4,
        modulus=433,
        recipient=other_recipient.id,
        recipient_key=other_key.body.id,
        masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(share_count=N_CLERKS, modulus=433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    service.create_aggregation(other_recipient, other_agg)
    assert service.get_snapshot_result(other_recipient, other_agg.id, snap.id) is None


def test_clerking_result_spoof_denied(service):
    recipient, clerks, agg, _ = build_world(service)
    participate_all(service, agg)
    snap = Snapshot(id=SnapshotId.random(), aggregation=agg.id)
    service.create_snapshot(recipient, snap)

    (clerk0, _), (clerk1, _) = clerks[0], clerks[1]
    job0 = service.get_clerking_job(clerk0, clerk0.id)
    # clerk1 cannot post a result for clerk0's job (server.rs:351-360)
    with pytest.raises((PermissionDenied, NotFound)):
        service.create_clerking_result(
            clerk1,
            ClerkingResult(job=job0.id, clerk=clerk0.id, encryption=mock_encryption(b"x")),
        )
    # clerk1 cannot poll clerk0's queue either
    with pytest.raises(PermissionDenied):
        service.get_clerking_job(clerk1, clerk0.id)


def test_participation_to_unknown_aggregation(service):
    p = new_agent()
    service.create_agent(p, p)
    with pytest.raises(NotFound):
        service.create_participation(
            p,
            Participation(
                id=ParticipationId.random(),
                participant=p.id,
                aggregation=AggregationId.random(),
                recipient_encryption=None,
                clerk_encryptions=[],
            ),
        )


def test_participation_retry_deduped(service):
    """Same participation id uploaded twice counts once (resources.rs:93-101)."""
    recipient, clerks, agg, _ = build_world(service)
    p = new_agent()
    service.create_agent(p, p)
    participation = Participation(
        id=ParticipationId.random(),
        participant=p.id,
        aggregation=agg.id,
        recipient_encryption=None,
        clerk_encryptions=[(p.id, mock_encryption(b"x")) for _ in range(N_CLERKS)],
    )
    service.create_participation(p, participation)
    service.create_participation(p, participation)  # network retry
    status = service.get_aggregation_status(recipient, agg.id)
    assert status.number_of_participations == 1
