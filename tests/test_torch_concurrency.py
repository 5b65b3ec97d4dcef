"""The recipes of ``tests/test_concurrency.py`` against the port's stores
and its HTTP seam: participations racing a snapshot, clerk results
racing their duplicates, agents registering at once, and competing job
pollers over REST, on the memory and sqlite backends. The invariants are
the reference's (a consistent frozen set, every job answered exactly
once, nothing lost), and every job the port hands out is read by the
reference as the same wire object."""

import threading

import pytest

from sda_tpu_torch.protocol import (
    AdditiveSharing,
    Aggregation,
    AggregationId,
    ClerkingResult,
    Committee,
    NoMasking,
    Participation,
    ParticipationId,
    Snapshot,
    SnapshotId,
    SodiumEncryption,
)

from torch_util import (mock_encryption, new_agent, new_full_agent,
                        open_service, to_reference)


@pytest.fixture(params=["memory", "sqlite"])
def service(request, tmp_path):
    return open_service(request.param, tmp_path)


def _world(service, clerks=3):
    recipient, recipient_key = new_full_agent(service)
    committee = [new_full_agent(service) for _ in range(clerks)]
    agg = Aggregation(
        id=AggregationId.random(), title="stress", vector_dimension=4,
        modulus=433, recipient=recipient.id,
        recipient_key=recipient_key.body.id,
        masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(share_count=clerks,
                                                 modulus=433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    service.create_aggregation(recipient, agg)
    service.create_committee(recipient, Committee(
        aggregation=agg.id,
        clerks_and_keys=[(a.id, k.body.id) for (a, k) in committee],
    ))
    return recipient, committee, agg


def _participate(service, agg, clerks):
    agent = new_agent()
    service.create_agent(agent, agent)
    participation = Participation(
        id=ParticipationId.random(), participant=agent.id, aggregation=agg.id,
        recipient_encryption=None,
        clerk_encryptions=[(a.id, mock_encryption(b"x")) for (a, _) in clerks],
    )
    service.create_participation(agent, participation)


def _run(target, args_list):
    errors = []

    def guarded(*args):
        try:
            target(*args)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=args)
               for args in args_list]
    for t in threads:
        t.start()
    return threads, errors


def test_concurrent_participations_race_snapshot(service):
    """60 participations from 6 threads racing one snapshot: the frozen set
    is a consistent subset and the total count ends exact."""
    recipient, committee, agg = _world(service)
    clerks = [c for (c, _) in committee]

    def worker():
        for _ in range(10):
            _participate(service, agg, committee)

    threads, errors = _run(worker, [()] * 6)
    service.create_snapshot(recipient, Snapshot(id=SnapshotId.random(),
                                                aggregation=agg.id))
    for t in threads:
        t.join()
    assert not errors
    status = service.get_aggregation_status(recipient, agg.id)
    assert status.number_of_participations == 60
    jobs = [service.get_clerking_job(clerk, clerk.id) for clerk in clerks]
    jobs = [j for j in jobs if j is not None]
    assert jobs, "snapshot must have enqueued clerk jobs"
    sizes = {len(j.encryptions) for j in jobs}
    assert len(sizes) == 1, f"clerks saw inconsistent frozen sets: {sizes}"
    assert 0 <= sizes.pop() <= 60
    for job in jobs:
        assert to_reference(job).to_obj() == job.to_obj()


def test_concurrent_clerk_results_exactly_once(service):
    """All clerks upload concurrently, each twice: every job ends done
    exactly once and the snapshot's results are complete."""
    recipient, committee, agg = _world(service, clerks=8)
    for _ in range(5):
        _participate(service, agg, committee)
    service.create_snapshot(recipient, Snapshot(id=SnapshotId.random(),
                                                aggregation=agg.id))

    def clerk_worker(agent):
        job = service.get_clerking_job(agent, agent.id)
        assert to_reference(job).to_obj() == job.to_obj()
        result = ClerkingResult(job=job.id, clerk=agent.id,
                                encryption=mock_encryption(b"sum"))
        service.create_clerking_result(agent, result)
        service.create_clerking_result(agent, result)  # duplicate upload

    threads, errors = _run(clerk_worker, [(a,) for (a, _) in committee])
    for t in threads:
        t.join()
    assert not errors
    status = service.get_aggregation_status(recipient, agg.id)
    assert status.snapshots[0].number_of_clerking_results == 8
    assert status.snapshots[0].result_ready
    assert to_reference(status).to_obj() == status.to_obj()
    for (agent, _) in committee:
        assert service.get_clerking_job(agent, agent.id) is None


def test_concurrent_agent_registration(service):
    agents = [new_agent() for _ in range(40)]
    threads, errors = _run(lambda a: service.create_agent(a, a),
                           [(a,) for a in agents])
    for t in threads:
        t.join()
    assert not errors
    for a in agents:
        got = service.get_agent(a, a.id)
        assert got == a
        assert to_reference(got).to_obj() == a.to_obj()


def test_http_transport_concurrent_job_polling(tmp_path):
    """The REST seam under contention: competing pollers of one clerk all
    see its one job (a poll leaves it queued until its result lands),
    racing results settle exactly once, and the queue then reads empty
    for everyone."""
    from sda_tpu_torch.http import SdaHttpClient, SdaHttpServer
    from sda_tpu_torch.server import new_memory_server
    from sda_tpu_torch.store import Filebased

    http_server = SdaHttpServer(new_memory_server(),
                                bind="127.0.0.1:0").start_background()
    try:
        service = SdaHttpClient(http_server.address,
                                store=Filebased(tmp_path / "tokens"))
        recipient, committee, agg = _world(service, clerks=4)
        for _ in range(12):
            _participate(service, agg, committee)
        service.create_snapshot(recipient, Snapshot(id=SnapshotId.random(),
                                                    aggregation=agg.id))
        polled, lock = [], threading.Lock()

        def clerk_worker(clerk):
            job = service.get_clerking_job(clerk, clerk.id)
            if job is not None:
                with lock:
                    polled.append((clerk.id, job.id))
                service.create_clerking_result(clerk, ClerkingResult(
                    job=job.id, clerk=clerk.id,
                    encryption=mock_encryption(b"sum")))

        threads, errors = _run(clerk_worker, [
            (clerk,) for (clerk, _) in committee for _ in range(3)])
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "worker hung"
        assert not errors
        jobs_by_clerk = {}
        for clerk_id, job_id in polled:
            jobs_by_clerk.setdefault(clerk_id, set()).add(job_id)
        assert all(len(v) == 1 for v in jobs_by_clerk.values()), jobs_by_clerk
        status = service.get_aggregation_status(recipient, agg.id)
        assert status.snapshots[0].number_of_clerking_results == len(committee)
        assert status.snapshots[0].result_ready
        for (clerk, _) in committee:
            assert service.get_clerking_job(clerk, clerk.id) is None
    finally:
        http_server.shutdown()
