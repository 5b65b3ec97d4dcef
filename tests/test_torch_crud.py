"""The recipes of ``tests/test_crud.py`` (CRUD and ACLs at the service
seam) against the port's server, on the memory, jsonfs, sqlite and fake
mongo backends. Every resource the port's store hands back is held to the
reference's wire object of the same resource."""

import pytest

from sda_tpu_torch.protocol import (
    AdditiveSharing,
    Aggregation,
    AggregationId,
    Committee,
    EncryptionKeyId,
    InvalidCredentials,
    InvalidRequest,
    NoMasking,
    NotFound,
    PermissionDenied,
    Profile,
    SodiumEncryption,
)
from sda_tpu_torch.server import auth_token

from torch_util import (new_agent, new_full_agent, new_key_for_agent,
                        open_service, to_reference)


@pytest.fixture(params=["memory", "jsonfs", "sqlite", "mongo"])
def service(request, tmp_path):
    return open_service(request.param, tmp_path)


def default_aggregation(recipient, key) -> Aggregation:
    return Aggregation(
        id=AggregationId.random(),
        title="foo",
        vector_dimension=4,
        modulus=433,
        recipient=recipient.id,
        recipient_key=key.body.id,
        masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=433),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )


def _same_wire(got, sent):
    """What the store returns is what was sent, as the reference reads it."""
    assert got == sent
    assert got.to_obj() == to_reference(sent).to_obj()


def test_ping(service):
    assert service.ping().running


def test_agent_crud(service):
    alice = new_agent()
    service.create_agent(alice, alice)
    _same_wire(service.get_agent(alice, alice.id), alice)
    assert service.get_agent(alice, new_agent().id) is None


def test_agent_create_spoof_denied(service):
    alice, bob = new_agent(), new_agent()
    with pytest.raises(PermissionDenied):
        service.create_agent(alice, bob)


def test_profile_upsert_and_spoof(service):
    alice = new_agent()
    service.create_agent(alice, alice)
    profile = Profile(owner=alice.id, name="Alice")
    service.upsert_profile(alice, profile)
    got = service.get_profile(alice, alice.id)
    assert got.name == "Alice"
    assert got.to_obj() == to_reference(profile).to_obj()
    service.upsert_profile(alice, Profile(owner=alice.id, name="Alice2"))
    assert service.get_profile(alice, alice.id).name == "Alice2"
    mallory = new_agent()
    service.create_agent(mallory, mallory)
    with pytest.raises(PermissionDenied):
        service.upsert_profile(mallory, Profile(owner=alice.id, name="Evil"))


def test_encryption_key_crud_and_spoof(service):
    alice = new_agent()
    service.create_agent(alice, alice)
    key = new_key_for_agent(alice)
    service.create_encryption_key(alice, key)
    _same_wire(service.get_encryption_key(alice, key.body.id), key)
    assert service.get_encryption_key(alice, EncryptionKeyId.random()) is None
    mallory = new_agent()
    with pytest.raises(PermissionDenied):
        service.create_encryption_key(mallory, new_key_for_agent(alice))


def test_aggregation_lifecycle_and_filters(service):
    alice, alice_key = new_full_agent(service)
    bob, bob_key = new_full_agent(service)

    agg1 = default_aggregation(alice, alice_key).replace(title="apples and pears")
    agg2 = default_aggregation(alice, alice_key).replace(title="apples only")
    agg3 = default_aggregation(bob, bob_key).replace(title="only pears")
    for caller, agg in [(alice, agg1), (alice, agg2), (bob, agg3)]:
        service.create_aggregation(caller, agg)
    _same_wire(service.get_aggregation(alice, agg1.id), agg1)

    def ids(listed):
        return {str(i) for i in listed}

    assert ids(service.list_aggregations(alice, filter="apples")) == ids([agg1.id, agg2.id])
    assert ids(service.list_aggregations(alice, filter="pears")) == ids([agg1.id, agg3.id])
    assert ids(service.list_aggregations(alice, recipient=bob.id)) == ids([agg3.id])
    assert ids(
        service.list_aggregations(alice, filter="pears", recipient=alice.id)
    ) == ids([agg1.id])

    with pytest.raises(PermissionDenied):
        service.delete_aggregation(bob, agg1.id)
    service.delete_aggregation(alice, agg1.id)
    assert service.get_aggregation(alice, agg1.id) is None
    with pytest.raises(NotFound):
        service.delete_aggregation(alice, agg1.id)


def test_aggregation_create_spoof_denied(service):
    alice, alice_key = new_full_agent(service)
    mallory = new_agent()
    with pytest.raises(PermissionDenied):
        service.create_aggregation(mallory, default_aggregation(alice, alice_key))


def test_committee_size_validation(service):
    alice, alice_key = new_full_agent(service)
    agg = default_aggregation(alice, alice_key)  # share_count=3
    service.create_aggregation(alice, agg)
    too_small = Committee(aggregation=agg.id,
                          clerks_and_keys=[(alice.id, alice_key.body.id)])
    with pytest.raises(InvalidRequest):
        service.create_committee(alice, too_small)


def test_auth_token_lifecycle(service):
    server = service.server
    alice = new_agent()
    service.create_agent(alice, alice)
    token = auth_token(alice.id, "sekrit-token")
    server.upsert_auth_token(token)
    assert server.check_auth_token(token) == alice
    with pytest.raises(InvalidCredentials):
        server.check_auth_token(auth_token(alice.id, "wrong"))
    server.delete_auth_token(alice.id)
    with pytest.raises(InvalidCredentials):
        server.check_auth_token(token)


def test_status_requires_recipient(service):
    alice, alice_key = new_full_agent(service)
    bob, _ = new_full_agent(service)
    agg = default_aggregation(alice, alice_key)
    service.create_aggregation(alice, agg)
    with pytest.raises(PermissionDenied):
        service.get_aggregation_status(bob, agg.id)
    status = service.get_aggregation_status(alice, agg.id)
    assert status.number_of_participations == 0 and status.snapshots == []
    assert status.to_obj() == to_reference(status).to_obj()
