"""The recipes of ``tests/test_fault_tolerance.py`` (clerk dropout and
quorum reconstruction) against the port: every minimal subset of the
8 clerk rows reconstructs through the port's oracle exactly as through
the reference's; an 80-clerk committee reconstructs through one device
contraction shape whatever the survivor set, bit for bit as the
reference; and full rounds of ``SdaClient(..., device="cpu")`` over the
port's memory server reveal exactly at quorum, fail closed below it and
complete when a straggler clerk wakes up.
"""

import itertools

import numpy as np
import pytest

from sda_tpu.crypto.sharing import PackedShamirReconstructor as RefReconstructor
from sda_tpu.fields import oracle as ref_oracle
from sda_tpu.protocol import PackedShamirSharing as RefPackedShamir
from sda_tpu_torch import fields
from sda_tpu_torch.client import SdaClient
from sda_tpu_torch.crypto import MemoryKeystore, sharing
from sda_tpu_torch.crypto.sharing import PackedShamirReconstructor
from sda_tpu_torch.fields import numtheory, oracle
from sda_tpu_torch.protocol import (
    Aggregation,
    AggregationId,
    FullMasking,
    NoMasking,
    NotFound,
    PackedShamirSharing,
    SodiumEncryption,
)
from sda_tpu_torch.server import new_memory_server

GOLDEN = PackedShamirSharing(
    secret_count=3, share_count=8, privacy_threshold=4,
    prime_modulus=433, omega_secrets=354, omega_shares=150,
)
REF_GOLDEN = RefPackedShamir(3, 8, 4, 433, 354, 150)


# ---------------------------------------------------------------------------
# the quorum property of the sharing itself

def test_packed_reconstruct_every_minimal_subset():
    """share -> reconstruct == id for ALL size-7 subsets of 8 clerk rows,
    and the port's oracle gives the reference's values on each subset."""
    s = GOLDEN
    rng = np.random.default_rng(7)
    secrets = rng.integers(0, s.prime_modulus, size=11)
    B = -(-len(secrets) // s.secret_count)
    randomness = rng.integers(0, s.prime_modulus, size=(s.privacy_threshold, B))
    shares = oracle.packed_share_from_randomness(secrets, randomness, s)
    np.testing.assert_array_equal(
        shares, ref_oracle.packed_share_from_randomness(
            secrets, randomness, REF_GOLDEN))
    r = s.reconstruction_threshold
    assert r == 7
    for subset in itertools.combinations(range(s.share_count), r):
        got = oracle.packed_reconstruct(
            subset, shares[list(subset)], s, dimension=len(secrets))
        np.testing.assert_array_equal(got, secrets)


def test_packed_reconstruct_below_quorum_rejected():
    s = GOLDEN
    with pytest.raises(ValueError, match="need at least"):
        numtheory.packed_reconstruct_matrix(
            s.secret_count, s.share_count, s.privacy_threshold,
            s.prime_modulus, s.omega_secrets, s.omega_shares,
            tuple(range(s.reconstruction_threshold - 1)),
        )


def test_large_committee_one_reconstruct_shape(monkeypatch):
    """80-clerk committee (81 = 3^4 share points): reconstruction across
    many survivor sets and counts truncates each to the threshold, so the
    device contraction sees ONE [r, B] shape (the reference's one compiled
    kernel), and each reconstruct equals the reference's on the same
    survivors."""
    monkeypatch.setattr(sharing, "HOST_PATH_MAX", 0)
    shapes = []
    contraction = fields.packed_reconstruct

    def recorded(shares, recon_matrix, **kw):
        shapes.append(tuple(shares.shape))
        return contraction(shares, recon_matrix, **kw)

    monkeypatch.setattr(fields, "packed_reconstruct", recorded)

    t, p, w2, w3 = numtheory.generate_packed_params(3, 80, 20)
    s = PackedShamirSharing(3, 80, t, p, w2, w3)
    ref_s = RefPackedShamir(3, 80, t, p, w2, w3)
    rng = np.random.default_rng(17)
    secrets = rng.integers(0, 433, size=31)
    B = -(-len(secrets) // 3)
    randomness = rng.integers(0, p, size=(t, B))
    shares = oracle.packed_share_from_randomness(secrets, randomness, s)
    recon = PackedShamirReconstructor(s, len(secrets), "cpu")
    ref_recon = RefReconstructor(ref_s, dimension=len(secrets))
    r = s.reconstruction_threshold

    for survivors in [
        list(range(80)),
        list(range(1, 80)),
        sorted(rng.choice(80, size=r + 5, replace=False)),
        sorted(rng.choice(80, size=r, replace=False)),
        sorted(rng.choice(80, size=r, replace=False)),
    ]:
        indexed = [(i, shares[i]) for i in survivors]
        got = recon.reconstruct(indexed)
        np.testing.assert_array_equal(got, secrets)
        np.testing.assert_array_equal(got, ref_recon.reconstruct(indexed))
    assert set(shapes) == {(r, B)}, shapes

    with pytest.raises(ValueError, match="need at least"):
        recon.reconstruct([(i, shares[i]) for i in range(r - 1)])


# ---------------------------------------------------------------------------
# protocol-level dropout: full rounds with killed clerks

def _new_client(service):
    keystore = MemoryKeystore()
    client = SdaClient(SdaClient.new_agent(keystore), keystore, service,
                       device="cpu")
    client.upload_agent()
    return client


def _build_round(service, masking):
    recipient = _new_client(service)
    recipient_key = recipient.new_encryption_key()
    recipient.upload_encryption_key(recipient_key)

    clerks = {}
    for _ in range(GOLDEN.share_count + 1):  # spares: the recipient is a candidate too
        clerk = _new_client(service)
        clerk.upload_encryption_key(clerk.new_encryption_key())
        clerks[clerk.agent.id] = clerk
    clerks[recipient.agent.id] = recipient

    aggregation = Aggregation(
        id=AggregationId.random(),
        title="dropout",
        vector_dimension=4,
        modulus=433,
        recipient=recipient.agent.id,
        recipient_key=recipient_key,
        masking_scheme=masking,
        committee_sharing_scheme=GOLDEN,
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    recipient.upload_aggregation(aggregation)
    recipient.begin_aggregation(aggregation.id)

    for offset in range(2):
        participant = _new_client(service)
        participant.participate([1 + offset, 2 + offset, 3 + offset, 4 + offset],
                                aggregation.id)
    recipient.end_aggregation(aggregation.id)

    committee = service.get_committee(recipient.agent, aggregation.id)
    members = [clerks[cid] for (cid, _) in committee.clerks_and_keys]
    return recipient, aggregation, members


@pytest.mark.parametrize("masking", [NoMasking(), FullMasking(433)])
def test_clerk_dropout_at_quorum_reveals_exact(masking):
    """Kill one clerk of 8: 7 results == reconstruction_threshold -> exact."""
    service = new_memory_server()
    recipient, aggregation, members = _build_round(service, masking)

    dead = members[3]
    for clerk in members:
        if clerk is not dead:
            clerk.run_chores(-1)

    status = recipient.service.get_aggregation_status(recipient.agent, aggregation.id)
    snap = status.snapshots[0]
    assert snap.number_of_clerking_results == GOLDEN.reconstruction_threshold
    assert snap.result_ready

    output = recipient.reveal_aggregation(aggregation.id)
    np.testing.assert_array_equal(output.positive().values, [3, 5, 7, 9])


def test_clerk_dropout_below_quorum_fails_closed():
    """Kill two clerks of 8: 6 results < threshold -> not ready, no reveal."""
    service = new_memory_server()
    recipient, aggregation, members = _build_round(service, NoMasking())

    for clerk in members[2:]:
        clerk.run_chores(-1)

    status = recipient.service.get_aggregation_status(recipient.agent, aggregation.id)
    snap = status.snapshots[0]
    assert snap.number_of_clerking_results == GOLDEN.reconstruction_threshold - 1
    assert not snap.result_ready
    with pytest.raises(NotFound, match="not ready"):
        recipient.reveal_aggregation(aggregation.id)


def test_late_clerk_completes_round_after_not_ready():
    """A straggler clerk finishing later flips the round to ready."""
    service = new_memory_server()
    recipient, aggregation, members = _build_round(service, NoMasking())

    for clerk in members[2:]:
        clerk.run_chores(-1)
    status = recipient.service.get_aggregation_status(recipient.agent, aggregation.id)
    assert not status.snapshots[0].result_ready

    members[0].run_chores(-1)  # the straggler wakes up
    status = recipient.service.get_aggregation_status(recipient.agent, aggregation.id)
    assert status.snapshots[0].result_ready
    output = recipient.reveal_aggregation(aggregation.id)
    np.testing.assert_array_equal(output.positive().values, [3, 5, 7, 9])
