"""Every resource that tests/test_wire_golden.py pins, built with the JAX
package and carried into the port by ``convert.resource_from_reference``:
the port's canonical JSON (the bytes signatures cover) must equal the
reference's byte for byte, from the wire object and from the JSON text."""

import pytest

from sda_tpu import protocol as ref
from sda_tpu.protocol import helpers as ref_helpers
from sda_tpu.protocol import resources as ref_res

from sda_tpu_torch.convert import resource_from_reference
from sda_tpu_torch.protocol import canonical_json

A = ref.AgentId("00000000-0000-0000-0000-00000000000a")
VK = ref.VerificationKeyId("00000000-0000-0000-0000-0000000000b0")
EK = ref.EncryptionKeyId("00000000-0000-0000-0000-0000000000c0")
AG = ref.AggregationId("00000000-0000-0000-0000-0000000000d0")
PA = ref.ParticipationId("00000000-0000-0000-0000-0000000000e0")
SN = ref.SnapshotId("00000000-0000-0000-0000-0000000000f0")
JB = ref.ClerkingJobId("00000000-0000-0000-0000-000000000010")
B32 = ref_helpers.B32(bytes(range(32)))
B64 = ref_helpers.B64(bytes(range(64)))
ENC = ref.Encryption("Sodium", ref_helpers.Binary(b"\x01\x02\xff"))


def _aggregation(**kw):
    base = dict(
        id=AG, title="t", vector_dimension=4, modulus=433, recipient=A,
        recipient_key=EK, masking_scheme=ref.NoMasking(),
        committee_sharing_scheme=ref.AdditiveSharing(share_count=3,
                                                     modulus=433),
        recipient_encryption_scheme=ref.SodiumEncryption(),
        committee_encryption_scheme=ref.SodiumEncryption(),
    )
    base.update(kw)
    return ref.Aggregation(**base)


def _resources():
    status = ref_res.SnapshotStatus(id=SN, number_of_clerking_results=2,
                                    result_ready=True)
    result = ref_res.ClerkingResult(job=JB, clerk=A, encryption=ENC)
    signed = ref_helpers.Signed(
        signature=ref.Signature("Sodium", B64), signer=A,
        body=ref_helpers.Labelled(EK, ref.EncryptionKey("Sodium", B32)))
    return {
        "Agent": ref_res.Agent(
            id=A, verification_key=ref_res.labelled_verification_key(
                VK, ref.VerificationKey("Sodium", B32))),
        "Profile": ref_res.Profile(owner=A),
        "Profile-named": ref_res.Profile(owner=A, name="n",
                                         website="https://example.org"),
        "Aggregation": _aggregation(),
        "Aggregation-packed-full": _aggregation(
            masking_scheme=ref.FullMasking(433),
            committee_sharing_scheme=ref.PackedShamirSharing(
                3, 8, 4, 433, 354, 150)),
        "Aggregation-basic-chacha": _aggregation(
            masking_scheme=ref.ChaChaMasking(433, 4, 128),
            committee_sharing_scheme=ref.BasicShamirSharing(5, 2, 433)),
        "ClerkCandidate": ref_res.ClerkCandidate(id=A, keys=[EK]),
        "Committee": ref_res.Committee(aggregation=AG,
                                       clerks_and_keys=[(A, EK)]),
        "Participation": ref_res.Participation(
            id=PA, participant=A, aggregation=AG, recipient_encryption=None,
            clerk_encryptions=[(A, ENC)]),
        "Participation-masked": ref_res.Participation(
            id=PA, participant=A, aggregation=AG, recipient_encryption=ENC,
            clerk_encryptions=[(A, ENC), (A, ENC)]),
        "Snapshot": ref_res.Snapshot(id=SN, aggregation=AG),
        "ClerkingJob": ref_res.ClerkingJob(id=JB, clerk=A, aggregation=AG,
                                           snapshot=SN, encryptions=[ENC]),
        "ClerkingResult": result,
        "SnapshotStatus": status,
        "AggregationStatus": ref_res.AggregationStatus(
            aggregation=AG, number_of_participations=5, snapshots=[status]),
        "SnapshotResult": ref_res.SnapshotResult(
            snapshot=SN, number_of_participations=5,
            clerk_encryptions=[result], recipient_encryptions=None),
        "SignedEncryptionKey": signed,
        "LinearSecretSharingScheme-packed": ref.PackedShamirSharing(
            3, 8, 4, 433, 354, 150),
        "LinearSecretSharingScheme-basic": ref.BasicShamirSharing(5, 2, 433),
        "LinearSecretSharingScheme-additive": ref.AdditiveSharing(3, 433),
        "LinearMaskingScheme-none": ref.NoMasking(),
        "LinearMaskingScheme-full": ref.FullMasking(433),
        "LinearMaskingScheme-chacha": ref.ChaChaMasking(433, 10, 128),
        "LinearMaskingScheme-chacha-v1": ref.ChaChaMasking(
            433, 10, 256, prg=ref.CHACHA_PRG_V1),
        "AdditiveEncryptionScheme-sodium": ref.SodiumEncryption(),
        "AdditiveEncryptionScheme-paillier": ref.PackedPaillierEncryption(
            2, 48, 32, 512),
        "Encryption": ENC,
        "EncryptionKey": ref.EncryptionKey("Sodium", B32),
        "Signature": ref.Signature("Sodium", B64),
        "VerificationKey": ref.VerificationKey("Sodium", B32),
        "B8": ref_helpers.B8(bytes(range(8))),
        "B32": B32,
        "B64": B64,
        "Binary": ref_helpers.Binary(b"\x00\x01\x02"),
    }


@pytest.mark.parametrize("name", sorted(_resources()))
def test_resource_canonical_json_crosses_byte_for_byte(name):
    resource = _resources()[name]
    want = ref_helpers.canonical_json(resource.to_obj())
    cls_name = name.split("-")[0]
    for wire in (resource.to_obj(), want):
        ported = resource_from_reference(cls_name, wire)
        assert type(ported).__module__.startswith("sda_tpu_torch.")
        assert canonical_json(ported.to_obj()) == want


def test_signed_key_canonical_body_is_what_is_signed():
    signed = _resources()["SignedEncryptionKey"]
    ported = resource_from_reference("SignedEncryptionKey", signed.to_obj())
    assert ported.body.canonical() == signed.body.canonical()
