"""The recipes of ``tests/test_protocol.py`` (the protocol layer's golden
serde) against the port's protocol. Every wire object the port emits is
parsed by the reference into an equal object with the same wire object
and the same canonical bytes, and the reverse."""

import json

import pytest

import sda_tpu.protocol as ref
from sda_tpu_torch.protocol import (
    B32,
    B64,
    Agent,
    AgentId,
    AdditiveSharing,
    Aggregation,
    AggregationId,
    Binary,
    ChaChaMasking,
    Committee,
    Encryption,
    EncryptionKey,
    EncryptionKeyId,
    FullMasking,
    Labelled,
    LinearMaskingScheme,
    LinearSecretSharingScheme,
    NoMasking,
    PackedShamirSharing,
    Participation,
    ParticipationId,
    Signature,
    Signed,
    SodiumEncryption,
    VerificationKey,
    VerificationKeyId,
    canonical_json,
    signed_encryption_key_from_obj,
)


def crosses(obj, ref_parse):
    """The reference parses ``obj``'s wire object to the same wire object
    and canonical JSON, and the port parses that back to ``obj``."""
    wire = obj.to_obj()
    theirs = ref_parse(wire)
    assert theirs.to_obj() == wire
    assert ref.canonical_json(theirs.to_obj()) == canonical_json(wire)
    assert type(obj).from_obj(theirs.to_obj()) == obj
    return theirs


def test_resource_id_roundtrip():
    a = AgentId.random()
    assert AgentId.from_obj(a.to_obj()) == a
    assert len(a.to_obj()) == 36  # hyphenated uuid
    crosses(a, ref.AgentId.from_obj)
    for cls in (AgentId, ref.AgentId):
        with pytest.raises(ValueError):
            cls("not-a-uuid")


def test_resource_id_types_distinct():
    a = AgentId("00000000-0000-0000-0000-000000000001")
    b = ParticipationId("00000000-0000-0000-0000-000000000001")
    assert a != b  # distinct id types never compare equal
    assert a.to_obj() == b.to_obj() == ref.AgentId(a.to_obj()).to_obj()


def test_byte_arrays():
    b = B32(bytes(range(32)))
    assert B32.from_obj(b.to_obj()) == b
    assert ref.B32.from_obj(b.to_obj()).data == b.data
    for cls in (B32, ref.B32):
        with pytest.raises(ValueError):
            cls(bytes(31))
    # default is all-zero, like the reference test factories
    assert B32().data == bytes(32) == ref.B32().data


def test_binary_base64():
    blob = Binary(b"\x00\x01\xfe\xff")
    assert Binary.from_obj(blob.to_obj()) == blob
    assert blob.to_obj() == "AAH+/w==" == ref.Binary(blob.data).to_obj()


def test_enum_tagging():
    e = Encryption.sodium(b"ciphertext")
    obj = e.to_obj()
    assert list(obj) == ["Sodium"]
    assert Encryption.from_obj(obj) == e
    crosses(e, ref.Encryption.from_obj)
    key = EncryptionKey("Sodium", B32())
    assert EncryptionKey.from_obj(key.to_obj()) == key
    crosses(key, ref.EncryptionKey.from_obj)


def test_masking_scheme_serde():
    for scheme in [
        NoMasking(),
        FullMasking(modulus=433),
        ChaChaMasking(modulus=433, dimension=4, seed_bitsize=128),
    ]:
        assert LinearMaskingScheme.from_obj(scheme.to_obj()) == scheme
        theirs = ref.LinearMaskingScheme.from_obj(scheme.to_obj())
        assert theirs.to_obj() == scheme.to_obj()
        assert theirs.has_mask == scheme.has_mask
    assert NoMasking().to_obj() == "None"
    assert not NoMasking().has_mask
    assert FullMasking(433).has_mask
    assert json.dumps(FullMasking(433).to_obj()) == \
        '{"Full": {"modulus": 433}}'


def test_sharing_scheme_derived_properties():
    # crypto.rs:117-155 derived-property semantics
    additive = AdditiveSharing(share_count=3, modulus=433)
    assert additive.input_size == 1
    assert additive.output_size == 3
    assert additive.privacy_threshold == 2
    assert additive.reconstruction_threshold == 3
    shamir = PackedShamirSharing(
        secret_count=3, share_count=8, privacy_threshold=4, prime_modulus=433,
        omega_secrets=354, omega_shares=150,
    )
    assert shamir.input_size == 3
    assert shamir.output_size == 8
    assert shamir.privacy_threshold == 4
    assert shamir.reconstruction_threshold == 7  # t + k
    for scheme in [additive, shamir]:
        assert LinearSecretSharingScheme.from_obj(scheme.to_obj()) == scheme
        theirs = ref.LinearSecretSharingScheme.from_obj(scheme.to_obj())
        assert theirs.to_obj() == scheme.to_obj()
        for prop in ("input_size", "output_size", "privacy_threshold",
                     "reconstruction_threshold"):
            assert getattr(theirs, prop) == getattr(scheme, prop)


def test_aggregation_roundtrip():
    agg = Aggregation(
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
    assert Aggregation.from_obj(agg.to_obj()) == agg
    crosses(agg, ref.Aggregation.from_obj)
    # replace() mirrors Rust struct-update syntax used throughout tests
    agg2 = agg.replace(title="bar")
    assert agg2.title == "bar" and agg2.id == agg.id
    assert ref.Aggregation.from_obj(agg.to_obj()).replace(
        title="bar").to_obj() == agg2.to_obj()


def test_participation_roundtrip_with_optional():
    p = Participation(
        id=ParticipationId.random(),
        participant=AgentId.random(),
        aggregation=AggregationId.random(),
        recipient_encryption=None,
        clerk_encryptions=[(AgentId.random(), Encryption.sodium(b"abc"))],
    )
    assert Participation.from_obj(p.to_obj()) == p
    assert Participation.from_obj(json.loads(json.dumps(p.to_obj()))) == p
    crosses(p, ref.Participation.from_obj)
    p3 = Participation(
        id=p.id, participant=p.participant, aggregation=p.aggregation,
        recipient_encryption=Encryption.sodium(b"mask"),
        clerk_encryptions=p.clerk_encryptions,
    )
    assert Participation.from_obj(p3.to_obj()) == p3
    theirs = crosses(p3, ref.Participation.from_obj)
    assert theirs.canonical_digest() == p3.canonical_digest()


def test_signed_labelled_canonical_bytes():
    """Canonical bytes are compact declaration-ordered JSON
    (helpers.rs:138-142), the reference's byte for byte."""
    key_id = EncryptionKeyId("11111111-2222-3333-4444-555555555555")
    labelled = Labelled(key_id, EncryptionKey("Sodium", B32()))
    expected = (
        '{"id":"11111111-2222-3333-4444-555555555555",'
        '"body":{"Sodium":"' + "A" * 43 + '="}}'
    )
    assert labelled.canonical() == expected.encode()
    ref_labelled = ref.Labelled(
        ref.EncryptionKeyId(str(key_id)), ref.EncryptionKey("Sodium", ref.B32()))
    assert ref_labelled.canonical() == labelled.canonical()
    signed = Signed(signature=Signature("Sodium", B64()),
                    signer=AgentId.random(), body=labelled)
    obj = signed.to_obj()
    assert list(obj) == ["signature", "signer", "body"]
    assert signed_encryption_key_from_obj(obj) == signed
    theirs = ref.signed_encryption_key_from_obj(obj)
    assert theirs.to_obj() == obj
    assert theirs.body.canonical() == signed.body.canonical()


def test_committee_tuple_encoding():
    c = Committee(
        aggregation=AggregationId.random(),
        clerks_and_keys=[(AgentId.random(), EncryptionKeyId.random())
                         for _ in range(3)],
    )
    obj = c.to_obj()
    assert isinstance(obj["clerks_and_keys"][0], list)  # nested arrays
    assert Committee.from_obj(obj) == c
    crosses(c, ref.Committee.from_obj)


def test_agent_roundtrip():
    agent = Agent(
        id=AgentId.random(),
        verification_key=Labelled(VerificationKeyId.random(),
                                  VerificationKey("Sodium", B32())),
    )
    assert Agent.from_obj(agent.to_obj()) == agent
    crosses(agent, ref.Agent.from_obj)
