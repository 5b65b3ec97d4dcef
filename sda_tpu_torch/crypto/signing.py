"""Ed25519 signing of protocol resources over canonical JSON.

Reference: client/src/crypto/signing/mod.rs — keys are generated into the
keystore; `sign_export` signs a Labelled encryption key with the agent's
signing key; `signature_is_valid` verifies any Signed<M> against the agent's
verification key, binding the claimed signer to the agent id (:106-132).
"""

from __future__ import annotations

from typing import Optional

from ..protocol import (
    Agent,
    B32,
    B64,
    EncryptionKeyId,
    Labelled,
    Signature,
    Signed,
    SigningKey,
    VerificationKey,
    VerificationKeyId,
    canonical_json,
)
from . import sodium
from .core import Keystore, SignatureKeypair


def new_signature_keypair() -> SignatureKeypair:
    vk, sk = sodium.sign_keypair()
    return SignatureKeypair(
        vk=VerificationKey("Sodium", B32(vk)),
        sk=SigningKey("Sodium", B64(sk)),
    )


def new_labelled_verification_key(keystore: Keystore) -> Labelled:
    """Generate + store a signature keypair; return the public half labelled
    by its fresh id (signing/mod.rs:46-60)."""
    keypair = new_signature_keypair()
    key_id = VerificationKeyId.random()
    keystore.put_signature_keypair(key_id, keypair)
    return Labelled(key_id, keypair.vk)


def sign_export(
    agent: Agent, key_id: EncryptionKeyId, keystore: Keystore
) -> Optional[Signed]:
    """Sign the agent's stored encryption key for upload (signing/mod.rs:72-103)."""
    enc_keypair = keystore.get_encryption_keypair(key_id)
    if enc_keypair is None:
        return None
    message = Labelled(key_id, enc_keypair.ek)
    sig_keypair = keystore.get_signature_keypair(agent.verification_key.id)
    if sig_keypair is None:
        return None
    raw_sig = sodium.sign_detached(message.canonical(), sig_keypair.sk.value.data)
    return Signed(
        signature=Signature("Sodium", B64(raw_sig)),
        signer=agent.id,
        body=message,
    )


def signature_is_valid(agent: Agent, signed: Signed) -> bool:
    """Verify a Signed<M> against the agent's verification key.

    Raises ValueError if the claimed signer is a different agent
    (signing/mod.rs:113-116).
    """
    if signed.signer != agent.id:
        raise ValueError("agent differs from claimed signer")
    vk = agent.verification_key.body
    sig = signed.signature
    if vk.variant != "Sodium" or sig.variant != "Sodium":
        raise ValueError("unsupported signature scheme")
    message = canonical_json(signed.body.to_obj())
    return sodium.verify_detached(sig.value.data, message, vk.value.data)
