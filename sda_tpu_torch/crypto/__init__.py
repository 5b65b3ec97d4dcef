"""L1b: crypto modules — sharing, masking, encryption, signing.

``CryptoModule`` is the factory facade the client roles use
(client/src/crypto/mod.rs:58-66): constructed over a keystore, it builds
scheme-dispatched maskers/generators/encryptors from the scheme values
carried in Aggregation resources.

Port of ``sda_tpu/crypto/__init__.py``: the module resolves its device once,
at its first device use (CUDA unless ``device="cpu"``), and hands it to
every masker, generator, combiner and reconstructor it builds. Key
generation, signing and encryption are host work, so a role that does only
those never imports torch.
"""

from __future__ import annotations

from typing import Optional

from ..device import resolve_device
from ..protocol import (
    Agent,
    AgentId,
    EncryptionKeyId,
    Labelled,
    Signed,
    VerificationKeyId,
)
from . import encryption, masking, paillier, sharing, signing, sodium, varint
from .encryption import paillier_combine
from .core import (
    DecryptionKey,
    EncryptionKeypair,
    Keystore,
    MemoryKeystore,
    SignatureKeypair,
    fresh_prng_key,
)
from .signing import signature_is_valid


class CryptoModule:
    """Factory for all crypto primitives, bound to a keystore and a device.

    ``device=None`` means CUDA, and its first device use raises
    ``RuntimeError`` without it; pass ``device="cpu"`` to run the scheme
    algebra on the host."""

    def __init__(self, keystore: Keystore, device=None):
        self.keystore = keystore
        self._device_spec = device
        self._device = None

    @property
    def device(self):
        """The device of the scheme algebra, resolved on first read."""
        if self._device is None:
            self._device = resolve_device(self._device_spec)
        return self._device

    # -- key generation ----------------------------------------------------
    def new_encryption_key(self, scheme=None) -> EncryptionKeyId:
        """Fresh encryption keypair; ``scheme`` selects the key type
        (default Sodium/Curve25519, PackedPaillierEncryption for Paillier)."""
        keypair = encryption.new_encryption_keypair(scheme)
        key_id = EncryptionKeyId.random()
        self.keystore.put_encryption_keypair(key_id, keypair)
        return key_id

    def new_verification_key(self) -> Labelled:
        return signing.new_labelled_verification_key(self.keystore)

    def sign_export(self, agent: Agent, key_id: EncryptionKeyId) -> Optional[Signed]:
        return signing.sign_export(agent, key_id, self.keystore)

    # -- masking -----------------------------------------------------------
    def new_secret_masker(self, scheme):
        return masking.new_secret_masker(scheme, self.device)

    def new_mask_combiner(self, scheme):
        return masking.new_mask_combiner(scheme, self.device)

    def new_secret_unmasker(self, scheme):
        return masking.new_secret_unmasker(scheme, self.device)

    # -- sharing -----------------------------------------------------------
    def new_share_generator(self, scheme):
        return sharing.new_share_generator(scheme, self.device)

    def new_share_combiner(self, scheme):
        return sharing.new_share_combiner(scheme, self.device)

    def new_secret_reconstructor(self, scheme, dimension: int):
        return sharing.new_secret_reconstructor(scheme, dimension, self.device)

    # -- encryption --------------------------------------------------------
    def new_share_encryptor(self, ek, scheme):
        return encryption.new_share_encryptor(ek, scheme)

    def new_share_decryptor(self, key_id, scheme):
        return encryption.new_share_decryptor(key_id, scheme, self.keystore)
