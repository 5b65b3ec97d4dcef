"""Embedded-participant flow: native C core compute, Python transport.

The reference declares an ``/embeddable-client`` wrapping its client "in a
C-friendly" API for mobile/embedded apps (reference README.md:196-204 —
announced, never released into the repo). This module is the TPU build's
analog, split the same way the reference intended:

- ALL participant crypto (canonicalize -> mask -> share -> varint ->
  sealed boxes) runs in the native C core
  (``sda_tpu_torch.native.embed_participate``, dispatching to the C ABI
  ``sda_embed_participate`` for additive committees and
  ``sda_embed_participate_shamir`` for packed-/BasicShamir ones, with
  the share matrix computed host-side) — the part an embedded app links;
- service interaction (fetching the aggregation/committee, verifying key
  signatures, uploading) stays host-side — here the Python client, in an
  app whatever HTTP stack it already has.

The sealed blobs are wire-compatible with the Python/TPU clerks and
recipient (same zigzag-varint + libsodium sealedbox formats), so an
embedded participant joins ordinary rounds: pinned end-to-end in
tests/test_embed.py across the none/full/chacha masking lattice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..protocol import (
    AdditiveSharing,
    BasicShamirSharing,
    ChaChaMasking,
    Encryption,
    FullMasking,
    NoMasking,
    PackedShamirSharing,
    Participation,
    ParticipationId,
    SodiumEncryption,
)
from ..protocol.errors import NotFound

__all__ = ["new_participation_embedded", "participate_embedded"]


def _sodium_pk(key) -> bytes:
    if key.variant != "Sodium":
        raise ValueError(
            f"embedded participant needs Sodium keys, got {key.variant}")
    return key.value.data


def new_participation_embedded(
    client, input: Sequence[int], aggregation_id
) -> Participation:
    """``SdaClient.new_participation`` with the crypto computed natively.

    Supports the full scheme lattice an embedded participant meets:
    additive, packed-Shamir, and BasicShamir sharing (Shamir share
    matrices are computed host-side and evaluated in C) with Sodium
    encryption and none/full/chacha masking; other combinations raise
    ``ValueError`` — use the full client.
    """
    from .. import native

    secrets = np.asarray(input, dtype=np.int64)
    aggregation = client.service.get_aggregation(client.agent, aggregation_id)
    if aggregation is None:
        raise NotFound("could not find aggregation")
    if secrets.shape != (aggregation.vector_dimension,):
        raise ValueError("the input length does not match the aggregation")
    committee = client.service.get_committee(client.agent, aggregation_id)
    if committee is None:
        raise NotFound("could not find committee")

    sharing = aggregation.committee_sharing_scheme
    share_matrix, secret_count = None, 0
    if isinstance(sharing, AdditiveSharing):
        sharing_modulus = sharing.modulus
    elif isinstance(sharing, (PackedShamirSharing, BasicShamirSharing)):
        # the polynomial number theory stays host-side: the C core takes
        # the share MATRIX (numtheory.share_matrix_for) and evaluates it
        from ..fields import numtheory

        sharing_modulus = sharing.prime_modulus
        share_matrix = numtheory.share_matrix_for(sharing)
        secret_count = sharing.secret_count
    else:
        raise ValueError(
            "embedded participant supports additive and Shamir sharing; "
            f"got {type(sharing).__name__}")
    # ring discipline mirrors the Python client exactly: additive rounds
    # live in ONE ring (sharing modulus == aggregation modulus); Shamir
    # shares ride the scheme's NTT prime, which may exceed the
    # aggregation modulus (the CLI/protocol policy gives participant-sum
    # headroom) — masks stay in the masking scheme's own ring. Drifts the
    # Python path would also mis-handle raise here instead of revealing
    # silently-wrong sums.
    if share_matrix is None and sharing_modulus != aggregation.modulus:
        raise ValueError(
            f"sharing modulus {sharing_modulus} != aggregation modulus "
            f"{aggregation.modulus}")
    for scheme_name in ("recipient_encryption_scheme",
                       "committee_encryption_scheme"):
        scheme = getattr(aggregation, scheme_name)
        if not isinstance(scheme, SodiumEncryption):
            raise ValueError(
                f"embedded participant needs Sodium {scheme_name}, "
                f"got {type(scheme).__name__}")

    masking = aggregation.masking_scheme
    mask_modulus = None
    if isinstance(masking, NoMasking):
        kind, seed_bits = "none", 0
    elif isinstance(masking, (FullMasking, ChaChaMasking)):
        if isinstance(masking, ChaChaMasking):
            # native masking kind tracks the scheme's PRG tag: the default
            # rand-0.3 stream (kind 3) keeps embedded participations
            # interoperable with Rust peers; V1 (kind 2) is the tagged
            # TPU-native opt-in. Unknown tags already failed in the scheme
            # constructor.
            from ..protocol import CHACHA_PRG_V1

            kind = "chacha" if masking.prg == CHACHA_PRG_V1 else "chacha_rand03"
            seed_bits = masking.seed_bitsize
            if masking.dimension != aggregation.vector_dimension:
                raise ValueError(
                    f"ChaCha masking dimension {masking.dimension} != "
                    f"vector dimension {aggregation.vector_dimension}")
        else:
            kind, seed_bits = "full", 0
        mask_modulus = masking.modulus
        if mask_modulus > sharing_modulus:
            raise ValueError(
                f"masking modulus {mask_modulus} exceeds the sharing "
                f"modulus {sharing_modulus}: masked values would wrap")
        if share_matrix is None and mask_modulus != sharing_modulus:
            # one-ring discipline for additive rounds (see above)
            raise ValueError(
                f"masking modulus {mask_modulus} != sharing modulus "
                f"{sharing_modulus}")
        if mask_modulus != aggregation.modulus:
            # the recipient unmasks in the MASK ring; a ring different
            # from the aggregation's reveals sums mod the wrong modulus
            raise ValueError(
                f"masking modulus {mask_modulus} != aggregation modulus "
                f"{aggregation.modulus}")
    else:
        raise ValueError(
            f"unsupported masking {type(masking).__name__}")

    recipient_pk = b""
    if kind != "none":
        # flat rounds: the recipient; tree rounds: the ROOT recipient,
        # past the leaf's relay — the one rule both clients share
        mask_owner, mask_key_id = aggregation.mask_seal_target()
        recipient_pk = _sodium_pk(client._fetch_verified_key(
            mask_owner, mask_key_id))
    clerk_ids, clerk_pks = [], []
    for clerk_id, clerk_key_id in committee.clerks_and_keys:
        clerk_ids.append(clerk_id)
        clerk_pks.append(_sodium_pk(
            client._fetch_verified_key(clerk_id, clerk_key_id)))

    recipient_blob, clerk_blobs = native.embed_participate(
        secrets, sharing_modulus, sharing.output_size,
        masking=kind, seed_bits=seed_bits,
        recipient_pk=recipient_pk, clerk_pks=clerk_pks,
        share_matrix=share_matrix, secret_count=secret_count,
        mask_modulus=mask_modulus,
    )
    return Participation(
        id=ParticipationId.random(),
        participant=client.agent.id,
        aggregation=aggregation.id,
        recipient_encryption=(
            Encryption.sodium(recipient_blob)
            if recipient_blob is not None else None),
        clerk_encryptions=[
            (cid, Encryption.sodium(blob))
            for cid, blob in zip(clerk_ids, clerk_blobs)
        ],
    )


def participate_embedded(client, input: Sequence[int], aggregation_id) -> None:
    """Build natively + upload (the embedded ``participate``)."""
    from .. import obs

    with obs.span("participant.participate",
                  attributes={"aggregation": str(aggregation_id),
                              "embedded": True}):
        client.upload_participation(
            new_participation_embedded(client, input, aggregation_id))
