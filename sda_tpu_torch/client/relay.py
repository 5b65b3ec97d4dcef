"""The relay role — the client-side hinge of hierarchical (tree) rounds.

A relay is the *recipient of a leaf aggregation that must never learn the
leaf's aggregate*. Tree rounds arrange exactly that (``sda_tpu_torch/tree``,
docs/scaling.md):

- leaf participants seal their clerk shares to the leaf committee as
  usual, but their recipient-MASK ciphertexts to the ROOT recipient
  (``TreeLink.mask_recipient_key`` — the client redirects the seal);
- the relay quorum-reconstructs the leaf's clerk results, which yields
  only the **masked** leaf total ``Σ(xᵢ + maskᵢ) mod m`` — without the
  masks (sealed past it) the value is uniformly random to the relay;
- the relay re-shares the masked total into the parent round as an
  ordinary participation (masked again by the parent scheme, so privacy
  composes per level) and forwards the leaf's mask ciphertexts upward
  IN-BAND (``Participation.forwarded_masks``) — one exactly-once ingest
  covers the re-share and the forwarding atomically;
- only the root recipient, holding the one key every mask in the tree is
  sealed to, can unmask — and the standard flat reveal does it: the
  parent's snapshot mask collection merges relay masks and forwarded
  leaf masks into one list.

Correctness of the modular reduction: the leaf reconstruction returns the
exact integer sum of the masked secrets (the scheme's prime gives
participant-sum headroom), and only its residue mod the aggregation
modulus survives the final unmask, so the relay reduces before
re-sharing — parent rounds need headroom for G relay totals, not N
device totals. At G=1 the tree reveal is bit-exact with the flat round
(pinned in tests/test_tree_round.py).
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

import numpy as np

from .. import obs
from ..utils import metrics
from ..protocol import (
    AggregationId,
    Encryption,
    NotFound,
    RoundExpired,
    RoundFailed,
    ServerError,
    SnapshotId,
)

log = logging.getLogger(__name__)

__all__ = ["MaskedLeafTotal", "reveal_masked", "await_masked", "relay_up"]


class MaskedLeafTotal:
    """A leaf round's contribution as the relay sees it: the masked total
    (mod the aggregation modulus), the unopened mask ciphertexts to
    forward, and the audit counts. ``state`` records the leaf round's
    lifecycle verdict at reveal time (``degraded`` leaves complete from
    the surviving quorum — the survivors feed up)."""

    __slots__ = ("values", "mask_encryptions", "participations", "results",
                 "state")

    def __init__(self, values, mask_encryptions: Optional[List[Encryption]],
                 participations: int, results: int,
                 state: Optional[str] = None):
        self.values = np.asarray(values, dtype=np.int64)
        self.mask_encryptions = (None if mask_encryptions is None
                                 else list(mask_encryptions))
        self.participations = int(participations)
        self.results = int(results)
        self.state = state

    def __repr__(self):
        return (f"MaskedLeafTotal(participations={self.participations}, "
                f"results={self.results}, state={self.state!r})")


def reveal_masked(
    client, aggregation_id: AggregationId,
    snapshot_id: Optional[SnapshotId] = None,
) -> MaskedLeafTotal:
    """Reconstruct the MASKED total of a result-ready leaf round.

    The flat reveal minus everything the relay must not do: clerk results
    are decrypted (they are sealed to this relay, the leaf's recipient)
    and quorum-reconstructed, but the recipient-mask ciphertexts are
    returned UNOPENED for forwarding — they are sealed to the root and
    would fail to decrypt here anyway. The reconstruction is reduced mod
    the aggregation modulus (see module docstring).
    """
    from ..crypto import batch as crypto_batch

    with obs.span("relay.reveal_masked",
                  attributes={"aggregation": str(aggregation_id)}):
        aggregation = client._cached_aggregation(aggregation_id)
        if aggregation is None:
            raise NotFound(f"unknown aggregation {aggregation_id}")
        committee = client._cached_committee(aggregation_id)
        if committee is None:
            raise NotFound(f"unknown committee {aggregation_id}")

        status = client.service.get_aggregation_status(
            client.agent, aggregation_id)
        if status is None:
            raise NotFound("unknown aggregation")
        if snapshot_id is not None:
            snapshot = next((s for s in status.snapshots
                             if s.id == snapshot_id and s.result_ready), None)
        else:
            snapshot = next((s for s in status.snapshots if s.result_ready),
                            None)
        if snapshot is None:
            raise NotFound("aggregation not ready")
        result = client.service.get_snapshot_result(
            client.agent, aggregation_id, snapshot.id)
        if result is None:
            raise NotFound("missing aggregation result")

        if result.number_of_participations == 0:
            # a leaf whose every device dropped before the freeze: the
            # identity contribution — zeros, nothing to forward (the
            # clerk results of empty columns carry no shares to give the
            # reconstruction its length)
            metrics.count("relay.leaf_empty")
            return MaskedLeafTotal(
                values=np.zeros(aggregation.vector_dimension,
                                dtype=np.int64),
                mask_encryptions=[],
                participations=0,
                results=len(result.clerk_encryptions),
            )

        decryptor = client.crypto.new_share_decryptor(
            aggregation.recipient_key, aggregation.recipient_encryption_scheme
        )
        clerk_positions = {
            cid: ix for ix, (cid, _) in enumerate(committee.clerks_and_keys)}

        def decrypt_result(clerking_result):
            ix = clerk_positions.get(clerking_result.clerk)
            if ix is None:
                # same skip policy as the recipient reveal: an unknown-
                # clerk result must not abort the reconstruction from
                # inside the crypto pool — skip it, counted and logged
                log.warning(
                    "relay reveal %s: skipping result from unknown "
                    "clerk %s (not in the committee)",
                    aggregation_id, clerking_result.clerk,
                )
                metrics.count("relay.result.unknown_clerk")
                return None
            return (ix, decryptor.decrypt(clerking_result.encryption))

        indexed_shares = [
            pair for pair in crypto_batch.pmap(
                decrypt_result, result.clerk_encryptions)
            if pair is not None
        ]
        reconstructor = client.crypto.new_secret_reconstructor(
            aggregation.committee_sharing_scheme, aggregation.vector_dimension
        )
        masked = np.asarray(
            reconstructor.reconstruct(indexed_shares), dtype=np.int64)
        # residue mod the aggregation modulus: the only part of the exact
        # integer total the final unmask consumes, and the range parent
        # input validation expects
        masked = np.mod(masked, aggregation.modulus)
        metrics.count("relay.leaf_revealed")
        return MaskedLeafTotal(
            values=masked,
            mask_encryptions=result.recipient_encryptions,
            participations=result.number_of_participations,
            results=len(result.clerk_encryptions),
        )


def await_masked(
    client, aggregation_id: AggregationId, *,
    deadline: Optional[float] = None,
    poll_interval: float = 0.05,
    snapshot_id: Optional[SnapshotId] = None,
) -> MaskedLeafTotal:
    """Block until the leaf round completes, then :func:`reveal_masked`.

    The relay-side mirror of ``SdaClient.await_result``: polls the round
    lifecycle state alongside the snapshot status. A ``degraded`` leaf is
    NOT an error — the surviving quorum's result feeds up (the verdict is
    recorded on the returned total). Terminal ``failed``/``expired``
    raise the typed :class:`RoundFailed`/:class:`RoundExpired` carrying
    the server's diagnosis, which the tree driver surfaces as a root
    failure naming this leaf.
    """
    import random as _random

    give_up = (None if deadline is None
               else time.monotonic() + float(deadline))
    jitter_rng = _random.Random(f"{client.agent.id}:{aggregation_id}:relay")
    round_status = None
    with obs.span("relay.await_masked",
                  attributes={"aggregation": str(aggregation_id)}):
        while True:
            retry_after = None
            try:
                round_status = client.service.get_round_status(
                    client.agent, aggregation_id)
                if round_status is not None and round_status.state in (
                        "failed", "expired"):
                    exc = (RoundExpired if round_status.state == "expired"
                           else RoundFailed)
                    raise exc(
                        f"leaf round {aggregation_id} is "
                        f"{round_status.state}: "
                        f"{round_status.reason or 'no reason recorded'}",
                        state=round_status.state,
                        reason=round_status.reason,
                        dead_clerks=round_status.dead_clerks,
                    )
                # reveal on the round VERDICT, not the bare result count:
                # waiting for ready (full committee) / degraded (sweeper
                # diagnosed the stragglers dead, quorum survives) keeps a
                # slow-but-alive clerk's share in the leaf total and makes
                # the degraded verdict observable before the relay feeds
                # survivors up. A pre-supervisor server (no round state)
                # degrades to plain result_ready polling.
                verdict_ready = (round_status is None
                                 or round_status.state in ("ready",
                                                           "degraded",
                                                           "revealed"))
                status = client.service.get_aggregation_status(
                    client.agent, aggregation_id)
                if status is not None and verdict_ready:
                    if snapshot_id is not None:
                        snap = next((s for s in status.snapshots
                                     if s.id == snapshot_id), None)
                    else:
                        snap = next((s for s in status.snapshots
                                     if s.result_ready), None)
                    if snap is not None and snap.result_ready:
                        total = reveal_masked(client, aggregation_id, snap.id)
                        total.state = (round_status.state
                                       if round_status is not None else None)
                        return total
            except ServerError as e:
                # transient transport/store trouble past the retry budget:
                # the leaf round itself may be fine — keep waiting, on
                # the SERVER's schedule when the 503 carried a
                # Retry-After hint (breaker-open and draining workers
                # stamp one), exactly like SdaClient.await_result
                metrics.count("relay.await.transient")
                retry_after = getattr(e, "retry_after", None)
            if give_up is not None and time.monotonic() >= give_up:
                raise RoundExpired(
                    f"relay await_masked deadline exceeded for "
                    f"{aggregation_id}",
                    state=(round_status.state
                           if round_status is not None else None),
                    reason="relay await_masked deadline exceeded",
                )
            # Retry-After beats the cadence; both get the seeded jitter,
            # and the sleep never outlives the remaining deadline
            sleep = (retry_after if retry_after
                     else poll_interval) * (0.5 + jitter_rng.random())
            if give_up is not None:
                sleep = min(sleep, max(0.0, give_up - time.monotonic()))
            time.sleep(sleep)


def relay_up(
    client, leaf_id: AggregationId, parent_id: AggregationId, *,
    deadline: Optional[float] = None,
    poll_interval: float = 0.05,
    journal=None,
) -> MaskedLeafTotal:
    """The whole relay hop: await the leaf, re-share the masked total
    into the parent round, forward the leaf's mask ciphertexts in-band.

    The forwarded list rides the SAME participation upload, so the
    exactly-once ingestion plane covers the pair atomically — the
    parent's snapshot can never see the re-share without its masks, and
    a transport-level retry re-sends the same bytes.

    ``journal`` (a :class:`~sda_tpu_torch.client.journal.ParticipationJournal`)
    adds the crash-resume half, exactly like the device-side
    ``SdaClient.participate(..., journal=...)``: the sealed re-share is
    persisted BEFORE the first upload and reaped after the confirmed
    one, so a relay process that dies in the lost-ack window replays the
    SAME bytes on restart instead of recomputing with fresh mask
    randomness (which the server would reject as an equivocation, 409,
    losing the leaf's contribution). Without a journal, a relay crash
    between upload and ack needs operator attention — the conflict is at
    least loud, never a double count.

    Returns the leaf total that was relayed (``participations`` feeds
    the driver's device accounting).
    """
    with obs.span("relay.round", attributes={"leaf": str(leaf_id),
                                             "parent": str(parent_id)}):
        total = await_masked(client, leaf_id, deadline=deadline,
                             poll_interval=poll_interval)
        if journal is not None:
            pending = journal.load(client.agent.id, parent_id)
            if pending is not None:
                # an earlier attempt crashed between seal and confirm:
                # replay ITS bytes verbatim — the server dedupes
                metrics.count("relay.journal.recovered")
                client.upload_participation(pending)
                journal.reap(client.agent.id, parent_id)
                return total
        participation = client.new_participation(
            [int(v) for v in total.values], parent_id)
        if total.mask_encryptions:
            participation.forwarded_masks = list(total.mask_encryptions)
        if journal is not None:
            journal.record(participation)
        client.upload_participation(participation)
        if journal is not None:
            journal.reap(client.agent.id, parent_id)
        metrics.count("relay.relayed")
        if total.mask_encryptions:
            metrics.count("relay.masks_forwarded",
                          len(total.mask_encryptions))
        return total
