"""Secure federated averaging over the SDA stack.

Port of ``sda_tpu/models/federated.py``. This is the reference's raison
d'etre run end-to-end: each participant trains locally, and only *encoded
model deltas* leave the device — masked, secret-shared across the
committee, and revealed as an exact sum by the recipient
(participate.rs:37-113 / clerk.rs:63-107 / receive.rs:80-157 flow). No
individual update is ever visible to the server or any quorum smaller than
the scheme's privacy threshold.

Two execution surfaces, same math:

- ``FederatedSession`` — the real protocol: an `SdaService` (any store or
  the HTTP seam), one aggregation per round, clerks running chores.
- ``pod_fedavg_round`` — the device fast path: deltas for a whole cohort
  live as a [P, d] tensor and one `SimulatedPod`/`StreamedPod` round
  produces the sum (K1 a shard, or a shard a tile, with ``use_pallas``).

The fixed-point codec guarantees the secure sum equals the plaintext sum
of quantized deltas bit-for-bit, so FedAvg here is exactly FedAvg — the
only deviation from float averaging is the quantization step itself.

``LocalTrainer`` is functional, as the reference's jitted ``lax.scan``
is: it never updates the caller's tensors, so one set of global params
seeds every participant. Its optimizer has optax's shape
(``init(params) -> state``, ``update(grads, state, params) -> (updates,
state)``, updates added to the params); ``sgd(lr)`` is optax.sgd's plain
form.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..protocol import Aggregation, AggregationId
from .encoding import FixedPointCodec, _tree_leaves, _tree_rebuild

__all__ = ["LocalTrainer", "FederatedSession", "pod_fedavg_round", "sgd"]


def _tree_map(fn, tree, *rest):
    """``tree`` with each leaf ``x`` replaced by ``fn(x, *leaves of rest
    at the same place)`` (the trees share one structure)."""
    others = [_tree_leaves(r, []) for r in rest]
    leaves = _tree_leaves(tree, [])
    return _tree_rebuild(tree, iter(
        fn(x, *(o[i] for o in others)) for i, x in enumerate(leaves)))


class GradientTransformation(NamedTuple):
    """optax's optimizer shape: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)``."""

    init: Callable
    update: Callable


def sgd(learning_rate: float) -> GradientTransformation:
    """Plain SGD as ``optax.sgd(learning_rate)`` computes it: the updates
    are ``-learning_rate * grads`` (the new params ``p - lr * g``), and
    the state is empty."""

    def init(params):
        return ()

    def update(grads, state, params=None):
        return _tree_map(lambda g: g * -learning_rate, grads), state

    return GradientTransformation(init, update)


class LocalTrainer:
    """Local-steps trainer: params -> params after k optimizer steps.

    ``loss_fn(params, batch) -> scalar`` over a tree of tensors (a dict
    for ``torch.func.functional_call``, or any tree the loss reads) and an
    optimizer of optax's shape (:func:`sgd`). ``fit`` runs the k steps
    eagerly on ``device`` (CUDA unless ``"cpu"``); each step's loss is
    taken at its pre-update params, as in the reference's ``lax.scan``,
    and every step builds new tensors, so the caller's params are never
    changed.
    """

    def __init__(self, loss_fn: Callable, optimizer, device=None):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.device = resolve_device(device)
        # devprof registry: a cohort whose batch shapes drift (ragged local
        # datasets) shows as several signatures of one entry
        from ..obs import devprof

        self._fit = devprof.instrument("models.local_fit", self._steps)

    def init_state(self, params):
        return self.optimizer.init(params)

    def _on_device(self, tree):
        return _tree_map(lambda x: torch.as_tensor(x, device=self.device),
                         tree)

    def _steps(self, params, opt_state, batches):
        params = self._on_device(params)
        batches = self._on_device(batches)
        leaves = [p.detach() for p in _tree_leaves(params, [])]
        steps = _tree_leaves(batches, [])[0].shape[0]
        losses = []
        for i in range(steps):
            batch = _tree_map(lambda b: b[i], batches)
            with torch.enable_grad():
                live = [p.requires_grad_(True) for p in
                        (q.detach() for q in leaves)]
                loss = self.loss_fn(_tree_rebuild(params, iter(live)), batch)
                grads = torch.autograd.grad(loss, live)
            updates, opt_state = self.optimizer.update(
                _tree_rebuild(params, iter(grads)), opt_state,
                _tree_rebuild(params, iter(leaves)))
            leaves = [(p + u).to(p.dtype) for p, u in
                      zip(leaves, _tree_leaves(updates, []))]
            losses.append(loss.detach())
        return (_tree_rebuild(params, iter(leaves)), opt_state,
                torch.stack(losses).mean())

    def fit(self, params, opt_state, batches):
        """batches: tree of arrays with a leading [k, ...] steps axis.
        Returns (params, opt_state, mean loss) on the trainer's device."""
        return self._fit(params, opt_state, batches)


class FederatedSession:
    """Drives secure FedAvg rounds through the real protocol stack.

    The caller supplies ready SdaClients (recipient with an uploaded
    encryption key, clerks with keys, participants) and an Aggregation
    *template* whose schemes/modulus/dimension describe the update vector;
    each round clones it under a fresh id (aggregations are one-shot,
    resources.rs:44-67).
    """

    def __init__(self, template: Aggregation, codec: FixedPointCodec,
                 recipient, clerks: Sequence, participants: Sequence):
        if template.vector_dimension <= 0:
            raise ValueError("template.vector_dimension must be positive")
        if template.modulus != codec.modulus:
            raise ValueError(
                f"codec modulus {codec.modulus} != aggregation modulus "
                f"{template.modulus}: the decoded mean would be garbage")
        if len(participants) > codec.max_summands:
            raise ValueError(
                f"{len(participants)} participants exceed the codec capacity "
                f"{codec.max_summands}")
        self.template = template
        self.codec = codec
        self.recipient = recipient
        self.clerks = list(clerks)
        self.participants = list(participants)

    def round(self, deltas: Sequence[np.ndarray], *,
              deadline: float = 60.0) -> np.ndarray:
        """One secure round: encode + participate + clerk + reveal.

        ``deltas`` is one float vector per participant (client_params -
        global_params, pre-raveled). Returns the exact decoded *mean* delta.

        The encoded int64 residue array is handed to ``participate``
        as-is — the client normalizes ndarrays without a per-element
        Python conversion, so a 10^5-dim model costs one vectorized
        pass, not 10^5 ``int()`` calls (sda_tpu_torch/loadgen/inputbench.py
        measures the difference).

        The reveal is driven through the lifecycle plane
        (:meth:`SdaClient.await_result`): a round the supervisor
        declared terminal raises the typed
        :class:`~sda_tpu_torch.protocol.RoundFailed` /
        :class:`~sda_tpu_torch.protocol.RoundExpired` with the server's
        diagnosis, and a quorum-degraded Shamir round reveals bit-exactly
        from the survivors — never a hang, never a silent partial-
        committee sum. The mean divides by the *revealed* participation
        count (the snapshot's frozen set), so a round whose committee
        degraded still averages over exactly the participations it
        actually summed. ``deadline`` bounds the wait client-side.
        """
        if len(deltas) != len(self.participants):
            raise ValueError("one delta per participant required")
        dim = self.template.vector_dimension
        aggregation = self.template.replace(id=AggregationId.random())
        self.recipient.upload_aggregation(aggregation)
        self.recipient.begin_aggregation(aggregation.id)

        for participant, delta in zip(self.participants, deltas):
            delta = np.asarray(delta, dtype=np.float64)
            if delta.shape != (dim,):
                raise ValueError(f"delta shape {delta.shape} != ({dim},)")
            participant.participate(self.codec.encode(delta), aggregation.id)

        self.recipient.end_aggregation(aggregation.id)
        self.recipient.run_chores(-1)
        for clerk in self.clerks:
            clerk.run_chores(-1)

        output = self.recipient.await_result(
            aggregation.id, deadline=deadline, poll_interval=0.05)
        values = output.positive().values
        # None = pre-lifecycle server: fall back to the nominal count. A
        # REVEALED 0 is a real (degenerate) answer — let decode_mean's
        # typed empty-summand guard surface it rather than silently
        # averaging an empty sum over the full population.
        summands = (output.participations
                    if output.participations is not None
                    else len(self.participants))
        return self.codec.decode_mean(values, summands)


def pod_fedavg_round(pod, codec: FixedPointCodec, global_vec, client_vecs,
                     seed: Optional[int] = None) -> np.ndarray:
    """Device FedAvg round: cohort deltas -> pod round -> mean delta.

    ``client_vecs`` is a [P, d] float array or tensor (or a list of
    vectors) of client parameter vectors. The deltas against
    ``global_vec`` are taken in float64 and cast to float32 on the pod's
    first device (a cohort already there is not copied), encoded there
    (``codec.encode_device``) and aggregated in ONE pod round (``seed``:
    the round's int seed, None draws one). Returns the new global vector
    (numpy float64), exactly global + mean(quantized deltas).
    """
    home = pod.mesh.devices[0, 0]
    global_t = torch.as_tensor(global_vec).to(home, torch.float64)
    if isinstance(client_vecs, (list, tuple)):
        client_vecs = torch.stack([torch.as_tensor(v).to(home, torch.float64)
                                   for v in client_vecs])
    stacked = torch.as_tensor(client_vecs).to(home, torch.float64)
    if stacked.ndim != 2 or global_t.ndim != 1 \
            or stacked.shape[1] != global_t.shape[0]:
        raise ValueError(f"client_vecs shape {tuple(stacked.shape)} "
                         f"incompatible with global {tuple(global_t.shape)}")
    n = stacked.shape[0]
    if n > codec.max_summands:
        raise ValueError(f"{n} clients exceed codec capacity {codec.max_summands}")
    pod_modulus = getattr(pod, "modulus", codec.modulus)
    if pod_modulus != codec.modulus:
        raise ValueError(
            f"codec modulus {codec.modulus} != pod modulus {pod_modulus}: "
            "the decoded mean would be garbage")

    deltas = (stacked - global_t[None, :]).to(torch.float32)
    del stacked
    encoded = codec.encode_device(deltas, device=home)
    del deltas
    summed = pod.aggregate(encoded, seed)
    if isinstance(summed, torch.Tensor):
        summed = summed.cpu().numpy()
    mean_delta = codec.decode_mean(np.asarray(summed), n)
    return global_t.cpu().numpy() + mean_delta
