"""L6: the federated-learning scenario suite — the canonical workload.

Everything below this package existed as substrate: a fleet of stateless
servers over one store (``server/fleet.py``), deterministic round
termination (``server/lifecycle.py``), gray-failure survival, exactly-once
sporadic devices (``client/journal.py``),
hierarchical trees (``tree/``) and recurring multi-tenant rounds
(``service/scheduler.py``).
This package is the first end-to-end *consumer* of all of it: R rounds
of secure FedAvg where a seeded population of simulated devices trains
locally (``models.LocalTrainer``), quantizes its model delta through
``models.FixedPointCodec``, and participates through the real protocol
stack — availability churn modeled by the churn schedule +
journal/resume, round ids minted by the scheduler so device
journals stay exactly-once across epochs, reveal driven through the
lifecycle plane (degraded Shamir rounds included), and an optional
central-DP knob at the recipient.

Entry points:

- :class:`FLProfile` / :func:`run_fl` — the scenario driver behind
  ``sda-sim --fl`` (docs/federated.md);
- :mod:`sda_tpu_torch.fl.data` — the seeded synthetic-classification shim and
  the optional MNIST-format (IDX) loader;
- :mod:`sda_tpu_torch.fl.dp` — Gaussian-mechanism accounting for the DP knob.
"""

from .data import load_mnist_idx, shard_dataset, synthetic_classification
from .dp import gaussian_accounting
from .flagship import FLAGSHIP_FAMILIES, flagship_dim, flagship_dims
from .scenario import FLProfile, run_fl

__all__ = [
    "FLAGSHIP_FAMILIES",
    "FLProfile",
    "flagship_dim",
    "flagship_dims",
    "run_fl",
    "gaussian_accounting",
    "load_mnist_idx",
    "shard_dataset",
    "synthetic_classification",
]
