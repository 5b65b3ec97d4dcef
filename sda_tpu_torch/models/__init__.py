"""Model layer: float models in, secure aggregates out.

Completes the reference's federated-ML story (README.md:3-15) with the
pieces it leaves to the application: fixed-point encoding into Z_m,
torch model families sized to the benchmark workloads, and FedAvg driven
through either the real protocol or the device fast path.

Port of ``sda_tpu/models/__init__.py``; the families load lazily
(PEP 562), as the reference's flax families do.
"""

from .encoding import (
    FieldSizingError,
    FixedPointCodec,
    field_capacity,
    field_headroom_check,
    ravel_pytree,
)
from .federated import FederatedSession, LocalTrainer, pod_fedavg_round, sgd

_FAMILY_EXPORTS = (
    "LeNet",
    "MobileLite",
    "LoRAMLP",
    "lora_adapter_params",
    "merge_lora_params",
    "param_count",
)

__all__ = [
    "FieldSizingError",
    "FixedPointCodec",
    "field_capacity",
    "field_headroom_check",
    "ravel_pytree",
    "FederatedSession",
    "LocalTrainer",
    "pod_fedavg_round",
    "sgd",
    *_FAMILY_EXPORTS,
]


def __getattr__(name):
    if name in _FAMILY_EXPORTS:
        from . import families

        return getattr(families, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
