"""Model layer: float models in, secure aggregates out.

Completes the reference's federated-ML story (README.md:3-15) with the
pieces it leaves to the application: fixed-point encoding into Z_m.

Port of ``sda_tpu/models/__init__.py`` with the encoding names only: the
model families (flax in the reference), ``ravel_pytree`` and the
federated sessions come over with ROADMAP item 14.
"""

from .encoding import (
    FieldSizingError,
    FixedPointCodec,
    field_capacity,
    field_headroom_check,
)

__all__ = [
    "FieldSizingError",
    "FixedPointCodec",
    "field_capacity",
    "field_headroom_check",
]
