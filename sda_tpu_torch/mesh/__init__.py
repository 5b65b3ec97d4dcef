"""Single-device execution of the aggregation round."""

from .simpod import single_chip_round
