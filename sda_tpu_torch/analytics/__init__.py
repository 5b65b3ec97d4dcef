"""Federated analytics plane (L6, sibling of ``fl/``).

The substrate's one primitive — a secure modular sum — powers more than
FedAvg: this package is the encoder/decoder family that turns the SAME
mask→share→combine→reconstruct round into secure histograms,
frequency/heavy-hitter estimation (count-min / count-sketch), quantile
estimation and A/B metric aggregation, plus the scenario driver
(``sda-sim --analytics``) that proves each of them end-to-end over the
real multi-tenant scheduled service. See docs/analytics.md.
"""

from .encoders import (
    ABMetricEncoder,
    AnalyticsEncoder,
    CountMinEncoder,
    CountSketchEncoder,
    ENCODERS,
    HistogramEncoder,
    QuantileEncoder,
    make_encoder,
)
from .scenario import AnalyticsProfile, expand_kinds, run_analytics

__all__ = [
    "ABMetricEncoder",
    "AnalyticsEncoder",
    "AnalyticsProfile",
    "CountMinEncoder",
    "CountSketchEncoder",
    "ENCODERS",
    "HistogramEncoder",
    "QuantileEncoder",
    "expand_kinds",
    "make_encoder",
    "run_analytics",
]
