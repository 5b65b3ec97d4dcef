"""Environment-variable knob parsing — the one parser for every
``SDA_*`` tunable (HTTP client retry knobs, long-poll bounds, ...), so
the knobs can't drift in how they treat blanks or garbage."""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)

__all__ = ["env_float"]


def env_float(name: str, default: float) -> float:
    """Float env knob with a default; blank or unparseable values fall
    back (with a warning) instead of crashing the process at import."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        log.warning("ignoring unparseable %s=%r", name, raw)
        return default
