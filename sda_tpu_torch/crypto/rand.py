"""Randomness policy for security-critical draws (shares, masks) — port of
``sda_tpu/crypto/rand.py``.

The reference draws every share/mask element from OsRng (additive.rs:17,
full.rs:16) — information-theoretically fresh. A torch generator's seed is
only 64 bits, so deriving a whole share vector from one generator would cap
the scheme's privacy at brute-forcible 2^63 work. Policy here:

- ``secure`` (default): draws come from the ChaCha20 PRG keyed with a fresh
  256-bit OS seed per operation (sda_tpu_torch.fields.chacha) —
  computational security at the PRG level, host-side, the same draws as
  the JAX package's.
- ``fast``: drawn on the role's device by ``fields.uniform_mod`` from a
  63-bit OS seed — for benchmarks and trusted-simulation runs where the
  adversary model is absent. Callers must opt in explicitly
  (``set_mode("fast")`` or the ``mode=`` argument).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import fields
from ..device import resolve_device
from ..fields import chacha
from .core import fresh_prng_key

_MODE = "secure"
_MODES = ("secure", "fast")


def set_mode(mode: str) -> None:
    global _MODE
    if mode not in _MODES:
        raise ValueError(f"unknown randomness mode {mode!r}; choose from {_MODES}")
    _MODE = mode


def get_mode() -> str:
    return _MODE


def uniform(shape: Tuple[int, ...], modulus: int, mode: Optional[str] = None,
            device=None) -> np.ndarray:
    """Uniform int64 draws in [0, modulus) under the active policy; ``fast``
    draws on ``device`` (resolved as every entry point does)."""
    mode = mode or _MODE
    if mode == "fast":
        gen = fresh_prng_key(resolve_device(device))
        return fields.uniform_mod(gen, tuple(shape), modulus).cpu().numpy()
    n = int(np.prod(shape)) if shape else 1
    flat = chacha.expand_mask(chacha.random_seed(256), n, modulus)
    return flat.reshape(shape)
