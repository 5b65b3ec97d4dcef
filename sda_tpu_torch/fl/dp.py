"""Central differential privacy for the FL scenario: the Gaussian
mechanism at the recipient, with simple composed accounting.

Scope — deliberately modest (the caveats live in docs/federated.md):

- **Central model.** Noise is added by the *recipient* to the revealed
  aggregate. The secure-aggregation layer already hides individuals from
  the server and any sub-threshold quorum; the DP knob additionally
  bounds what the revealed sums leak about one device across rounds. The
  recipient is trusted to add the noise (it sees the exact sum either
  way — that is the protocol's design point).
- **Sensitivity from the codec clip.** The codec clips per coordinate to
  ``c``, so one device's quantized update has L2 norm at most
  ``c * sqrt(dim)`` — a worst-case box bound, conservative for real
  gradients. Quantization (half-to-even on a ``2^-f`` grid) never
  increases the per-coordinate bound, so the clip survives encoding.
- **zCDP composition.** The Gaussian mechanism with noise multiplier
  ``sigma`` (noise std ``sigma * sensitivity`` on the sum) satisfies
  ``1/(2 sigma^2)``-zCDP; R adaptive rounds compose to
  ``rho = R / (2 sigma^2)``, converted to ``(eps, delta)`` via the
  standard ``eps = rho + 2 sqrt(rho ln(1/delta))`` bound (Bun &
  Steinberg 2016). No subsampling amplification is claimed — the drill
  population participates every round.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["apply_gaussian_noise", "gaussian_accounting"]


def apply_gaussian_noise(sum_delta, *, sigma: float, clip: float,
                         seed: int, round_index: int):
    """Add one round's central-DP noise to the revealed SUM.

    The single noise rule both scenario modes share (and the rule
    :func:`gaussian_accounting` accounts for): iid per-coordinate
    ``N(0, (sigma * clip * sqrt(dim))^2)``, seeded on
    ``(seed, round)`` so fixed-seed runs reproduce exactly. Applied to
    the sum BEFORE the dropout-weighted division — the accounting's
    sensitivity bound is on the sum, and the caller's division is
    post-processing.
    """
    sum_delta = np.asarray(sum_delta, dtype=np.float64)
    clip_l2 = float(clip) * math.sqrt(sum_delta.size)
    noise = np.random.default_rng(
        [int(seed), 0xD9, int(round_index)]).normal(
        0.0, float(sigma) * clip_l2, size=sum_delta.size)
    return sum_delta + noise


def gaussian_accounting(sigma: float, rounds: int, *, clip: float,
                        dim: int, delta: float = 1e-5) -> dict:
    """Accounting block for ``rounds`` Gaussian-mechanism releases.

    ``sigma`` is the noise MULTIPLIER: each round's revealed sum gets
    iid ``N(0, (sigma * clip_l2)^2)`` noise per coordinate, where
    ``clip_l2 = clip * sqrt(dim)`` is the per-device L2 sensitivity
    bound derived from the codec's per-coordinate clip. Returns the
    JSON-able report block (``rho_zcdp``, ``epsilon``, ``delta``, the
    sensitivity used, and the per-round mean-noise scale is left to the
    caller, who knows the per-round summand count).
    """
    if sigma <= 0:
        raise ValueError("sigma must be positive (0 disables DP)")
    if rounds < 1:
        raise ValueError("rounds must be >= 1")
    if not 0 < delta < 1:
        raise ValueError("delta must be in (0, 1)")
    clip_l2 = float(clip) * math.sqrt(dim)
    rho = rounds / (2.0 * sigma * sigma)
    epsilon = rho + 2.0 * math.sqrt(rho * math.log(1.0 / delta))
    return {
        "mechanism": "central gaussian on the revealed sum",
        "sigma": float(sigma),
        "rounds": int(rounds),
        "clip_per_coordinate": float(clip),
        "clip_l2": clip_l2,
        "noise_std_sum": float(sigma) * clip_l2,
        "rho_zcdp": rho,
        "epsilon": epsilon,
        "delta": float(delta),
        "caveats": "worst-case box sensitivity; no subsampling "
                   "amplification; quantization treated as post-processing",
    }
