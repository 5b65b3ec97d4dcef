"""Analytics encoders/decoders over the secure-sum primitive.

The substrate computes exactly one thing — a secure modular sum of
integer vectors — but that primitive powers far more than FedAvg: a
different client-side *encoder* in front of the same
mask→share→combine→reconstruct round yields secure histograms,
frequency/heavy-hitter estimation, quantile estimation and A/B metric
aggregation. This module is that encoder/decoder family:

- every encoder maps one device's private value(s) to an integer
  **contribution vector** whose per-coordinate magnitude is bounded by
  the encoder's declared ``max_abs``, uploaded as residues in
  ``[0, modulus)``;
- every decoder interprets the *revealed exact sum* (the recipient's
  ``RecipientOutput.positive().values``) — nothing about the round
  itself changes, so bit-exactness of the sum is inherited from the
  substrate and the only new error source is the encoding itself;
- every encoder declares a **field-sizing contract**: binding it to a
  ``(modulus, max_summands)`` pair routes through the SAME
  :func:`~sda_tpu_torch.models.encoding.field_headroom_check` rule
  ``FixedPointCodec`` uses, so packed-Shamir and tree moduli are sized
  correctly by construction and a misconfigured encoder is a typed
  :class:`~sda_tpu_torch.models.encoding.FieldSizingError`, not a silent wrap.

Error-bound semantics per encoder (docs/analytics.md):

- ``HistogramEncoder`` / ``ABMetricEncoder``: **exact** — the decoded
  counts/moments equal the plaintext tally of the frozen set (A/B
  means/variances are exact in the quantized domain; the float-domain
  error is the fixed-point grid).
- ``CountMinEncoder``: **ε–δ, overestimate-only** — every point query
  satisfies ``true <= est`` always, and ``est <= true + eps * total``
  with probability ``>= 1 - delta`` per query (``eps = e/width``,
  ``delta = exp(-depth)``).
- ``CountSketchEncoder``: **ε–δ, unbiased** — each row estimate is
  unbiased; the median over ``depth`` rows satisfies
  ``|est - true| <= sqrt(3 * F2 / width)`` with probability
  ``>= 1 - delta`` (``delta = exp(-depth/6)``, ``F2`` the second
  frequency moment of the aggregated stream).
- ``QuantileEncoder``: **grid resolution** — each decoded quantile is
  within one grid step ``(hi - lo) / bins`` of the exact sample
  quantile of the frozen set (for in-range data).

Sketch hash families are seeded: recipient and devices must agree on
the family, so the seed rides the aggregation identity (the scenario
derives it from the schedule name + run seed — one deterministic
value both sides compute; see ``analytics/scenario.py``).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterable, List, Optional, Sequence, Type

import numpy as np

from ..models.encoding import FieldSizingError, field_headroom_check

__all__ = [
    "ABMetricEncoder",
    "AnalyticsEncoder",
    "CountMinEncoder",
    "CountSketchEncoder",
    "ENCODERS",
    "HistogramEncoder",
    "QuantileEncoder",
    "make_encoder",
]


def _hash_lane(seed: int, row: int, item) -> int:
    """Deterministic 64-bit hash of ``item`` for sketch row ``row`` under
    the shared family ``seed`` — stable across processes and platforms
    (blake2b, not Python's randomized ``hash``)."""
    digest = hashlib.blake2b(
        f"{int(seed)}:{int(row)}:{item!r}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little")


class AnalyticsEncoder:
    """Base contract every analytics encoder implements.

    Subclasses set ``kind`` (registry name), ``dim`` (the aggregation's
    vector dimension), ``max_abs`` (the largest per-coordinate magnitude
    one device can contribute — THE field-sizing declaration) and
    ``values_per_device`` (raw private values one encode call carries,
    the throughput accounting unit). ``bind(modulus, max_summands)``
    checks the contract through the shared headroom rule and must be
    called before any encode/decode.
    """

    kind = "abstract"
    #: human-readable error-bound class: exact | eps-delta | grid
    error_contract = "exact"

    dim: int
    max_abs: int
    values_per_device: int

    def __init__(self):
        self.modulus: Optional[int] = None
        self.max_summands: Optional[int] = None
        self.headroom_margin: Optional[int] = None

    # -- field-sizing contract --------------------------------------------

    def bind(self, modulus: int, max_summands: int) -> "AnalyticsEncoder":
        """Check the field-sizing contract (max per-coordinate
        contribution x max participants against the centered decodable
        band) and arm the encoder for ``encode``/``decode``. Raises
        :class:`FieldSizingError` naming this encoder otherwise."""
        self.headroom_margin = field_headroom_check(
            self.max_abs, max_summands, modulus, context=repr(self))
        self.modulus = int(modulus)
        self.max_summands = int(max_summands)
        return self

    def _require_bound(self) -> int:
        if self.modulus is None:
            raise FieldSizingError(
                f"{self!r} is not bound to a field: call "
                "bind(modulus, max_summands) before encode/decode so the "
                "headroom contract is checked")
        return self.modulus

    # -- encode / decode ----------------------------------------------------

    def contribution(self, value) -> np.ndarray:
        """One device's signed integer contribution vector
        (``|entry| <= max_abs``). Subclasses implement this."""
        raise NotImplementedError

    def encode(self, value) -> np.ndarray:
        """One device's upload: the contribution as residues in
        ``[0, modulus)`` — exactly what ``participate`` ships."""
        m = self._require_bound()
        contrib = np.asarray(self.contribution(value), dtype=np.int64)
        if contrib.shape != (self.dim,):
            raise ValueError(
                f"{self!r}: contribution shape {contrib.shape} != "
                f"({self.dim},)")
        peak = int(np.abs(contrib).max()) if contrib.size else 0
        if peak > self.max_abs:
            raise FieldSizingError(
                f"{self!r}: contribution magnitude {peak} exceeds the "
                f"declared per-coordinate bound {self.max_abs} — the "
                "field-sizing contract would be a lie")
        return np.mod(contrib, m).astype(np.int64)

    def lift(self, revealed) -> np.ndarray:
        """Centered lift of the revealed sum into (-m/2, m/2] — the
        decoder-side inverse of the residue upload."""
        m = self._require_bound()
        v = np.mod(np.asarray(revealed, dtype=np.int64), m)
        half = m // 2
        return v - np.where(v > half, m, 0)

    def decode(self, revealed, summands: int) -> dict:
        """Interpret the revealed exact sum; returns the encoder's result
        block. Subclasses implement this."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(dim={getattr(self, 'dim', '?')})"


#: kind -> encoder class; the scenario driver and CLI resolve through this.
ENCODERS: Dict[str, Type[AnalyticsEncoder]] = {}


def _register(cls: Type[AnalyticsEncoder]) -> Type[AnalyticsEncoder]:
    ENCODERS[cls.kind] = cls
    return cls


def make_encoder(kind: str, **params) -> AnalyticsEncoder:
    """Registry constructor; unknown kinds are a typed error naming the
    registry, not a KeyError three frames deep."""
    try:
        cls = ENCODERS[kind]
    except KeyError:
        raise ValueError(
            f"unknown analytics encoder {kind!r} "
            f"(registered: {', '.join(sorted(ENCODERS))})") from None
    return cls(**params)


# ---------------------------------------------------------------------------
# histogram


@_register
class HistogramEncoder(AnalyticsEncoder):
    """Bounded-range binning with exact counts.

    Each device holds up to ``samples_per_device`` scalar samples in
    ``[lo, hi]``; its contribution is the per-bin count vector
    (out-of-range samples clamp deterministically to the edge bins, so
    adversarial floats cannot escape the contract). The revealed sum IS
    the population histogram — exact, no estimation error.
    """

    kind = "histogram"
    error_contract = "exact"

    def __init__(self, lo: float = 0.0, hi: float = 1.0, bins: int = 16,
                 samples_per_device: int = 1):
        super().__init__()
        if not hi > lo:
            raise ValueError(f"histogram range [{lo}, {hi}] is empty")
        if bins < 1:
            raise ValueError("bins must be >= 1")
        if samples_per_device < 1:
            raise ValueError("samples_per_device must be >= 1")
        self.lo, self.hi, self.bins = float(lo), float(hi), int(bins)
        self.dim = self.bins
        self.max_abs = int(samples_per_device)
        self.values_per_device = int(samples_per_device)

    def bin_of(self, sample: float) -> int:
        x = float(sample)
        if math.isnan(x):
            x = self.lo  # deterministic, like the codec's NaN scrub
        frac = (min(max(x, self.lo), self.hi) - self.lo) / (self.hi - self.lo)
        return min(self.bins - 1, int(frac * self.bins))

    def contribution(self, samples) -> np.ndarray:
        samples = np.atleast_1d(np.asarray(samples, dtype=np.float64))
        if samples.size > self.values_per_device:
            raise FieldSizingError(
                f"{self!r}: {samples.size} samples exceed the declared "
                f"samples_per_device {self.values_per_device}")
        out = np.zeros(self.dim, dtype=np.int64)
        for x in samples:
            out[self.bin_of(x)] += 1
        return out

    def decode(self, revealed, summands: int) -> dict:
        counts = self.lift(revealed)
        edges = np.linspace(self.lo, self.hi, self.bins + 1)
        return {"counts": counts, "edges": edges,
                "total": int(counts.sum())}

    def __repr__(self):
        return (f"HistogramEncoder(bins={self.bins}, range=[{self.lo:.6g}, "
                f"{self.hi:.6g}], samples_per_device={self.values_per_device})")


# ---------------------------------------------------------------------------
# sketches


class _SketchEncoder(AnalyticsEncoder):
    """Shared machinery for the seeded-hash-family sketches: a
    ``depth x width`` table flattened into one aggregation vector, the
    family seed shared recipient<->devices via the aggregation seed."""

    def __init__(self, width: int = 64, depth: int = 4, seed: int = 0,
                 items_per_device: int = 1):
        super().__init__()
        if width < 2 or depth < 1:
            raise ValueError(f"sketch needs width >= 2 and depth >= 1, "
                             f"got width={width} depth={depth}")
        if items_per_device < 1:
            raise ValueError("items_per_device must be >= 1")
        self.width, self.depth = int(width), int(depth)
        self.seed = int(seed)
        self.dim = self.width * self.depth
        # worst case every one of a device's items lands in ONE cell
        self.max_abs = int(items_per_device)
        self.values_per_device = int(items_per_device)

    def _cell(self, row: int, item) -> int:
        return row * self.width + _hash_lane(self.seed, row, item) % self.width

    def _check_items(self, items: Sequence) -> Sequence:
        if len(items) > self.values_per_device:
            raise FieldSizingError(
                f"{self!r}: {len(items)} items exceed the declared "
                f"items_per_device {self.values_per_device}")
        return items

    def table(self, revealed) -> np.ndarray:
        return self.lift(revealed).reshape(self.depth, self.width)

    def heavy_hitters(self, revealed, candidates: Iterable,
                      threshold: float, total: int) -> List[tuple]:
        """Heavy-hitter extraction: every candidate whose estimated
        frequency reaches ``threshold * total``, heaviest first. The
        candidate domain is enumerated by the recipient (the sketch
        itself is one-way); the ε–δ contract bounds the estimates."""
        hits = []
        for item in candidates:
            est = self.estimate(revealed, item)
            if est >= threshold * total:
                hits.append((item, est))
        hits.sort(key=lambda pair: (-pair[1], repr(pair[0])))
        return hits

    def estimate(self, revealed, item) -> float:
        raise NotImplementedError


@_register
class CountMinEncoder(_SketchEncoder):
    """Count-min sketch: overestimate-only frequency estimation.

    ``est(item) = min over rows of the item's cell``; collisions only
    ADD, so ``true <= est`` always, and ``est <= true + eps * total``
    with probability ``>= 1 - delta`` per query, where ``eps = e/width``
    and ``delta = exp(-depth)`` (Cormode–Muthukrishnan).
    """

    kind = "countmin"
    error_contract = "eps-delta"

    @property
    def eps(self) -> float:
        return math.e / self.width

    @property
    def delta(self) -> float:
        return math.exp(-self.depth)

    def contribution(self, items) -> np.ndarray:
        out = np.zeros(self.dim, dtype=np.int64)
        for item in self._check_items(items):
            for row in range(self.depth):
                out[self._cell(row, item)] += 1
        return out

    def estimate(self, revealed, item) -> int:
        table = self.lift(revealed)
        return int(min(table[self._cell(row, item)]
                       for row in range(self.depth)))

    def error_bound(self, total: int) -> float:
        """The ε–δ additive overestimate bound for a stream of ``total``
        items: ``est - true <= eps * total`` w.p. ``>= 1 - delta``."""
        return self.eps * float(total)

    def __repr__(self):
        return (f"CountMinEncoder(width={self.width}, depth={self.depth}, "
                f"items_per_device={self.values_per_device})")


@_register
class CountSketchEncoder(_SketchEncoder):
    """Count-sketch: unbiased frequency estimation with signed buckets.

    Each row hashes the item to a bucket AND a sign in {-1, +1}; the
    estimate is the median over rows of ``sign * bucket``. Unbiased per
    row; the median satisfies ``|est - true| <= sqrt(3 * F2 / width)``
    with probability ``>= 1 - exp(-depth/6)`` (Chebyshev per row at
    failure probability 1/3, Chernoff over the median). Signed
    contributions ride the same non-negative residue upload — a ``-1``
    is ``m - 1``; the centered lift restores it.
    """

    kind = "countsketch"
    error_contract = "eps-delta"

    @property
    def delta(self) -> float:
        return math.exp(-self.depth / 6.0)

    def _sign(self, row: int, item) -> int:
        return 1 if _hash_lane(self.seed ^ 0x5D, row, item) & 1 else -1

    def contribution(self, items) -> np.ndarray:
        out = np.zeros(self.dim, dtype=np.int64)
        for item in self._check_items(items):
            for row in range(self.depth):
                out[self._cell(row, item)] += self._sign(row, item)
        return out

    def estimate(self, revealed, item) -> float:
        table = self.lift(revealed)
        return float(np.median([
            self._sign(row, item) * table[self._cell(row, item)]
            for row in range(self.depth)]))

    def error_bound(self, f2: float) -> float:
        """The ε–δ two-sided bound for second frequency moment ``f2``
        (sum of squared true counts): ``|est - true| <=
        sqrt(3 * f2 / width)`` w.p. ``>= 1 - delta``."""
        return math.sqrt(3.0 * float(f2) / self.width)

    def __repr__(self):
        return (f"CountSketchEncoder(width={self.width}, "
                f"depth={self.depth}, "
                f"items_per_device={self.values_per_device})")


# ---------------------------------------------------------------------------
# quantiles


@_register
class QuantileEncoder(AnalyticsEncoder):
    """Quantile estimation: a CDF over a histogram grid with interpolated
    decode.

    Encoding is the :class:`HistogramEncoder` contribution over ``bins``
    grid cells; the decoder builds the population CDF from the revealed
    exact counts and linearly interpolates each requested quantile
    within its cell. For in-range data the decoded quantile is within
    one grid step ``(hi - lo) / bins`` of the exact sample quantile —
    the declared grid-resolution bound.
    """

    kind = "quantile"
    error_contract = "grid"

    def __init__(self, lo: float = 0.0, hi: float = 1.0, bins: int = 64,
                 samples_per_device: int = 1):
        super().__init__()
        self._hist = HistogramEncoder(lo, hi, bins, samples_per_device)
        self.lo, self.hi, self.bins = self._hist.lo, self._hist.hi, \
            self._hist.bins
        self.dim = self._hist.dim
        self.max_abs = self._hist.max_abs
        self.values_per_device = self._hist.values_per_device

    @property
    def grid_step(self) -> float:
        """The declared error bound: one grid cell."""
        return (self.hi - self.lo) / self.bins

    def contribution(self, samples) -> np.ndarray:
        return self._hist.contribution(samples)

    def decode_quantiles(self, revealed, qs: Sequence[float]) -> np.ndarray:
        counts = self.lift(revealed).astype(np.float64)
        total = counts.sum()
        if total <= 0:
            raise ValueError(
                f"{self!r}: cannot decode quantiles of an empty population "
                f"(revealed total {total:.0f})")
        cdf = np.cumsum(counts)
        edges = np.linspace(self.lo, self.hi, self.bins + 1)
        out = np.empty(len(qs), dtype=np.float64)
        for ix, q in enumerate(qs):
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"quantile {q} outside [0, 1]")
            rank = q * total
            b = int(np.searchsorted(cdf, rank, side="left"))
            b = min(b, self.bins - 1)
            below = cdf[b - 1] if b > 0 else 0.0
            inside = counts[b]
            frac = ((rank - below) / inside) if inside > 0 else 0.0
            out[ix] = edges[b] + frac * (edges[b + 1] - edges[b])
        return out

    def decode(self, revealed, summands: int,
               qs: Sequence[float] = (0.1, 0.25, 0.5, 0.75, 0.9)) -> dict:
        return {
            "quantiles": {f"p{int(round(q * 100))}": float(v)
                          for q, v in
                          zip(qs, self.decode_quantiles(revealed, qs))},
            "grid_step": self.grid_step,
        }

    def __repr__(self):
        return (f"QuantileEncoder(bins={self.bins}, range=[{self.lo:.6g}, "
                f"{self.hi:.6g}], "
                f"samples_per_device={self.values_per_device})")


# ---------------------------------------------------------------------------
# A/B metrics


@_register
class ABMetricEncoder(AnalyticsEncoder):
    """A/B metric aggregation: per-arm sum/count/sum-of-squares lanes.

    Each device reports ``(arm, metric)`` with the metric in
    ``[lo, hi]``; the contribution carries three lanes per arm — count
    (1), the fixed-point quantized metric (``q``), and its square
    (``q^2``) — so the revealed sum decodes to per-arm count, mean and
    variance in one round. Exact in the quantized domain; the
    float-domain error is the fixed-point grid ``2^-fractional_bits``.

    The ``q^2`` lane dominates the field-sizing contract
    (``max_abs = q_max^2``): a modulus that fits FedAvg deltas can be
    far too small for second moments, which is exactly the misconfig
    the typed :class:`FieldSizingError` exists to catch.
    """

    kind = "ab"
    error_contract = "exact"

    def __init__(self, arms: int = 2, lo: float = -1.0, hi: float = 1.0,
                 fractional_bits: int = 6):
        super().__init__()
        if arms < 2:
            raise ValueError("an A/B encoder needs >= 2 arms")
        if not hi > lo:
            raise ValueError(f"metric range [{lo}, {hi}] is empty")
        self.arms = int(arms)
        self.lo, self.hi = float(lo), float(hi)
        self.fractional_bits = int(fractional_bits)
        self.scale = float(1 << self.fractional_bits)
        self.q_max = int(math.ceil(max(abs(self.lo), abs(self.hi))
                                   * self.scale))
        self.dim = 3 * self.arms
        self.max_abs = max(1, self.q_max, self.q_max * self.q_max)
        self.values_per_device = 1

    def quantize(self, metric: float) -> int:
        x = float(metric)
        if math.isnan(x):
            x = 0.0
        x = min(max(x, self.lo), self.hi)
        return int(round(x * self.scale))

    def contribution(self, value) -> np.ndarray:
        arm, metric = value
        arm = int(arm)
        if not 0 <= arm < self.arms:
            raise ValueError(f"arm {arm} outside [0, {self.arms})")
        q = self.quantize(metric)
        out = np.zeros(self.dim, dtype=np.int64)
        out[3 * arm] = 1            # count lane
        out[3 * arm + 1] = q        # sum lane (signed)
        out[3 * arm + 2] = q * q    # sum-of-squares lane
        return out

    def decode(self, revealed, summands: int) -> dict:
        lanes = self.lift(revealed).reshape(self.arms, 3)
        per_arm = {}
        for arm in range(self.arms):
            n, s, ss = (int(v) for v in lanes[arm])
            if n > 0:
                mean = s / n / self.scale
                # population variance in the quantized domain, exactly
                var = max(0.0, (ss / n - (s / n) ** 2)) / (self.scale ** 2)
            else:
                mean = var = None
            per_arm[f"arm{arm}"] = {"count": n, "mean": mean,
                                    "variance": var}
        return {"arms": per_arm,
                "total": int(lanes[:, 0].sum()),
                "quantization_step": 1.0 / self.scale}

    def __repr__(self):
        return (f"ABMetricEncoder(arms={self.arms}, range=[{self.lo:.6g}, "
                f"{self.hi:.6g}], fractional_bits={self.fractional_bits})")
