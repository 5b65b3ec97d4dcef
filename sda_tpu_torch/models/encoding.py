"""Fixed-point encoding of float model vectors into Z_m.

Port of ``sda_tpu/models/encoding.py``: the host (numpy) lane is the
reference's, and ``encode_device`` is torch on an explicit device.
``ravel_pytree`` flattens nested dicts and lists of tensors (a
``state_dict`` too) in jax's order.

The reference aggregates i64 vectors and leaves the float<->integer story
to the application ("combining locally trained machine learning models",
reference README.md:3-15; `Secret = i64`, client/src/crypto/mod.rs:33-36).
This module owns that story for the TPU build: a deterministic fixed-point
codec whose central guarantee is *exactness of the aggregate* — the secure
modular sum of encodings decodes to the exact sum of the quantized client
values, provided the configured summand capacity is respected.

Centered representation: a quantized value q in [-Q, Q] is uploaded as
q mod m. Sums stay decodable while |sum q_i| < m/2, so the codec derives
its clip range from (modulus, fractional_bits, max_summands) and refuses
configurations that could wrap. This mirrors the headroom discipline the
reference leaves implicit (values "assumed small enough", sharing/
additive.rs:37-39) but makes it a checked, documented contract.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "FieldSizingError",
    "FixedPointCodec",
    "field_capacity",
    "field_headroom_check",
    "ravel_pytree",
]


class FieldSizingError(ValueError):
    """A configuration whose worst-case aggregate could wrap the field.

    Raised by :func:`field_headroom_check` — the one headroom rule shared
    by :class:`FixedPointCodec` and every analytics encoder
    (``sda_tpu_torch/analytics``), so the two contracts cannot drift. A
    subclass of ``ValueError`` so existing callers keep catching it.
    """


def field_capacity(modulus: int, max_summands: int) -> int:
    """Largest per-coordinate magnitude the centered band can carry.

    A sum of ``max_summands`` contributions each bounded by the returned
    value stays strictly inside the decodable band ``|sum| <= m//2 - 1``
    (centered lift, matching ``RecipientOutput.positive()``'s canonical
    band shifted to (-m/2, m/2]).
    """
    if modulus < 3:
        raise FieldSizingError(f"modulus {modulus} must be >= 3")
    if max_summands < 1:
        raise FieldSizingError(f"max_summands {max_summands} must be >= 1")
    return (modulus // 2 - 1) // int(max_summands)


def field_headroom_check(max_abs: int, max_summands: int, modulus: int,
                         *, context: str = "") -> int:
    """THE modulus-headroom rule: refuse configurations that could wrap.

    Checks that the worst-case aggregate magnitude ``max_abs *
    max_summands`` fits the centered decodable band of ``modulus`` and
    returns the remaining margin (``m//2 - 1 - max_abs*max_summands``,
    always >= 0 on success). Raises :class:`FieldSizingError` naming the
    whole configuration otherwise — a misconfigured encoder is a typed
    error at construction, never a silent wrap at decode.

    ``context`` names the caller (e.g. ``"FixedPointCodec"`` or
    ``"CountMinEncoder(width=64, depth=4)"``) so the error says WHICH
    contract failed.
    """
    max_abs = int(max_abs)
    if max_abs < 1:
        raise FieldSizingError(
            f"{context or 'field sizing'}: max per-coordinate contribution "
            f"{max_abs} must be >= 1")
    cap = field_capacity(modulus, max_summands)
    margin = modulus // 2 - 1 - max_abs * int(max_summands)
    if margin < 0:
        raise FieldSizingError(
            f"{context or 'field sizing'}: per-coordinate contribution up "
            f"to {max_abs} x {max_summands} summands needs a decodable "
            f"band of {max_abs * int(max_summands)}, but modulus {modulus} "
            f"only carries |sum| <= {modulus // 2 - 1} "
            f"(per-coordinate capacity {cap}): increase the modulus or "
            f"lower max_summands")
    return margin


def _tree_leaves(tree, out):
    """Append ``tree``'s leaves to ``out`` in jax's order: a dict's values
    by sorted key, a list's or tuple's in order, depth first."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            _tree_leaves(tree[key], out)
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            _tree_leaves(item, out)
    else:
        out.append(tree)
    return out


def _tree_rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves`` (each container keeps its type and key order)."""
    if isinstance(tree, dict):
        done = {key: _tree_rebuild(tree[key], leaves) for key in sorted(tree)}
        return type(tree)((key, done[key]) for key in tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_rebuild(item, leaves) for item in tree)
    return next(leaves)


def ravel_pytree(tree):
    """Flatten a tree of float tensors to one float64 vector.

    The tree is nested dicts, lists and tuples (a module's ``state_dict``
    too) of tensors, numpy arrays or numbers; dicts flatten by sorted key
    as jax's pytrees do, so a dict tree gives the reference's vector,
    coordinate for coordinate. The vector lies on the first leaf's device.
    Returns (vector, unravel) where unravel maps a same-length float
    vector (tensor or numpy) back to the original structure, each leaf a
    tensor of its original shape, dtype and device. This is the analog of
    the reference's "the model IS the vector" convention (README.md:3-15):
    one participation carries one flattened model (or model delta).
    """
    leaves = [torch.as_tensor(leaf) for leaf in _tree_leaves(tree, [])]
    home = leaves[0].device if leaves else torch.device("cpu")
    specs = [(leaf.shape, leaf.dtype, leaf.device, leaf.numel())
             for leaf in leaves]
    vec = torch.cat([leaf.detach().reshape(-1).to(home, torch.float64)
                     for leaf in leaves]) if leaves \
        else torch.zeros((0,), dtype=torch.float64)

    def unravel(flat):
        flat = torch.as_tensor(flat).to(home, torch.float64)
        if flat.shape != vec.shape:
            raise ValueError(f"expected shape {tuple(vec.shape)}, got "
                             f"{tuple(flat.shape)}")
        out, off = [], 0
        for shape, dtype, device, size in specs:
            out.append(flat[off:off + size].reshape(shape).to(
                device, dtype, copy=True))
            off += size
        return _tree_rebuild(tree, iter(out))

    return vec, unravel


class FixedPointCodec:
    """Deterministic fixed-point codec float -> Z_m with summand capacity.

    Parameters
    ----------
    modulus:
        The aggregation modulus m (additive scheme modulus or the Shamir
        prime; resources.rs:44-67 carries it in-band in the Aggregation).
    fractional_bits:
        Scale = 2**fractional_bits. Quantization step is 2**-fractional_bits.
    max_summands:
        Largest number of vectors that will ever be summed under one
        aggregation (participants; clerk partial sums never exceed this).
        The decodable band is |sum| < m/2, so per-value magnitude is capped
        at clip = floor((m//2 - 1) / max_summands) / scale.
    clip:
        Optional tighter magnitude bound (floats are clamped to [-clip, clip]
        before quantization). Must not exceed the capacity-derived bound.
    norm_clip:
        Optional L2 bound enforced BY CONSTRUCTION: any vector whose
        Euclidean norm exceeds it is projected onto the norm_clip ball
        before quantization. This is the input-side poisoning defense —
        a boosted or sign-flipped update cannot contribute more L2 mass
        than an honest one, because the bound lives in the codec every
        client routes through, not in a flag a malicious client could
        skip. Host-lane only: the float64 norm reduction is not
        bit-reproducible across numpy and XLA, so ``encode_device``
        rejects the combination with a typed error.

    Adversarial floats (NaN/±Inf) clamp deterministically on BOTH lanes:
    NaN -> 0, ±Inf -> ±clip — never an undefined int cast (``np.clip``
    passes NaN through, so the scrub happens explicitly first).
    """

    __slots__ = ("modulus", "fractional_bits", "scale", "max_summands",
                 "clip", "norm_clip", "_q_max")

    def __init__(self, modulus: int, fractional_bits: int, max_summands: int,
                 clip: Optional[float] = None,
                 norm_clip: Optional[float] = None):
        modulus = int(modulus)
        if modulus < 3:
            raise ValueError("modulus must be >= 3")
        if max_summands < 1:
            raise ValueError("max_summands must be >= 1")
        self.modulus = modulus
        self.fractional_bits = int(fractional_bits)
        self.scale = float(1 << self.fractional_bits)
        self.max_summands = int(max_summands)
        q_cap = field_capacity(modulus, self.max_summands)
        if q_cap < 1:
            raise FieldSizingError(
                f"modulus {modulus} has no headroom for {max_summands} "
                f"summands: increase the modulus or lower max_summands"
            )
        cap = q_cap / self.scale
        if clip is None:
            clip = cap
        elif clip > cap:
            raise ValueError(
                f"clip {clip} exceeds the exactness capacity {cap:.6g} "
                f"(modulus {modulus}, {max_summands} summands, "
                f"{self.fractional_bits} fractional bits)"
            )
        elif clip <= 0:
            raise ValueError("clip must be positive")
        self.clip = float(clip)
        if norm_clip is not None:
            norm_clip = float(norm_clip)
            if not norm_clip > 0:
                raise ValueError("norm_clip must be positive")
        self.norm_clip = norm_clip
        self._q_max = int(round(self.clip * self.scale))
        # seal the invariant through the SHARED headroom rule (the same
        # one every analytics encoder calls), so the codec's capacity
        # derivation above and the field contract cannot drift apart
        field_headroom_check(max(1, self._q_max), self.max_summands,
                             modulus, context="FixedPointCodec")

    @property
    def q_max(self) -> int:
        """The integer quantization cap: |quantize(x)| <= q_max, so the
        worst-case sum magnitude is q_max * max_summands (< m/2 by the
        constructor's capacity rule)."""
        return self._q_max

    # -- host (numpy) path -------------------------------------------------

    def quantize(self, x) -> np.ndarray:
        """Float array -> signed quantized int64 in [-q_max, q_max].

        Quantization happens in float32 — the same arithmetic the device
        path uses — so host and device encodings are bit-identical (both
        numpy and XLA round half to even). Adversarial floats clamp
        deterministically: NaN -> 0 (np.clip would pass it through into
        an undefined int64 cast), ±Inf -> ±clip. With ``norm_clip``, the
        per-coordinate clamp happens FIRST (bounding every coordinate,
        Inf included), then the L2 projection — computed in float64 so
        the scale factor is deterministic — shrinks the whole vector
        onto the norm ball.
        """
        x32 = np.asarray(x, dtype=np.float32)
        x32 = np.where(np.isnan(x32), np.float32(0.0), x32)
        x32 = np.clip(x32, np.float32(-self.clip), np.float32(self.clip))
        if self.norm_clip is not None:
            x64 = x32.astype(np.float64)
            norm = float(np.sqrt(np.sum(x64 * x64)))
            if norm > self.norm_clip:
                x32 = (x64 * (self.norm_clip / norm)).astype(np.float32)
        q = np.rint(x32 * np.float32(self.scale)).astype(np.int64)
        return np.clip(q, -self._q_max, self._q_max)

    def encode(self, x) -> np.ndarray:
        """Float array -> representatives in [0, modulus) ready to share."""
        return np.mod(self.quantize(x), self.modulus).astype(np.int64)

    def decode_sum(self, values, summands: int = 1) -> np.ndarray:
        """Aggregate in [0, m) -> exact float sum of the quantized inputs.

        ``summands`` is checked against the configured capacity; the lift is
        centered, matching RecipientOutput.positive()'s canonical band
        (receive.rs:14-21) shifted to (-m/2, m/2].
        """
        v = np.asarray(values, dtype=np.int64)
        if summands < 1:
            # a zero/negative summand count is always a caller bug (an
            # empty frozen set, a None participation count propagated
            # into the mean): fail typed here rather than as a
            # ZeroDivisionError inside decode_mean or a silently wrong
            # "sum of zero things" — and name the aggregation context so
            # the error is actionable from a decoder stack trace
            raise ValueError(
                f"decode needs at least one summand, got {summands} "
                f"(aggregation: dim {v.size}, modulus {self.modulus}, "
                f"capacity {self.max_summands} summands; empty frozen "
                "set? use the revealed participation count)"
            )
        if summands > self.max_summands:
            raise ValueError(
                f"{summands} summands exceeds configured capacity "
                f"{self.max_summands} (aggregation: dim {v.size}, "
                f"modulus {self.modulus}); the sum may have wrapped"
            )
        v = np.mod(v, self.modulus)
        half = self.modulus // 2
        centered = v - np.where(v > half, self.modulus, 0)
        return centered.astype(np.float64) / self.scale

    def decode_mean(self, values, summands: int) -> np.ndarray:
        return self.decode_sum(values, summands) / float(summands)

    # -- device (torch) path ------------------------------------------------

    def encode_device(self, x, device=None) -> torch.Tensor:
        """Float array or tensor -> int64 residues in [0, m) on ``device``
        (CUDA unless ``device="cpu"``).

        Matches the host ``encode`` bit-for-bit: both paths scrub NaN,
        clip, scale, and round in float32 (half-to-even), then clamp to
        the q_max boundary. Requires clip * scale within float32's
        exact-integer range (2^24) so the rounded product is
        representable. The residues are int64, the port's residue type
        (the reference's are int32, for moduli below 2^31).
        """
        if self.norm_clip is not None:
            raise ValueError(
                f"norm_clip {self.norm_clip} is a host-lane contract: the "
                "L2 reduction is not bit-reproducible between numpy and "
                "torch; use the host encode() for norm-clipped configs"
            )
        if self._q_max > (1 << 24):
            raise ValueError(
                f"q_max {self._q_max} exceeds float32's exact-integer range; "
                "use the host encode() for this configuration"
            )
        dev = resolve_device(device)
        xf = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
        xf = torch.where(torch.isnan(xf), torch.zeros_like(xf), xf)
        clip = torch.tensor(self.clip, dtype=torch.float32, device=dev)
        xc = torch.minimum(torch.maximum(xf, -clip), clip)
        q = torch.round(xc * self.scale).to(torch.int64)
        q = torch.clamp(q, -self._q_max, self._q_max)
        return torch.where(q < 0, q + self.modulus, q)

    # -- misc ----------------------------------------------------------------

    def __repr__(self):
        norm = ("" if self.norm_clip is None
                else f", norm_clip={self.norm_clip:.6g}")
        return (f"FixedPointCodec(modulus={self.modulus}, "
                f"fractional_bits={self.fractional_bits}, "
                f"max_summands={self.max_summands}, clip={self.clip:.6g}"
                f"{norm})")
