"""Seeded poisoning populations: adversarial-INPUT chaos.

The failpoint registry models infrastructure failure (errors, delays,
death); this module models the other production threat a million-device
FL service faces — devices that run the protocol *correctly* but feed it
*malicious* inputs (PAPER.md's threat model is honest-but-curious, so
the reveal proves the sum is exact without saying anything about whether
the summands are honest). Poisoning keeps the chaos layer's determinism
discipline: attacker selection is a pure function of ``(seed, epoch)``
exactly like :func:`~sda_tpu_torch.chaos.churn_schedule`, so a poisoned drill
replays bit-for-bit and an A/B against the clean run is meaningful.

Three attack kinds, each a corruption of the float model delta BEFORE
``FixedPointCodec.quantize`` (the attacker runs the standard client
stack — masking, sharing and the bit-exact reveal are untouched, which
is exactly why the protocol layer cannot catch this alone):

- ``boost:FACTOR`` — scale the delta by FACTOR (model-replacement /
  boosting attacks; negative factors flip AND amplify, the classic
  untargeted "push the global model away" move).
- ``signflip`` — negate the delta (gradient-ascent attacker; alias of
  ``boost:-1``).
- ``backdoor:TRIGGER_DIM`` — train on trigger-stamped inputs relabeled
  to class 0 (targeted attack; the corruption happens in the attacker's
  local TRAINING data, so the submitted delta is a genuinely-trained
  backdoor direction — see ``fl/data.py:apply_backdoor_trigger``).

Defenses live where the data flows: the codec clamps adversarial floats
and enforces an L2 norm bound by construction (``models/encoding.py``),
clerks count out-of-field share values (``clerk.share.out_of_range``),
and tree mode's root can take a trimmed mean over leaf subtotals
(``tree/round.py``). ``docs/robustness.md`` has the failure matrix.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

__all__ = ["parse_poison_kind", "poison_schedule", "corrupt_delta",
           "POISON_KINDS"]

#: the attack kinds ``--poison-kind`` accepts (spec grammar in parens)
POISON_KINDS = ("boost:FACTOR", "signflip", "backdoor:TRIGGER_DIM")


def parse_poison_kind(spec: str) -> Dict[str, object]:
    """Parse a ``--poison-kind`` spec into ``{"kind", "factor",
    "trigger_dim"}`` with typed errors (the same compact-grammar style as
    :func:`~sda_tpu_torch.chaos.parse_spec`).

        parse_poison_kind("boost:-8")     -> kind=boost, factor=-8.0
        parse_poison_kind("signflip")     -> kind=signflip
        parse_poison_kind("backdoor:17")  -> kind=backdoor, trigger_dim=17
    """
    spec = (spec or "").strip()
    kind, _, arg = spec.partition(":")
    if kind == "signflip":
        if arg:
            raise ValueError(
                f"poison kind {spec!r}: signflip takes no argument")
        return {"kind": "signflip", "factor": -1.0, "trigger_dim": None}
    if kind == "boost":
        if not arg:
            raise ValueError(
                f"poison kind {spec!r}: boost needs a factor (boost:FACTOR)")
        try:
            factor = float(arg)
        except ValueError:
            raise ValueError(
                f"poison kind {spec!r}: boost factor {arg!r} is not a number")
        if factor == 1.0:
            raise ValueError(
                f"poison kind {spec!r}: boost:1 is the identity, not an "
                "attack")
        return {"kind": "boost", "factor": factor, "trigger_dim": None}
    if kind == "backdoor":
        if not arg:
            raise ValueError(
                f"poison kind {spec!r}: backdoor needs a trigger dimension "
                "(backdoor:TRIGGER_DIM)")
        try:
            trigger_dim = int(arg)
        except ValueError:
            raise ValueError(
                f"poison kind {spec!r}: trigger dim {arg!r} is not an int")
        if trigger_dim < 0:
            raise ValueError(
                f"poison kind {spec!r}: trigger dim must be >= 0")
        return {"kind": "backdoor", "factor": None,
                "trigger_dim": trigger_dim}
    raise ValueError(
        f"unknown poison kind {spec!r}; expected one of "
        f"{', '.join(POISON_KINDS)}")


def poison_schedule(agents: int, rate: float, seed: int = 0,
                    epoch: Optional[int] = None) -> List[dict]:
    """Seeded per-agent attacker plan — ``churn_schedule``'s exact
    ``(seed, epoch)`` RNG discipline applied to adversary selection:
    each of ``agents`` entries decides whether that agent is an ATTACKER
    this epoch (probability ``rate``). ``epoch`` folds the round index
    into the key so a recurring workload draws an independent-but-
    reproducible attacker set per round from one seed — who attacks in
    round 3 does not depend on round 2, but both replay exactly. The
    poison key is disjoint from the churn key, so churn + poison compose
    from one seed without correlating.

    The plan says WHO attacks; the drill (``fl/scenario.py``) applies
    the corruption, which keeps the plan reusable and the corruption
    testable in isolation (:func:`corrupt_delta`)."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"poison rate {rate} outside [0, 1]")
    key = f"{seed}:poison" if epoch is None else f"{seed}:poison:{int(epoch)}"
    rng = random.Random(key)
    return [{"index": index, "attacker": rng.random() < rate}
            for index in range(agents)]


def corrupt_delta(delta: np.ndarray, kind: Dict[str, object]) -> np.ndarray:
    """Apply a parsed attack kind to a float model delta. ``backdoor``
    is a no-op here — its corruption happens at training time (stamped,
    relabeled local data), so the delta is already the attack."""
    delta = np.asarray(delta)
    if kind["kind"] in ("boost", "signflip"):
        return delta * np.asarray(kind["factor"], dtype=delta.dtype)
    return delta
