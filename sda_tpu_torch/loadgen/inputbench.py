"""Participation-input micro-bench: ndarray pass-through vs the
per-element Python conversion the FL session used to do.

``FederatedSession.round`` historically converted every encoded delta to
a Python list — ``[int(v) for v in encoded]`` — before handing it to
``participate``, an O(dim) interpreter loop per participant per round
that also forced ``np.asarray(list)`` to re-materialize the array from
boxed ints. The client normalizes integer ndarrays in one vectorized
pass, so the loop bought nothing. This bench pins the delta at model
scale (default dim 10^5, the lora-13m neighborhood per shard):

    python -m sda_tpu_torch.loadgen.inputbench --dim 100000

Two measurements, best-of-``repeats`` each:

- ``seal``: full ``new_participation`` (mask + share + seal — the real
  participant hot path) fed by list vs ndarray;
- ``convert``: the input-normalization step alone (the pure overhead the
  list path adds).

Requires libsodium (the seal rung runs real sealed-box crypto).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np

__all__ = ["run_input_bench", "main"]

M31 = (1 << 31) - 1


def _best_of(fn, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run_input_bench(dim: int = 100_000, repeats: int = 5,
                    seed: int = 0, device=None) -> dict:
    """Run both rungs at ``dim``; returns the JSON-able report. ``device``:
    the participant's device (CUDA unless ``"cpu"``)."""
    from ..client import SdaClient
    from ..crypto import MemoryKeystore, sodium
    from ..models import FixedPointCodec
    from ..protocol import (
        AdditiveSharing,
        Aggregation,
        AggregationId,
        NoMasking,
        SodiumEncryption,
    )
    from ..server import new_memory_server

    if not sodium.available():
        raise RuntimeError("the input bench needs libsodium "
                           "(real participant seal path)")

    service = new_memory_server()

    def new_client():
        keystore = MemoryKeystore()
        client = SdaClient(SdaClient.new_agent(keystore), keystore, service,
                           device=device)
        client.upload_agent()
        return client

    recipient = new_client()
    recipient_key = recipient.new_encryption_key()
    recipient.upload_encryption_key(recipient_key)
    clerks = [new_client() for _ in range(3)]
    for clerk in clerks:
        clerk.upload_encryption_key(clerk.new_encryption_key())
    aggregation = Aggregation(
        id=AggregationId.random(), title="input-bench",
        vector_dimension=dim, modulus=M31,
        recipient=recipient.agent.id, recipient_key=recipient_key,
        masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=M31),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    recipient.upload_aggregation(aggregation)
    recipient.begin_aggregation(aggregation.id)

    participant = new_client()
    codec = FixedPointCodec(M31, fractional_bits=16, max_summands=64,
                            clip=4.0)
    rng = np.random.default_rng(seed)
    encoded = codec.encode(rng.normal(0, 1, size=dim))

    # the conversion step alone (what the list path adds per participant)
    convert_list_s = _best_of(
        lambda: np.asarray([int(v) for v in encoded], dtype=np.int64),
        repeats)
    convert_array_s = _best_of(
        lambda: np.asarray(encoded, dtype=np.int64), repeats)

    # the real participant hot path, fed both ways
    seal_list_s = _best_of(
        lambda: participant.new_participation(
            [int(v) for v in encoded], aggregation.id), repeats)
    seal_array_s = _best_of(
        lambda: participant.new_participation(encoded, aggregation.id),
        repeats)

    return {
        "metric": f"participation input normalization (dim {dim})",
        "value": round(convert_list_s / max(convert_array_s, 1e-9), 1),
        "unit": "x speedup (list -> ndarray)",
        "platform": participant.crypto.device.type,
        "seed": seed,
        "dim": dim,
        "repeats": repeats,
        "convert_list_ms": round(convert_list_s * 1e3, 3),
        "convert_array_ms": round(convert_array_s * 1e3, 3),
        "seal_list_ms": round(seal_list_s * 1e3, 3),
        "seal_array_ms": round(seal_array_s * 1e3, 3),
        "seal_saved_ms": round((seal_list_s - seal_array_s) * 1e3, 3),
    }


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sda_tpu_torch.loadgen.inputbench",
        description="participation input-path micro-bench")
    parser.add_argument("--dim", type=int, default=100_000)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="the participant's device "
                             "(cuda, or cpu for the host)")
    args = parser.parse_args(argv)
    print(json.dumps(run_input_bench(args.dim, args.repeats, args.seed,
                                     args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
