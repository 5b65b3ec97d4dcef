"""A streamed round that dies mid-stream and resumes bit-identically.

StreamingAggregator processes a vector too large to hold per-participant
in memory, in (participant-chunk x dim-chunk) tiles with constant device
footprint, checkpointing an atomic fsync'd snapshot as it goes. This demo
injects a failure partway through the stream, then resumes from the
snapshot and proves the result equals an uninterrupted run exactly.

    python -m sda_tpu_torch.examples.streamed_checkpoint [--device cpu]

Port of ``examples/streamed_checkpoint.py``. The tiles run on
``--device``, where the resumed run restores the snapshot's accumulators;
the round seed is the int 0 (the script's ``PRNGKey(0)``).
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np

P_TOTAL, DIM, MODULUS = 96, 30_000, 433
P_CHUNK, D_CHUNK = 16, 7_500
#: provider calls the first run survives, snapshot cadence, round seed
DIE_AFTER, CHECKPOINT_EVERY, SEED = 5, 2, 0


def run(device=None, log=None) -> dict:
    """The killed run, the resumed run and a fresh one. ``log`` gets the
    injected failure. Returns ``out`` (resumed), ``fresh``, ``calls``
    (the provider calls of the killed run, the failing one included),
    ``resumed`` (blocks the resumed run streamed), ``blocks`` (a fresh
    run's), ``column_sum`` (the inputs' int64 column sum mod 433) and
    ``exact``."""
    from sda_tpu_torch.device import resolve_device
    from sda_tpu_torch.mesh import (StreamingAggregator,
                                    synthetic_block_provider32)
    from sda_tpu_torch.protocol import FullMasking, PackedShamirSharing

    dev = resolve_device(device)
    scheme = PackedShamirSharing(3, 8, 4, MODULUS, 354, 150)

    def make_agg():
        return StreamingAggregator(scheme, FullMasking(MODULUS),
                                   participants_chunk=P_CHUNK,
                                   dim_chunk=D_CHUNK, device=dev)

    provider = synthetic_block_provider32(MODULUS, seed=42,
                                          max_value=MODULUS)
    log = log or (lambda *a: None)
    calls, resumed = {"n": 0}, {"n": 0}
    with tempfile.TemporaryDirectory() as tmp:
        ck = f"{tmp}/round.ckpt"

        # a provider that dies after a few chunks, like a tunnel mid-round
        def flaky(p0, p1, d0, d1):
            calls["n"] += 1
            if calls["n"] > DIE_AFTER:
                raise RuntimeError("injected failure (stream died)")
            return provider(p0, p1, d0, d1)

        try:
            make_agg().aggregate_blocks(flaky, P_TOTAL, DIM, SEED,
                                        checkpoint_path=ck,
                                        checkpoint_every_chunks=
                                        CHECKPOINT_EVERY)
        except RuntimeError as e:
            log(f"round died mid-stream as injected: {e}")
        else:
            raise AssertionError("the injected failure did not stop the "
                                 "round")

        # resume from the snapshot: only the remaining tiles are streamed
        def counting(p0, p1, d0, d1):
            resumed["n"] += 1
            return provider(p0, p1, d0, d1)

        out = make_agg().aggregate_blocks(counting, P_TOTAL, DIM, SEED,
                                          checkpoint_path=ck,
                                          checkpoint_every_chunks=
                                          CHECKPOINT_EVERY)
    inputs = provider(0, P_TOTAL, 0, DIM).astype(np.int64)
    fresh = make_agg().aggregate(inputs, SEED)
    column_sum = inputs.sum(0) % MODULUS
    return {"out": out, "fresh": fresh, "column_sum": column_sum,
            "calls": calls["n"], "resumed": resumed["n"],
            "blocks": (P_TOTAL // P_CHUNK) * (DIM // D_CHUNK),
            "exact": bool(np.array_equal(out, fresh)
                          and np.array_equal(out, column_sum))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="device of the streamed tiles (default cuda; "
                             "cpu for the host)")
    args = parser.parse_args(argv)
    rec = run(args.device, log=print)
    print(f"resumed run streamed {rec['resumed']} blocks "
          f"(a fresh run would stream {rec['blocks']})")
    assert rec["exact"], "resume must be bit-identical"
    print("resumed aggregate == uninterrupted aggregate: OK (bit-identical)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
