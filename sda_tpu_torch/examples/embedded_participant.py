"""An embedded (C-core) participant joins a packed-Shamir round.

The reference README announces an `/embeddable-client` exposing the
client "in a C-friendly" API for mobile apps (never released). This demo
runs the analog end-to-end in one process:

- participant #1's crypto is computed ENTIRELY by the native C core
  (`sda_embed_participate_shamir`): ChaCha-seed masking, packed-Shamir
  share evaluation, varint framing, sealed boxes;
- participant #2 is an ordinary Python `SdaClient`;
- the Python clerks and recipient decrypt, combine, and reveal — the
  exact sum proves byte-level wire compatibility.

    python -m sda_tpu_torch.examples.embedded_participant [--device cpu]

Port of ``examples/embedded_participant.py``. The native core and the
sealed boxes are the port's (``sda_tpu_torch/native/``, built with
``crypto/csrc/sodium.c``). The clients' field arithmetic runs on
``--device``: on a card the Python participant's mask is one K3 expand
and the recipient's sum of the two seeds one K3 combine.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

DIM, MOD, CLERKS = 8, 433, 8
EMBEDDED_UPDATE = [3, 1, 4, 1, 5, 9, 2, 6]
PYTHON_UPDATE = [2, 7, 1, 8, 2, 8, 1, 8]


def run(device=None) -> dict:
    """One round with the embedded and the Python participant. Returns
    the revealed ``out``, ``expected`` and ``exact``. Raises
    ``RuntimeError`` when the sealed boxes or the native core do not
    build: there is no other path."""
    from sda_tpu_torch import native
    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.client.embed import participate_embedded
    from sda_tpu_torch.crypto import MemoryKeystore, sodium
    from sda_tpu_torch.device import resolve_device
    from sda_tpu_torch.protocol import (Aggregation, AggregationId,
                                        ChaChaMasking, PackedShamirSharing,
                                        SodiumEncryption)
    from sda_tpu_torch.server import new_memory_server

    dev = resolve_device(device)
    if not (sodium.available() and native.available()):
        raise RuntimeError("the sealed boxes or the native build is "
                           "unavailable")
    service = new_memory_server()

    def new_client():
        ks = MemoryKeystore()
        c = SdaClient(SdaClient.new_agent(ks), ks, service, device=dev)
        c.upload_agent()
        return c

    recipient = new_client()
    rkey = recipient.new_encryption_key()
    recipient.upload_encryption_key(rkey)
    agg = Aggregation(
        id=AggregationId.random(),
        title="embedded-demo",
        vector_dimension=DIM,
        modulus=MOD,
        recipient=recipient.agent.id,
        recipient_key=rkey,
        # the golden full_loop.rs packed-Shamir config: 8 clerks, threshold 4
        masking_scheme=ChaChaMasking(MOD, DIM, 128),
        committee_sharing_scheme=PackedShamirSharing(3, CLERKS, 4, MOD, 354,
                                                     150),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    recipient.upload_aggregation(agg)
    clerks = [new_client() for _ in range(CLERKS)]
    for c in clerks:
        c.upload_encryption_key(c.new_encryption_key())
    recipient.begin_aggregation(agg.id)

    participate_embedded(new_client(), EMBEDDED_UPDATE, agg.id)  # C core
    new_client().participate(PYTHON_UPDATE, agg.id)              # Python

    recipient.end_aggregation(agg.id)
    recipient.run_chores(-1)
    for c in clerks:
        c.run_chores(-1)
    out = recipient.reveal_aggregation(agg.id).positive().values
    expected = (np.asarray(EMBEDDED_UPDATE) + np.asarray(PYTHON_UPDATE)) % MOD
    return {"out": np.asarray(out), "expected": expected,
            "exact": bool(np.array_equal(out, expected))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="device of the clients' field arithmetic "
                             "(default cuda; cpu for the host)")
    args = parser.parse_args(argv)
    from sda_tpu_torch import native
    from sda_tpu_torch.crypto import sodium

    if not (sodium.available() and native.available()):
        # loud on purpose: the port builds both from its own sources, so an
        # unavailable native core is a build regression, not an environment
        print("error: the sealed boxes or the native build is unavailable "
              "— the embedded demo cannot run", file=sys.stderr)
        return 1
    rec = run(args.device)
    assert rec["exact"], (rec["out"], rec["expected"])
    print("embedded + python updates:", [int(v) for v in rec["out"]])
    print("C-core participation revealed exactly alongside the Python one: "
          "OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
