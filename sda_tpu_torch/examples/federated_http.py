"""A secure FedAvg round over the real REST protocol, in one process.

Spins up the HTTP server on a loopback port, registers a recipient, an
8-clerk committee, and three participants as ordinary `SdaClient`s
talking REST, then drives one `FederatedSession` round: encoded float
deltas go up, clerks decrypt/sum/re-encrypt, and the recipient reveals
the exact quantized mean.

    python -m sda_tpu_torch.examples.federated_http [--device cpu]

Port of ``examples/federated_http.py``. Every client's field arithmetic
is placed on ``--device``; at this width (d=32) each share, combine and
mask stays under ``crypto.sharing.HOST_PATH_MAX``, so the roles do no
device work even on a card.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np

M31 = (1 << 31) - 1
DIM, N_PART, CLERKS, SEED = 32, 3, 8, 7


def run(device=None, log=None) -> dict:
    """One round as the script runs it. ``log`` gets the serving address.
    Returns the revealed ``mean``, its quantized ``oracle``, the
    ``deltas``, ``address`` and ``exact``."""
    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.crypto import MemoryKeystore
    from sda_tpu_torch.device import resolve_device
    from sda_tpu_torch.http import SdaHttpClient, SdaHttpServer
    from sda_tpu_torch.models import FederatedSession, FixedPointCodec
    from sda_tpu_torch.protocol import (AdditiveSharing, Aggregation,
                                        AggregationId, FullMasking,
                                        SodiumEncryption)
    from sda_tpu_torch.server import new_memory_server
    from sda_tpu_torch.store import Filebased

    dev = resolve_device(device)
    log = log or (lambda *a: None)
    http_server = SdaHttpServer(new_memory_server(), bind="127.0.0.1:0")
    http_server.start_background()
    log("serving on", http_server.address)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            def client(name):
                proxy = SdaHttpClient(http_server.address,
                                      store=Filebased(f"{tmp}/{name}"))
                ks = MemoryKeystore()
                return SdaClient(SdaClient.new_agent(ks), ks, proxy,
                                 device=dev)

            recipient = client("recipient")
            rkey = recipient.new_encryption_key()
            recipient.upload_agent()
            recipient.upload_encryption_key(rkey)
            clerks = []
            for i in range(CLERKS):
                c = client(f"clerk{i}")
                key = c.new_encryption_key()
                c.upload_agent()
                c.upload_encryption_key(key)
                clerks.append(c)
            participants = []
            for i in range(N_PART):
                p = client(f"part{i}")
                p.upload_agent()
                participants.append(p)

            template = Aggregation(
                id=AggregationId.random(), title="fedavg-over-rest",
                vector_dimension=DIM, modulus=M31,
                recipient=recipient.agent.id, recipient_key=rkey,
                masking_scheme=FullMasking(M31),
                committee_sharing_scheme=AdditiveSharing(
                    share_count=CLERKS, modulus=M31),
                recipient_encryption_scheme=SodiumEncryption(),
                committee_encryption_scheme=SodiumEncryption(),
            )
            codec = FixedPointCodec(M31, fractional_bits=16,
                                    max_summands=N_PART, clip=4.0)
            session = FederatedSession(template, codec, recipient, clerks,
                                       participants)
            deltas = np.random.default_rng(SEED).normal(0, 1,
                                                        size=(N_PART, DIM))
            mean = session.round(list(deltas))
    finally:
        http_server.shutdown()
    oracle = np.stack([codec.quantize(d) for d in deltas]).sum(0) \
        / codec.scale / N_PART
    return {"mean": mean, "oracle": oracle, "deltas": deltas,
            "address": http_server.address,
            "exact": bool(np.array_equal(mean, oracle))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="device of the clients' field arithmetic "
                             "(default cuda; cpu for the host)")
    args = parser.parse_args(argv)
    rec = run(args.device, log=print)
    assert rec["exact"], "secure mean must equal quantized mean"
    print(f"revealed mean delta over {N_PART} participants "
          f"(first 4 dims): {np.round(rec['mean'][:4], 4)}")
    print("exact vs plaintext quantized oracle: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
