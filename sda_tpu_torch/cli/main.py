"""`sda` — the agent command-line interface.

Reference: cli/src/main.rs. Subcommands: ping; agent create/show; agent keys
create; clerk (poll loop); aggregations create/list/begin/end/status/reveal/
delete; participate. Identity (agent + keys + auth token) lives in a
directory (``-i``), server selection via ``-s``, the device of the
agent's field arithmetic via ``--device`` (``cuda``, or ``cpu`` for the host).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..client import SdaClient
from ..protocol import (
    AdditiveSharing,
    Agent,
    AgentId,
    Aggregation,
    AggregationId,
    BasicShamirSharing,
    ChaChaMasking,
    EncryptionKeyId,
    FullMasking,
    NoMasking,
    NotFound,
    PackedPaillierEncryption,
    PackedShamirSharing,
    ParticipationConflict,
    SodiumEncryption,
)
from ..store import Filebased

AGENT_ALIAS = "agent"
KEY_ALIAS = "primary-encryption-key"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="sda", description="SDA agent CLI")
    parser.add_argument("-s", "--server", default="http://127.0.0.1:8888",
                        help="server root URL")
    parser.add_argument("-i", "--identity", default=".sda", help="identity directory")
    parser.add_argument("-v", "--verbose", action="count", default=0)
    parser.add_argument("--device", default="cuda",
                        help="device of this agent's field arithmetic "
                             "(cuda, or cpu for the host)")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("ping")

    agent = sub.add_parser("agent").add_subparsers(dest="agent_command", required=True)
    agent.add_parser("create")
    agent.add_parser("show")
    prof = agent.add_parser("profile").add_subparsers(
        dest="profile_command", required=True)
    prof_set = prof.add_parser("set")
    prof_set.add_argument("--name")
    prof_set.add_argument("--twitter", dest="twitter_id")
    prof_set.add_argument("--keybase", dest="keybase_id")
    prof_set.add_argument("--website")
    prof_show = prof.add_parser("show")
    prof_show.add_argument("agent_id", nargs="?",
                           help="default: this identity's own profile")
    keys = agent.add_parser("keys").add_subparsers(dest="keys_command", required=True)
    keys_create = keys.add_parser("create")
    keys_create.add_argument("--encryption", choices=["sodium", "paillier"],
                             default="sodium")
    keys_create.add_argument("--paillier-modulus-bits", type=int, default=2048)

    clerk = sub.add_parser("clerk")
    clerk.add_argument("--once", action="store_true", help="drain the queue once and exit")
    clerk.add_argument("--interval", type=float, default=300.0,
                       help="poll sleep seconds when looping (reference: 5 min)")

    agg = sub.add_parser("aggregations").add_subparsers(dest="agg_command", required=True)
    create = agg.add_parser("create")
    create.add_argument("title")
    create.add_argument("--dimension", type=int, required=True)
    create.add_argument("--modulus", type=int, required=True)
    create.add_argument("--mask", choices=["none", "full", "chacha"], default="none")
    create.add_argument("--seed-bits", type=int, default=128)
    create.add_argument("--sharing", choices=["add", "shamir", "basic-shamir"],
                        default="add")
    create.add_argument("--shares", type=int, default=3, help="committee size")
    create.add_argument("--privacy-threshold", type=int, default=None,
                        help="basic-shamir only: colluding-clerk bound t "
                             "(reconstruction needs t+1 shares; default "
                             "(shares-1)//2, honest majority)")
    create.add_argument("--encryption", choices=["sodium", "paillier"],
                        default="sodium",
                        help="share-transport encryption for both slots "
                             "(paillier = additively homomorphic)")
    create.add_argument("--paillier-modulus-bits", type=int, default=2048)
    create.add_argument("--secrets-per-batch", type=int, default=3,
                        help="packed secrets per polynomial (shamir)")
    lst = agg.add_parser("list")
    lst.add_argument("--filter", default=None)
    for name in ("end", "status", "delete", "show"):
        p = agg.add_parser(name)
        p.add_argument("aggregation")
    begin = agg.add_parser("begin")
    begin.add_argument("aggregation")
    begin.add_argument("--clerk", action="append", dest="clerks",
                       metavar="AGENT_ID",
                       help="choose this agent for the committee (repeat "
                            "once per clerk, in committee order); default: "
                            "elect automatically from suggestions")
    rev = agg.add_parser("reveal")
    rev.add_argument("aggregation")
    rev.add_argument("--fixed-point-bits", type=int, metavar="B",
                     help="decode the revealed sum as fixed-point floats "
                          "(scale 2^B); pairs with `participate --model`")
    rev.add_argument("--mean", action="store_true",
                     help="with --fixed-point-bits: print the mean update "
                          "(sum / number of participations) instead of "
                          "the sum")

    part = sub.add_parser("participate")
    part.add_argument("aggregation")
    part.add_argument("values", nargs="*", type=int)
    part.add_argument("--model", metavar="FILE",
                      help="participate with a float vector from a .npy "
                           "(or single-array .npz) file, fixed-point "
                           "encoded to the aggregation's modulus")
    part.add_argument("--fixed-point-bits", type=int, default=16, metavar="B",
                      help="fractional bits for --model (default 16)")
    part.add_argument("--clip", type=float,
                      help="magnitude clip for --model (default: the "
                           "capacity-derived bound)")
    part.add_argument("--max-summands", type=int, default=1024,
                      help="largest participant count the encoding must "
                           "stay exact for (default 1024); bounds the "
                           "clip range")
    part.add_argument("--embedded", action="store_true",
                      help="compute the participation in the native C "
                           "core (the embeddable-client path: additive "
                           "or Shamir sharing, Sodium encryption)")
    part.add_argument("--journal", action="store_true",
                      help="durable exactly-once participation: persist "
                           "the sealed bundle under "
                           "<identity>/journal/ BEFORE the first upload "
                           "so a crash can be recovered with `sda "
                           "resume` — same bytes, no recompute, no "
                           "double count (docs/client.md)")

    sub.add_parser(
        "resume",
        help="re-upload this identity's journaled participations after a "
             "crash (`participate --journal`); byte-identical replays are "
             "deduped server-side, so resuming is always safe")

    return parser


def _encode_model_values(client, agg_id, args):
    """`participate --model FILE`: load a float vector, fixed-point encode
    it to the aggregation's modulus. Returns int list, or None after
    printing an error. The reveal side decodes with
    `aggregations reveal --fixed-point-bits B [--mean]`."""
    import numpy as np

    from ..models import FixedPointCodec

    try:
        loaded = np.load(args.model)
        if hasattr(loaded, "files"):  # .npz archive: exactly one array
            if len(loaded.files) != 1:
                print(f"error: {args.model} holds {len(loaded.files)} "
                      f"arrays; save a single flat vector", file=sys.stderr)
                return None
            loaded = loaded[loaded.files[0]]
        vec = np.asarray(loaded, dtype=np.float64).reshape(-1)
    except (OSError, ValueError) as e:
        print(f"error: cannot load {args.model}: {e}", file=sys.stderr)
        return None
    aggregation = client.service.get_aggregation(client.agent, agg_id)
    if aggregation is None:
        print(f"error: no aggregation {agg_id}", file=sys.stderr)
        return None
    if vec.size != aggregation.vector_dimension:
        print(f"error: {args.model} has {vec.size} elements; the "
              f"aggregation wants {aggregation.vector_dimension}",
              file=sys.stderr)
        return None
    try:
        codec = FixedPointCodec(aggregation.modulus, args.fixed_point_bits,
                                args.max_summands, clip=args.clip)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return None
    return [int(v) for v in codec.encode(vec)]


def load_client(args) -> SdaClient:
    from ..http import SdaHttpClient

    store = Filebased(args.identity)
    service = SdaHttpClient(args.server, store=store)
    agent_obj = store.get_aliased(AGENT_ALIAS)
    if agent_obj is None:
        agent = SdaClient.new_agent(store)
        store.put(f"agent-{agent.id}", agent.to_obj())
        store.put_alias(AGENT_ALIAS, f"agent-{agent.id}")
    else:
        agent = Agent.from_obj(agent_obj)
    return SdaClient(agent, store, service, device=args.device)


def _primary_key(client: SdaClient, store: Filebased) -> EncryptionKeyId:
    record = store.get_aliased(KEY_ALIAS)
    if record is None:
        raise SystemExit("no encryption key; run `sda agent keys create` first")
    return EncryptionKeyId(record["id"])


def _check_prime_capacity(prime: int, modulus: int, note: str) -> bool:
    """Shared participant-headroom policy for the Shamir sharing paths:
    correctness needs participants * (modulus-1) < prime. Returns False
    (after printing an error) when even 2 participants can wrap."""
    if modulus == prime:  # native mod-p runs are exact as-is
        return True
    capacity = (prime - 1) // max(1, modulus - 1)
    if capacity < 2:
        print(f"error: modulus {modulus} does not fit the sharing prime "
              f"{prime} (even a 2-participant sum can wrap mod p and "
              f"reveal a wrong aggregate); use a smaller modulus",
              file=sys.stderr)
        return False
    print(f"note: {note}; sums stay exact for up to {capacity} "
          f"participants at modulus {modulus}", file=sys.stderr)
    if capacity < 1000:
        print("warning: <1000-participant headroom — use a smaller "
              "modulus or a larger prime", file=sys.stderr)
    return True


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils import configure_logging

    configure_logging(args.verbose)
    client = load_client(args)
    store: Filebased = client.crypto.keystore  # type: ignore[assignment]

    if args.command == "ping":
        pong = client.service.ping()
        print(json.dumps({"running": pong.running}))
        return 0

    if args.command == "agent":
        if args.agent_command == "create":
            client.upload_agent()
            print(str(client.agent.id))
            return 0
        if args.agent_command == "show":
            print(json.dumps(client.agent.to_obj(), indent=2))
            return 0
        if args.agent_command == "profile":
            from ..protocol import Profile

            if args.profile_command == "set":
                client.upload_agent()
                client.upsert_profile(Profile(
                    owner=client.agent.id, name=args.name,
                    twitter_id=args.twitter_id, keybase_id=args.keybase_id,
                    website=args.website,
                ))
                return 0
            owner = (AgentId(args.agent_id) if args.agent_id
                     else client.agent.id)
            profile = client.get_profile(owner)
            print(json.dumps(profile.to_obj() if profile else None, indent=2))
            return 0
        if args.agent_command == "keys":
            client.upload_agent()  # idempotent; key upload needs the agent
            key_scheme = None
            if args.encryption == "paillier":
                # only min_modulus_bitsize matters for key material; window
                # parameters are carried per-aggregation, not per-key
                try:
                    key_scheme = PackedPaillierEncryption(
                        1, 32, 32, args.paillier_modulus_bits
                    )
                except ValueError as e:
                    print(f"error: --paillier-modulus-bits "
                          f"{args.paillier_modulus_bits} is too small for "
                          f"even one packed component window ({e}); use a "
                          f"larger key size (e.g. 2048)", file=sys.stderr)
                    return 1
            key_id = client.new_encryption_key(key_scheme)
            client.upload_encryption_key(key_id)
            store.put(f"keymeta-{key_id}", {"id": str(key_id)})
            store.put_alias(KEY_ALIAS, f"keymeta-{key_id}")
            print(str(key_id))
            return 0

    if args.command == "clerk":
        client.upload_agent()
        if args.once:
            client.run_chores(-1)
            return 0
        while True:  # reference daemon loop: cli/src/main.rs:194-206
            client.run_chores(-1)
            time.sleep(args.interval)

    if args.command == "aggregations":
        if args.agg_command == "create":
            if args.mask == "none":
                masking = NoMasking()
            elif args.mask == "full":
                masking = FullMasking(args.modulus)
            else:
                masking = ChaChaMasking(args.modulus, args.dimension, args.seed_bits)
            if args.sharing == "add":
                sharing = AdditiveSharing(share_count=args.shares, modulus=args.modulus)
            elif args.sharing == "basic-shamir":
                from ..fields import numtheory

                # classic Shamir (the reference's declared-but-disabled
                # BasicShamir, crypto.rs:89-95): any prime works — pick a
                # Solinas one with participant-sum headroom, same policy
                # and capacity reporting as the packed path below
                min_bits = min(args.modulus.bit_length() + 21, 28)
                bp = numtheory.find_prime_with_orders(1, 1, min_bits)
                t = (args.privacy_threshold if args.privacy_threshold
                     is not None else max(1, (args.shares - 1) // 2))
                try:
                    sharing = BasicShamirSharing(args.shares, t, bp)
                except ValueError as e:
                    print(f"error: {e}", file=sys.stderr)
                    return 1
                if not _check_prime_capacity(
                        bp, args.modulus,
                        f"basic Shamir over prime {bp}, t={t} (reveal "
                        f"needs {t + 1} of {args.shares} clerks)"):
                    return 1
            else:
                from ..fields import numtheory

                k = args.secrets_per_batch
                # Unless the NTT prime equals the aggregation modulus, sums of
                # values mod `modulus` must never wrap mod p: correctness
                # needs participants * (modulus-1) < p. Request 21 bits of
                # headroom over the modulus, but cap the request at 28 bits
                # so the generator lands on a Solinas prime (uint32 fast
                # path) — for moduli above ~7 bits the cap wins and the REAL
                # headroom is only (p.bit_length() - modulus bits), so we
                # report the actual participant capacity below.
                min_bits = min(args.modulus.bit_length() + 21, 28)
                t, p, w2, w3 = numtheory.generate_packed_params(
                    k, args.shares, min_modulus_bits=min_bits
                )
                if not _check_prime_capacity(
                        p, args.modulus, f"sharing over NTT prime {p}"):
                    return 1
                sharing = PackedShamirSharing(k, args.shares, t, p, w2, w3)
            if args.encryption == "paillier":
                # windows must fit the widest values each slot carries:
                # shares/partial-sums live mod the SHARING modulus (the NTT
                # prime for shamir), and ChaCha "masks" are 32-bit seed words
                share_bits = (
                    sharing.prime_modulus
                    if args.sharing in ("shamir", "basic-shamir")
                    else sharing.modulus
                ).bit_length()
                value_bits = max(share_bits, 32 if args.mask == "chacha" else 0)
                window = value_bits + 16  # capacity 2^16 homomorphic summands
                count = max(1, (args.paillier_modulus_bits - 1) // window)
                try:
                    encryption_scheme = PackedPaillierEncryption(
                        min(count, 64), window, value_bits,
                        args.paillier_modulus_bits,
                    )
                except ValueError as e:
                    print(f"error: --paillier-modulus-bits "
                          f"{args.paillier_modulus_bits} cannot hold even one "
                          f"{window}-bit component window ({e}); use a larger "
                          f"key size", file=sys.stderr)
                    return 1
            else:
                encryption_scheme = SodiumEncryption()
            recipient_key = _primary_key(client, store)
            # fail at create time, not at every later participation, when the
            # recipient's primary key can't serve the chosen encryption scheme
            keypair = store.get_encryption_keypair(recipient_key)
            want_variant = ("PackedPaillier" if args.encryption == "paillier"
                            else "Sodium")
            if keypair is not None and keypair.ek.variant != want_variant:
                flag = (" --encryption paillier" if args.encryption == "paillier"
                        else "")
                print(f"error: recipient key {recipient_key} is a "
                      f"{keypair.ek.variant} key but --encryption "
                      f"{args.encryption} needs a {want_variant} key; run "
                      f"`sda agent keys create{flag}` first", file=sys.stderr)
                return 1
            if (keypair is not None and args.encryption == "paillier"
                    and keypair.ek.variant == "PackedPaillier"):
                # variant alone isn't enough: a key below the scheme's
                # modulus floor is rejected by PackedPaillierEncryptor at
                # every later participation (encryption.py:84-88)
                from .. import crypto as _crypto

                key_bits = _crypto.paillier.PaillierPublicKey.from_bytes(
                    keypair.ek.value.data).bitsize
                if key_bits < args.paillier_modulus_bits:
                    print(f"error: recipient key {recipient_key} is "
                          f"{key_bits}-bit but the aggregation requires "
                          f">= {args.paillier_modulus_bits}-bit keys; run "
                          f"`sda agent keys create --encryption paillier "
                          f"--paillier-modulus-bits "
                          f"{args.paillier_modulus_bits}` first",
                          file=sys.stderr)
                    return 1
            aggregation = Aggregation(
                id=AggregationId.random(),
                title=args.title,
                vector_dimension=args.dimension,
                modulus=args.modulus,
                recipient=client.agent.id,
                recipient_key=recipient_key,
                masking_scheme=masking,
                committee_sharing_scheme=sharing,
                recipient_encryption_scheme=encryption_scheme,
                committee_encryption_scheme=encryption_scheme,
            )
            client.upload_aggregation(aggregation)
            print(str(aggregation.id))
            return 0
        if args.agg_command == "list":
            for agg_id in client.service.list_aggregations(client.agent, filter=args.filter):
                print(str(agg_id))
            return 0
        agg_id = AggregationId(args.aggregation)
        if args.agg_command == "begin":
            if args.clerks:
                try:
                    client.begin_aggregation_with(
                        agg_id, [AgentId(c) for c in args.clerks])
                except (NotFound, ValueError) as e:
                    print(f"error: {e}", file=sys.stderr)
                    return 1
            else:
                client.begin_aggregation(agg_id)
            return 0
        if args.agg_command == "end":
            client.end_aggregation(agg_id)
            return 0
        if args.agg_command in ("status", "show"):
            status = client.service.get_aggregation_status(client.agent, agg_id)
            print(json.dumps(status.to_obj() if status else None, indent=2))
            return 0
        if args.agg_command == "reveal":
            if args.mean and args.fixed_point_bits is None:
                print("error: --mean needs --fixed-point-bits (a mean of "
                      "raw field elements is not meaningful)",
                      file=sys.stderr)
                return 1
            output = client.reveal_aggregation(agg_id).positive()
            if args.fixed_point_bits is None:
                print(" ".join(str(v) for v in output.values.tolist()))
                return 0
            from ..models import FixedPointCodec

            # divide by the revealed SNAPSHOT's summand count, not the
            # aggregation-wide one: participations accepted after `end`
            # (or in other pipelined snapshots) are not in this sum
            n = output.participations
            if n is None:
                # only a RecipientOutput constructed outside
                # reveal_aggregation can lack the count; the aggregation-
                # wide status count would be the WRONG divisor (stragglers
                # after `end` are counted there but not summed), so refuse
                print("error: revealed output carries no snapshot "
                      "participation count; cannot decode a mean/sum "
                      "safely", file=sys.stderr)
                return 1
            try:
                codec = FixedPointCodec(output.modulus,
                                        args.fixed_point_bits, n)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
            decoded = (codec.decode_mean(output.values, n) if args.mean
                       else codec.decode_sum(output.values, n))
            print(" ".join(repr(float(v)) for v in decoded))
            return 0
        if args.agg_command == "delete":
            client.service.delete_aggregation(client.agent, agg_id)
            return 0

    if args.command == "participate":
        agg_id = AggregationId(args.aggregation)
        if args.model and args.values:
            print("error: give either integer values or --model, not both",
                  file=sys.stderr)
            return 1
        # register the agent BEFORE any service read: a fresh identity's
        # auth token is only minted server-side on its first upload
        client.upload_agent()
        if args.model:
            values = _encode_model_values(client, agg_id, args)
            if values is None:
                return 1
        elif args.values:
            values = args.values
        else:
            print("error: nothing to participate with (integer values "
                  "or --model FILE)", file=sys.stderr)
            return 1
        if args.embedded:
            if args.journal:
                print("error: --journal needs the Python participation "
                      "path (the embedded C core uploads internally); "
                      "drop --embedded", file=sys.stderr)
                return 1
            from ..client.embed import participate_embedded

            try:
                participate_embedded(client, values, agg_id)
            except (NotFound, RuntimeError, ValueError) as e:
                print(f"error: embedded participation failed: {e}",
                      file=sys.stderr)
                return 1
        else:
            journal = None
            if args.journal:
                from ..client.journal import ParticipationJournal

                journal = ParticipationJournal(
                    os.path.join(args.identity, "journal"))
            try:
                client.participate(values, agg_id, journal=journal)
            except ParticipationConflict as e:
                print(f"error: the server already holds a participation "
                      f"for this identity in {agg_id} — one device, one "
                      f"contribution per round ({e})", file=sys.stderr)
                return 1
        return 0

    if args.command == "resume":
        from ..client.journal import ParticipationJournal

        journal = ParticipationJournal(
            os.path.join(args.identity, "journal"))
        pending = len(journal)
        if not pending:
            print("nothing journaled; all participations confirmed")
            return 0
        # re-register first: resume may follow a server restart that lost
        # the auth-token row (same rule as participate)
        client.upload_agent()
        resumed = client.resume(journal)
        print(f"resumed {resumed} of {pending} journaled "
              f"participation(s); {len(journal)} still pending")
        return 0 if len(journal) == 0 else 1

    return 1


if __name__ == "__main__":
    sys.exit(main())
