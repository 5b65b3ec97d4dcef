"""The tree driver: run a planned hierarchical round through the real
server stack — in-process stores or the HTTP fleet — level by level.

One call drives the whole protocol the planner laid out
(``tree/plan.py``): agents and keys registered, every node's aggregation
uploaded by ITS recipient (the root, or a relay), committees elected
deterministically from a shared clerk pool, leaf participants masked and
sharded in, then levels complete bottom-up — each relay awaits its
round, re-shares the masked total and forwards the leaf masks in-band
(``client/relay.py``), until the root's ordinary flat reveal unmasks the
population total.

Failure semantics ride the round lifecycle supervisor
(``server/lifecycle.py``):

- a leaf whose committee loses clerks down to a surviving quorum goes
  ``degraded`` and its SURVIVORS feed up — the root result is unchanged;
- a leaf that cannot reconstruct (additive sharing, quorum lost) goes
  ``failed``, the sweeper's tree propagation fails every ancestor with a
  machine-readable reason naming the leaf, and the driver surfaces the
  typed ``RoundFailed`` from the root instead of hanging;
- chaos dropout at the leaves (``participant.dies``) shrinks the
  expected sum exactly like the flat chaos drill — the optional flat
  reference round re-runs the surviving inputs through an ordinary flat
  aggregation on the same stack and pins bit-exactness.

Span linkage: the whole run executes under one ``tree.round`` span, with
one ``tree.node`` span per aggregation — a root round's timeline
contains its children (docs/observability.md).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from .. import chaos, obs
from ..utils import metrics
from .plan import TreePlan, plan_tree

class TreeRoundReport(dict):
    """Plain dict with attribute sugar; one JSON-able report per run."""

    __getattr__ = dict.get


def _make_schemes(sharing: str, modulus: int, share_count: int):
    from ..chaos.drill import golden_packed_scheme
    from ..protocol import AdditiveSharing

    if sharing == "additive":
        return AdditiveSharing(share_count=share_count, modulus=modulus)
    if sharing == "packed":
        # the golden drill committee, ONE definition shared with the
        # chaos and load drills
        scheme = golden_packed_scheme()
        if modulus != scheme.prime_modulus:
            raise ValueError(
                f"packed drill scheme is pinned to modulus "
                f"{scheme.prime_modulus}")
        return scheme
    raise ValueError(f"unknown sharing {sharing!r}")


def _make_masking(masking: str, modulus: int, dim: int):
    from ..protocol import ChaChaMasking, FullMasking, NoMasking

    if masking == "none":
        return NoMasking()
    if masking == "full":
        return FullMasking(modulus)
    if masking == "chacha":
        return ChaChaMasking(modulus, dim, 128)
    raise ValueError(f"unknown masking {masking!r}")


def run_tree_round(
    inputs,
    *,
    group_size: int,
    fanout: Optional[int] = None,
    modulus: int = 433,
    sharing: str = "additive",
    share_count: int = 3,
    masking: str = "full",
    store: str = "memory",
    store_path=None,
    http: bool = False,
    seed: int = 0,
    dropout_rate: float = 0.0,
    dead_clerks_leaf: int = 0,
    flat_reference: bool = True,
    timeout_s: float = 120.0,
    clerking_deadline_s: float = 1.5,
    sweep_interval_s: float = 0.2,
    lease_seconds: float = 0.75,
    service=None,
    reset_obs: bool = True,
    return_output: bool = False,
    taint_participants=None,
    collect_leaf_subtotals: bool = False,
    device=None,
) -> TreeRoundReport:
    """Drive one full tree round; returns the report dict.

    ``inputs`` is the ``[N, dim]`` integer matrix of device vectors
    (values in ``[0, modulus)``). ``dropout_rate`` arms the
    ``participant.dies`` chaos failpoint at the leaves; a dead device
    never contributes and the expected sum excludes it.
    ``dead_clerks_leaf`` permanently kills that many clerks of the first
    planned leaf's committee and arms the lifecycle sweeper: with packed
    Shamir the leaf completes ``degraded`` from the surviving quorum and
    the root reveal is unchanged; with additive sharing the leaf goes
    terminal ``failed`` and the ROOT round fails with a reason naming
    the leaf. ``service`` injects an existing in-process service (tests);
    otherwise one is built from ``store``/``http``. ``device`` is the
    clients' device (CUDA unless ``"cpu"``).

    ``reset_obs=False`` keeps the caller's span/metrics/failpoint state
    (an embedding workload — the FL scenario runs one tree round per
    FedAvg round under its own trace — must not have its telemetry wiped
    per call). ``return_output=True`` attaches the revealed root vector
    as ``report["output_values"]`` (an int64 ndarray — NOT JSON-able, so
    it is opt-in; the JSON-bound ``sda-sim --tree`` profile leaves it
    off).

    ``taint_participants`` names device INDICES whose share uploads are
    adversarially tainted (the ``participant.taint_shares`` chaos kind is
    armed around exactly their participate calls — index-addressed, so
    the attacker set stays fixed even when dropout kills other devices).
    ``collect_leaf_subtotals=True`` has the ROOT additionally unmask each
    leaf's masked subtotal individually (decrypting the leaf's mask
    ciphertexts, which are sealed to the root anyway) and attaches
    ``report["leaf_subtotals"]`` — the data robust (trimmed-mean)
    recipient aggregation consumes. Depth-2 trees only: deeper trees
    interleave relay re-masking, so per-leaf unmasking no longer
    decomposes. This is recipient post-processing — the protocol reveal
    and its exactness check are untouched — and it is also precisely
    what robust aggregation LEAKS relative to the flat protocol: the
    root learns per-leaf group subtotals, not just the population total
    (docs/federated.md's threat-model section).
    """
    from ..client import SdaClient, relay as relay_mod
    from ..crypto import MemoryKeystore, sodium
    from ..protocol import RoundFailed, ServerError, SodiumEncryption

    if not sodium.available():
        raise RuntimeError("tree rounds need libsodium (real crypto)")
    inputs = np.asarray(inputs, dtype=np.int64)
    if inputs.ndim != 2:
        raise ValueError("inputs must be [participants, dim]")
    n, dim = inputs.shape
    scheme = _make_schemes(sharing, modulus, share_count)
    masking_scheme = _make_masking(masking, modulus, dim)

    if reset_obs:
        obs.reset_all()
        chaos.reset()
    own_service = service is None
    http_server = None
    if own_service:
        from ..server import (
            new_jsonfs_server, new_memory_server, new_sqlite_server)

        if store == "memory":
            service_impl = new_memory_server()
        elif store == "sqlite":
            service_impl = new_sqlite_server(store_path or ":memory:")
        elif store == "jsonfs":
            if store_path is None:
                raise ValueError("store='jsonfs' needs store_path")
            service_impl = new_jsonfs_server(store_path)
        else:
            raise ValueError(f"unknown store {store!r}")
    else:
        service_impl = service
    server = service_impl.server
    if dead_clerks_leaf:
        from ..server import lifecycle

        server.clerking_lease_seconds = lease_seconds
        server.round_deadlines = lifecycle.RoundDeadlines(
            clerking_s=clerking_deadline_s)
        sweeper = lifecycle.RoundSweeper(
            server, interval_s=sweep_interval_s).start()
    else:
        sweeper = None
    if http and own_service:
        from ..http import SdaHttpClient, SdaHttpServer

        http_server = SdaHttpServer(service_impl, bind="127.0.0.1:0")
        http_server.start_background()

        def client_service():
            return SdaHttpClient(http_server.address, token="tree-drill",
                                 max_retries=8, backoff_base=0.01,
                                 backoff_cap=0.1)
    else:
        def client_service():
            return service_impl

    def new_client():
        keystore = MemoryKeystore()
        agent = SdaClient.new_agent(keystore)
        client = SdaClient(agent, keystore, client_service(),
                           device=device)
        client.upload_agent()
        return client

    def keyed(client):
        client.upload_encryption_key(client.new_encryption_key())
        return client

    report = TreeRoundReport(
        mode=f"tree round over {'HTTP' if http else 'in-process'} "
             f"({store} store)",
        participants=n, dim=dim, modulus=modulus, sharing=sharing,
        masking=masking, group_size=group_size, seed=seed,
        dropout_rate=dropout_rate, dead_clerks_leaf=dead_clerks_leaf,
    )
    try:
        with obs.span("tree.round", attributes={"participants": n,
                                                "seed": seed}):
            # -- identities (no chaos during setup: the drill targets the
            # round, exactly like chaos/drill.py)
            participants = [new_client() for _ in range(n)]
            # shard on seed-derived STABLE keys, not the freshly minted
            # agent uuids: the drill's plan (group memberships, dropout
            # impact, aggregation ids) must reproduce at a fixed seed.
            # Production sharding keys on real agent ids via plan_tree
            # directly — the ring mapping is the same either way.
            device_keys = [f"dev-{seed}-{ix}" for ix in range(n)]
            plan: TreePlan = plan_tree(
                device_keys, group_size=group_size, fanout=fanout,
                seed=f"tree-{seed}")
            participant_of = dict(zip(device_keys, participants))
            nodes = plan.nodes()
            relay_nodes = plan.relay_nodes()

            root = new_client()
            root_key = root.new_encryption_key()
            root.upload_encryption_key(root_key)
            relay_clients: Dict[str, SdaClient] = {}
            relay_ids = []
            for node in relay_nodes:
                client = new_client()
                key = client.new_encryption_key()
                client.upload_encryption_key(key)
                relay_clients[node.path] = client
                relay_ids.append((client.agent.id, key))

            # disjoint per-node committees from one clerk pool, so a
            # dead clerk at one leaf cannot bleed into another round
            committee_size = scheme.output_size
            pool = [keyed(new_client()) for _ in range(
                committee_size * len(nodes))]
            committees: Dict[str, List] = {}
            for ix, node in enumerate(nodes):
                committees[node.path] = pool[ix * committee_size:
                                             (ix + 1) * committee_size]

            aggregations = plan.build_aggregations(
                title=f"tree-{seed}",
                vector_dimension=dim,
                modulus=modulus,
                masking_scheme=masking_scheme,
                leaf_sharing=scheme,
                recipient_encryption_scheme=SodiumEncryption(),
                committee_encryption_scheme=SodiumEncryption(),
                root_recipient=root.agent.id,
                root_recipient_key=root_key,
                relays=relay_ids,
            )
            report["groups"] = len(plan.leaves())
            report["depth"] = plan.depth()
            report["levels"] = plan.level_table(scheme)
            if collect_leaf_subtotals and plan.depth() != 2:
                raise ValueError(
                    f"collect_leaf_subtotals needs a depth-2 tree (leaf "
                    f"relays feeding the root directly); this plan is "
                    f"depth {plan.depth()} — deeper levels re-mask, so "
                    "per-leaf unmasking no longer decomposes")

            def recipient_of(node):
                return (root if node.is_root
                        else relay_clients[node.path])

            for node in nodes:
                owner = recipient_of(node)
                owner.upload_aggregation(aggregations[node.path])
                owner.begin_aggregation_with(
                    node.aggregation_id,
                    [c.agent.id for c in committees[node.path]])

            # -- targeted leaf dead clerks: latch K members of the FIRST
            # leaf's committee permanently dead before any poll (ring
            # shards can come up empty and are dropped at plan time, so
            # never assume a particular group index survived)
            victims = []
            if dead_clerks_leaf:
                leaf0 = plan.leaves()[0]
                for clerk in committees[leaf0.path][:dead_clerks_leaf]:
                    clerk._dead = True
                    victims.append(str(clerk.agent.id))
                report["dead_clerks"] = victims
                report["dead_clerk_leaf"] = leaf0.path

            # -- leaf participation under chaos dropout
            if dropout_rate:
                chaos.configure("participant.dies", kill=True,
                                rate=dropout_rate, seed=seed)
            alive_rows: List[np.ndarray] = []
            leaf_of = {}
            for leaf in plan.leaves():
                for member in leaf.members:
                    leaf_of[member] = leaf
            taint_set = {int(i) for i in (taint_participants or ())}
            if taint_set and (min(taint_set) < 0 or max(taint_set) >= n):
                raise ValueError(
                    f"taint_participants indices must be in [0, {n}); "
                    f"got {sorted(taint_set)}")
            for ix, (key, row) in enumerate(zip(device_keys, inputs)):
                participant = participant_of[key]
                # the taint failpoint is armed around exactly this
                # device's upload: always-trigger, cleared immediately —
                # attacker identity is the caller's plan, not a rate draw
                if ix in taint_set:
                    chaos.configure("participant.taint_shares", taint=True)
                try:
                    participant.participate(
                        [int(x) for x in row], leaf_of[key].aggregation_id)
                finally:
                    if ix in taint_set:
                        chaos.clear("participant.taint_shares")
                if not participant._dead:
                    alive_rows.append(row)
            chaos.reset()  # dropout targets devices, not the levels above
            report["participants_dropped"] = n - len(alive_rows)

            # -- complete levels bottom-up
            by_level: Dict[int, List] = {}
            for node in nodes:
                by_level.setdefault(node.level, []).append(node)
            node_states: Dict[str, dict] = {}
            failed_paths: set = set()
            leaf_subtotals: List[dict] = []

            def pump(level_nodes) -> None:
                """Clerk the committees until every round at this level
                is result-ready or terminally diagnosed."""
                give_up = time.monotonic() + timeout_s
                pending = {node.path for node in level_nodes}
                while pending and time.monotonic() < give_up:
                    for path in list(pending):
                        for clerk in committees[path]:
                            try:
                                clerk.run_chores(-1)
                            except ServerError:
                                metrics.count("tree.clerk.transient")
                        node = next(x for x in level_nodes
                                    if x.path == path)
                        owner = recipient_of(node)
                        try:
                            status = owner.service.get_aggregation_status(
                                owner.agent, node.aggregation_id)
                            state = owner.service.get_round_status(
                                owner.agent, node.aggregation_id)
                        except ServerError:
                            continue
                        ready = any(s.result_ready
                                    for s in (status.snapshots
                                              if status else []))
                        # done on the round VERDICT (ready / degraded /
                        # terminal), or on bare result_ready when nothing
                        # tracks the round — same rule the relay applies
                        if state is None:
                            if ready:
                                pending.discard(path)
                        elif state.state in ("failed", "expired") or (
                                ready and state.state in ("ready",
                                                          "degraded",
                                                          "revealed")):
                            pending.discard(path)
                    if pending:
                        time.sleep(0.02)
                if pending:
                    raise TimeoutError(
                        f"tree level stalled: {sorted(pending)} not "
                        f"ready within {timeout_s}s")

            for level in sorted(by_level, reverse=True):
                if level == 0:
                    break  # the root completes below, after all relays
                level_nodes = by_level[level]
                for node in level_nodes:
                    skip = {c.path for c in node.children} & failed_paths
                    if skip:
                        # a failed child makes this round unrecoverable;
                        # never snapshot it — the sweeper's propagation
                        # delivers the verdict
                        failed_paths.add(node.path)
                        continue
                    with obs.span("tree.node", attributes={
                            "path": node.path, "level": node.level,
                            "aggregation": str(node.aggregation_id)}):
                        recipient_of(node).end_aggregation(
                            node.aggregation_id)
                active = [x for x in level_nodes
                          if x.path not in failed_paths]
                if active:
                    pump(active)
                for node in active:
                    client = relay_clients[node.path]
                    try:
                        total = relay_mod.relay_up(
                            client, node.aggregation_id,
                            node.parent.aggregation_id,
                            deadline=timeout_s)
                        node_states[node.path] = {
                            "level": node.level, "group": node.group,
                            "state": total.state or "revealed",
                            "participations": total.participations,
                            "results": total.results,
                        }
                        if collect_leaf_subtotals:
                            # the root unmasks THIS leaf individually:
                            # the leaf's mask ciphertexts are sealed to
                            # the root anyway (TreeLink redirects the
                            # seal), so no extra key material changes
                            # hands — only what the root LEARNS does
                            leaf_subtotals.append(_unmask_leaf_subtotal(
                                root, aggregations[node.path], total,
                                masking_scheme, modulus, node.path))
                    except RoundFailed as e:  # RoundExpired subclasses it
                        failed_paths.add(node.path)
                        node_states[node.path] = {
                            "level": node.level, "group": node.group,
                            "state": e.state or "failed",
                            "reason": e.reason,
                            "dead_clerks": [str(c) for c in e.dead_clerks],
                        }

            # -- the root round
            output = None
            failure = None
            root_node = plan.root
            if {c.path for c in root_node.children} & failed_paths:
                failed_paths.add(root_node.path)
            if root_node.path not in failed_paths:
                with obs.span("tree.node", attributes={
                        "path": root_node.path, "level": 0,
                        "aggregation": str(root_node.aggregation_id)}):
                    root.end_aggregation(root_node.aggregation_id)
                pump([root_node])
            try:
                output = root.await_result(
                    root_node.aggregation_id, deadline=timeout_s,
                    poll_interval=0.05)
            except RoundFailed as e:
                failure = {"type": type(e).__name__, "state": e.state,
                           "reason": e.reason,
                           "dead_clerks": [str(c) for c in e.dead_clerks]}
            final_root = root.service.get_round_status(
                root.agent, root_node.aggregation_id)
            node_states[root_node.path] = {
                "level": 0, "group": None,
                "state": final_root.state if final_root else None,
                "reason": final_root.reason if final_root else None,
            }
            report["node_states"] = node_states
            report["root_state"] = (final_root.state if final_root
                                    else None)
            report["root_reason"] = (final_root.reason if final_root
                                     else None)
            report["root_children"] = ([str(c) for c in
                                        final_root.children]
                                       if final_root else None)
            report["failure"] = failure
            if collect_leaf_subtotals:
                # ndarrays, like output_values: opt-in, not JSON-able
                report["leaf_subtotals"] = leaf_subtotals

            expected = (np.stack(alive_rows).sum(axis=0) % modulus
                        if alive_rows else np.zeros(dim, dtype=np.int64))
            if output is not None:
                revealed = output.positive().values
                report["exact"] = bool((revealed == expected).all())
                report["relays"] = int(output.participations or 0)
                if return_output:
                    report["output_values"] = revealed
                if dim <= 16:
                    report["output"] = [int(v) for v in revealed]
            else:
                report["exact"] = False

            # -- flat reference: the SAME surviving inputs through an
            # ordinary flat round on the same stack, revealed by a fresh
            # recipient — the bit-exactness bar for the hierarchy
            if flat_reference and alive_rows and output is not None:
                flat = _run_flat_reference(
                    new_client, keyed, np.stack(alive_rows), modulus, dim,
                    scheme, masking_scheme, timeout_s)
                report["flat_exact"] = bool(
                    (revealed == flat).all())
            elif flat_reference:
                report["flat_exact"] = None
    finally:
        failpoints = chaos.report()
        chaos.reset()
        if sweeper is not None:
            sweeper.stop()
        if http_server is not None:
            http_server.shutdown()

    counters = metrics.counter_report()
    report["counters"] = {
        k: v for k, v in counters.items()
        if k.startswith(("relay.", "tree.", "chaos.", "participant.",
                         "clerk.share.", "server.round.",
                         "server.snapshot."))
    }
    report["failpoints"] = failpoints or None
    # span linkage proof: the whole run is ONE trace rooted at
    # tree.round, so the root round's timeline contains its children
    timelines = obs.round_timelines()
    tree_trace = next((t for t in timelines if t["root"] == "tree.round"),
                      None)
    report["trace_spans"] = tree_trace["spans"] if tree_trace else 0
    report["trace_lanes"] = tree_trace["lanes"] if tree_trace else []
    return report


def _unmask_leaf_subtotal(root, aggregation, total, masking_scheme,
                          modulus, path):
    """Unmask ONE leaf's masked subtotal with the root's key: the leaf's
    mask ciphertexts ride the ``MaskedLeafTotal`` sealed to the root
    (``Aggregation.mask_seal_target``), so the root can subtract their
    combination from the masked values exactly like the flat reveal does
    for the population total — just scoped to one leaf. Returns the
    ``leaf_subtotals`` entry robust aggregation consumes."""
    values = np.asarray(total.values, dtype=np.int64)
    encs = total.mask_encryptions or []
    if encs:
        _, mask_key_id = aggregation.mask_seal_target()
        decryptor = root.crypto.new_share_decryptor(
            mask_key_id, aggregation.recipient_encryption_scheme)
        decrypted = [decryptor.decrypt(e) for e in encs]
        mask = root.crypto.new_mask_combiner(masking_scheme).combine(
            decrypted)
        values = values - np.asarray(mask, dtype=np.int64)
    return {"path": path,
            "participations": int(total.participations or 0),
            "values": np.mod(values, modulus).astype(np.int64)}


def _run_flat_reference(new_client, keyed, rows, modulus, dim, scheme,
                        masking_scheme, timeout_s):
    """One ordinary flat round over ``rows`` on the same service; returns
    the revealed vector (positive representatives)."""
    from ..protocol import Aggregation, AggregationId, SodiumEncryption

    recipient = new_client()
    recipient_key = recipient.new_encryption_key()
    recipient.upload_encryption_key(recipient_key)
    clerks = [keyed(new_client()) for _ in range(scheme.output_size)]
    aggregation = Aggregation(
        id=AggregationId.random(),
        title="tree-flat-reference",
        vector_dimension=dim,
        modulus=modulus,
        recipient=recipient.agent.id,
        recipient_key=recipient_key,
        masking_scheme=masking_scheme,
        committee_sharing_scheme=scheme,
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    recipient.upload_aggregation(aggregation)
    recipient.begin_aggregation_with(
        aggregation.id, [c.agent.id for c in clerks])
    for row in rows:
        participant = new_client()
        participant.participate([int(x) for x in row], aggregation.id)
    recipient.end_aggregation(aggregation.id)
    give_up = time.monotonic() + timeout_s
    while time.monotonic() < give_up:
        for clerk in clerks:
            clerk.run_chores(-1)
        status = recipient.service.get_aggregation_status(
            recipient.agent, aggregation.id)
        if status and status.snapshots and status.snapshots[0].result_ready:
            break
        time.sleep(0.02)
    return recipient.await_result(
        aggregation.id, deadline=max(1.0, give_up - time.monotonic()),
        poll_interval=0.05).positive().values
