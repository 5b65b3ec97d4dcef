"""The tree plane on the port (``sda_tpu_torch/tree``) on the CPU: the
recipes of ``tests/test_tree_plan.py`` (the planner: topology,
deterministic ids, the privacy-threshold / quorum composition math),
``tests/test_tree_round.py`` (end-to-end hierarchical rounds through the
port's server stack, its clients on the CPU: bit-exact against the flat
reference, masks sealed past the relay, degraded and failed leaves,
linkage) and ``tests/test_tree_sim.py`` (the population simulator:
exactness, bounded memory, the BENCH record the port's regression gate
parses).
"""

import functools
import json

import numpy as np
import pytest
import torch

from sda_tpu_torch.obs import regress
from sda_tpu_torch.protocol import (
    AdditiveSharing,
    AgentId,
    EncryptionKeyId,
    FullMasking,
    PackedShamirSharing,
    SodiumEncryption,
)
from sda_tpu_torch.server import lifecycle, new_memory_server
from sda_tpu_torch.tree import run_tree_round as _run_tree_round
from sda_tpu_torch.tree import simulate_population_round
from sda_tpu_torch.tree.plan import plan_tree

#: the tree rounds' clients run their field arithmetic on the CPU
run_tree_round = functools.partial(_run_tree_round, device="cpu")

@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many small tensor ops: with one intra-op thread
    they do not spin against the suite's other workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the planner (tests/test_tree_plan.py)

PACKED = PackedShamirSharing(
    secret_count=3, share_count=8, privacy_threshold=4,
    prime_modulus=433, omega_secrets=354, omega_shares=150,
)
ADDITIVE = AdditiveSharing(share_count=3, modulus=433)


def participants(n):
    return [f"p-{ix:05d}" for ix in range(n)]


class TestTopology:
    def test_two_level_tree_by_default(self):
        plan = plan_tree(participants(100), group_size=10)
        assert plan.depth() == 2
        leaves = plan.leaves()
        assert len(leaves) == 10
        assert sum(len(leaf.members) for leaf in leaves) == 100
        assert plan.root.level == 0
        assert all(leaf.level == 1 for leaf in leaves)
        assert all(leaf.parent is plan.root for leaf in leaves)

    def test_degenerate_single_group_is_leaf_plus_root(self):
        """G=1: one leaf holding everyone under one root — a flat round
        plus exactly one relay hop."""
        plan = plan_tree(participants(7), group_size=16)
        assert plan.depth() == 2
        assert len(plan.leaves()) == 1
        assert plan.leaves()[0].members == participants(7)
        assert len(plan.relay_nodes()) == 1

    def test_fanout_stacks_levels(self):
        plan = plan_tree(participants(64), group_size=4, fanout=4)
        assert len(plan.leaves()) == 16
        assert plan.depth() == 3  # 16 leaves / fanout 4 -> 4 -> 1
        for node in plan.nodes():
            assert node.is_leaf or node.fan_in() <= 4

    def test_deterministic_aggregation_ids(self):
        a = plan_tree(participants(30), group_size=10, seed="fixed")
        b = plan_tree(participants(30), group_size=10, seed="fixed")
        assert [str(n.aggregation_id) for n in a.nodes()] == \
            [str(n.aggregation_id) for n in b.nodes()]
        c = plan_tree(participants(30), group_size=10, seed="other")
        assert str(a.root.aggregation_id) != str(c.root.aggregation_id)

    def test_empty_ring_shards_dropped(self):
        """A ring shard with no members is dropped at plan time: every
        planned leaf has at least one participant (an empty leaf would
        feed a zero-length reconstruction upward), and the survivors
        keep their ring group indices."""
        for n in (2, 3, 5, 17):
            plan = plan_tree(participants(n), group_size=1,
                             seed=f"empty-{n}")
            leaves = plan.leaves()
            assert all(leaf.members for leaf in leaves)
            assert sum(len(leaf.members) for leaf in leaves) == n
            assert len({leaf.group for leaf in leaves}) == len(leaves)

    def test_group_of(self):
        plan = plan_tree(participants(40), group_size=10)
        for leaf in plan.leaves():
            for member in leaf.members:
                assert plan.group_of(member) == leaf.group
        with pytest.raises(KeyError):
            plan.group_of("not-a-participant")


class TestComposition:
    def test_level_table_thresholds(self):
        """Per-level privacy/quorum table: every level carries its
        committee's thresholds — the composition claim is that an
        adversary must exceed privacy_threshold at some SINGLE level."""
        plan = plan_tree(participants(120), group_size=16)
        table = plan.level_table(PACKED)
        assert [row["level"] for row in table] == [0, 1]
        root_row, leaf_row = table
        assert root_row["kind"] == "root" and root_row["rounds"] == 1
        assert leaf_row["kind"] == "leaf"
        assert leaf_row["rounds"] == len(plan.leaves())
        for row in table:
            assert row["committee_size"] == 8
            assert row["privacy_threshold"] == 4
            assert row["reconstruction_threshold"] == 7  # t + k
        assert root_row["max_fan_in"] == len(plan.leaves())
        assert leaf_row["max_fan_in"] == max(
            len(leaf.members) for leaf in plan.leaves())

    def test_mixed_schemes_per_level(self):
        plan = plan_tree(participants(60), group_size=20)
        table = plan.level_table(PACKED, internal_sharing=ADDITIVE)
        root_row, leaf_row = table
        assert leaf_row["privacy_threshold"] == 4
        assert leaf_row["reconstruction_threshold"] == 7
        # additive at the root: n-of-n — everyone is required
        assert root_row["privacy_threshold"] == 2
        assert root_row["reconstruction_threshold"] == 3

    def test_degenerate_tree_matches_flat_committee(self):
        """G=1 leaf round == the flat round's committee shape: same
        scheme object, same thresholds — flat-equivalence at the math
        level (bit-exact reveal pinned end-to-end elsewhere)."""
        plan = plan_tree(participants(9), group_size=9)
        table = plan.level_table(PACKED)
        leaf_row = table[1]
        assert leaf_row["rounds"] == 1
        assert leaf_row["max_fan_in"] == 9
        assert leaf_row["committee_size"] == PACKED.output_size
        assert leaf_row["privacy_threshold"] == PACKED.privacy_threshold
        assert (leaf_row["reconstruction_threshold"]
                == PACKED.reconstruction_threshold)

    def test_headroom_one_ring_is_wrap_free(self):
        """modulus == prime: all arithmetic is mod p, no headroom needed
        no matter the fan-in (the drill committees' configuration)."""
        plan = plan_tree(participants(400), group_size=100)
        plan.validate_headroom(433, PACKED)  # must not raise

    def test_headroom_two_ring_guard(self):
        """modulus < prime: the exact integer sum must fit under the
        prime, so an oversized fan-in is rejected at PLAN time, not
        discovered as a silently wrong reveal."""
        scheme = PackedShamirSharing(
            secret_count=3, share_count=8, privacy_threshold=4,
            prime_modulus=433, omega_secrets=354, omega_shares=150,
        )
        small = plan_tree(participants(8), group_size=2)
        small.validate_headroom(100, scheme)  # 2 * 99 < 433: fine
        big = plan_tree(participants(80), group_size=10)
        with pytest.raises(ValueError, match="headroom"):
            big.validate_headroom(100, scheme)  # 10 * 99 >= 433


class TestBuildAggregations:
    def _relays(self, plan):
        return [(AgentId.random(), EncryptionKeyId.random())
                for _ in plan.relay_nodes()]

    def _build(self, plan, **overrides):
        root_recipient = overrides.pop("root_recipient", AgentId.random())
        root_key = overrides.pop("root_recipient_key",
                                 EncryptionKeyId.random())
        kwargs = dict(
            title="t", vector_dimension=4, modulus=433,
            masking_scheme=FullMasking(433),
            leaf_sharing=ADDITIVE,
            recipient_encryption_scheme=SodiumEncryption(),
            committee_encryption_scheme=SodiumEncryption(),
            root_recipient=root_recipient,
            root_recipient_key=root_key,
            relays=overrides.pop("relays", self._relays(plan)),
        )
        kwargs.update(overrides)
        return root_recipient, root_key, plan.build_aggregations(**kwargs)

    def test_tree_links_wired(self):
        plan = plan_tree(participants(30), group_size=10)
        root_recipient, root_key, aggs = self._build(plan)
        root_agg = aggs[plan.root.path]
        assert root_agg.tree.parent is None
        assert root_agg.recipient == root_recipient
        assert len(root_agg.tree.children) == 3
        # the root's own masks already seal to its recipient: no redirect
        assert root_agg.tree.mask_recipient_key is None
        for leaf in plan.leaves():
            agg = aggs[leaf.path]
            assert agg.tree.root == plan.root.aggregation_id
            assert agg.tree.parent == plan.root.aggregation_id
            assert agg.tree.level == 1 and agg.tree.group == leaf.group
            # the privacy hinge: leaf masks seal to the ROOT, past the relay
            assert agg.tree.mask_recipient == root_recipient
            assert agg.tree.mask_recipient_key == root_key
            assert agg.recipient != root_recipient
            assert agg.id in root_agg.tree.children

    def test_serde_round_trip(self):
        from sda_tpu_torch.protocol import Aggregation

        plan = plan_tree(participants(12), group_size=6)
        _, _, aggs = self._build(plan)
        for agg in aggs.values():
            back = Aggregation.from_obj(agg.to_obj())
            assert back == agg
            assert back.tree.to_obj() == agg.tree.to_obj()

    def test_flat_wire_shape_unchanged(self):
        """A flat aggregation serializes WITHOUT a tree key — the exact
        reference wire shape old peers parse."""
        from sda_tpu_torch.protocol import Aggregation, AggregationId

        flat = Aggregation(
            id=AggregationId.random(), title="flat", vector_dimension=4,
            modulus=433, recipient=AgentId.random(),
            recipient_key=EncryptionKeyId.random(),
            masking_scheme=FullMasking(433),
            committee_sharing_scheme=ADDITIVE,
            recipient_encryption_scheme=SodiumEncryption(),
            committee_encryption_scheme=SodiumEncryption(),
        )
        assert "tree" not in flat.to_obj()

    def test_relay_count_mismatch_rejected(self):
        plan = plan_tree(participants(30), group_size=10)
        with pytest.raises(ValueError, match="relay"):
            self._build(plan, relays=[(AgentId.random(),
                                       EncryptionKeyId.random())])

    def test_mask_ring_mismatch_rejected(self):
        plan = plan_tree(participants(10), group_size=5)
        with pytest.raises(ValueError, match="ring"):
            self._build(plan, masking_scheme=FullMasking(101))


# ---------------------------------------------------------------------------
# tree rounds (tests/test_tree_round.py)

def inputs_for(n, dim=4, seed=0, modulus=433):
    rng = np.random.default_rng(seed)
    return rng.integers(0, modulus, size=(n, dim), dtype=np.int64)


class TestBitExact:
    def test_tree_reveals_flat_sum(self):
        report = run_tree_round(
            inputs_for(9), group_size=4, sharing="additive",
            masking="full", seed=7)
        assert report["exact"] is True
        assert report["flat_exact"] is True
        assert report["depth"] == 2
        assert report["root_state"] == "revealed"
        assert report["relays"] == report["groups"]

    def test_degenerate_single_group_equals_flat(self):
        """G=1: every participant in one leaf, one relay hop — the tree
        reveal is bit-exact with the flat reference round."""
        report = run_tree_round(
            inputs_for(6, seed=3), group_size=32, sharing="additive",
            masking="full", seed=3)
        assert report["groups"] == 1
        assert report["exact"] is True
        assert report["flat_exact"] is True

    def test_chacha_masking_forwards_seeds(self):
        report = run_tree_round(
            inputs_for(8, seed=5), group_size=3, sharing="additive",
            masking="chacha", seed=5)
        assert report["exact"] is True
        assert report["flat_exact"] is True
        assert report["counters"].get("relay.masks_forwarded", 0) == 8

    def test_dropout_shrinks_the_sum_exactly(self):
        report = run_tree_round(
            inputs_for(12, seed=11), group_size=4, sharing="additive",
            masking="full", seed=11, dropout_rate=0.5)
        assert report["participants_dropped"] >= 1
        assert report["exact"] is True
        assert report["flat_exact"] is True


class TestRelayPrivacy:
    def test_masks_seal_past_the_relay(self):
        """The privacy hinge, mechanically: every leaf mask ciphertext
        opens with the ROOT's key (the exact reveal proves it) and the
        relay's own key CANNOT open it — a relay never sees an unmasked
        value."""
        from sda_tpu_torch.client import SdaClient
        from sda_tpu_torch.crypto import MemoryKeystore
        from sda_tpu_torch.protocol import (
            AdditiveSharing, FullMasking, SodiumEncryption)
        from sda_tpu_torch.tree.plan import plan_tree

        service = new_memory_server()

        def new_client():
            keystore = MemoryKeystore()
            agent = SdaClient.new_agent(keystore)
            client = SdaClient(agent, keystore, service, device="cpu")
            client.upload_agent()
            return client

        root = new_client()
        root_key = root.new_encryption_key()
        root.upload_encryption_key(root_key)
        relay = new_client()
        relay_key = relay.new_encryption_key()
        relay.upload_encryption_key(relay_key)
        clerks = []
        for _ in range(3):
            clerk = new_client()
            clerk.upload_encryption_key(clerk.new_encryption_key())
            clerks.append(clerk)
        participant = new_client()

        plan = plan_tree([str(participant.agent.id)], group_size=4)
        aggs = plan.build_aggregations(
            title="privacy", vector_dimension=4, modulus=433,
            masking_scheme=FullMasking(433),
            leaf_sharing=AdditiveSharing(share_count=3, modulus=433),
            recipient_encryption_scheme=SodiumEncryption(),
            committee_encryption_scheme=SodiumEncryption(),
            root_recipient=root.agent.id, root_recipient_key=root_key,
            relays=[(relay.agent.id, relay_key)],
        )
        leaf = plan.leaves()[0]
        relay.upload_aggregation(aggs[leaf.path])
        relay.begin_aggregation_with(
            leaf.aggregation_id, [c.agent.id for c in clerks])
        participant.participate([1, 2, 3, 4], leaf.aggregation_id)
        uploaded = list(
            service.server.aggregation_store._participations[
                leaf.aggregation_id].values())
        assert len(uploaded) == 1
        mask_ct = uploaded[0].recipient_encryption
        assert mask_ct is not None
        # the root opens it; the relay must not be able to
        root_decryptor = root.crypto.new_share_decryptor(
            root_key, aggs[leaf.path].recipient_encryption_scheme)
        assert len(root_decryptor.decrypt(mask_ct)) == 4
        relay_decryptor = relay.crypto.new_share_decryptor(
            relay_key, aggs[leaf.path].recipient_encryption_scheme)
        with pytest.raises(Exception):
            relay_decryptor.decrypt(mask_ct)


class TestRelayResume:
    def test_crashed_relay_replays_byte_identically(self, tmp_path):
        """A relay that dies in the lost-ack window (upload ingested, ack
        never seen) must replay its journaled bytes on restart — the
        server dedupes the byte-identical re-upload instead of rejecting
        a fresh-randomness recompute as an equivocation."""
        from sda_tpu_torch.client import SdaClient, relay
        from sda_tpu_torch.client.journal import ParticipationJournal
        from sda_tpu_torch.crypto import MemoryKeystore
        from sda_tpu_torch.protocol import (
            AdditiveSharing, FullMasking, SodiumEncryption)
        from sda_tpu_torch.tree.plan import plan_tree
        from sda_tpu_torch.utils import metrics

        service = new_memory_server()

        def new_client():
            keystore = MemoryKeystore()
            agent = SdaClient.new_agent(keystore)
            client = SdaClient(agent, keystore, service, device="cpu")
            client.upload_agent()
            return client

        def keyed(client):
            client.upload_encryption_key(client.new_encryption_key())
            return client

        root = new_client()
        root_key = root.new_encryption_key()
        root.upload_encryption_key(root_key)
        relay_client = new_client()
        relay_key = relay_client.new_encryption_key()
        relay_client.upload_encryption_key(relay_key)
        participant = new_client()
        plan = plan_tree([str(participant.agent.id)], group_size=4,
                         seed="resume")
        scheme = AdditiveSharing(share_count=3, modulus=433)
        aggs = plan.build_aggregations(
            title="resume", vector_dimension=4, modulus=433,
            masking_scheme=FullMasking(433), leaf_sharing=scheme,
            recipient_encryption_scheme=SodiumEncryption(),
            committee_encryption_scheme=SodiumEncryption(),
            root_recipient=root.agent.id, root_recipient_key=root_key,
            relays=[(relay_client.agent.id, relay_key)],
        )
        leaf = plan.leaves()[0]
        root_node = plan.root
        clerks = {node.path: [keyed(new_client()) for _ in range(3)]
                  for node in plan.nodes()}
        for node in plan.nodes():
            owner = root if node.is_root else relay_client
            owner.upload_aggregation(aggs[node.path])
            owner.begin_aggregation_with(
                node.aggregation_id,
                [c.agent.id for c in clerks[node.path]])
        participant.participate([1, 2, 3, 4], leaf.aggregation_id)
        relay_client.end_aggregation(leaf.aggregation_id)
        for clerk in clerks[leaf.path]:
            clerk.run_chores(-1)

        # first attempt: seal + journal + upload, then "crash" before
        # the reap — exactly what relay_up does up to the lost ack
        journal = ParticipationJournal(str(tmp_path))
        total = relay.await_masked(relay_client, leaf.aggregation_id,
                                   deadline=30)
        participation = relay_client.new_participation(
            [int(v) for v in total.values], root_node.aggregation_id)
        participation.forwarded_masks = list(total.mask_encryptions)
        journal.record(participation)
        relay_client.upload_participation(participation)  # ack "lost"

        # restart: relay_up with the journal replays the SAME bytes
        relay.relay_up(relay_client, leaf.aggregation_id,
                       root_node.aggregation_id, deadline=30,
                       journal=journal)
        assert metrics.counter_report().get(
            "server.participation.replayed", 0) >= 1
        assert journal.load(relay_client.agent.id,
                            root_node.aggregation_id) is None  # reaped
        status = root.service.get_aggregation_status(
            root.agent, root_node.aggregation_id)
        assert status.number_of_participations == 1  # never double-counted

        # the round still completes exactly
        root.end_aggregation(root_node.aggregation_id)
        for clerk in clerks[root_node.path]:
            clerk.run_chores(-1)
        out = root.await_result(root_node.aggregation_id, deadline=30)
        np.testing.assert_array_equal(out.positive().values, [1, 2, 3, 4])


class TestLeafFailureModes:
    def test_dead_clerk_degrades_leaf_root_stays_exact(self):
        """Packed Shamir leaf loses one clerk: the sweeper declares the
        leaf degraded, the relay completes from the surviving quorum,
        and the ROOT round reveals bit-exactly."""
        report = run_tree_round(
            inputs_for(8, seed=3), group_size=4, sharing="packed",
            masking="full", seed=3, dead_clerks_leaf=1)
        leaf_states = {path: s for path, s in report["node_states"].items()
                       if s.get("group") is not None}
        assert report["node_states"][report["dead_clerk_leaf"]][
            "state"] == "degraded"
        assert report["root_state"] == "revealed"
        assert report["exact"] is True
        assert report["flat_exact"] is True
        # the other leaf was untouched (disjoint committees)
        others = [s for path, s in leaf_states.items()
                  if path != report["dead_clerk_leaf"]]
        assert all(s["state"] == "ready" for s in others)

    def test_failed_leaf_fails_root_naming_the_leaf(self):
        """Additive leaf loses a clerk: unrecoverable — the leaf goes
        terminal failed and the sweeper's tree propagation fails the
        ROOT with a machine-readable reason naming the child round."""
        report = run_tree_round(
            inputs_for(8, seed=3), group_size=4, sharing="additive",
            masking="full", seed=3, dead_clerks_leaf=1,
            flat_reference=False)
        dead_leaf = report["dead_clerk_leaf"]
        leaf_state = report["node_states"][dead_leaf]
        assert leaf_state["state"] == "failed"
        assert report["root_state"] == "failed"
        assert report["failure"]["type"] == "RoundFailed"
        # machine-readable: the root's reason names the failed child
        failed_leaf_id = [
            str(s) for s in report["root_children"]
        ]
        assert "child round" in report["root_reason"]
        assert any(cid in report["root_reason"] for cid in failed_leaf_id)
        assert "additive sharing cannot recover" in report["root_reason"]


class TestLinkage:
    def test_round_documents_expose_parent_and_children(self):
        """RoundStatus + the /statusz rounds table carry the tree
        linkage: the root names its children, each leaf its parent — a
        stuck tree is diagnosable from any worker."""
        service = new_memory_server()
        report = run_tree_round(
            inputs_for(6, seed=9), group_size=3, sharing="additive",
            masking="full", seed=9, service=service,
            flat_reference=False)
        assert report["exact"] is True
        docs = service.server.aggregation_store.list_round_states()
        by_id = {d["aggregation"]: d for d in docs}
        roots = [d for d in docs if d.get("children")]
        assert len(roots) == 1
        root_doc = roots[0]
        assert root_doc.get("parent") is None
        assert len(root_doc["children"]) == report["groups"]
        for child_id in root_doc["children"]:
            child = by_id[child_id]
            assert child["parent"] == root_doc["aggregation"]
            assert child["level"] == 1
            assert child["group"] is not None
        # the /statusz table rows carry the linkage too
        table = lifecycle.rounds_report(service.server, limit=16)
        rows = {r["aggregation"]: r for r in table["recent"]}
        assert rows[root_doc["aggregation"]]["children"] == \
            root_doc["children"]
        assert rows[root_doc["children"][0]]["parent"] == \
            root_doc["aggregation"]

    def test_round_status_serde_carries_linkage(self):
        from sda_tpu_torch.protocol import AggregationId, RoundStatus

        status = RoundStatus(
            aggregation=AggregationId("11111111-1111-1111-1111-111111111111"),
            state="clerking",
            parent="22222222-2222-2222-2222-222222222222",
            children=["33333333-3333-3333-3333-333333333333"],
        )
        back = RoundStatus.from_obj(status.to_obj())
        assert str(back.parent) == "22222222-2222-2222-2222-222222222222"
        assert [str(c) for c in back.children] == [
            "33333333-3333-3333-3333-333333333333"]


# ---------------------------------------------------------------------------
# the population simulator (tests/test_tree_sim.py)

class TestSimExactness:
    def test_tree_total_matches_flat_walk(self):
        record = simulate_population_round(
            20_000, group_size=2048, dim=4, batch=512, seed=3)
        assert record["exact"] is True
        assert record["groups"] == 10
        assert record["depth"] == 2

    def test_deterministic_at_fixed_seed(self):
        a = simulate_population_round(
            5_000, group_size=512, dim=4, batch=256, seed=11)
        b = simulate_population_round(
            5_000, group_size=512, dim=4, batch=256, seed=11)
        for key in ("exact", "groups", "peak_node_elements", "group_min",
                    "group_max"):
            assert a[key] == b[key]

    def test_multi_level_tree(self):
        record = simulate_population_round(
            8_000, group_size=256, fanout=8, dim=2, batch=128, seed=5)
        assert record["exact"] is True
        assert record["depth"] >= 3


class TestBoundedMemory:
    def test_peak_is_batch_bound_not_population(self):
        """The acceptance bound: peak live elements per node is a
        function of (batch, dim) only — growing the population 4x leaves
        it untouched."""
        small = simulate_population_round(
            5_000, group_size=1024, dim=4, batch=256, seed=7)
        large = simulate_population_round(
            20_000, group_size=1024, dim=4, batch=256, seed=7)
        assert small["bounded"] and large["bounded"]
        assert large["peak_node_elements"] <= large["bound_elements"]
        assert large["peak_node_elements"] == small["peak_node_elements"]
        assert large["bound_elements"] == small["bound_elements"]
        # the measured half: tracemalloc peak of the 4x population's
        # streaming pass stays under the SAME batch-derived bound
        assert large["peak_pass_bytes"] <= large["bound_pass_bytes"]
        assert large["bound_pass_bytes"] == small["bound_pass_bytes"]

    @pytest.mark.slow
    def test_full_population_1e5(self):
        """The headline drill size: a fixed-seed 10^5-participant
        2-level tree completes, bit-exact, with bounded per-node
        memory."""
        record = simulate_population_round(100_000, seed=20260803)
        assert record["participants"] == 100_000
        assert record["depth"] == 2
        assert record["exact"] is True
        assert record["bounded"] is True


class TestBenchRecord:
    def test_record_parses_through_the_gate(self, tmp_path):
        record = simulate_population_round(
            5_000, group_size=512, dim=4, batch=256, seed=1)
        for key in ("metric", "value", "unit", "platform", "seed"):
            assert key in record
        path = tmp_path / "TREE_r01.json"
        path.write_text(json.dumps(record))
        entries = regress.load_records([str(path)])
        assert len(entries) == 1
        assert entries[0]["record"] is not None
        assert entries[0]["record"]["value"] == record["value"]
        # one record seeds its metric's window: the gate passes (advisory
        # first-of-metric), never errors on the shape
        verdict = regress.check(entries)
        assert verdict["regressions"] == []
