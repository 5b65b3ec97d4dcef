"""The tree planner: deterministic sharding + privacy/quorum composition.

Planning a population-scale round means answering three questions before
any resource exists:

1. **Who aggregates with whom?** ``shard_groups`` assigns participants to
   G leaf groups with the SAME consistent-hash ring the serving fleet
   routes aggregations with (``server/routing.py``): deterministic from
   the key alone (every planner computes the same shards with no
   coordination), balanced across groups, and minimal-movement when G
   changes by one — a population re-planned at G+1 keeps ~(G/(G+1)) of
   its assignments, so device-side caches and journals stay warm.
2. **Does privacy compose?** ``TreePlan.level_table`` lays out, per
   level, the committee's ``privacy_threshold`` (max colluding clerks
   that learn nothing) and ``reconstruction_threshold`` (min surviving
   results): an adversary must exceed some single level's privacy
   threshold — relays between levels see only masked totals, and every
   mask is sealed to the root.
3. **Does the arithmetic survive?** Shamir reconstruction returns the
   exact *integer* sum of the shared values, so each round's input count
   times the modulus must fit under the scheme's prime
   (``validate_headroom``). Relays reduce mod the aggregation modulus
   before re-sharing, so a parent needs headroom for its fan-in only —
   never for the whole population.

``TreePlan.build_aggregations`` then mints the actual resources: one
child aggregation per group plus a parent per internal node, each
carrying its :class:`~sda_tpu_torch.protocol.TreeLink` (parent/children
linkage, level, group, and the root mask-recipient redirect). The
degenerate G=1 plan is a flat round plus one relay hop and reveals
bit-exactly the same output (tests/test_tree_plan.py,
tests/test_tree_round.py).
"""

from __future__ import annotations

import uuid
from typing import Dict, List, Optional, Sequence

from ..protocol import (
    Aggregation,
    AggregationId,
    TreeLink,
)
from ..server.routing import DEFAULT_REPLICAS, HashRing

#: Namespace for deterministic aggregation ids minted by the planner
#: (uuid5 over plan-seed:node-path) — fixed-seed drills rebuild the exact
#: same tree, and a crash-replayed planner converges on the same ids.
_PLAN_NAMESPACE = uuid.UUID("8c90f3fa-52e9-4f19-9597-2b4b1be01877")


def shard_groups(
    keys: Sequence[str], groups: int, replicas: int = DEFAULT_REPLICAS
) -> List[List[str]]:
    """Assign ``keys`` (participant/agent ids) to ``groups`` leaf groups
    via the consistent-hash ring. Deterministic (SHA-256, no process
    state), near-balanced, and minimal-movement when ``groups`` changes
    by one — the Karger-ring properties the serving fleet already relies
    on, reused for population sharding."""
    if groups < 1:
        raise ValueError("need at least one group")
    ring = HashRing([f"group-{ix}" for ix in range(groups)],
                    replicas=replicas)
    out: List[List[str]] = [[] for _ in range(groups)]
    for key in keys:
        out[int(ring.node_for(str(key)).rsplit("-", 1)[1])].append(str(key))
    return out


class TreeNode:
    """One aggregation in the tree: the root (level 0), an internal
    relay node, or a leaf holding a participant shard."""

    __slots__ = ("path", "level", "group", "members", "children", "parent",
                 "aggregation_id")

    def __init__(self, path: str, level: int, group: Optional[int],
                 members: Optional[List[str]] = None):
        self.path = path          # stable tree-position label, e.g. "0/2"
        self.level = int(level)
        self.group = group        # leaf-group index (None for internal)
        self.members = list(members or [])  # participant keys (leaves)
        self.children: List["TreeNode"] = []
        self.parent: Optional["TreeNode"] = None
        self.aggregation_id: Optional[AggregationId] = None

    @property
    def is_leaf(self) -> bool:
        return not self.children

    @property
    def is_root(self) -> bool:
        return self.parent is None

    def fan_in(self) -> int:
        """Inputs this node's round aggregates: devices at a leaf,
        child relays at an internal node."""
        return len(self.members) if self.is_leaf else len(self.children)

    def walk(self):
        yield self
        for child in self.children:
            yield from child.walk()

    def __repr__(self):
        return (f"TreeNode(path={self.path!r}, level={self.level}, "
                f"fan_in={self.fan_in()})")


def plan_tree(
    participants: Sequence[str],
    *,
    group_size: int,
    fanout: Optional[int] = None,
    replicas: int = DEFAULT_REPLICAS,
    seed: str = "tree",
) -> "TreePlan":
    """Shard ``participants`` into leaf groups of about ``group_size``
    and stack relay levels until one root remains.

    ``fanout`` bounds an internal round's fan-in (child relays per
    parent); the default ``None`` means a single parent absorbs all G
    leaf relays — the 2-level tree. ``ceil(N / group_size)`` fixes the
    group COUNT; ring assignment is multinomial, so individual groups
    land *around* ``group_size``, not at-or-under it (size-sensitive
    scheme choices must check ``level_table``'s ``max_fan_in`` /
    ``validate_headroom``, which use the actual shards). A ring shard
    that comes up empty is dropped — every planned leaf has at least one
    member, and surviving groups keep their ring order. ``seed``
    namespaces the deterministic aggregation ids so independent trees
    never collide."""
    participants = [str(p) for p in participants]
    if not participants:
        raise ValueError("cannot plan a tree for zero participants")
    if group_size < 1:
        raise ValueError("group_size must be >= 1")
    if fanout is not None and fanout < 2:
        raise ValueError("fanout must be >= 2 (or None for one parent)")
    groups = max(1, -(-len(participants) // group_size))
    shards = shard_groups(participants, groups, replicas=replicas)
    # drop empty ring shards: a leaf round with no members has nothing
    # to aggregate and would feed a zero-length reconstruction upward
    nodes: List[TreeNode] = [
        TreeNode(path=f"leaf-{ix}", level=0, group=ix, members=shard)
        for ix, shard in enumerate(shards) if shard
    ]
    # stack levels bottom-up with contiguous chunking (the ring matters
    # for PARTICIPANT movement; internal nodes are plan-internal and
    # contiguous chunks keep sibling groups adjacent and deterministic).
    # A tree always has at least one relay hop — the degenerate G=1 plan
    # is one leaf under one root, the flat-equivalence fixture.
    height = 0
    while len(nodes) > 1 or height == 0:
        height += 1
        span = len(nodes) if fanout is None else fanout
        parents: List[TreeNode] = []
        for start in range(0, len(nodes), span):
            parent = TreeNode(path=f"l{height}-{start // span}",
                              level=0, group=None)
            for child in nodes[start:start + span]:
                child.parent = parent
                parent.children.append(child)
            parents.append(parent)
        nodes = parents
    root = nodes[0]
    # levels number root-down (root 0), matching TreeLink/RoundStatus
    depth = height
    for node in root.walk():
        node.level = depth - _height_of(node)
    return TreePlan(root=root, participants=participants, seed=str(seed))


def _height_of(node: TreeNode) -> int:
    return 0 if node.is_leaf else 1 + max(_height_of(c)
                                          for c in node.children)


class TreePlan:
    """A planned tree: topology + composition tables + resource minting."""

    def __init__(self, root: TreeNode, participants: List[str], seed: str):
        self.root = root
        self.participants = participants
        self.seed = seed
        for node in root.walk():
            node.aggregation_id = AggregationId(
                uuid.uuid5(_PLAN_NAMESPACE, f"{seed}:{node.path}"))

    # -- topology ----------------------------------------------------------
    def nodes(self) -> List[TreeNode]:
        return list(self.root.walk())

    def leaves(self) -> List[TreeNode]:
        return [n for n in self.nodes() if n.is_leaf]

    def relay_nodes(self) -> List[TreeNode]:
        """Every node whose recipient is a relay (all but the root), in
        deterministic walk order — the order ``build_aggregations``
        expects relay identities in."""
        return [n for n in self.nodes() if not n.is_root]

    def depth(self) -> int:
        """Number of levels (a flat-equivalent G=1 tree has 2)."""
        return 1 + max(n.level for n in self.nodes())

    def group_of(self, participant: str) -> int:
        for leaf in self.leaves():
            if str(participant) in leaf.members:
                return leaf.group
        raise KeyError(f"{participant} is not in this plan")

    # -- composition tables ------------------------------------------------
    def level_table(self, leaf_sharing, internal_sharing=None) -> List[dict]:
        """Per-level privacy/quorum composition: for each level, the
        round count, worst-case fan-in, and the committee thresholds in
        force. ``internal_sharing`` defaults to ``leaf_sharing`` (one
        committee shape everywhere)."""
        internal_sharing = internal_sharing or leaf_sharing
        by_level: Dict[int, List[TreeNode]] = {}
        for node in self.nodes():
            by_level.setdefault(node.level, []).append(node)
        table = []
        for level in sorted(by_level):
            members = by_level[level]
            leaf_level = all(n.is_leaf for n in members)
            scheme = leaf_sharing if leaf_level else internal_sharing
            table.append({
                "level": level,
                "rounds": len(members),
                "kind": "leaf" if leaf_level else
                        ("root" if level == 0 else "internal"),
                "max_fan_in": max(n.fan_in() for n in members),
                "committee_size": int(scheme.output_size),
                "privacy_threshold": int(scheme.privacy_threshold),
                "reconstruction_threshold":
                    int(scheme.reconstruction_threshold),
            })
        return table

    def validate_headroom(self, modulus: int, leaf_sharing,
                          internal_sharing=None) -> None:
        """Exactness guard for the two-ring case: when the aggregation
        modulus is SMALLER than a Shamir scheme's prime, reducing the
        reconstructed value mod the modulus is only correct if the exact
        integer sum of the round's inputs (each < modulus) never wrapped
        mod the prime — so fan-in x modulus must fit under it. Relays
        reduce mod the aggregation modulus before re-sharing, so each
        round only needs headroom for its own fan-in, never the
        population's. One-ring rounds (additive, or modulus == prime,
        where all arithmetic IS mod p) are wrap-free by construction."""
        for row in self.level_table(leaf_sharing, internal_sharing):
            scheme = (leaf_sharing if row["kind"] == "leaf"
                      else internal_sharing or leaf_sharing)
            prime = getattr(scheme, "prime_modulus", None)
            if prime is None or prime == int(modulus):
                continue  # one ring end to end, wrap-free
            need = row["max_fan_in"] * (int(modulus) - 1)
            if need >= prime:
                raise ValueError(
                    f"level {row['level']}: fan-in {row['max_fan_in']} x "
                    f"modulus {modulus} needs sum headroom {need} >= the "
                    f"scheme prime {prime}; shrink group_size/fanout or "
                    f"pick a larger prime")

    # -- resource minting --------------------------------------------------
    def build_aggregations(
        self,
        *,
        title: str,
        vector_dimension: int,
        modulus: int,
        masking_scheme,
        leaf_sharing,
        recipient_encryption_scheme,
        committee_encryption_scheme,
        root_recipient,
        root_recipient_key,
        relays: Sequence,
        internal_sharing=None,
    ) -> Dict[str, Aggregation]:
        """Mint one Aggregation per tree node, TreeLink-wired.

        ``relays`` aligns with :meth:`relay_nodes`: one ``(agent_id,
        encryption_key_id)`` per non-root node, naming that node's relay
        recipient. Every node shares the masking scheme (leaf masks and
        relay masks must combine in one ring at the root) and the mask
        redirect points at the root recipient. Returns ``{node.path:
        Aggregation}``."""
        internal_sharing = internal_sharing or leaf_sharing
        self.validate_headroom(modulus, leaf_sharing, internal_sharing)
        if masking_scheme.has_mask and \
                getattr(masking_scheme, "modulus", modulus) != int(modulus):
            raise ValueError(
                "tree rounds unmask in one ring: masking modulus "
                f"{masking_scheme.modulus} != aggregation modulus {modulus}")
        relay_nodes = self.relay_nodes()
        if len(relays) != len(relay_nodes):
            raise ValueError(
                f"need {len(relay_nodes)} relay identities "
                f"(one per non-root node), got {len(relays)}")
        relay_of = dict(zip((n.path for n in relay_nodes), relays))
        out: Dict[str, Aggregation] = {}
        for node in self.nodes():
            if node.is_root:
                recipient, recipient_key = root_recipient, root_recipient_key
                mask_recipient = mask_key = None  # masks already seal here
            else:
                recipient, recipient_key = relay_of[node.path]
                mask_recipient, mask_key = root_recipient, root_recipient_key
            out[node.path] = Aggregation(
                id=node.aggregation_id,
                title=(title if node.is_root
                       else f"{title}/{node.path}"),
                vector_dimension=vector_dimension,
                modulus=modulus,
                recipient=recipient,
                recipient_key=recipient_key,
                masking_scheme=masking_scheme,
                committee_sharing_scheme=(leaf_sharing if node.is_leaf
                                          else internal_sharing),
                recipient_encryption_scheme=recipient_encryption_scheme,
                committee_encryption_scheme=committee_encryption_scheme,
                tree=TreeLink(
                    root=self.root.aggregation_id,
                    parent=(None if node.is_root
                            else node.parent.aggregation_id),
                    children=[c.aggregation_id for c in node.children],
                    level=node.level,
                    group=node.group,
                    mask_recipient=mask_recipient,
                    mask_recipient_key=mask_key,
                ),
            )
        return out


