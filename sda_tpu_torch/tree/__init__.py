"""Hierarchical (tree) aggregation — population-scale rounds over
recursive committees.

Flat committees cap out structurally: every clerk touches every
participation, so per-clerk round cost is O(participants) no matter how
many workers serve the fleet. The standard scale move for secure
aggregation at population scale (Bonawitz et al., "Towards Federated
Learning at Scale", MLSys 2019) is hierarchy: shard the population into
leaf groups whose committees produce encrypted partial aggregates
feeding a parent round — recursively, so every committee's cost is
O(group size) and the tree covers any population.

Privacy composes per level (docs/scaling.md):

- leaf participants seal masks to the **root** recipient
  (``TreeLink.mask_recipient_key``), shares to their leaf committee;
- each leaf's **relay** (``client/relay.py``) reconstructs only the
  *masked* leaf total, re-shares it into the parent round and forwards
  the mask ciphertexts upward unopened;
- only the root, holding the single mask key, unmasks — with the
  ordinary flat reveal.

Modules: :mod:`sda_tpu_torch.tree.plan` (the planner: ring sharding, privacy /
quorum composition tables, aggregation construction),
:mod:`sda_tpu_torch.tree.round` (the driver: runs every level through the real
server stack with lifecycle, chaos and span linkage), and
:mod:`sda_tpu_torch.tree.sim` (the population-scale simulator behind the
``participants=1e5`` bench record, with bounded per-node memory asserted).
"""

from .plan import TreeNode, TreePlan, plan_tree, shard_groups  # noqa: F401
from .round import TreeRoundReport, run_tree_round  # noqa: F401
from .sim import simulate_population_round  # noqa: F401
