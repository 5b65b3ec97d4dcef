"""The recipes of ``tests/test_routing_groups.py`` against the port's
group sharding (``sda_tpu_torch.tree.plan.shard_groups`` over
``server/routing.py``'s ``HashRing``): determinism, balance and minimal
movement, each with the port's shards equal to the reference's on the
same population."""

import pytest

from sda_tpu.server.routing import HashRing as RefHashRing
from sda_tpu.tree.plan import shard_groups as ref_shard_groups
from sda_tpu_torch.server.routing import HashRing
from sda_tpu_torch.tree.plan import shard_groups


def keys(n, tag="agent"):
    return [f"{tag}-{ix:06d}" for ix in range(n)]


def assignment(shards):
    return {key: ix for ix, shard in enumerate(shards) for key in shard}


def shards(population, groups, **kw):
    """The port's shards, held equal to the reference's."""
    got = shard_groups(population, groups, **kw)
    assert got == ref_shard_groups(population, groups, **kw)
    return got


class TestDeterminism:
    def test_same_keys_same_shards(self):
        population = keys(500)
        assert shards(population, 7) == shard_groups(population, 7)

    def test_order_independent(self):
        population = keys(300)
        forward = assignment(shards(population, 5))
        backward = assignment(shards(list(reversed(population)), 5))
        assert forward == backward

    def test_matches_ring_directly(self):
        population = keys(64)
        names = [f"group-{ix}" for ix in range(4)]
        ring, ref_ring = HashRing(names), RefHashRing(names)
        got = assignment(shards(population, 4))
        for key in population:
            assert f"group-{got[key]}" == ring.node_for(key) \
                == ref_ring.node_for(key)

    def test_single_group_takes_all(self):
        population = keys(40)
        assert shards(population, 1) == [population]

    def test_zero_groups_rejected(self):
        with pytest.raises(ValueError):
            shard_groups(keys(4), 0)
        with pytest.raises(ValueError):
            ref_shard_groups(keys(4), 0)


class TestBalance:
    def test_rough_balance_across_groups(self):
        population = keys(4000)
        groups = 8
        sizes = [len(s) for s in shards(population, groups)]
        fair = len(population) / groups
        assert sum(sizes) == len(population)
        assert min(sizes) > 0
        assert max(sizes) < 2.5 * fair
        assert min(sizes) > fair / 3.5

    def test_more_replicas_tighten_balance(self):
        population = keys(4000)
        loose = [len(s) for s in shards(population, 8, replicas=8)]
        tight = [len(s) for s in shards(population, 8, replicas=256)]

        def spread(sizes):
            return max(sizes) - min(sizes)

        assert spread(tight) <= spread(loose)


class TestMinimalMovement:
    def test_adding_one_group_moves_about_one_share(self):
        population = keys(3000)
        groups = 9
        before = assignment(shards(population, groups))
        after = assignment(shards(population, groups + 1))
        moved = [key for key in population if before[key] != after[key]]
        fair_share = len(population) / (groups + 1)
        assert len(moved) < 2.5 * fair_share
        assert all(after[key] == groups for key in moved)

    def test_removing_one_group_only_drains_it(self):
        population = keys(3000)
        groups = 10
        before = assignment(shards(population, groups))
        after = assignment(shards(population, groups - 1))
        for key in population:
            if before[key] != groups - 1:
                assert after[key] == before[key]
