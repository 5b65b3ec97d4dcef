"""Consistent-hash routing of aggregations onto fleet workers.

The SDA server is a stateless broker over durable stores, so *any* worker
can serve *any* request — routing is purely an affinity optimization: by
concentrating one aggregation's traffic (its snapshot POSTs, its clerks'
job polls, its recipient's status/result reads) on a preferred worker, the
client-side immutable-doc caches stay hot and clerking-job leases are
taken and refreshed by the node that already holds the committee documents
in memory. A request that lands elsewhere is still served correctly; the
store-level contended-idempotency contract (docs/scaling.md) guarantees
that even racing control-plane writes from two nodes converge bit-exactly.

The ring is the classic Karger construction: each node is hashed onto the
circle at ``replicas`` virtual points and a key routes to the first node
clockwise. Adding/removing one node therefore only moves ~1/N of the
keyspace — a drained worker's aggregations redistribute without reshuffling
everyone else's affinity (and therefore their caches).

Deterministic by construction (SHA-256, no process state): every client,
worker, and the fleet launcher computes the same mapping from the same
peer list, so routing needs no coordination service.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Sequence

#: Response header naming the worker that actually served the request.
NODE_HEADER = "X-SDA-Node"

DEFAULT_REPLICAS = 64


def _point(data: str) -> int:
    return int.from_bytes(hashlib.sha256(data.encode("utf-8")).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring over a fixed set of node ids."""

    def __init__(self, nodes: Sequence[str], replicas: int = DEFAULT_REPLICAS):
        nodes = list(dict.fromkeys(str(n) for n in nodes))  # dedupe, keep order
        if not nodes:
            raise ValueError("HashRing needs at least one node")
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self.nodes = nodes
        self.replicas = replicas
        points = []
        for node in nodes:
            for replica in range(replicas):
                points.append((_point(f"{node}#{replica}"), node))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [n for _, n in points]

    def node_for(self, key: str) -> str:
        """The preferred worker for ``key`` (e.g. an aggregation id)."""
        ix = bisect.bisect_right(self._points, _point(str(key)))
        if ix == len(self._points):
            ix = 0  # wrap: first point clockwise past the top of the circle
        return self._owners[ix]

    def preferred(self, key: str, count: int = 1) -> List[str]:
        """The first ``count`` DISTINCT nodes clockwise from ``key`` —
        position 0 is the primary, the rest are the natural failover
        order (same walk a replica placement would use)."""
        count = min(count, len(self.nodes))
        ix = bisect.bisect_right(self._points, _point(str(key)))
        out: List[str] = []
        for step in range(len(self._points)):
            node = self._owners[(ix + step) % len(self._points)]
            if node not in out:
                out.append(node)
                if len(out) == count:
                    break
        return out

    def spread(self, keys: Sequence[str]) -> Dict[str, int]:
        """Keys-per-node tally — the launcher prints this so an operator
        can eyeball balance before pointing real traffic at the fleet."""
        tally = {node: 0 for node in self.nodes}
        for key in keys:
            tally[self.node_for(key)] += 1
        return tally
