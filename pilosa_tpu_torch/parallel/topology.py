"""Cluster topology: hash partitioning and replica placement.

Reference: cluster.go (partition(index, shard) = fnv % 256, partitionNodes,
shardNodes, ReplicaN, Node, Topology). Shards hash to 256 partitions;
each partition maps to a primary node with ``ReplicaN - 1`` consecutive
followers in sorted-node order — identical placement math on every node, no
coordination needed to route.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

PARTITION_N = 256

# states (reference: cluster.go NORMAL/STARTING/RESIZING/DEGRADED)
STATE_STARTING = "STARTING"
STATE_NORMAL = "NORMAL"
STATE_RESIZING = "RESIZING"
STATE_DEGRADED = "DEGRADED"
STATE_REMOVED = "REMOVED"  # this node was removed from the cluster


class ShardUnavailableError(RuntimeError):
    """No alive owner can serve a shard (or this node left the cluster)."""


def _fnv1a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def partition(index: str, shard: int) -> int:
    """(index, shard) → partition id (reference: cluster.partition)."""
    return _fnv1a(index.encode() + struct.pack("<Q", shard)) % PARTITION_N


@dataclass
class Node:
    id: str
    uri: str
    is_coordinator: bool = False
    state: str = STATE_NORMAL
    alive: bool = True

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "uri": self.uri,
            "isCoordinator": self.is_coordinator,
            "state": self.state,
        }


@dataclass
class Topology:
    nodes: list[Node] = field(default_factory=list)
    replica_n: int = 1
    # membership version: bumped by every applied add/remove. Heartbeat
    # reconciliation adopts the HIGHER-epoch list, so both growth and
    # shrink converge across nodes that missed a broadcast (reference:
    # memberlist incarnation numbers serving the same role).
    epoch: int = 0

    def __post_init__(self) -> None:
        self.nodes.sort(key=lambda n: n.id)

    def node(self, node_id: str) -> Node | None:
        for n in self.nodes:
            if n.id == node_id:
                return n
        return None

    def remove(self, node_id: str) -> bool:
        """Drop a node; shard ownership re-derives from the smaller node
        list (reference: cluster.go removeNode → ResizeJob placement diff)."""
        before = len(self.nodes)
        self.nodes = [n for n in self.nodes if n.id != node_id]
        if len(self.nodes) < before:
            self.epoch += 1
            return True
        return False

    def add(self, node: Node) -> bool:
        """Insert a joining node (idempotent by URI); shard ownership
        re-derives from the larger node list (reference: cluster.go
        memberlist join → ResizeJob placement diff)."""
        if any(n.uri == node.uri for n in self.nodes):
            return False
        # build-then-rebind, never sort in place: list.sort detaches the
        # buffer mid-sort, so a lock-free concurrent reader (read routing,
        # heartbeats) could observe an empty/partial node list during a
        # join (same discipline as remove/_adopt_topology)
        self.nodes = sorted([*self.nodes, node], key=lambda n: n.id)
        self.epoch += 1
        return True

    def partition_nodes(self, partition_id: int) -> list[Node]:
        """Replica chain for a partition: primary + next ReplicaN-1 nodes
        in sorted order (reference: cluster.partitionNodes)."""
        if not self.nodes:
            return []
        n = len(self.nodes)
        start = partition_id % n
        count = min(self.replica_n, n)
        return [self.nodes[(start + i) % n] for i in range(count)]

    def shard_nodes(self, index: str, shard: int) -> list[Node]:
        """Owner nodes of one shard (reference: cluster.shardNodes)."""
        return self.partition_nodes(partition(index, shard))

    def primary(self, index: str, shard: int) -> Node | None:
        """First alive owner — the node that executes reads for the shard."""
        for n in self.shard_nodes(index, shard):
            if n.alive:
                return n
        return None

    def owns(self, node_id: str, index: str, shard: int) -> bool:
        return any(n.id == node_id for n in self.shard_nodes(index, shard))
