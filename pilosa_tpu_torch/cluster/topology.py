"""Cluster topology: nodes, partition placement, replication, resize math.

The port of pilosa_tpu/cluster/topology.py, placement for placement:
- partition = fnv1a64(index || shard as 8 big-endian bytes) % partitionN;
- partition -> first owner by jump consistent hash;
- ReplicaN consecutive nodes (in id order) own each partition;
- fragSources: which node streams which fragment to whom on a resize
  (pure math here; the resize itself is not ported yet);
- the cluster states STARTING / NORMAL / RESIZING / DEGRADED / DOWN.

Host-side and transport-free: the HTTP control plane (server/) and the
tests run the same placement. Nodes sort by id to fix the ring order.
The `meshGroup` field rides the JSON forms only; the port has no
mesh-group execution.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Set, Tuple

DEFAULT_PARTITION_N = 256  # reference: defaultPartitionN, cluster.go:44

# cluster states (cluster.go:46-50)
STATE_STARTING = "STARTING"
STATE_NORMAL = "NORMAL"
STATE_DEGRADED = "DEGRADED"
STATE_RESIZING = "RESIZING"
STATE_DOWN = "DOWN"

# node states during resize (cluster.go:52-63)
NODE_STATE_READY = "READY"
NODE_STATE_DOWN = "DOWN"

RESIZE_ADD = "ADD"
RESIZE_REMOVE = "REMOVE"


class ClusterError(Exception):
    pass


def fnv1a64(data: bytes) -> int:
    """FNV-1a 64-bit (the reference's partition hash primitive)."""
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class JumpHasher:
    """Jump consistent hash (Lamping & Veach 2014): key -> bucket in [0, n).

    Minimal-movement property: adding bucket n moves only ~1/n of keys —
    this is what makes resize streaming cheap (cluster.go:948 jmphasher)."""

    def hash(self, key: int, n: int) -> int:
        if n <= 0:
            return 0
        key &= 0xFFFFFFFFFFFFFFFF
        b, j = -1, 0
        while j < n:
            b = j
            key = (key * 2862933555777941757 + 1) & 0xFFFFFFFFFFFFFFFF
            j = int(float(b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
        return b


class ModHasher:
    """Deterministic key % n placement for tests (reference: test/cluster.go:18)."""

    def hash(self, key: int, n: int) -> int:
        return key % n if n > 0 else 0


@dataclass
class Node:
    id: str
    uri: str = ""
    is_coordinator: bool = False
    state: str = NODE_STATE_READY
    # carried in the JSON forms for the reference's mesh groups; unused here
    mesh_group: str = ""

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "uri": self.uri,
            "isCoordinator": self.is_coordinator,
            "state": self.state,
            "meshGroup": self.mesh_group,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Node":
        return cls(
            id=d["id"],
            uri=d.get("uri", ""),
            is_coordinator=d.get("isCoordinator", False),
            state=d.get("state", NODE_STATE_READY),
            mesh_group=d.get("meshGroup", ""),
        )


@dataclass(frozen=True)
class Frag:
    """A fragment address without the index (reference: frag, cluster.go)."""

    field: str
    view: str
    shard: int


@dataclass
class ResizeSource:
    """One fragment a node must fetch during resize (cluster.go ResizeSource)."""

    node: Node
    index: str
    field: str
    view: str
    shard: int

    def to_json(self) -> dict:
        return {
            "node": self.node.to_json(),
            "index": self.index,
            "field": self.field,
            "view": self.view,
            "shard": self.shard,
        }


@dataclass
class Cluster:
    """Placement and membership math for one cluster generation: a resize
    makes a new Cluster, which the server layer swaps in."""

    nodes: List[Node] = dc_field(default_factory=list)
    replica_n: int = 1
    partition_n: int = DEFAULT_PARTITION_N
    hasher: object = dc_field(default_factory=JumpHasher)
    state: str = STATE_STARTING

    def __post_init__(self):
        self.nodes = sorted(self.nodes, key=lambda n: n.id)

    # -- membership --------------------------------------------------------

    def node_by_id(self, node_id: str) -> Optional[Node]:
        for n in self.nodes:
            if n.id == node_id:
                return n
        return None

    def coordinator(self) -> Optional[Node]:
        for n in self.nodes:
            if n.is_coordinator:
                return n
        return None

    def with_added_node(self, node: Node) -> "Cluster":
        if self.node_by_id(node.id):
            return self
        return Cluster(
            nodes=self.nodes + [node],
            replica_n=self.replica_n,
            partition_n=self.partition_n,
            hasher=self.hasher,
            state=self.state,
        )

    def with_removed_node(self, node_id: str) -> "Cluster":
        return Cluster(
            nodes=[n for n in self.nodes if n.id != node_id],
            replica_n=self.replica_n,
            partition_n=self.partition_n,
            hasher=self.hasher,
            state=self.state,
        )

    # -- placement (cluster.go:871-959) ------------------------------------

    def partition(self, index: str, shard: int) -> int:
        return fnv1a64(index.encode() + shard.to_bytes(8, "big")) % self.partition_n

    def partition_nodes(self, partition_id: int) -> List[Node]:
        if not self.nodes:
            return []
        replica_n = min(max(self.replica_n, 1), len(self.nodes))
        start = self.hasher.hash(partition_id, len(self.nodes))
        return [self.nodes[(start + i) % len(self.nodes)] for i in range(replica_n)]

    def shard_nodes(self, index: str, shard: int) -> List[Node]:
        return self.partition_nodes(self.partition(index, shard))

    def primary_node(self, index: str, shard: int) -> Optional[Node]:
        owners = self.shard_nodes(index, shard)
        return owners[0] if owners else None

    def owns_shard(self, node_id: str, index: str, shard: int) -> bool:
        return any(n.id == node_id for n in self.shard_nodes(index, shard))

    def contains_shards(
        self, index: str, available_shards: Sequence[int], node_id: str
    ) -> List[int]:
        """Shards of `index` held by node_id, replicas included
        (cluster.go:926 containsShards)."""
        return [
            s for s in available_shards if self.owns_shard(node_id, index, s)
        ]

    def shards_by_node(
        self, index: str, shards: Sequence[int]
    ) -> Dict[str, List[int]]:
        """Primary-owner grouping for query fan-out (executor.go:2440
        shardsByNode). Uses the first live owner per shard; the executor
        retries against later replicas on failure."""
        out: Dict[str, List[int]] = {}
        for s in shards:
            owners = self.shard_nodes(index, s)
            for n in owners:
                if n.state != NODE_STATE_DOWN:
                    out.setdefault(n.id, []).append(s)
                    break
        return out

    def shards_by_all_owners(
        self, index: str, shards: Sequence[int]
    ) -> Dict[str, List[int]]:
        """Every live owner (replicas included) per shard — the WRITE
        fan-out grouping (executor.go:2142 write replication), vs
        shards_by_node's first-owner read grouping."""
        out: Dict[str, List[int]] = {}
        for s in shards:
            for n in self.shard_nodes(index, s):
                if n.state != NODE_STATE_DOWN:
                    out.setdefault(n.id, []).append(s)
        return out

    # -- mesh-group field -----------------------------------------------------

    def mesh_group_of(self, node_id: str) -> str:
        """The `meshGroup` node_id declared, or "" when the node is unknown
        or declared none."""
        n = self.node_by_id(node_id)
        return n.mesh_group if n is not None else ""

    def mesh_peers(self, node_id: str) -> List[Node]:
        """Every other live node sharing `node_id`'s non-empty mesh group."""
        group = self.mesh_group_of(node_id)
        if not group:
            return []
        return [
            n
            for n in self.nodes
            if n.id != node_id
            and n.mesh_group == group
            and n.state != NODE_STATE_DOWN
        ]

    # -- resize math (cluster.go:784-870) ----------------------------------

    def frags_by_host(
        self, index: str, frags: Sequence[Frag]
    ) -> Dict[str, List[Frag]]:
        """All fragments (replicas included) each node holds."""
        out: Dict[str, List[Frag]] = {n.id: [] for n in self.nodes}
        for fr in frags:
            for n in self.shard_nodes(index, fr.shard):
                out[n.id].append(fr)
        return out

    def diff(self, to: "Cluster") -> Tuple[str, str]:
        """(action, node_id) between self and `to` — exactly one node may
        be added or removed per resize (cluster.go diff)."""
        old_ids = {n.id for n in self.nodes}
        new_ids = {n.id for n in to.nodes}
        added = new_ids - old_ids
        removed = old_ids - new_ids
        if len(added) == 1 and not removed:
            return RESIZE_ADD, next(iter(added))
        if len(removed) == 1 and not added:
            return RESIZE_REMOVE, next(iter(removed))
        raise ClusterError(
            f"clusters must differ by exactly one node (added={added}, removed={removed})"
        )

    def frag_sources(
        self, to: "Cluster", index: str, frags: Sequence[Frag]
    ) -> Dict[str, List[ResizeSource]]:
        """For each node of `to`, the fragments it must fetch and from whom.

        Mirrors cluster.go:784 fragSources: on ADD the source set is the
        replica-1 (primary-only) placement of the old cluster so only
        primaries stream; on REMOVE the departing node is excluded and
        replicas serve as sources."""
        action, diff_node = self.diff(to)

        src_cluster = self
        if action == RESIZE_ADD and self.replica_n > 1:
            src_cluster = Cluster(
                nodes=list(self.nodes),
                replica_n=1,
                partition_n=self.partition_n,
                hasher=self.hasher,
            )

        f_frags = self.frags_by_host(index, frags)
        t_frags = to.frags_by_host(index, frags)
        src_frags = src_cluster.frags_by_host(index, frags)

        src_node_by_frag: Dict[Frag, str] = {}
        for node_id, fl in src_frags.items():
            if action == RESIZE_REMOVE and node_id == diff_node:
                continue
            for fr in fl:
                src_node_by_frag[fr] = node_id

        out: Dict[str, List[ResizeSource]] = {n.id: [] for n in to.nodes}
        for node_id, fl in t_frags.items():
            have = set(f_frags.get(node_id, []))
            need = [fr for fr in fl if fr not in have]
            for fr in need:
                src_id = src_node_by_frag.get(fr)
                if src_id is None:
                    raise ClusterError(
                        "not enough data to perform resize "
                        "(replica factor may need to be increased)"
                    )
                out[node_id].append(
                    ResizeSource(
                        node=self.node_by_id(src_id),
                        index=index,
                        field=fr.field,
                        view=fr.view,
                        shard=fr.shard,
                    )
                )
        return out

    # -- state machine (cluster.go:543-583) --------------------------------

    def placement_key(self) -> tuple:
        """What placement depends on: two clusters with equal keys place
        every shard on the same nodes (liveness marks do not move shards)."""
        return tuple(n.id for n in self.nodes), self.replica_n, self.partition_n

    def determine_state(self, down_node_ids: Set[str]) -> str:
        """NORMAL if all nodes up; DEGRADED if < replica_n nodes down (reads
        still safe); DOWN otherwise (cluster.go determineClusterState)."""
        n_down = len([n for n in self.nodes if n.id in down_node_ids])
        if n_down == 0:
            return STATE_NORMAL
        if n_down < self.replica_n:
            return STATE_DEGRADED
        return STATE_DOWN

    def to_json(self) -> dict:
        return {
            "nodes": [n.to_json() for n in self.nodes],
            "replicaN": self.replica_n,
            "partitionN": self.partition_n,
            "state": self.state,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Cluster":
        return cls(
            nodes=[Node.from_json(n) for n in d.get("nodes", [])],
            replica_n=d.get("replicaN", 1),
            partition_n=d.get("partitionN", DEFAULT_PARTITION_N),
            state=d.get("state", STATE_STARTING),
        )
