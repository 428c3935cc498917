"""Cluster topology for one node: the node record and a one-member
cluster that `/status` and `/hosts` read.

The port's slice of pilosa_tpu/cluster/topology.py. Placement (partition
hashing, replicas), resize and liveness probes come with the cluster
slice; until then the node is its own coordinator and owns every shard.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List

STATE_NORMAL = "NORMAL"

NODE_STATE_READY = "READY"


@dataclass
class Node:
    id: str
    uri: str = ""
    is_coordinator: bool = False
    state: str = NODE_STATE_READY
    mesh_group: str = ""

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "uri": self.uri,
            "isCoordinator": self.is_coordinator,
            "state": self.state,
            "meshGroup": self.mesh_group,
        }


@dataclass
class Cluster:
    """Membership: the nodes, sorted by id."""

    nodes: List[Node] = dc_field(default_factory=list)
