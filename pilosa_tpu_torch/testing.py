"""In-process multi-node cluster harness for tests and examples.

The port of pilosa_tpu/testing.py: N NodeServers in one process, each
with a real HTTP listener on a free localhost port, so internode traffic
goes over TCP as between processes. Node i is `node{i}`, node0 the
coordinator. The nodes share the process-wide settings (the [hbm],
[bsi], [ingest] and [cache] knobs) and, on the card, one CUDA context.
Extra keyword arguments go to every NodeServer (`device="cpu"` for the
CPU path, or the retry, breaker and deadline knobs); with
`anti_entropy_interval` > 0 every node runs an anti-entropy pass that
often. TLS is not ported: `tls=` is refused by name.
"""

from __future__ import annotations

import shutil
import tempfile
from typing import List, Optional

from pilosa_tpu_torch.cluster.topology import Node
from pilosa_tpu_torch.server.node import NodeServer


class ClusterHarness:
    def __init__(
        self,
        n: int,
        replica_n: int = 1,
        base_dir: Optional[str] = None,
        in_memory: bool = False,
        probe_interval: float = 0.0,
        tls=None,
        **node_kwargs,
    ):
        if tls is not None:
            raise ValueError("tls: TLS is not yet ported; start the harness without it")
        self._own_dir = base_dir is None and not in_memory
        self.base_dir = None if in_memory else (base_dir or tempfile.mkdtemp(prefix="ptc-"))
        self.node_kwargs = node_kwargs
        self.nodes: List[NodeServer] = []
        try:
            for i in range(n):
                data_dir = None if in_memory else f"{self.base_dir}/node{i}"
                srv = NodeServer(
                    data_dir, f"node{i}", replica_n=replica_n, probe_interval=probe_interval, **node_kwargs
                )
                self.nodes.append(srv)
                srv.start()
            self.sync_topology(replica_n)
        except BaseException:
            self.close()
            raise

    def sync_topology(self, replica_n: Optional[int] = None) -> None:
        members = [Node(id=s.node.id, uri=s.node.uri, is_coordinator=(i == 0)) for i, s in enumerate(self.nodes)]
        for s in self.nodes:
            s.set_topology(members, replica_n=replica_n)

    def __getitem__(self, i: int) -> NodeServer:
        return self.nodes[i]

    def __len__(self) -> int:
        return len(self.nodes)

    def stop_node(self, i: int) -> None:
        """Hard-stop one node (the fault the liveness tests inject)."""
        self.nodes[i].stop()

    def restart_node(self, i: int) -> NodeServer:
        """A fresh NodeServer on node i's data dir, id and address (after
        stop_node(i)). Membership and schema come back from the
        coordinator's probe and repair for an in-memory node, or from the
        node's own .topology on disk."""
        old = self.nodes[i]
        host, port = old.node.uri.removeprefix("http://").rsplit(":", 1)
        srv = NodeServer(
            old.data_dir,
            old.node.id,
            bind=f"{host}:{port}",
            replica_n=old.cluster.replica_n,
            probe_interval=old.probe_interval,
            **self.node_kwargs,
        )
        srv.start()
        self.nodes[i] = srv
        return srv

    def close(self) -> None:
        """Stop every node, the last started first: each node puts back the
        process-wide result-cache budget it found, so node0 stopping last
        leaves the one the harness found."""
        for s in reversed(self.nodes):
            try:
                s.stop()
            except Exception:  # noqa: BLE001 - a stopped node stops again
                pass
        if self._own_dir and self.base_dir:
            shutil.rmtree(self.base_dir, ignore_errors=True)

    def __enter__(self) -> "ClusterHarness":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
