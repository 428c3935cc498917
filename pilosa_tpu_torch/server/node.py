"""NodeServer: one node of the port, serving its holder over HTTP.

The port's single-node slice of pilosa_tpu/server/node.py: a holder on
the card (or on the CPU when the caller passes device="cpu"), an
executor, the API and an HTTP listener on a daemon thread. The node is
its own coordinator in a one-member cluster in state NORMAL. With a data
directory the holder is durable: it opens what the directory holds, logs
every acknowledged write to the WAL (group commit at `wal_sync_interval`,
0 = each write fsynced before it is acknowledged) and writes its rank
caches every CACHE_FLUSH_INTERVAL seconds and at stop. An empty or None
`data_dir` serves from memory.

The `[hbm]` knobs (extent rows, pin timeout) and the `[ingest]` merge
crossover are process-wide, as in the reference: the node installs them
through `hbm.residency.configure` and `core.merge.configure`, so the last
node constructed in a process sets them for all.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

from pilosa_tpu_torch.cluster.topology import STATE_NORMAL, Cluster, Node
from pilosa_tpu_torch.core import merge as merge_mod
from pilosa_tpu_torch.core import wal as walmod
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.exec.executor import Executor
from pilosa_tpu_torch.hbm import residency
from pilosa_tpu_torch.server.api import API

CACHE_FLUSH_INTERVAL = 60.0  # s between rank-cache sidecar writes (the reference's default)


class NodeServer:
    def __init__(
        self,
        data_dir: Optional[str],
        node_id: str,
        *,
        bind: str = "localhost:0",
        device=None,
        max_writes_per_request: int = 5000,  # bits/values per import; 0 = no cap
        wal_sync_interval: float = 0.0,  # 0 strict; > 0 background fsync cadence, s
        hbm_extent_rows: int = residency.DEFAULT_EXTENT_ROWS,  # shards per extent; 0 = whole stacks
        hbm_pin_timeout: float = 60.0,  # stale-pin valve, s; 0 = off
        merge_device_threshold: Optional[int] = None,  # None AUTO, < 0 host only, 0 always device
        logger: Optional[Callable[[str], None]] = None,
    ):
        self.data_dir = os.path.expanduser(data_dir) if data_dir else None
        self.node = Node(id=node_id, uri="", is_coordinator=True)
        self.bind = bind
        self.cluster = Cluster(nodes=[self.node])
        self.cluster_name = "cluster0"  # the reference's default; one cluster
        self.state = STATE_NORMAL
        self.max_writes_per_request = max_writes_per_request
        self.logger = logger or (lambda msg: None)
        self.holder = Holder(self.data_dir, device=device)
        walmod.GROUP_COMMIT.configure(sync_interval=wal_sync_interval)
        residency.configure(extent_rows=hbm_extent_rows, pin_timeout=hbm_pin_timeout)
        merge_mod.configure(device_threshold=merge_device_threshold)
        self.executor = Executor(self.holder)
        self.api = API(self)
        self._httpd = None
        self._http_thread: Optional[threading.Thread] = None
        self._closing = threading.Event()
        self._cache_thread: Optional[threading.Thread] = None

    def start(self) -> "NodeServer":
        """Open the holder, bind (port 0 picks a free port, which node.uri
        then names) and serve on a daemon thread."""
        from pilosa_tpu_torch.server.handler import make_http_server

        self.holder.open()
        host, port = self.bind.rsplit(":", 1)
        self._httpd = make_http_server(self, host, int(port))
        self.node.uri = f"http://{host}:{self._httpd.server_address[1]}"
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name=f"http-{self.node.id}", daemon=True
        )
        self._http_thread.start()
        if self.data_dir is not None:
            self._cache_thread = threading.Thread(target=self._cache_flush_loop, name="cache-flush", daemon=True)
            self._cache_thread.start()
        return self

    def _cache_flush_loop(self) -> None:
        """Write the rank-cache sidecars periodically (the reference's
        holder.go:506 monitorCacheFlush)."""
        while not self._closing.wait(CACHE_FLUSH_INTERVAL):
            try:
                self.holder.flush_caches()
            except Exception as e:  # noqa: BLE001 - keep the ticker alive
                self.logger(f"cache flush failed: {e!r}")

    def stop(self) -> None:
        """Close the listener and join every HTTP thread, then close the
        holder: no handler may still be inside a CUDA call when the
        interpreter tears CUDA down, nor inside a write when the WALs
        close. Buffered WAL bytes (interval mode) are synced first."""
        self._closing.set()
        if self._httpd is not None:
            self._httpd.close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join()
            self._http_thread = None
        if self._cache_thread is not None:
            self._cache_thread.join()
            self._cache_thread = None
        try:
            walmod.GROUP_COMMIT.flush()
        except OSError as e:
            self.logger(f"wal flush on stop failed: {e}")
        self.holder.close()
