"""NodeServer: one node of the port, serving its holder over HTTP.

The port's single-node slice of pilosa_tpu/server/node.py: a holder on
the card (or on the CPU when the caller passes device="cpu"), an
executor, the API and an HTTP listener on a daemon thread. The node is
its own coordinator in a one-member cluster in state NORMAL. Durability
(a data directory) is not ported yet: `data_dir` must be None or empty,
and the node serves from memory.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from pilosa_tpu_torch.cluster.topology import STATE_NORMAL, Cluster, Node
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.exec.executor import Executor
from pilosa_tpu_torch.server.api import API


class NodeServer:
    def __init__(
        self,
        data_dir: Optional[str],
        node_id: str,
        *,
        bind: str = "localhost:0",
        device=None,
        max_writes_per_request: int = 5000,  # bits/values per import; 0 = no cap
        logger: Optional[Callable[[str], None]] = None,
    ):
        if data_dir:
            raise ValueError(
                f"data dir {data_dir!r}: durable storage is not yet ported; "
                "pass an empty data dir to serve from memory"
            )
        self.node = Node(id=node_id, uri="", is_coordinator=True)
        self.bind = bind
        self.cluster = Cluster(nodes=[self.node])
        self.cluster_name = "cluster0"  # the reference's default; one cluster
        self.state = STATE_NORMAL
        self.max_writes_per_request = max_writes_per_request
        self.logger = logger or (lambda msg: None)
        self.holder = Holder(None, device=device)
        self.executor = Executor(self.holder)
        self.api = API(self)
        self._httpd = None
        self._http_thread: Optional[threading.Thread] = None

    def start(self) -> "NodeServer":
        """Bind (port 0 picks a free port, which node.uri then names) and
        serve on a daemon thread."""
        from pilosa_tpu_torch.server.handler import make_http_server

        host, port = self.bind.rsplit(":", 1)
        self._httpd = make_http_server(self, host, int(port))
        self.node.uri = f"http://{host}:{self._httpd.server_address[1]}"
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name=f"http-{self.node.id}", daemon=True
        )
        self._http_thread.start()
        return self

    def stop(self) -> None:
        """Close the listener and join every HTTP thread, then close the
        holder: no handler may still be inside a CUDA call when the
        interpreter tears CUDA down."""
        if self._httpd is not None:
            self._httpd.close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join()
            self._http_thread = None
        self.holder.close()
