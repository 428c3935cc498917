"""Serving layer of one node: the API, the HTTP handler and the daemon.

The port's single-node slice of pilosa_tpu/server/: `NodeServer` binds
the port's Holder and Executor to the public REST routes
(`server/handler.py`), whose JSON bodies are the reference's.
"""

from pilosa_tpu_torch.server.api import API, ApiError  # noqa: F401
from pilosa_tpu_torch.server.node import NodeServer  # noqa: F401
