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

The served query front end, as the reference builds it: an admission
controller (sched/admission.py, on unless max_concurrent_queries is 0)
with its tenant policy (sched/tenants.py), the Count batcher
(exec/batcher.py) fed by the controller's load, the prefetcher
(hbm/prefetch.py, with hbm_prefetch_depth > 0) fed by its queue peek,
and the versioned result cache (core/resultcache.py).

The `[hbm]` knobs (extent rows, pin timeout), the `[bsi]` slab planes,
the `[ingest]` merge crossover and the `[cache]` knobs are process-wide,
as in the reference: the node installs them through
`hbm.residency.configure`, `exec.bsistream.configure`,
`core.merge.configure` and `RESULT_CACHE.configure`, so the last node
constructed in a process sets them for all. The result cache's budget
goes back to its earlier value when the node stops, so a node's cache
does not outlive it in a process that goes on with bare executors.
"""

from __future__ import annotations

import os
import threading
import uuid
from typing import Callable, Optional, Sequence

from pilosa_tpu_torch.cluster.topology import STATE_NORMAL, Cluster, Node
from pilosa_tpu_torch.core import merge as merge_mod
from pilosa_tpu_torch.core import wal as walmod
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.resultcache import RESULT_CACHE
from pilosa_tpu_torch.exec import bsistream
from pilosa_tpu_torch.exec.batcher import CountBatcher
from pilosa_tpu_torch.exec.executor import Executor
from pilosa_tpu_torch.hbm import residency
from pilosa_tpu_torch.hbm.prefetch import Prefetcher
from pilosa_tpu_torch.sched.admission import AdmissionController
from pilosa_tpu_torch.sched.tenants import TenantPolicy
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
        bsi_slab_planes: int = 16,  # BSI planes a streamed launch; <= 0 the default
        merge_device_threshold: Optional[int] = None,  # None AUTO, < 0 host only, 0 always device
        max_concurrent_queries: int = 16,  # admission cap; 0 turns admission off
        admission_queue_depth: int = 128,  # bounded admission queue
        admission_byte_budget: int = 0,  # in-flight device bytes; 0 = the device cache's budget
        admission_default_class: str = "interactive",  # queries without a priority header
        tenant_default_qps: float = 0.0,  # per-index query rate; 0 = unlimited
        tenant_default_bytes_per_s: float = 0.0,  # per-index device-byte rate
        tenant_default_inflight_bytes: int = 0,  # per-index in-flight byte cap
        tenant_default_hbm_bytes: int = 0,  # per-index device-cache quota
        tenant_default_cache_bytes: int = 0,  # per-index result-cache quota
        tenant_overrides: Sequence[str] = (),  # "idx:qps=5;hbm-bytes=65536"
        hbm_prefetch_depth: int = 0,  # warm queue bound; 0 turns the prefetcher off
        cache_result_mb: int = 64,  # result-cache budget, MB; 0 turns it off
        cache_count_repair: bool = True,  # Count repair on staged bursts
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
        bsistream.configure(slab_planes=bsi_slab_planes)
        merge_mod.configure(device_threshold=merge_device_threshold)
        self.executor = Executor(self.holder)
        # cross-request group-commit Count batching, split by lowering class
        self.count_batcher = CountBatcher()
        self.count_batcher.classify = self.executor.count_lowering_class
        # one tenant policy for admission, the prefetch gate and both caches
        self.tenant_policy = TenantPolicy(
            default_qps=tenant_default_qps,
            default_bytes_per_s=tenant_default_bytes_per_s,
            default_inflight_bytes=tenant_default_inflight_bytes,
            default_hbm_bytes=tenant_default_hbm_bytes,
            default_cache_bytes=tenant_default_cache_bytes,
            overrides=tenant_overrides,
        )
        self.scheduler: Optional[AdmissionController] = None
        if max_concurrent_queries > 0:
            self.scheduler = AdmissionController(
                max_concurrent=max_concurrent_queries,
                queue_depth=admission_queue_depth,
                byte_budget=admission_byte_budget,
                default_class=admission_default_class,
                tenants=self.tenant_policy,
                device_budget=lambda: self.holder.dcache.budget_bytes,
            )
            self.count_batcher.load_hint = self.scheduler.load
        # a restart replays versions from 0: the boot id tells a node's
        # lifetimes apart (the reference salts remote vectors with it)
        self.boot_id = uuid.uuid4().hex
        self._cache_budget_before = RESULT_CACHE.budget_bytes
        cache_default, cache_over = self.tenant_policy.cache_quota_map()
        RESULT_CACHE.configure(
            budget_bytes=max(0, int(cache_result_mb)) << 20,
            repair=cache_count_repair,
            tenant_default_bytes=cache_default,
            tenant_overrides=cache_over,
        )
        hbm_default, hbm_over = self.tenant_policy.hbm_quota_map()
        self.holder.dcache.configure_quotas(default_bytes=hbm_default, overrides=hbm_over)
        self.prefetcher: Optional[Prefetcher] = None
        if hbm_prefetch_depth > 0 and self.scheduler is not None:
            self.prefetcher = Prefetcher(depth=hbm_prefetch_depth, logger=self.logger).start()
            self.scheduler.prefetcher = self.prefetcher
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
        if self.prefetcher is not None:
            self.prefetcher.stop()
        try:
            walmod.GROUP_COMMIT.flush()
        except OSError as e:
            self.logger(f"wal flush on stop failed: {e}")
        self.holder.close()
        RESULT_CACHE.configure(budget_bytes=self._cache_budget_before)

    def drop_index(self, index: str) -> None:
        """What a deleted index leaves behind: its cached results and byte
        attribution, its queues' virtual times and token buckets, its
        device-cache quota evictions."""
        RESULT_CACHE.drop_index(index)
        if self.scheduler is not None:
            self.scheduler.drop_index(index)  # also the tenant policy's buckets
        else:
            self.tenant_policy.drop_index(index)
        self.holder.dcache.drop_index_attribution(index)
