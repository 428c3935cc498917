"""NodeServer: one node of the port, serving its holder over HTTP.

The port of pilosa_tpu/server/node.py without resize, anti-entropy,
tiering, coherence, tracing and telemetry: a holder on the card (or on
the CPU when the caller passes device="cpu"), the distributed executor,
the API and an HTTP listener on a daemon thread.

A node starts as its own coordinator in a one-member cluster in state
NORMAL; `set_topology` installs a membership (the CLI's --cluster-hosts,
ClusterHarness, or the coordinator's cluster-status broadcast). Its
identity is durable: a data dir keeps the node id in `.id`, which wins
over the id it is started with, and a multi-node membership in
`.topology`, which wins over the flags on later boots (the flags then
only heal peer URIs). One retry policy, one per-peer breaker registry
and one InternalClient carry every internode call. Key translation has
one writer, the coordinator: every other node's key stores forward new
keys to it and catch up from its log (`wire_translation`). With
`probe_interval` > 0 the coordinator probes every peer's /status on a
ticker, marks the silent ones DOWN (NORMAL -> DEGRADED, or DOWN when
replicaN nodes are gone), broadcasts the new state, and pushes the whole
schema to a node that comes back. With a data
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
constructed in a process sets them for all (the nodes of an in-process
ClusterHarness share them). The result cache's budget goes back to its
earlier value when the node stops, so a node's cache does not outlive it
in a process that goes on with bare executors. Locks are plain
threading locks.
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

from pilosa_tpu_torch.cluster.topology import (
    NODE_STATE_DOWN,
    NODE_STATE_READY,
    STATE_NORMAL,
    Cluster,
    Node,
)
from pilosa_tpu_torch.core import merge as merge_mod
from pilosa_tpu_torch.core import wal as walmod
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.resultcache import RESULT_CACHE
from pilosa_tpu_torch.exec import bsistream
from pilosa_tpu_torch.exec.batcher import CountBatcher
from pilosa_tpu_torch.exec.distributed import DistributedExecutor
from pilosa_tpu_torch.hbm import residency
from pilosa_tpu_torch.hbm.prefetch import Prefetcher
from pilosa_tpu_torch.sched.admission import AdmissionController
from pilosa_tpu_torch.sched.tenants import TenantPolicy
from pilosa_tpu_torch.server import faults
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.client import ClientError, InternalClient

CACHE_FLUSH_INTERVAL = 60.0  # s between rank-cache sidecar writes (the reference's default)
IMPORT_CONCURRENCY = 8  # replica-import RPCs in flight per node (the reference's default)


class NodeServer:
    def __init__(
        self,
        data_dir: Optional[str],
        node_id: str,
        *,
        bind: str = "localhost:0",
        device=None,
        replica_n: int = 1,
        probe_interval: float = 0.0,  # s between liveness passes; 0 = none
        retry_max_attempts: int = 3,  # internode RPC attempts per budget
        retry_base_backoff: float = 0.05,  # first-retry backoff, s
        breaker_threshold: int = 5,  # consecutive failures before a breaker opens
        breaker_cooldown: float = 2.0,  # s open before one half-open probe
        query_deadline: float = 30.0,  # a distributed fan-out's wall bound, s
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
        # a data dir's .id wins: placement is keyed by id, so a new id
        # would orphan every fragment the node holds
        node_id = self._load_or_create_id(node_id)
        self.node = Node(id=node_id, uri="", is_coordinator=True)
        self.bind = bind
        self.cluster = Cluster(nodes=[self.node], replica_n=replica_n)
        self.cluster_name = "cluster0"  # the reference's default
        self.state = STATE_NORMAL
        self.probe_interval = probe_interval
        self.topology_restored = False  # membership came from .topology
        self._down_ids: set = set()
        # serializes cluster-status changes against the probe ticker's
        self._status_mu = threading.Lock()
        self.max_writes_per_request = max_writes_per_request
        self.logger = logger or (lambda msg: None)
        self.holder = Holder(self.data_dir, device=device)
        # one retry policy and one breaker registry for every internode call
        self.retry_policy = faults.RetryPolicy(max_attempts=retry_max_attempts, base_backoff=retry_base_backoff)
        self.breakers = faults.BreakerRegistry(
            threshold=breaker_threshold, cooldown=breaker_cooldown, logger=self.logger
        )
        self.client = InternalClient(retry_policy=self.retry_policy, breakers=self.breakers)
        self._import_pool: Optional[ThreadPoolExecutor] = None
        self._import_pool_mu = threading.Lock()
        walmod.GROUP_COMMIT.configure(sync_interval=wal_sync_interval)
        residency.configure(extent_rows=hbm_extent_rows, pin_timeout=hbm_pin_timeout)
        bsistream.configure(slab_planes=bsi_slab_planes)
        merge_mod.configure(device_threshold=merge_device_threshold)
        self.executor = DistributedExecutor(
            self.holder, lambda: self.cluster, self.client, node_id, query_deadline=query_deadline
        )
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
        self._probe_thread: Optional[threading.Thread] = None

    # -- durable identity and membership -----------------------------------------

    def _load_or_create_id(self, node_id: str) -> str:
        if not self.data_dir:
            return node_id
        path = os.path.join(self.data_dir, ".id")
        try:
            with open(path) as f:
                disk_id = f.read().strip()
        except FileNotFoundError:
            pass
        except OSError as e:
            # an unreadable .id must never be replaced by a new identity
            raise RuntimeError(f"cannot read node id at {path}: {e}") from e
        else:
            if disk_id:
                return disk_id
        os.makedirs(self.data_dir, exist_ok=True)
        walmod.write_durable(path, node_id)
        return node_id

    @property
    def _topology_path(self) -> Optional[str]:
        return None if not self.data_dir else os.path.join(self.data_dir, ".topology")

    def _save_topology(self) -> None:
        """Persist a multi-node membership; a standalone one (or one that
        no longer holds this node) removes the file, so flags seed the
        next boot again."""
        path = self._topology_path
        if path is None:
            return
        try:
            in_cluster = any(n.id == self.node.id for n in self.cluster.nodes)
            if len(self.cluster.nodes) <= 1 or not in_cluster:
                if os.path.exists(path):
                    walmod.remove_durable(path)
                return
            doc = {
                "clusterName": self.cluster_name,
                "replicaN": self.cluster.replica_n,
                "partitionN": self.cluster.partition_n,
                # liveness is probed afresh each boot, never read from disk
                "nodes": [
                    {"id": n.id, "uri": n.uri, "isCoordinator": n.is_coordinator, "meshGroup": n.mesh_group}
                    for n in self.cluster.nodes
                ],
            }
            walmod.write_durable(path, json.dumps(doc))
        except OSError as e:
            self.logger(f"persist .topology: {e}")

    def _restore_topology(self) -> None:
        """Install the persisted membership on boot (from start(), once the
        node's own URI is known)."""
        path = self._topology_path
        if path is None or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                doc = json.load(f)
            nodes = [
                Node(
                    id=n["id"],
                    uri=n.get("uri", ""),
                    is_coordinator=n.get("isCoordinator", False),
                    mesh_group=n.get("meshGroup", ""),
                )
                for n in doc.get("nodes", [])
            ]
        except (OSError, ValueError, KeyError) as e:
            self.logger(f"restore .topology: {e} (ignored; flags will seed)")
            return
        if len(nodes) <= 1 or not any(n.id == self.node.id for n in nodes):
            return
        self.set_topology(nodes, replica_n=doc.get("replicaN"), partition_n=doc.get("partitionN"))
        self.topology_restored = True
        self.logger(f"restored {len(nodes)}-node topology from disk (replicaN={self.cluster.replica_n})")

    def heal_peer_uris(self, hosts) -> List[str]:
        """Take peer addresses from (id, uri) pairs without touching the
        restored membership; returns the ids whose URI changed."""
        by_id = dict(hosts)
        healed = []
        for n in self.cluster.nodes:
            if n.id == self.node.id:
                continue
            new_uri = by_id.get(n.id)
            if new_uri and new_uri != n.uri:
                n.uri = new_uri
                healed.append(n.id)
        if healed:
            self.wire_translation()
            self._save_topology()
        return healed

    # -- lifecycle ------------------------------------------------------------------

    def start(self) -> "NodeServer":
        """Open the holder, bind (port 0 picks a free port, which node.uri
        then names), restore a persisted membership and serve on a daemon
        thread; with a probe interval, start the liveness ticker."""
        from pilosa_tpu_torch.server.handler import make_http_server

        self.holder.open()
        host, port = self.bind.rsplit(":", 1)
        self._httpd = make_http_server(self, host, int(port))
        self.node.uri = f"http://{host}:{self._httpd.server_address[1]}"
        # before serving: a request in between would meet a standalone
        # coordinator with the wrong placement (it waits in the backlog)
        self._restore_topology()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name=f"http-{self.node.id}", daemon=True
        )
        self._http_thread.start()
        if self.data_dir is not None:
            self._cache_thread = threading.Thread(target=self._cache_flush_loop, name="cache-flush", daemon=True)
            self._cache_thread.start()
        if self.probe_interval > 0:
            self._probe_thread = threading.Thread(target=self._probe_loop, name=f"probe-{self.node.id}", daemon=True)
            self._probe_thread.start()
        return self

    @property
    def import_pool(self) -> ThreadPoolExecutor:
        """The pool replica import frames ship on, made on first use."""
        with self._import_pool_mu:
            if self._import_pool is None:
                self._import_pool = ThreadPoolExecutor(
                    max_workers=IMPORT_CONCURRENCY, thread_name_prefix=f"import-{self.node.id}"
                )
            return self._import_pool

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
        if self._probe_thread is not None:
            self._probe_thread.join()
            self._probe_thread = None
        with self._import_pool_mu:
            pool, self._import_pool = self._import_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        self.executor.close()
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

    # -- topology ---------------------------------------------------------------------

    def set_topology(
        self, nodes: List[Node], replica_n: Optional[int] = None, partition_n: Optional[int] = None
    ) -> None:
        """Install a cluster membership (every node gets the same one)."""
        self.cluster = Cluster(
            nodes=[
                # a node the sender saw DOWN stays DOWN here until a probe
                # says otherwise (placement skips DOWN nodes)
                Node(id=n.id, uri=n.uri, is_coordinator=n.is_coordinator, state=n.state, mesh_group=n.mesh_group)
                for n in nodes
            ],
            replica_n=replica_n if replica_n is not None else self.cluster.replica_n,
            partition_n=partition_n if partition_n is not None else self.cluster.partition_n,
            hasher=self.cluster.hasher,
            state=STATE_NORMAL,
        )
        # this node is alive, whatever a peer's stale view says
        mine = self.cluster.node_by_id(self.node.id)
        if mine is not None:
            mine.uri = self.node.uri
            mine.state = NODE_STATE_READY
            self.node = mine
        self.wire_translation()
        self._save_topology()
        # a departed node's debt can never be repaired: drop it
        member_ids = {n.id for n in self.cluster.nodes}
        for iname, shard, debtor in self.holder.pending_repairs():
            if debtor not in member_ids:
                self.holder.discard_pending_repair(iname, shard, debtor)

    def wire_translation(self) -> None:
        """Single-writer key translation: the coordinator's stores stay
        writable; every other node's forward new keys to the coordinator
        and catch up from its log."""
        coord = self.cluster.coordinator() or (self.cluster.nodes[0] if self.cluster.nodes else None)
        if coord is None:
            return
        is_primary = coord.id == self.node.id
        for idx in self.holder.indexes():
            if idx.keys and idx.translate_store is not None:
                self._wire_store(idx.translate_store, coord, is_primary, idx.name, None)
            for f in idx.fields(include_hidden=True):
                if f.options.keys and f.translate_store is not None:
                    self._wire_store(f.translate_store, coord, is_primary, idx.name, f.name)

    def _wire_store(self, store, coord, is_primary: bool, index: str, field) -> None:
        if is_primary:
            store.read_only = False
            store.forward_fn = None
            store.catchup_fn = None
            return
        if not hasattr(store, "_repl_offset"):
            store._repl_offset = 0
        store.read_only = True
        store.forward_fn = lambda keys: self.client.translate_keys_remote(coord.uri, index, field, keys)

        def catchup():
            entries, off = self.client.translate_entries(coord.uri, index, field, store._repl_offset)
            store.apply_entries(entries)
            store._repl_offset = off

        store.catchup_fn = catchup

    def apply_cluster_status(self, msg: dict) -> None:
        self.set_topology([Node.from_json(n) for n in msg["nodes"]], replica_n=msg.get("replicaN"))
        self.state = msg.get("state", self.state)

    def set_node_state(self, node_id: str, state: str) -> None:
        with self._status_mu:
            n = self.cluster.node_by_id(node_id)
            if n is not None:
                n.state = state
            if state == NODE_STATE_DOWN:
                self._down_ids.add(node_id)
            else:
                self._down_ids.discard(node_id)
            self.state = self.cluster.determine_state(self._down_ids)

    # -- liveness -----------------------------------------------------------------------

    def probe_peers(self, timeout: float = 2.0) -> Dict[str, bool]:
        """One failure-detection pass: every peer's /status at once, so
        several dead peers cost one probe timeout, not one each."""
        peers = list(self.cluster.nodes)

        def probe(n: Node) -> bool:
            if n.id == self.node.id:
                return True
            try:
                # past the breaker: a probe is how an open breaker learns
                # that its peer recovered
                self.client.status(n.uri, timeout=timeout, probe=True)
                return True
            except ClientError:
                return False

        if len(peers) > 1:
            with ThreadPoolExecutor(max_workers=min(16, len(peers))) as pool:
                results = list(pool.map(probe, peers))
        else:
            results = [probe(n) for n in peers]
        alive = {}
        for n, ok in zip(peers, results):
            alive[n.id] = ok
            if n.id != self.node.id:
                self.set_node_state(n.id, NODE_STATE_READY if ok else NODE_STATE_DOWN)
        return alive

    def _probe_loop(self) -> None:
        """The coordinator's liveness ticker: a node that dies while the
        cluster idles flips it NORMAL <-> DEGRADED without waiting for a
        query to fail over."""
        while not self._closing.wait(self.probe_interval):
            try:
                self.run_probe_pass()
            except Exception as e:  # noqa: BLE001 - keep the ticker alive
                self.logger(f"liveness-probe ticker error: {e!r}\n{traceback.format_exc()}")

    def run_probe_pass(self, timeout: float = 2.0) -> bool:
        """One coordinator liveness pass; True when a state change was
        found and broadcast. Other nodes learn liveness from that
        broadcast, not by probing. A node that came back gets the whole
        schema: it missed every DDL broadcast while it was down."""
        if not self.node.is_coordinator or len(self.cluster.nodes) <= 1:
            return False
        before = {n.id: n.state for n in self.cluster.nodes}
        before_state = self.state
        self.probe_peers(timeout=timeout)
        with self._status_mu:
            after = {n.id: n.state for n in self.cluster.nodes}
            if before == after and before_state == self.state:
                return False
            changed = sorted(k for k in after if after[k] != before.get(k))
            self.logger(f"liveness: node state changes {changed}, cluster {self.state}")
            msg = {
                "type": "cluster-status",
                "nodes": [m.to_json() for m in self.cluster.nodes],
                "replicaN": self.cluster.replica_n,
                "state": self.state,
            }
            for n in self.cluster.nodes:
                if n.id == self.node.id or n.state == NODE_STATE_DOWN:
                    continue
                try:
                    self.client.send_message(n.uri, msg, timeout=5.0)
                except ClientError as e:
                    self.logger(f"liveness broadcast to {n.id}: {e}")
        recovered = [nid for nid, st in after.items() if st != NODE_STATE_DOWN and before.get(nid) == NODE_STATE_DOWN]
        if recovered:
            schema = self.api.schema()
            for nid in recovered:
                n = self.cluster.node_by_id(nid)
                if n is None or n.id == self.node.id:
                    continue
                try:
                    self.client.post_schema(n.uri, schema)
                except ClientError as e:
                    self.logger(f"schema push to recovered {nid}: {e}")
        return True

    def _send_status(
        self,
        to_nodes: List[Node],
        member_nodes: List[Node],
        replica_n: int,
        state: str,
        require: bool = False,
        retries: int = 3,
    ) -> List[str]:
        """Deliver a cluster status to `to_nodes`, retrying and checking
        through /status that each applied it. Returns the ids that never
        did, or raises ClientError with `require`."""
        msg = {
            "type": "cluster-status",
            "nodes": [m.to_json() for m in member_nodes],
            "replicaN": replica_n,
            "state": state,
        }
        with self._status_mu:
            failed: List[str] = []
            for n in to_nodes:
                if n.id == self.node.id:
                    self.set_topology([Node.from_json(d) for d in msg["nodes"]], replica_n=replica_n)
                    self.state = state
                    continue
                ok = False
                last: Optional[Exception] = None
                for attempt in range(max(retries, 1)):
                    try:
                        self.client.send_message(n.uri, msg, timeout=10.0)
                        st = self.client.status(n.uri, timeout=5.0)
                        if st.get("state") == state:
                            ok = True
                            break
                        last = ClientError(f"applied state {st.get('state')!r}, want {state!r}")
                    except ClientError as e:
                        last = e
                    if attempt + 1 < max(retries, 1):
                        time.sleep(self.retry_policy.backoff(attempt + 1))
                if not ok:
                    failed.append(n.id)
                    self.logger(f"cluster-status {state} to {n.id} not acknowledged: {last}")
            if require and failed:
                raise ClientError(f"cluster-status {state} not acknowledged by: {failed}")
            return failed
