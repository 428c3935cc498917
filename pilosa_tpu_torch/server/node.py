"""NodeServer: one node of the port, serving its holder over HTTP.

The port of pilosa_tpu/server/node.py without tiering, coherence,
tracing and telemetry: a holder on the card (or on the CPU when the
caller passes device="cpu"), the distributed executor, the API,
anti-entropy, the elastic resize (server/resize.py: join, remove-node,
abort and the holder cleaner) and an HTTP listener on a daemon thread.

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
schema to a node that comes back; it leaves the status flow to a running
resize job.

Anti-entropy (`sync_holder`, `POST /internal/sync`, or a pass every
`anti_entropy_interval` seconds when it is above 0) repairs replicas that
missed writes: the primary of each shard compares per-block digests of
each fragment with its live replicas' and merges each differing block
by majority vote (at replica 2 the union), writing the deltas through
the fragments' ordinary write path; the pending-repair ledger loses an
entry only when every fragment of its shard reached its replica, and
debt on a shard this node holds no copy of is nudged to the shard's
primary. Peers' availability and the attribute stores are pulled too.
The digests read the host row stores, so a pass stages nothing on the
device; each pass logs one line of what it did. With a data
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

from pilosa_tpu_torch.cluster import antientropy
from pilosa_tpu_torch.cluster.topology import (
    NODE_STATE_DOWN,
    NODE_STATE_READY,
    STATE_NORMAL,
    STATE_RESIZING,
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
from pilosa_tpu_torch.server.resize import Resizer

CACHE_FLUSH_INTERVAL = 60.0  # s between rank-cache sidecar writes (the reference's default)
IMPORT_CONCURRENCY = 8  # replica-import RPCs in flight per node (the reference's default)
# what a fragment sync counts: blocks merged, bits written here, bits
# shipped to replicas (a pass logs their sums)
AE_COUNTS = ("blocks", "bits_applied", "bits_sent")


class NodeServer(Resizer):
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
        anti_entropy_interval: float = 0.0,  # s between anti-entropy passes; 0 = on demand only
        resize_transfer_concurrency: int = 4,  # fragment fetches in flight per node
        resize_cutover_timeout: float = 30.0,  # wall bound of a stream step's catch-up rounds, s
        resize_resume_policy: str = "resume",  # resume | abort on a failed stream step
        logger: Optional[Callable[[str], None]] = None,
    ):
        # first: a bad resize knob raises before any process-wide setting moves
        self._init_resize(resize_transfer_concurrency, resize_cutover_timeout, resize_resume_policy)
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
        self.anti_entropy_interval = float(anti_entropy_interval)
        self._ae_thread: Optional[threading.Thread] = None
        # fragment versions as of their last sync: a pass takes the
        # fragments mutated since first
        self._ae_versions: Dict[tuple, int] = {}
        # single-flight passes: the ticker, POST /internal/sync and a
        # peer's debt nudge never stack (which also ends A-nudges-B-nudges-A)
        self._sync_once = threading.Lock()
        # the nudge runs outside _sync_once, so it has its own guard
        self._nudge_once = threading.Lock()
        # what the last finished pass did (also logged as one line)
        self.ae_last: Optional[dict] = None

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
        if self.anti_entropy_interval > 0:
            self._ae_thread = threading.Thread(
                target=self._anti_entropy_loop, name=f"anti-entropy-{self.node.id}", daemon=True
            )
            self._ae_thread.start()
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
        if self._ae_thread is not None:
            self._ae_thread.join()
            self._ae_thread = None
        if self._resize_thread is not None:
            self._resize_thread.join(timeout=60.0)
            self._resize_thread = None
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
        # debt of a node that no longer holds the shard (it left, or a
        # resize moved the shard away) can never be repaid: drop it
        member_ids = {n.id for n in self.cluster.nodes}
        for iname, shard, debtor in self.holder.pending_repairs():
            if debtor not in member_ids or not self.cluster.owns_shard(debtor, iname, shard):
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
            if self.state != STATE_RESIZING:  # a resize job's broadcast restores it
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
        if self.state == STATE_RESIZING:
            return False  # the resize job owns the status flow
        before = {n.id: n.state for n in self.cluster.nodes}
        before_state = self.state
        self.probe_peers(timeout=timeout)
        with self._status_mu:
            # a job started while this pass probed: its broadcasts win
            if self.state == STATE_RESIZING or (self.resize_job is not None and self.resize_job["state"] == "RUNNING"):
                return False
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

    # -- anti-entropy (the reference's holder.go:911 SyncHolder) ----------------------

    def _anti_entropy_loop(self) -> None:
        while not self._closing.wait(self.anti_entropy_interval):
            try:
                # the non-waiting form: a tick must not stall behind the
                # passes its debt nudge starts on peers
                self.try_sync_holder()
            except Exception as e:  # noqa: BLE001 - keep the ticker alive
                self.logger(f"anti-entropy ticker error: {e!r}\n{traceback.format_exc()}")

    def sync_holder(self) -> int:
        """One whole anti-entropy pass, waiting for its debt nudge: every
        fragment whose shard this node primary-owns (or owes repair debt
        on) is reconciled with its live replicas by block digests and the
        majority-vote merge. Returns how many fragments needed repair; 0
        when another pass was running (single-flight)."""
        res = self.try_sync_holder(wait_nudge=True)
        return 0 if res is None else res[0]

    def try_sync_holder(self, wait_nudge: bool = False):
        """One pass, or None when another pass is running. Returns
        (fragments repaired, reached): `reached` holds the confirmed
        (index, shard, node id) reconciliations, returned rather than kept
        so that a pass starting next cannot change it before the caller
        replies. Debt left on shards this node does not own is nudged to
        their primaries on a thread of its own, which `wait_nudge` joins
        (POST /internal/sync replies as soon as the local pass is done:
        mutual debt would otherwise chain blocking passes across nodes)."""
        if not self._sync_once.acquire(blocking=False):
            return None
        try:
            res = self._sync_holder_pass()
        finally:
            self._sync_once.release()
        if self.holder.pending_repair_count() == 0:
            return res
        t = threading.Thread(target=self._nudge_debt_primaries, name=f"nudge-{self.node.id}", daemon=True)
        t.start()
        if wait_nudge:
            t.join()
        return res

    def _sync_holder_pass(self):
        """Returns (fragments repaired, confirmed reached triples) and
        leaves what the pass did in `ae_last` and the log."""
        t0 = time.perf_counter()
        restage0 = residency.stats_snapshot()["restage_bytes"]
        repaired, reached, tally = self._sync_holder_work()
        self.ae_last = dict(
            seconds=time.perf_counter() - t0,
            synced=repaired,
            reached=len(reached),
            restage_bytes_before=restage0,
            restage_bytes_after=residency.stats_snapshot()["restage_bytes"],
            pending_repairs=self.holder.pending_repair_count(),
            **tally,
        )
        self.logger(f"anti-entropy pass {json.dumps(self.ae_last)}")
        return repaired, reached

    def _sync_holder_work(self):
        """(fragments repaired, reached triples, the fragment syncs' sums
        of AE_COUNTS)."""
        tally = dict.fromkeys(("fragments",) + AE_COUNTS, 0)
        if len(self.cluster.nodes) <= 1:
            return 0, set(), tally
        # first every peer's availability: a node that missed shard
        # announcements while it was down learns which shards exist (this
        # is about fan-out, so it runs at replica_n 1 too)
        peers = [n for n in self.cluster.nodes if n.id != self.node.id and n.state != NODE_STATE_DOWN]

        def merge_avail(args) -> None:
            idx, peer = args
            try:
                for fname, shards in self.client.available_shards(peer.uri, idx.name).items():
                    f = idx.field(fname)
                    if f is not None:
                        f.add_remote_available(shards)
            except ClientError:
                pass

        tasks = [(idx, p) for idx in self.holder.indexes() for p in peers]
        if tasks:
            with ThreadPoolExecutor(max_workers=min(8, len(tasks))) as pool:
                list(pool.map(merge_avail, tasks))
        # attributes live on every node (not sharded): their repair runs
        # at replica_n 1 too
        self._sync_attrs(peers)
        if self.cluster.replica_n <= 1:
            return 0, set(), tally
        sync_tasks = self._ae_tasks()
        if not sync_tasks:
            return 0, set(), tally

        def run_sync(t):
            idx, f, vname, shard, replicas = t
            attempted = [n.id for n in replicas]
            try:
                repaired, reached, counts = self._sync_fragment(idx, f, vname, shard, replicas)
            except Exception as e:  # noqa: BLE001 - one bad fragment must not end the pass
                self.logger(f"anti-entropy {idx.name}/{f.name}/{vname}/{shard}: {e!r}")
                return False, (idx.name, shard, attempted, []), {}
            frag = f.views[vname].fragment_if_exists(shard)
            if frag is not None:
                self._ae_versions[(idx.name, f.name, vname, shard)] = frag.version
            return repaired, (idx.name, shard, attempted, reached), counts

        with ThreadPoolExecutor(max_workers=min(8, len(sync_tasks))) as pool:
            results = list(pool.map(run_sync, sync_tasks))
        tally["fragments"] = len(results)
        for k in AE_COUNTS:
            tally[k] = sum(counts.get(k, 0) for _, _, counts in results)
        # (index, shard, replica) is confirmed only when EVERY fragment task
        # of the shard (each field and view syncs on its own) reached the
        # replica: one failed fragment leaves the shard's debt unpaid
        confirmed: Dict[tuple, bool] = {}
        shard_all_ok: Dict[tuple, bool] = {}
        for _, (iname, shard, attempted, reached), _ in results:
            for nid in attempted:
                key = (iname, shard, nid)
                confirmed[key] = confirmed.get(key, True) and nid in reached
            ok = all(nid in reached for nid in attempted)
            shard_all_ok[(iname, shard)] = shard_all_ok.get((iname, shard), True) and ok
        reached_triples = {k for k, ok in confirmed.items() if ok}
        # a shard whose every fragment reached every attempted replica left
        # this node's own copy merged with them all: it counts as reached
        # for this node too, so a peer whose debtor is this node (a primary
        # never lists itself among its replicas) can resolve its entry
        for (iname, shard), ok in shard_all_ok.items():
            if ok:
                reached_triples.add((iname, shard, self.node.id))
        for iname, shard, nid in reached_triples:
            self.holder.discard_pending_repair(iname, shard, nid)
        return sum(1 for r, _, _ in results if r), reached_triples, tally

    def _nudge_debt_primaries(self) -> None:
        """Debt on shards this node holds no copy of cannot be repaired
        here: ask each such shard's primary for a pass now. An entry goes
        only when the primary's reply lists exactly that (index, shard,
        debtor) in `reached`; a pass that could not reach the debtor keeps
        the debt visible. Single-flight, so mutual debt cannot recurse."""
        if not self._nudge_once.acquire(blocking=False):
            return
        try:
            foreign: Dict[str, set] = {}
            for iname, shard, debtor in self.holder.pending_repairs():
                owners = self.cluster.shard_nodes(iname, shard)
                if not owners or any(n.id == self.node.id for n in owners):
                    continue  # this node's own debt-driven task covers it
                if owners[0].state != NODE_STATE_DOWN:
                    foreign.setdefault(owners[0].id, set()).add((iname, shard, debtor))
            for nid, entries in foreign.items():
                n = self.cluster.node_by_id(nid)
                if n is None:
                    continue
                try:
                    resp = self.client.trigger_sync(n.uri)
                except ClientError as e:
                    self.logger(f"debt sync nudge to {nid}: {e}")
                    continue
                if not resp.get("ran"):
                    continue  # the primary was mid-pass: the next tick retries
                reached = {(i, int(s), d) for i, s, d in resp.get("reached", [])}
                for entry in entries & reached:
                    self.holder.discard_pending_repair(*entry)
        finally:
            self._nudge_once.release()

    def _ae_tasks(self) -> list:
        """A pass's fragment syncs, (index, field, view name, shard, live
        replicas), the fragments mutated since their last sync first (a
        fixed order would starve fresh drift behind clean fragments under
        sustained writes)."""
        sync_tasks = []
        for idx in self.holder.indexes():
            for f in idx.fields(include_hidden=True):
                for vname, v in list(f.views.items()):
                    # shards known cluster-wide but absent here too: a
                    # replica may hold a fragment its primary missed
                    for shard in sorted(set(v.fragments) | set(f.remote_available_shards)):
                        owners = self.cluster.shard_nodes(idx.name, shard)
                        if not owners or owners[0].id != self.node.id:
                            continue  # the primary drives the sync
                        replicas = [n for n in owners[1:] if n.state != NODE_STATE_DOWN]
                        if replicas:
                            sync_tasks.append((idx, f, vname, shard, replicas))
        # debt-driven tasks: a shard with a pending-repair entry is synced
        # now where this node holds a copy, even as a replica (the primary
        # may be the very node that missed the write)
        pending: Dict[str, set] = {}
        for iname, shard, _ in self.holder.pending_repairs():
            pending.setdefault(iname, set()).add(shard)
        seen = {(idx.name, f.name, vname, shard) for idx, f, vname, shard, _ in sync_tasks}
        for idx in self.holder.indexes():
            debt_shards = pending.get(idx.name)
            if not debt_shards:
                continue
            for f in idx.fields(include_hidden=True):
                for vname, v in list(f.views.items()):
                    for shard in sorted(set(v.fragments) & debt_shards):
                        if (idx.name, f.name, vname, shard) in seen:
                            continue
                        owners = self.cluster.shard_nodes(idx.name, shard)
                        if not any(n.id == self.node.id for n in owners):
                            continue  # not a copy of ours: the nudge covers it
                        replicas = [n for n in owners if n.id != self.node.id and n.state != NODE_STATE_DOWN]
                        if replicas:
                            sync_tasks.append((idx, f, vname, shard, replicas))
        # forget the versions of fragments no longer walked (a recreated
        # index must not inherit a "clean" mark; the map must not grow)
        live_keys = {(idx.name, f.name, vname, shard) for idx, f, vname, shard, _ in sync_tasks}
        for key in list(self._ae_versions):
            if key not in live_keys:
                self._ae_versions.pop(key, None)  # a concurrent prune may have won

        def changed_first(t) -> int:
            idx, f, vname, shard, _ = t
            frag = f.views[vname].fragment_if_exists(shard)
            return 0 if frag is None or self._ae_versions.get((idx.name, f.name, vname, shard)) != frag.version else 1

        sync_tasks.sort(key=changed_first)
        return sync_tasks

    def _sync_attrs(self, peers) -> None:
        """Pull-merge the attribute stores from peers by block checksums
        (the reference's holder.go:975-1019 syncIndex): the index's column
        attributes and each field's row attributes. Pull-only and
        add-only, as the reference's bulk merge: a delete a peer missed
        may come back (deletes travel by the SetRowAttrs/SetColumnAttrs
        broadcast, not here). The peers' block lists are fetched on one
        pool; a local checksum is recomputed only for a merged block."""
        if not peers:
            return
        stores = []
        for idx in self.holder.indexes():
            stores.append((idx.name, None, idx.column_attr_store))
            for f in idx.fields():
                stores.append((idx.name, f.name, f.row_attr_store))
        if not stores:
            return

        def fetch(args):
            iname, fname, peer = args
            try:
                return self.client.attr_blocks(peer.uri, iname, fname)
            except ClientError:
                return None

        jobs = [(iname, fname, p) for iname, fname, _ in stores for p in peers]
        with ThreadPoolExecutor(max_workers=min(16, len(jobs))) as pool:
            remotes = list(pool.map(fetch, jobs))
        by_store: Dict[tuple, list] = {}
        for (iname, fname, peer), remote in zip(jobs, remotes):
            by_store.setdefault((iname, fname), []).append((peer, remote))
        for iname, fname, store in stores:
            results = by_store.get((iname, fname), [])
            if not any(r for _, r in results):
                continue
            local = {b["id"]: b["checksum"] for b in store.blocks()}
            for peer, remote in results:
                for b in remote or []:
                    bid = int(b["id"])
                    if local.get(bid) == b["checksum"]:
                        continue
                    try:
                        data = self.client.attr_block_data(peer.uri, iname, fname, bid)
                    except ClientError:
                        continue
                    if data:
                        store.set_bulk_attrs({int(k): v for k, v in data.items()})
                        local[bid] = store.block_checksum(bid)

    def _sync_fragment(self, idx, f, view: str, shard: int, replicas):
        """Reconcile one fragment with its live replicas. Returns
        (repaired, ids of the replicas reached, {AE_COUNTS name: n}): only
        a reached replica's debt may be resolved."""
        frag = f.views[view].fragment(shard)  # made here if only replicas hold it
        local_sums = frag.block_checksums()
        peer_sums = []
        live = []
        for n in replicas:
            try:
                sums = self.client.fragment_blocks(n.uri, idx.name, f.name, view, shard)
            except ClientError:
                continue
            peer_sums.append({k: bytes.fromhex(hx) for k, hx in sums.items()})
            live.append(n)
        if not live:
            return False, [], {}
        reached = [n.id for n in live]
        diff: set = set()
        for ps in peer_sums:
            diff.update(antientropy.diff_blocks(local_sums, ps))
        if not diff:
            return False, reached, {}
        counts = dict.fromkeys(AE_COUNTS, 0)
        for bid in sorted(diff):
            blocks = [frag.block_pairs(bid)]
            for n in live:
                blocks.append(self.client.block_data(n.uri, idx.name, f.name, view, shard, bid))
            sets, clears = antientropy.merge_block(bid, blocks)
            frag.apply_deltas(sets[0], clears[0])
            counts["blocks"] += 1
            counts["bits_applied"] += len(sets[0][0]) + len(clears[0][0])
            for i, n in enumerate(live, start=1):
                if len(sets[i][0]) or len(clears[i][0]):
                    self.client.send_block_deltas(n.uri, idx.name, f.name, view, shard, sets[i], clears[i])
                    counts["bits_sent"] += len(sets[i][0]) + len(clears[i][0])
        return True, reached, counts
