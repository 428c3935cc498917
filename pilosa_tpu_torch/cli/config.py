"""Config schema + TOML/env/flag merge.

A copy of pilosa_tpu/cli/config.py (the reference's server/config.go:48-157
TOML schema and cmd/root.go:94-131 precedence): flags > env (PILOSA_TPU_*)
> TOML file > defaults. The port's `server` command serves one node and
refuses every knob whose feature is not ported yet when it is set away
from its default here (pilosa_tpu_torch/cli/main.py). `config` dumps the
effective TOML and `generate-config` the defaults, as the reference's
do. `parse_hosts` reads the `--cluster-hosts` entries."""

from __future__ import annotations

import dataclasses
import os

try:  # tomllib is stdlib only from 3.11; 3.10 environments carry tomli
    import tomllib
except ImportError:  # pragma: no cover - depends on interpreter version
    import tomli as tomllib  # type: ignore[no-redef]
from dataclasses import dataclass, field
from typing import List, Optional

ENV_PREFIX = "PILOSA_TPU_"


@dataclass
class ClusterConfig:
    # static membership: list of "node_id@http://host:port" entries; empty
    # means single-node (reference: cluster.hosts + disabled)
    hosts: List[str] = field(default_factory=list)
    replicas: int = 1
    coordinator: bool = False
    # coordinator liveness-probe ticker, seconds; 0 disables (the SWIM
    # role — reference gossip probes continuously, gossip/gossip.go:364)
    probe_interval: float = 2.0
    # internode RPC fault tolerance (server/faults.py): attempts share
    # one deadline budget per request; per-peer circuit breakers fast-
    # fail requests to known-dead peers; query-deadline bounds a whole
    # distributed fan-out including failover re-map rounds
    retry_max_attempts: int = 3
    retry_base_backoff: float = 0.05  # seconds before the first retry
    breaker_threshold: int = 5  # consecutive failures before open
    breaker_cooldown: float = 2.0  # seconds open before a half-open probe
    query_deadline: float = 30.0  # seconds per distributed query


@dataclass
class SchedConfig:
    # query admission control & QoS (pilosa_tpu/sched/): every query is
    # admitted before it may dispatch — bounded concurrency, a bounded
    # deadline/priority-aware queue, 429 load shedding
    max_concurrent_queries: int = 16  # executing at once; 0 disables sched
    admission_queue_depth: int = 128  # waiting queries before shedding
    admission_byte_budget: int = 0  # in-flight device bytes; 0 = HBM budget
    admission_default_class: str = "interactive"  # headerless queries
    shed_retry_after: float = 1.0  # Retry-After seconds on 429


@dataclass
class TenantsConfig:
    # multi-tenant QoS enforcement (sched/tenants.py; docs/
    # configuration.md "[tenants]"): per-index token-bucket rate limits
    # and byte quotas, enforced at admission (429 + informed
    # Retry-After) and in both caches' eviction loops. 0 = unlimited.
    # Defaults apply to EVERY index; `overrides` entries of the form
    # "index:knob=value[;knob=value...]" (kebab knob names: qps,
    # bytes-per-s, inflight-bytes, hbm-bytes, cache-bytes) replace
    # individual defaults per index.
    default_qps: float = 0.0  # admitted queries/s per index
    default_bytes_per_s: float = 0.0  # estimated device bytes/s per index
    default_inflight_bytes: int = 0  # in-flight device-byte quota per index
    default_hbm_bytes: int = 0  # HBM residency quota per index
    default_cache_bytes: int = 0  # result-cache byte quota per index
    overrides: List[str] = field(default_factory=list)


@dataclass
class HbmConfig:
    # HBM residency manager (pilosa_tpu/hbm/): operand stacks page in
    # and out of the device budget as shard-major EXTENTS instead of
    # monolithic entries, so a budget below one query's working set
    # re-stages only evicted slices (docs/configuration.md "HBM
    # residency")
    extent_rows: int = 256  # shards per extent; 0 = monolithic staging
    prefetch_depth: int = 0  # warm-queue bound; 0 disables the prefetcher
    pin_timeout: float = 60.0  # stale-pin safety valve, seconds; 0 = off


@dataclass
class BsiConfig:
    # plane-streamed BSI aggregates (exec/bsistream.py; docs/
    # configuration.md "BSI aggregates"): Sum/Min/Max and single-
    # condition Range counts stage and reduce magnitude planes in slabs
    # of this many planes per compiled dispatch — peak plane residency
    # is slab-sized however deep the field, and a field at or under the
    # slab answers in ONE dispatch. <= 0 restores the default (16).
    slab_planes: int = 16


@dataclass
class IngestConfig:
    # bulk-ingest merge barrier (core/merge.py; docs/configuration.md
    # "Ingest"): staged deltas merge cross-fragment-batched at read
    # barriers — one device program launch per burst at or above the
    # threshold, one vectorized host pass below it. None = AUTO
    # (65536 on a real accelerator, device-off on the CPU backend,
    # where the XLA sort is the same silicon ~6x slower than numpy's)
    merge_device_threshold: Optional[int] = None  # <0 never, 0 always


@dataclass
class WalConfig:
    # durable write path (core/wal.py group commit; docs/configuration.md
    # "Durability"): 0 = strict — every commit group fsyncs before any
    # caller returns, so an acked write survives a crash; > 0 = bounded-
    # loss cadence in seconds — callers return after the buffered
    # write+flush and a background syncer fsyncs on this interval, the
    # crash loss window. Process-global (WAL files belong to the
    # process, not to one in-process node).
    sync_interval: float = 0.0


@dataclass
class MeshConfig:
    # mesh-local sharded execution (exec/meshgroup.py; docs/
    # configuration.md "Mesh execution"): nodes declaring the same
    # non-empty `group` share an ICI domain — their shards fold into ONE
    # compiled sharded program with in-program collectives instead of
    # per-node HTTP legs. HTTP/DCN remains the transport across groups.
    group: str = ""  # ICI domain id; "" = no mesh-local execution
    min_nodes: int = 2  # group-local owners before the fold engages; 0 disables
    # collective-cost link classes (sched/cost.py transport terms):
    # intra-group reductions ride ICI, cross-group legs ride HTTP/DCN
    ici_gbps: float = 100.0
    dcn_gbps: float = 3.0


@dataclass
class CacheConfig:
    # versioned result cache (core/resultcache.py; docs/configuration.md
    # "Result cache"): Count/TopN/GroupBy results cached keyed on the
    # exact fragment-version vector the plan read — repeats serve from
    # host memory with zero compiled dispatches after a cheap
    # revalidation, and cached Counts are patched in place from the
    # merge barrier's word deltas after set-only staged bursts.
    result_mb: int = 64  # LRU byte budget, MB; 0 disables the cache
    count_repair: bool = True  # incremental Count repair on staged bursts


@dataclass
class CoherenceConfig:
    # cache coherence plane (pilosa_tpu/coherence/; docs/configuration.md
    # "[coherence]"): push invalidation + version leases + query
    # subscriptions. With leases on, a coordinator holding a lease
    # serves fan-out warm hits with ZERO per-query version RTTs —
    # writers push batched version bumps instead; lease expiry degrades
    # safely to the /internal/versions revalidate path, so a dead or
    # partitioned publisher causes staleness bounded by lease-duration,
    # never a wrong answer served as fresh.
    lease_duration: float = 0.0  # lease lifetime, seconds; 0 = leases off
    publish_batch_ms: float = 20.0  # bump batching / flush tick, ms
    max_subscriptions: int = 64  # standing queries per node; 0 = subs off
    sub_poll_interval: float = 5.0  # unleased-shard refresh floor, seconds


@dataclass
class ResizeConfig:
    # live elastic resize (streaming resharding under traffic;
    # docs/configuration.md "Elastic resize"): moving fragments stream as
    # snapshot + live write capture while the old topology keeps serving;
    # writes are never globally frozen
    transfer_concurrency: int = 4  # parallel fragment fetches per node
    cutover_timeout: float = 30.0  # catch-up barrier wall bound, seconds
    resume_policy: str = "resume"  # resume | abort on a failed stream leg


@dataclass
class TierConfig:
    # tiered storage (pilosa_tpu/tier/; docs/configuration.md "Tiered
    # storage"): idle fragments demote to immutable snapshot objects in
    # a shared object store (upload strictly before local delete) and
    # hydrate on demand through the batch admission lane — datasets
    # larger than host RAM + local disk stay queryable, and joining
    # nodes bootstrap from stored snapshots instead of peer-streaming
    # every byte. "" store-path disables the whole plane.
    store_path: str = ""  # shared object-store directory; "" = tier off
    placement: str = "hot"  # default placement: hot | warm | cold
    # per-index placement overrides, "index:placement=cold" entries
    overrides: List[str] = field(default_factory=list)
    demote_after: float = 300.0  # idle seconds before a cold-placement demote
    host_budget_bytes: int = 0  # local snap+wal byte budget; 0 = unlimited
    fetch_concurrency: int = 4  # concurrent store transfers per node


@dataclass
class AntiEntropyConfig:
    interval: float = 0.0  # seconds; 0 disables the loop


@dataclass
class MetricConfig:
    service: str = "expvar"  # none | expvar | prometheus | statsd
    # (reference default: expvar, stats/stats.go:84; statsd pushes
    # DogStatsD datagrams to `host` AND feeds the scrape registry)
    host: str = "localhost:8125"  # statsd daemon address
    poll_interval: float = 30.0


@dataclass
class TracingConfig:
    # query flight recorder (utils/tracing.py; docs/observability.md).
    # `enabled` gates spontaneous ROOT sampling only: an incoming trace
    # header (the sender sampled) and the `profile=true` query option
    # always record, so flight recording works on demand either way.
    enabled: bool = False
    sample_rate: float = 1.0  # fraction of root queries traced
    ring: int = 1024  # spans kept in the per-node ring (/debug/traces)


@dataclass
class TelemetryConfig:
    # cluster telemetry plane (server/telemetry.py;
    # docs/observability.md "Cluster telemetry"): the always-on
    # utilization timeline sampler behind /debug/timeline — each tick
    # also refreshes the devcache/HBM gauges so statsd backends see
    # them without an HTTP scrape
    sample_interval: float = 5.0  # seconds between samples; 0 disables
    ring: int = 720  # utilization samples kept per node (~1h at 5s)


@dataclass
class TLSConfig:
    # Serve the whole HTTP plane (client API + internode) over TLS when
    # certificate+key are set (reference: server/config.go:151-157 TLS
    # block, applied in server.go:222-295). skip_verify disables peer cert
    # verification in the internode client (self-signed deployments);
    # ca_certificate pins a CA instead — the verified alternative.
    certificate: str = ""
    key: str = ""
    skip_verify: bool = False
    ca_certificate: str = ""


@dataclass
class Config:
    data_dir: str = "~/.pilosa-tpu"
    bind: str = "localhost:10101"
    node_id: str = ""  # default: derived from bind
    log_path: str = ""  # empty = stderr
    verbose: bool = False
    long_query_time: float = 0.0  # seconds; 0 disables slow-query logging
    max_writes_per_request: int = 5000
    # bulk-import replica fan-out: shard batches ship to their owner
    # nodes on a bounded thread pool this wide (docs/configuration.md
    # "Ingest")
    import_concurrency: int = 8
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    sched: SchedConfig = field(default_factory=SchedConfig)
    tenants: TenantsConfig = field(default_factory=TenantsConfig)
    hbm: HbmConfig = field(default_factory=HbmConfig)
    bsi: BsiConfig = field(default_factory=BsiConfig)
    ingest: IngestConfig = field(default_factory=IngestConfig)
    wal: WalConfig = field(default_factory=WalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    coherence: CoherenceConfig = field(default_factory=CoherenceConfig)
    resize: ResizeConfig = field(default_factory=ResizeConfig)
    tier: TierConfig = field(default_factory=TierConfig)
    anti_entropy: AntiEntropyConfig = field(default_factory=AntiEntropyConfig)
    metric: MetricConfig = field(default_factory=MetricConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    tls: TLSConfig = field(default_factory=TLSConfig)

    # -- sources -----------------------------------------------------------

    @classmethod
    def load(
        cls,
        path: Optional[str] = None,
        env: Optional[dict] = None,
        overrides: Optional[dict] = None,
    ) -> "Config":
        """defaults <- TOML file <- PILOSA_TPU_* env <- explicit overrides."""
        cfg = cls()
        if path:
            with open(path, "rb") as f:
                cfg._apply_dict(tomllib.load(f))
        cfg._apply_env(env if env is not None else os.environ)
        if overrides:
            cfg._apply_dict(overrides)
        return cfg

    def _apply_dict(self, d: dict) -> None:
        for k, v in d.items():
            k = k.replace("-", "_")
            if not hasattr(self, k):
                continue
            cur = getattr(self, k)
            if dataclasses.is_dataclass(cur) and isinstance(v, dict):
                for k2, v2 in v.items():
                    k2 = k2.replace("-", "_")
                    if hasattr(cur, k2):
                        setattr(cur, k2, _coerce(getattr(cur, k2), v2))
            else:
                setattr(self, k, _coerce(cur, v))

    def _apply_env(self, env: dict) -> None:
        for name, raw in env.items():
            if not name.startswith(ENV_PREFIX):
                continue
            parts = name[len(ENV_PREFIX):].lower().split("__")
            try:
                if len(parts) == 1:
                    cur = getattr(self, parts[0])
                    setattr(self, parts[0], _coerce(cur, raw))
                elif len(parts) == 2:
                    sect = getattr(self, parts[0])
                    cur = getattr(sect, parts[1])
                    setattr(sect, parts[1], _coerce(cur, raw))
            except AttributeError:
                continue

    # -- dump --------------------------------------------------------------

    def to_toml(self) -> str:
        out = []
        flat = {
            "data-dir": self.data_dir,
            "bind": self.bind,
            "node-id": self.node_id,
            "log-path": self.log_path,
            "verbose": self.verbose,
            "long-query-time": self.long_query_time,
            "max-writes-per-request": self.max_writes_per_request,
            "import-concurrency": self.import_concurrency,
        }
        for k, v in flat.items():
            out.append(f"{k} = {_toml_value(v)}")
        for sect_name, sect in (
            ("cluster", self.cluster),
            ("sched", self.sched),
            ("tenants", self.tenants),
            ("hbm", self.hbm),
            ("bsi", self.bsi),
            ("ingest", self.ingest),
            ("wal", self.wal),
            ("mesh", self.mesh),
            ("cache", self.cache),
            ("coherence", self.coherence),
            ("resize", self.resize),
            ("tier", self.tier),
            ("anti-entropy", self.anti_entropy),
            ("metric", self.metric),
            ("tracing", self.tracing),
            ("telemetry", self.telemetry),
            ("tls", self.tls),
        ):
            out.append(f"\n[{sect_name}]")
            for f_ in dataclasses.fields(sect):
                val = getattr(sect, f_.name)
                if val is None:
                    # TOML has no null: an unset knob (e.g. the AUTO
                    # merge-device-threshold) is expressed by omission
                    continue
                out.append(
                    f"{f_.name.replace('_', '-')} = {_toml_value(val)}"
                )
        return "\n".join(out) + "\n"



def _coerce(current, value):
    if isinstance(current, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(current, int) and not isinstance(current, bool):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, list):
        if isinstance(value, str):
            return [x.strip() for x in value.split(",") if x.strip()]
        return list(value)
    return value


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, list):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    return f'"{v}"'


def parse_hosts(hosts: List[str], default_scheme: str = "http"):
    """'node_id@http://host:port' entries -> [(id, uri)]. A bare host:port
    entry gets `default_scheme` and the id host-port."""
    out = []
    for h in hosts:
        if "@" in h:
            nid, uri = h.split("@", 1)
            if not uri.startswith("http"):
                uri = f"{default_scheme}://{uri}"
        else:
            uri = h if h.startswith("http") else f"{default_scheme}://{h}"
            nid = uri.split("//", 1)[-1].replace(":", "-")
        out.append((nid, uri))
    return out
