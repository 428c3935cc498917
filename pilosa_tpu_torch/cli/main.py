"""CLI of the port: server / import / export / inspect / check / config.

    python -m pilosa_tpu_torch.cli server --data-dir /tmp/p0 --bind localhost:10101
    python -m pilosa_tpu_torch.cli server --data-dir '' --device cpu
    python -m pilosa_tpu_torch.cli inspect /tmp/p0
    python -m pilosa_tpu_torch.cli check /tmp/p0

The port's slice of pilosa_tpu/cli/main.py. `server` takes the
reference's flags, TOML file and PILOSA_TPU_* environment, and serves one
node on the CUDA card (`--device cpu` asks for the CPU) from its data
dir (the default `~/.pilosa-tpu`; an empty one serves from memory), with
`--wal-sync-interval` as the group commit's cadence; the front-end
knobs are honoured too: `--max-concurrent-queries`, `--admission-*`,
`--tenants-*`, `--hbm-prefetch-depth`, `--cache-result-mb` and
`--cache-count-repair`, and so are the cluster's: `--cluster-hosts`
(`id@uri` entries: they seed the membership on the first boot, after
which the data dir's `.topology` wins and the flags only heal peer
URIs), `--replicas`, `--coordinator`, `--probe-interval`, the retry and
breaker knobs and `--query-deadline`, `--anti-entropy-interval`
(seconds between anti-entropy passes; the default 0 runs one only on
`POST /internal/sync`), `--join <coordinator URI>` (a fresh node asks the
coordinator to admit it and waits until a resize job made it a member;
ignored when the data dir's `.topology` already names a membership) and
the resize knobs `--resize-transfer-concurrency`,
`--resize-cutover-timeout` and `--resize-resume-policy`. Every knob
whose feature the port lacks (TLS, `--shed-retry-after`, tiered
storage, mesh groups, coherence, tracing, metrics) must stay at its
default: a run that sets one exits non-zero naming it. `import` and
`export` talk to a server over HTTP; `inspect` opens a data dir and
`check` reads its files offline; `config` and `generate-config` print
TOML. Each prints what the reference's does.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
import urllib.request
from typing import List, Optional

from pilosa_tpu_torch.cli.config import Config

# argparse dest -> (section, knob) for every server flag that overrides a
# Config field; None section means a flat Config field (the reference's
# table, cli/main.py _FLAG_KNOBS)
_FLAG_KNOBS = {
    "data_dir": (None, "data_dir"),
    "bind": (None, "bind"),
    "node_id": (None, "node_id"),
    "log_path": (None, "log_path"),
    "verbose": (None, "verbose"),
    "long_query_time": (None, "long_query_time"),
    "max_writes_per_request": (None, "max_writes_per_request"),
    "import_concurrency": (None, "import_concurrency"),
    "cluster_hosts": ("cluster", "hosts"),
    "replicas": ("cluster", "replicas"),
    "coordinator": ("cluster", "coordinator"),
    "probe_interval": ("cluster", "probe_interval"),
    "retry_max_attempts": ("cluster", "retry_max_attempts"),
    "retry_base_backoff": ("cluster", "retry_base_backoff"),
    "breaker_threshold": ("cluster", "breaker_threshold"),
    "breaker_cooldown": ("cluster", "breaker_cooldown"),
    "query_deadline": ("cluster", "query_deadline"),
    "max_concurrent_queries": ("sched", "max_concurrent_queries"),
    "admission_queue_depth": ("sched", "admission_queue_depth"),
    "admission_byte_budget": ("sched", "admission_byte_budget"),
    "admission_default_class": ("sched", "admission_default_class"),
    "shed_retry_after": ("sched", "shed_retry_after"),
    "tenants_default_qps": ("tenants", "default_qps"),
    "tenants_default_bytes_per_s": ("tenants", "default_bytes_per_s"),
    "tenants_default_inflight_bytes": ("tenants", "default_inflight_bytes"),
    "tenants_default_hbm_bytes": ("tenants", "default_hbm_bytes"),
    "tenants_default_cache_bytes": ("tenants", "default_cache_bytes"),
    "tenants_overrides": ("tenants", "overrides"),
    "hbm_extent_rows": ("hbm", "extent_rows"),
    "hbm_prefetch_depth": ("hbm", "prefetch_depth"),
    "hbm_pin_timeout": ("hbm", "pin_timeout"),
    "bsi_slab_planes": ("bsi", "slab_planes"),
    "merge_device_threshold": ("ingest", "merge_device_threshold"),
    "wal_sync_interval": ("wal", "sync_interval"),
    "mesh_group": ("mesh", "group"),
    "mesh_min_nodes": ("mesh", "min_nodes"),
    "cache_result_mb": ("cache", "result_mb"),
    "cache_count_repair": ("cache", "count_repair"),
    "mesh_ici_gbps": ("mesh", "ici_gbps"),
    "mesh_dcn_gbps": ("mesh", "dcn_gbps"),
    "resize_transfer_concurrency": ("resize", "transfer_concurrency"),
    "resize_cutover_timeout": ("resize", "cutover_timeout"),
    "resize_resume_policy": ("resize", "resume_policy"),
    "tier_store_path": ("tier", "store_path"),
    "tier_placement": ("tier", "placement"),
    "tier_overrides": ("tier", "overrides"),
    "tier_demote_after": ("tier", "demote_after"),
    "tier_host_budget_bytes": ("tier", "host_budget_bytes"),
    "tier_fetch_concurrency": ("tier", "fetch_concurrency"),
    "coherence_lease_duration": ("coherence", "lease_duration"),
    "coherence_publish_batch_ms": ("coherence", "publish_batch_ms"),
    "coherence_max_subscriptions": ("coherence", "max_subscriptions"),
    "coherence_sub_poll_interval": ("coherence", "sub_poll_interval"),
    "anti_entropy_interval": ("anti_entropy", "interval"),
    "metric_service": ("metric", "service"),
    "metric_host": ("metric", "host"),
    "metric_poll_interval": ("metric", "poll_interval"),
    "tracing_enabled": ("tracing", "enabled"),
    "tracing_sample_rate": ("tracing", "sample_rate"),
    "tracing_ring": ("tracing", "ring"),
    "telemetry_sample_interval": ("telemetry", "sample_interval"),
    "telemetry_ring": ("telemetry", "ring"),
    "tls_certificate": ("tls", "certificate"),
    "tls_key": ("tls", "key"),
    "tls_skip_verify": ("tls", "skip_verify"),
    "tls_ca_certificate": ("tls", "ca_certificate"),
}

# the (section, knob)s a one-node server honours
_PORTED_KNOBS = {
    (None, "data_dir"),
    (None, "bind"),
    (None, "node_id"),
    (None, "log_path"),
    (None, "max_writes_per_request"),
    ("wal", "sync_interval"),
    ("hbm", "extent_rows"),
    ("hbm", "pin_timeout"),
    ("ingest", "merge_device_threshold"),
    ("sched", "max_concurrent_queries"),
    ("sched", "admission_queue_depth"),
    ("sched", "admission_byte_budget"),
    ("sched", "admission_default_class"),
    ("tenants", "default_qps"),
    ("tenants", "default_bytes_per_s"),
    ("tenants", "default_inflight_bytes"),
    ("tenants", "default_hbm_bytes"),
    ("tenants", "default_cache_bytes"),
    ("tenants", "overrides"),
    ("hbm", "prefetch_depth"),
    ("bsi", "slab_planes"),
    ("cache", "result_mb"),
    ("cache", "count_repair"),
    ("cluster", "hosts"),
    ("cluster", "replicas"),
    ("cluster", "coordinator"),
    ("cluster", "probe_interval"),
    ("cluster", "retry_max_attempts"),
    ("cluster", "retry_base_backoff"),
    ("cluster", "breaker_threshold"),
    ("cluster", "breaker_cooldown"),
    ("cluster", "query_deadline"),
    ("anti_entropy", "interval"),
    ("resize", "transfer_concurrency"),
    ("resize", "cutover_timeout"),
    ("resize", "resume_policy"),
}

# flags taking a list (the reference's nargs="*" flags)
_LIST_FLAGS = {"tenants_overrides", "tier_overrides"}


def _bool_flag(v: str) -> bool:
    """Explicit true/false flag value (for default-True knobs)."""
    s = v.strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected true/false, got {v!r}")


def _knob(cfg: Config, section: Optional[str], knob: str):
    return getattr(cfg if section is None else getattr(cfg, section), knob)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pilosa_tpu_torch", description="bitmap index on one CUDA card (PyTorch port)"
    )
    p.add_argument("--config", "-c", help="path to TOML config file")
    sub = p.add_subparsers(dest="command")
    sp = sub.add_parser("server", help="run one node")
    sp.add_argument(
        "--device",
        help="torch device to serve from (default: the CUDA card; 'cpu' runs the "
        "plain-PyTorch path)",
    )
    sp.add_argument(
        "--join",
        help="coordinator URI to join on boot (asks it for a resize job that adds this "
        "node and waits until the node is a member)",
    )
    defaults = Config()
    for dest, (section, knob) in _FLAG_KNOBS.items():
        flag = "--" + dest.replace("_", "-")
        default = _knob(defaults, section, knob)
        if dest == "cluster_hosts":
            sp.add_argument(flag, help="comma-separated id@uri entries")
        elif dest in _LIST_FLAGS:
            sp.add_argument(flag, nargs="*")
        elif isinstance(default, bool):
            if default:
                sp.add_argument(flag, type=_bool_flag)
            else:
                sp.add_argument(flag, action="store_true", default=None)
        elif isinstance(default, (int, float)) or dest == "merge_device_threshold":
            sp.add_argument(flag, type=float if isinstance(default, float) else int)
        else:
            sp.add_argument(flag)

    ip = sub.add_parser("import", help="bulk-import CSV rows (row,col[,ts])")
    ip.add_argument("--host", default="http://localhost:10101")
    ip.add_argument("--index", "-i", required=True)
    ip.add_argument("--field", "-f", required=True)
    ip.add_argument("--batch-size", type=int, default=100_000)
    ip.add_argument("--clear", action="store_true")
    ip.add_argument("--create", action="store_true", help="create index/field")
    ip.add_argument("--field-type", default="set")
    ip.add_argument("--field-keys", action="store_true")
    ip.add_argument("--index-keys", action="store_true")
    ip.add_argument("paths", nargs="*", help="CSV files ('-' or empty = stdin)")

    ep = sub.add_parser("export", help="export a field as CSV")
    ep.add_argument("--host", default="http://localhost:10101")
    ep.add_argument("--index", "-i", required=True)
    ep.add_argument("--field", "-f", required=True)
    ep.add_argument("--output", "-o", help="output path (default stdout)")

    np_ = sub.add_parser("inspect", help="dump fragment info from a data dir")
    np_.add_argument("data_dir")
    np_.add_argument("--index")
    np_.add_argument("--field")
    np_.add_argument("--device", help="torch device the holder opens on (default: the CUDA card)")

    cp = sub.add_parser("check", help="offline integrity check of data files")
    cp.add_argument("paths", nargs="+", help=".snap / .wal files or data dirs")

    sub.add_parser("config", help="print the effective configuration")
    sub.add_parser("generate-config", help="print default configuration")
    return p


def _load_config(args) -> Config:
    overrides: dict = {}
    for dest, (section, knob) in _FLAG_KNOBS.items():
        v = getattr(args, dest, None)
        if v is None:
            continue
        if section is None:
            overrides[knob] = v
        else:
            overrides.setdefault(section, {})[knob] = v
    return Config.load(path=args.config, overrides=overrides)


def _unported_settings(cfg: Config) -> List[str]:
    """Every option set away from its default whose feature the port lacks,
    named as its flag."""
    out = []
    defaults = Config()
    for dest, (section, knob) in _FLAG_KNOBS.items():
        if (section, knob) in _PORTED_KNOBS:
            continue
        if _knob(cfg, section, knob) != _knob(defaults, section, knob):
            out.append(f"--{dest.replace('_', '-')}")
    return out


def _join_on_boot(srv, coordinator_uri: str, timeout: float = 180.0, clock=None, wake=None) -> None:
    """Ask the coordinator to admit this node and wait until it is a
    member in state NORMAL. A busy coordinator (another job running) or
    one not up yet is asked again every second; a join whose job rolled
    back (this node is alone again 10 s after it registered) registers
    again. `clock` (monotonic seconds) and `wake` (an Event: `.wait(t)`
    bounds each poll, `.set()` wakes the loop) let a test drive the loop
    on a virtual clock. SystemExit when `timeout` passes."""
    from pilosa_tpu_torch.server.client import ClientError

    clock = clock or time.monotonic
    wake = wake or threading.Event()
    payload = {"id": srv.node.id, "uri": srv.node.uri}
    deadline = clock() + timeout
    registered_at: Optional[float] = None
    while clock() < deadline:
        if registered_at is None:
            try:
                srv.client.join_cluster(coordinator_uri, payload)
                registered_at = clock()
            except ClientError as e:
                print(f"join: waiting for coordinator: {e}", file=sys.stderr, flush=True)
                wake.wait(1.0)
                continue
        elif len(srv.cluster.nodes) <= 1 and clock() - registered_at > 10.0:
            print("join: resize rolled back; re-registering", file=sys.stderr, flush=True)
            registered_at = None
            continue
        if len(srv.cluster.nodes) > 1 and any(n.id == srv.node.id for n in srv.cluster.nodes) and srv.state == "NORMAL":
            print(f"joined cluster of {len(srv.cluster.nodes)} nodes via {coordinator_uri}", file=sys.stderr, flush=True)
            return
        wake.wait(0.2)
    raise SystemExit(f"join via {coordinator_uri} did not complete in {timeout}s")


def cmd_server(cfg: Config, device: Optional[str], join: Optional[str] = None, wait: bool = True):
    """Start the node, install the cluster the flags or its data dir name,
    then serve until SIGINT or SIGTERM and stop the node. With `wait`
    False, return the started node instead."""
    from pilosa_tpu_torch.cli.config import parse_hosts
    from pilosa_tpu_torch.cluster.topology import Node
    from pilosa_tpu_torch.server.node import NodeServer

    unported = _unported_settings(cfg)
    if unported:
        raise SystemExit(
            f"pilosa_tpu_torch server: {', '.join(unported)}: not yet ported; "
            "leave these options at their defaults"
        )
    hosts = parse_hosts(cfg.cluster.hosts)
    my_uri = cfg.bind if cfg.bind.startswith("http") else f"http://{cfg.bind}"
    node_id = cfg.node_id
    if not node_id:
        # the id parse_hosts gives this address, so an entry naming it matches
        matched = [nid for nid, uri in hosts if uri == my_uri]
        node_id = matched[0] if matched else cfg.bind.replace(":", "-")
    log_stream = open(cfg.log_path, "a") if cfg.log_path else sys.stderr

    def logger(msg: str) -> None:
        print(msg, file=log_stream, flush=True)

    try:
        srv = NodeServer(
            cfg.data_dir,
            node_id,
            bind=cfg.bind,
            device=device,
            replica_n=cfg.cluster.replicas,
            probe_interval=cfg.cluster.probe_interval,
            retry_max_attempts=cfg.cluster.retry_max_attempts,
            retry_base_backoff=cfg.cluster.retry_base_backoff,
            breaker_threshold=cfg.cluster.breaker_threshold,
            breaker_cooldown=cfg.cluster.breaker_cooldown,
            query_deadline=cfg.cluster.query_deadline,
            max_writes_per_request=cfg.max_writes_per_request,
            wal_sync_interval=cfg.wal.sync_interval,
            hbm_extent_rows=cfg.hbm.extent_rows,
            hbm_pin_timeout=cfg.hbm.pin_timeout,
            bsi_slab_planes=cfg.bsi.slab_planes,
            merge_device_threshold=cfg.ingest.merge_device_threshold,
            max_concurrent_queries=cfg.sched.max_concurrent_queries,
            admission_queue_depth=cfg.sched.admission_queue_depth,
            admission_byte_budget=cfg.sched.admission_byte_budget,
            admission_default_class=cfg.sched.admission_default_class,
            tenant_default_qps=cfg.tenants.default_qps,
            tenant_default_bytes_per_s=cfg.tenants.default_bytes_per_s,
            tenant_default_inflight_bytes=cfg.tenants.default_inflight_bytes,
            tenant_default_hbm_bytes=cfg.tenants.default_hbm_bytes,
            tenant_default_cache_bytes=cfg.tenants.default_cache_bytes,
            tenant_overrides=cfg.tenants.overrides,
            hbm_prefetch_depth=cfg.hbm.prefetch_depth,
            cache_result_mb=cfg.cache.result_mb,
            cache_count_repair=cfg.cache.count_repair,
            anti_entropy_interval=cfg.anti_entropy.interval,
            resize_transfer_concurrency=cfg.resize.transfer_concurrency,
            resize_cutover_timeout=cfg.resize.cutover_timeout,
            resize_resume_policy=cfg.resize.resume_policy,
            logger=logger,
        )
    except RuntimeError as e:  # no CUDA device and no --device cpu
        raise SystemExit(f"pilosa_tpu_torch server: {e} (here: --device cpu)") from None
    except ValueError as e:  # a knob out of its range (--resize-resume-policy)
        raise SystemExit(f"pilosa_tpu_torch server: {e}") from None
    try:
        srv.start()
        if srv.topology_restored:
            # the membership is on disk: the flags only heal peer URIs
            healed = srv.heal_peer_uris(hosts) if hosts else []
            if hosts:
                print(
                    "cluster-hosts: membership restored from .topology"
                    + (f"; healed URIs for {healed}" if healed else ""),
                    file=sys.stderr,
                )
        elif hosts:
            members = []
            for nid, uri in hosts:
                if uri == my_uri and nid != srv.node.id:
                    # the entry naming this address keeps the durable .id
                    print(f"cluster-hosts id {nid!r} for this address overridden by on-disk .id {srv.node.id!r}", file=sys.stderr)
                    nid = srv.node.id
                members.append(Node(id=nid, uri=uri))
            if not any(m.id == srv.node.id for m in members):
                members.append(Node(id=srv.node.id, uri=srv.node.uri))
            members[0].is_coordinator = True
            srv.set_topology(members, replica_n=cfg.cluster.replicas)
        if join:
            if srv.topology_restored:
                print(
                    f"--join {join} ignored: membership restored from .topology "
                    f"(remove {srv._topology_path} to join a different cluster)",
                    file=sys.stderr,
                )
            else:
                _join_on_boot(srv, join)
    except BaseException:
        srv.stop()  # the holder closes, the result-cache budget goes back
        raise
    print(
        f"pilosa_tpu_torch node {srv.node.id} listening on {srv.node.uri} "
        f"(device {srv.holder.device})",
        file=sys.stderr,
        flush=True,
    )
    if not wait:
        return srv
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    try:
        while not stop.wait(0.5):
            pass
    finally:
        srv.stop()
        from pilosa_tpu_torch.ops import kernels

        # the process's kernel launches, for whoever drove it (the smoke
        # script's cluster phase reads them from each node's last line)
        print(
            f"pilosa_tpu_torch node {srv.node.id} stopped; kernel launches {json.dumps(dict(kernels.LAUNCHES))}",
            file=sys.stderr,
            flush=True,
        )
        if log_stream is not sys.stderr:
            log_stream.close()


def _iter_csv_rows(paths: List[str]):
    files = paths or ["-"]
    for path in files:
        fh = sys.stdin if path == "-" else open(path)
        try:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(",")
                if len(parts) < 2:
                    raise ValueError(f"bad csv line: {line!r}")
                yield parts[0], parts[1], (parts[2] if len(parts) > 2 else None)
        finally:
            if path != "-":
                fh.close()


def _post_json(url: str, body: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        raw = resp.read()
    return json.loads(raw) if raw else {}


def cmd_import(args) -> int:
    def maybe_int(s):
        try:
            return int(s)
        except ValueError:
            return s  # string key

    if args.create:
        _post_json(
            f"{args.host}/index/{args.index}",
            {"options": {"keys": args.index_keys}},
        )
        _post_json(
            f"{args.host}/index/{args.index}/field/{args.field}",
            {"options": {"type": args.field_type, "keys": args.field_keys}},
        )
    batch_rows, batch_cols, batch_ts, n = [], [], [], 0
    is_value = args.field_type == "int"

    def flush():
        nonlocal batch_rows, batch_cols, batch_ts
        if not batch_cols:
            return
        if is_value:
            _post_json(
                f"{args.host}/index/{args.index}/field/{args.field}/import-value",
                {"cols": batch_cols, "values": [int(r) for r in batch_rows]},
            )
        else:
            body = {"rows": batch_rows, "cols": batch_cols}
            if any(t is not None for t in batch_ts):
                body["timestamps"] = batch_ts
            if args.clear:
                body["clear"] = True
            _post_json(
                f"{args.host}/index/{args.index}/field/{args.field}/import", body
            )
        batch_rows, batch_cols, batch_ts = [], [], []

    for row, col, ts in _iter_csv_rows(args.paths):
        batch_rows.append(maybe_int(row))
        batch_cols.append(maybe_int(col))
        batch_ts.append(ts)
        n += 1
        if len(batch_cols) >= args.batch_size:
            flush()
    flush()
    print(f"imported {n} records", file=sys.stderr)
    return 0


def cmd_export(args) -> int:
    url = f"{args.host}/export?index={args.index}&field={args.field}"
    with urllib.request.urlopen(url, timeout=120) as resp:
        data = resp.read()
    if args.output:
        with open(args.output, "wb") as f:
            f.write(data)
    else:
        sys.stdout.write(data.decode())
    return 0


def cmd_inspect(args) -> int:
    from pilosa_tpu_torch.core.holder import Holder

    h = Holder(args.data_dir, device=args.device).open()
    try:
        for idx in h.indexes():
            if args.index and idx.name != args.index:
                continue
            for f in idx.fields(include_hidden=True):
                if args.field and f.name != args.field:
                    continue
                for vname, v in f.views.items():
                    for shard in sorted(v.fragments):
                        frag = v.fragments[shard]
                        rows, _ = frag.pairs()
                        n_rows = len(frag.row_ids())
                        print(
                            f"{idx.name}/{f.name}/{vname}/shard={shard}: "
                            f"rows={n_rows} bits={len(rows)} op_n={frag._op_n}"
                        )
    finally:
        h.close()
    return 0


def cmd_check(paths: List[str]) -> int:
    """Offline integrity check (reference: ctl/check.go:47-133): exit 1
    if any file is corrupt."""
    from pilosa_tpu_torch.core import wal as walmod

    failed = 0
    todo: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, files in os.walk(p):
                todo.extend(
                    os.path.join(root, fn)
                    for fn in files
                    if fn.endswith((".snap", ".wal", ".bitmap", ".roaring"))
                )
        else:
            todo.append(p)
    for p in todo:
        try:
            if p.endswith(".snap"):
                shard, n_bits, rows = walmod.read_snapshot(p)
                total = sum(rb.count() for rb in rows.values())
                print(f"{p}: ok shard={shard} rows={len(rows)} bits={total}")
            elif p.endswith(".wal"):
                n_ops, status, detail = walmod.check_wal(p)
                if status == "corrupt":
                    raise ValueError(f"{detail} (after {n_ops} valid ops)")
                note = f" ({detail}, discarded on replay)" if status == "torn" else ""
                print(f"{p}: ok ops={n_ops}{note}")
            elif p.endswith((".bitmap", ".roaring")):
                # reference-format roaring files (ctl/check.go checks .bitmap)
                from pilosa_tpu_torch.core import roaring_io

                with open(p, "rb") as fh:
                    info = roaring_io.inspect(fh.read())
                print(
                    f"{p}: ok dialect={info['dialect']} bits={info['bit_count']} "
                    f"max={info['max_position']}"
                )
            else:
                print(f"{p}: skipped (unknown extension)")
        except Exception as e:
            print(f"{p}: CORRUPT: {e}")
            failed += 1
    return 1 if failed else 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)
    if not args.command:
        parser.print_help()
        return 2
    if args.command == "server":
        cmd_server(_load_config(args), args.device, join=args.join)
        return 0
    if args.command == "import":
        return cmd_import(args)
    if args.command == "export":
        return cmd_export(args)
    if args.command == "inspect":
        return cmd_inspect(args)
    if args.command == "check":
        return cmd_check(args.paths)
    if args.command == "config":
        sys.stdout.write(_load_config(args).to_toml())
        return 0
    sys.stdout.write(Config().to_toml())  # generate-config
    return 0


if __name__ == "__main__":
    sys.exit(main())
