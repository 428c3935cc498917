"""CLI of the port: the `server` subcommand for one node.

    python -m pilosa_tpu_torch.cli server --data-dir '' --bind localhost:10101
    python -m pilosa_tpu_torch.cli server --data-dir '' --device cpu

The port's slice of pilosa_tpu/cli/main.py. It takes the reference's
server flags, TOML file and PILOSA_TPU_* environment, and serves one node
from memory on the CUDA card (`--device cpu` asks for the CPU). Every
knob whose feature the port lacks (durable data dirs, clusters and
`--join`, TLS, admission and tenants, HBM paging, the result cache,
tiered storage, mesh groups, coherence, tracing, metrics) must stay at
its default: a run that sets one exits non-zero naming it. The other
subcommands exit non-zero as not yet ported.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
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

# the knobs a one-node in-memory server honours (data_dir only when empty)
_PORTED_KNOBS = {"data_dir", "bind", "node_id", "log_path", "max_writes_per_request"}

# flags taking a list (the reference's nargs="*" flags)
_LIST_FLAGS = {"tenants_overrides", "tier_overrides"}

_OTHER_COMMANDS = ("import", "export", "inspect", "check", "config", "generate-config")


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
    sp.add_argument("--join", help="coordinator URI to join on boot (not yet ported)")
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
    for name in _OTHER_COMMANDS:
        sub.add_parser(name, help="not yet ported")
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


def _unported_settings(cfg: Config, join: Optional[str]) -> List[str]:
    """Every option set away from its default whose feature the port lacks,
    named as its flag."""
    out = []
    defaults = Config()
    for dest, (section, knob) in _FLAG_KNOBS.items():
        if knob in _PORTED_KNOBS and section is None:
            continue
        if _knob(cfg, section, knob) != _knob(defaults, section, knob):
            out.append(f"--{dest.replace('_', '-')}")
    if join:
        out.append("--join")
    return out


def cmd_server(cfg: Config, device: Optional[str], join: Optional[str] = None) -> None:
    """Serve until SIGINT or SIGTERM, then stop the node and return."""
    from pilosa_tpu_torch.server.node import NodeServer

    if cfg.data_dir:
        raise SystemExit(
            f"pilosa_tpu_torch server: --data-dir {cfg.data_dir!r}: durable storage is not "
            "yet ported; pass --data-dir '' to serve from memory"
        )
    unported = _unported_settings(cfg, join)
    if unported:
        raise SystemExit(
            f"pilosa_tpu_torch server: {', '.join(unported)}: not yet ported (the port serves "
            "one node from memory); leave these options at their defaults"
        )
    log_stream = open(cfg.log_path, "a") if cfg.log_path else sys.stderr

    def logger(msg: str) -> None:
        print(msg, file=log_stream, flush=True)

    try:
        srv = NodeServer(
            None,
            cfg.node_id or cfg.bind.replace(":", "-"),
            bind=cfg.bind,
            device=device,
            max_writes_per_request=cfg.max_writes_per_request,
            logger=logger,
        )
    except RuntimeError as e:  # no CUDA device and no --device cpu
        raise SystemExit(f"pilosa_tpu_torch server: {e} (here: --device cpu)") from None
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    srv.start()
    print(
        f"pilosa_tpu_torch node {srv.node.id} listening on {srv.node.uri} "
        f"(device {srv.holder.device})",
        file=sys.stderr,
        flush=True,
    )
    try:
        while not stop.wait(0.5):
            pass
    finally:
        srv.stop()
        if log_stream is not sys.stderr:
            log_stream.close()


def main(argv: Optional[List[str]] = None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)
    if not args.command:
        parser.print_help()
        return 2
    if args.command == "server":
        cmd_server(_load_config(args), args.device, join=args.join)
        return 0
    print(f"pilosa_tpu_torch {args.command}: not yet ported", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
