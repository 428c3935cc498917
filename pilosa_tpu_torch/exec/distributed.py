"""Distributed executor: cluster fan-out, per-call reduce and failover.

The port of pilosa_tpu/exec/distributed.py. DistributedExecutor
subclasses the single-node Executor and intercepts the per-call entry
points. A "partial" is one call's result over one node's shard subset,
run with remote semantics (no translation, TopN candidates untrimmed,
no row-attr tail); `_fan_out` computes the partials (the local subset
through super(), remote ones through InternalClient) and `_reduce` folds
them per result type. Reads go to the first live owner of each shard;
when a node fails with a node-down shaped error its shards are re-mapped
onto their surviving replicas, preferring replicas whose circuit breaker
is closed. A leg that fails on a node that answered (a 4xx, a remote
payload error) surfaces as an ExecError: another replica would answer
the same, and nothing re-runs on the coordinator's own device.

Every leg runs the kernels the single node does: a node's share of a
Count is one plan_count launch, of a Row one plan_rows launch, and a run
of adjacent Counts goes to each node as one multi-call request that the
node evaluates as one plan_count_multi launch (`_execute_count_batch`).
A Shift carries each shard's top bits into the next shard. The
coordinator extends the shard list by those successors once, and each
shard goes to one leg, which answers exactly the shards it is given. A
leg still stacks each shard's predecessors for the carry: those its node
does not own it fetches from an owner, as the rows of the trees' leaves
over those shards in one internode request (`_pred_fills`). So every
shard is counted once, with its carry in, and a cluster answers as one
node over all shards.

TopN keeps its exact two-pass protocol: pass 1 merges every node's
untrimmed candidates, pass 2 re-counts the merged ids exactly on every
node. Writes route by ownership: Set and Clear go to every replica owner
of the column's shard, ClearRow and Store run on every owner over its
shards, attribute writes replicate to every node.

The result cache revalidates a coordinator's entry against the versions
of every fragment its legs read, fetched predecessors included, on the
node each is read from (`version_vector`): local parts directly,
remote ones over one parallel /internal/versions round, paid only from a
key's second sighting on. The reference's mesh-group execution, its
transport cost profile and its coherence leases are not ported; locks are
plain threading locks and no trace spans are recorded.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from pilosa_tpu_torch.cluster.topology import NODE_STATE_DOWN, Cluster
from pilosa_tpu_torch.core import resultcache as rcache
from pilosa_tpu_torch.core.fragment import TransferCutover
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.exec.executor import ExecError, ExecOptions, Executor, GroupCount, Pair, ValCount
from pilosa_tpu_torch.pql import Call, ParseError, parse
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

DEFAULT_QUERY_DEADLINE = 30.0


def _faults():
    # imported on use: the server package imports the node, which imports
    # this module
    from pilosa_tpu_torch.server import faults

    return faults


class RemoteError(ExecError):
    """A remote node failed to execute its shard subset."""


class DistributedExecutor(Executor):
    def __init__(
        self,
        holder: Holder,
        cluster_fn: Callable[[], Cluster],
        client,
        local_id: str,
        query_deadline: float = DEFAULT_QUERY_DEADLINE,
    ):
        super().__init__(holder)
        self.cluster_fn = cluster_fn
        self.client = client
        self.local_id = local_id
        # the wall-clock bound on one call's fan-out, every re-map round
        # and backoff included (the query-deadline knob)
        self.query_deadline = query_deadline
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_mu = threading.Lock()

    def _fanout_pool(self) -> ThreadPoolExecutor:
        """The shared pool of per-node requests, made on first use."""
        with self._pool_mu:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=16, thread_name_prefix=f"fanout-{self.local_id}")
            return self._pool

    def close(self) -> None:
        """Release the fan-out pool (NodeServer.stop)."""
        with self._pool_mu:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    # ------------------------------------------------------------------
    # fan-out plumbing
    # ------------------------------------------------------------------

    def _cluster(self) -> Cluster:
        return self.cluster_fn()

    def _is_single_node(self) -> bool:
        return len(self._cluster().nodes) <= 1

    def _uri_of(self, node_id: str) -> str:
        n = self._cluster().node_by_id(node_id)
        if n is None:
            raise RemoteError(f"unknown node {node_id}")
        return n.uri

    def _breaker_open(self, uri: str) -> bool:
        faults = _faults()
        breakers = getattr(self.client, "breakers", None) or faults.global_breakers()
        return breakers is not None and breakers.state(uri) == faults.OPEN

    def _fan_out(
        self,
        idx: Index,
        c: Call,
        shards: Optional[Sequence[int]],
        write: bool = False,
        leg: Optional[Callable[..., Any]] = None,
    ) -> List[Any]:
        """Run call `c` over the cluster's shards and return the partials,
        the local one included. Reads go to the first live owner of each
        shard and fail over to the next replica; writes go to every live
        owner. `leg(node_id, node_shards, timeout, deadline)` computes one
        node's partial (default: `_node_partial` of `c`). The whole
        fan-out is bounded by `query_deadline`; re-map rounds back off
        with the client's retry policy."""
        cluster = self._cluster()
        all_shards = self._shards_for(idx, shards, c)
        if write:
            remaining = dict(cluster.shards_by_all_owners(idx.name, all_shards))
        else:
            remaining = dict(cluster.shards_by_node(idx.name, all_shards))
        if leg is None:

            def leg(node_id, node_shards, timeout, deadline):
                return self._node_partial(
                    idx, c, node_id, node_shards, write=write, timeout=timeout, deadline=deadline
                )

        policy = getattr(self.client, "retry_policy", None) or _faults().RetryPolicy()
        budget = policy.budget(self.query_deadline)
        partials: List[Any] = []
        failed: set = set()
        attempts = 0
        while remaining:
            attempts += 1
            if attempts > len(cluster.nodes) + 1:
                raise RemoteError("shards could not be placed on any live node")
            if budget.expired():
                raise RemoteError(
                    f"query deadline ({self.query_deadline}s) exceeded with "
                    f"shards unplaced on nodes {sorted(remaining)}"
                )
            if attempts > 1:
                # a replica refusing connections while it restarts needs
                # milliseconds, not an instant second hammering
                delay = min(policy.backoff(attempts - 1), budget.remaining())
                if delay > 0:
                    policy.sleep(delay)
            items = list(remaining.items())

            def attempt(t):
                node_id, node_shards = t
                try:
                    # each RPC is bounded by the deadline's remaining time,
                    # and the peer's admission controller sheds the leg
                    # (429, retryable) once that can no longer be met
                    left = max(0.05, budget.remaining())
                    return leg(node_id, node_shards, left, left)
                except RemoteError as e:
                    return e

            if len(items) == 1:
                outcomes = [attempt(items[0])]
            else:
                outcomes = list(self._fanout_pool().map(attempt, items))
            retry: Dict[str, List[int]] = {}
            for (node_id, node_shards), res in zip(items, outcomes):
                if not isinstance(res, RemoteError):
                    partials.append(res)
                    continue
                failed.add(node_id)
                if write:
                    # the other replicas were written; the miss is visible
                    # debt for anti-entropy (with no second copy there is
                    # nothing to repair from, so none is recorded)
                    if cluster.replica_n > 1:
                        for s in node_shards:
                            self.holder.record_pending_repair(idx.name, s, node_id)
                    continue
                # re-map this node's shards to the next live replica,
                # preferring replicas whose breaker is closed
                for s in node_shards:
                    owners = [n for n in self._read_owners(cluster, idx.name, s) if n.id not in failed]
                    if not owners:
                        raise RemoteError(f"shard {s} unavailable: all replicas down")
                    retry.setdefault(owners[0].id, []).append(s)
            remaining = retry
        return partials

    def _node_partial(
        self,
        idx: Index,
        c: Call,
        node_id: str,
        node_shards: List[int],
        write: bool = False,
        timeout: Optional[float] = None,
        deadline: Optional[float] = None,
    ) -> Any:
        if node_id == self.local_id:
            return super()._execute_call(idx, c, node_shards, ExecOptions(remote=True))
        return self._remote_results(idx, str(c), node_id, node_shards, write, timeout, deadline)[0]

    def _remote_results(self, idx, pql: str, node_id, node_shards, write, timeout, deadline) -> List[Any]:
        """One remote leg's results. A read whose failure is node-down
        shaped (retryable) is a RemoteError, which failover re-maps; a
        non-retryable one (a 4xx, a remote payload error) means the peer
        ran the request and refused it, so it is the caller's ExecError.
        Every write failure is a RemoteError: the write path records the
        replica's debt and goes on with the other replicas."""
        try:
            return self.client.query_node(
                self._uri_of(node_id),
                idx.name,
                pql,
                shards=node_shards,
                remote=True,
                timeout=timeout,
                deadline=deadline,
                device=self.holder.device,
            )
        except Exception as e:
            if write or getattr(e, "retryable", True):
                raise RemoteError(f"node {node_id}: {e}") from e
            raise ExecError(f"node {node_id}: {e}") from e

    # ------------------------------------------------------------------
    # reduce table
    # ------------------------------------------------------------------

    @staticmethod
    def _reduce_rows(partials: List[Any]) -> Row:
        """The union of Row partials, shard by shard: read legs hold
        disjoint shards, and a shard two legs both answer (a Shift's
        carry into the next shard) is OR-ed."""
        segments: Dict[int, torch.Tensor] = {}
        for p in partials:
            if not isinstance(p, Row):
                continue
            for s, w in p.segments.items():
                cur = segments.get(s)
                segments[s] = w if cur is None else torch.bitwise_or(cur, w.to(cur.device))
        return Row(segments)

    def _reduce(self, name: str, c: Call, partials: List[Any]) -> Any:
        partials = [p for p in partials if p is not None]
        if name in ("Row", "Union", "Intersect", "Difference", "Xor", "Not", "Shift", "Range", "All"):
            return self._reduce_rows(partials)
        if name == "Count":
            return sum(int(p) for p in partials)
        if name in ("Clear", "ClearRow", "Store"):
            return any(bool(p) for p in partials)
        if name == "Sum":
            vc = ValCount(0, 0)
            for p in partials:
                vc = ValCount(int(vc.value) + int(p.value), int(vc.count) + int(p.count))
            return vc
        if name in ("Min", "Max"):
            best: Optional[ValCount] = None
            for p in partials:
                value, count = int(p.value), int(p.count)
                if count == 0:
                    continue
                if best is None:
                    best = ValCount(value, count)
                elif (value < best.value) == (name == "Min") and value != best.value:
                    best = ValCount(value, count)
                elif value == best.value:
                    best = ValCount(best.value, best.count + count)
            return best or ValCount(0, 0)
        if name in ("MinRow", "MaxRow"):
            best = None
            for p in partials:
                if not p or p.get("count", 0) == 0:
                    continue
                if best is None:
                    best = dict(p)
                elif p["id"] == best["id"]:
                    best["count"] += p["count"]
                elif (p["id"] < best["id"]) == (name == "MinRow"):
                    best = dict(p)
            if best is not None and not c.children:
                best["count"] = 1  # unfiltered, one node answers count 1
            return best or {"id": 0, "count": 0}
        if name == "Rows":
            merged = set()
            for p in partials:
                merged.update(int(r) for r in p)
            out = sorted(merged)
            limit = c.uint_arg("limit")
            prev = c.uint_arg("previous")
            if prev is not None:
                out = [r for r in out if r > prev]
            if limit is not None:
                out = out[:limit]
            return out
        if name == "GroupBy":
            groups: Dict[tuple, GroupCount] = {}
            for p in partials:
                for gc in p:
                    key = tuple((fr.field, fr.row_id) for fr in gc.group)
                    if key in groups:
                        groups[key].count += int(gc.count)
                    else:
                        groups[key] = GroupCount(group=list(gc.group), count=int(gc.count))
            out = sorted(groups.values(), key=lambda g: g.compare_key())
            offset = c.uint_arg("offset")
            limit = c.uint_arg("limit")
            if offset:
                out = out[offset:]
            if limit is not None:
                out = out[:limit]
            return out
        raise ExecError(f"no distributed reduce for call {name!r}")

    # ------------------------------------------------------------------
    # call interception
    # ------------------------------------------------------------------

    _FANOUT_CALLS = {
        "Row", "Union", "Intersect", "Difference", "Xor", "Not", "Shift",
        "Range", "All", "Count", "Sum", "Min", "Max", "MinRow", "MaxRow",
        "Rows", "GroupBy", "ClearRow", "Store",
    }

    def count_lowering_class(self, index_name: str, query) -> str:
        """The Count batcher's round key: "local" on one node, "fanout" in
        a cluster (the reference's "mesh" class is not ported)."""
        return "local" if self._is_single_node() else "fanout"

    def _execute_count_batch(self, idx: Index, calls: List[Call], shards, opt: Optional[ExecOptions] = None):
        """A run of adjacent Counts across the cluster in one round: each
        owner node gets every call in one request over its shards and
        answers them with one plan_count_multi launch (the local node
        through the base class directly); the per-node counts add up.
        None when the calls disagree on their shard lists (Shift) or a
        node has no stacked form for them: per-call fan-out instead."""
        if (opt is not None and opt.remote) or self._is_single_node():
            return super()._execute_count_batch(idx, calls, shards, opt)
        lists = [self._shards_for(idx, shards, c) for c in calls]
        if any(lst != lists[0] for lst in lists[1:]):
            return None
        pql = "\n".join(str(c) for c in calls)

        def leg(node_id, node_shards, timeout, deadline):
            if node_id == self.local_id:
                counts = Executor._execute_count_batch(self, idx, calls, node_shards, ExecOptions(remote=True))
                if counts is None:
                    counts = [
                        Executor._execute_call(self, idx, c, node_shards, ExecOptions(remote=True)) for c in calls
                    ]
                return counts
            return self._remote_results(idx, pql, node_id, node_shards, False, timeout, deadline)

        totals = [0] * len(calls)
        for counts in self._fan_out(idx, calls[0], shards, leg=leg):
            for i, n in enumerate(counts):
                totals[i] += int(n)
        return totals

    def _execute_call(self, idx: Index, c: Call, shards, opt: ExecOptions):
        if opt.remote and c.name in ("Set", "Clear") and not self._is_single_node():
            self._check_owner(idx, c)
        if opt.remote or self._is_single_node():
            return super()._execute_call(idx, c, shards, opt)
        name = c.name
        if name in ("Set", "Clear"):
            return self._execute_write_by_column(idx, c)
        if name in ("SetRowAttrs", "SetColumnAttrs"):
            # attributes replicate to every node
            super()._execute_call(idx, c, shards, ExecOptions(remote=True))
            self._broadcast_call(idx, c)
            return None
        if name == "Options":
            return super()._execute_call(idx, c, shards, opt)
        if name == "TopN":
            return self._execute_topn_distributed(idx, c, shards, opt)
        if name in self._FANOUT_CALLS:
            leg_call = c
            if name == "GroupBy" and c.uint_arg("offset"):
                # a leg cannot know which groups the offset skips: it
                # returns offset + limit groups and the reduce pages
                leg_call = Call(c.name, dict(c.args), list(c.children))
                offset = leg_call.args.pop("offset")
                if c.uint_arg("limit") is not None:
                    leg_call.args["limit"] = c.uint_arg("limit") + offset
            partials = self._fan_out(idx, leg_call, shards, write=name in ("ClearRow", "Store"))
            out = self._reduce(name, c, partials)
            if isinstance(out, Row):
                # attrs and exclusions attach on the coordinator only
                out = self._finish_bitmap_row(idx, c, out, opt)
            return out
        return super()._execute_call(idx, c, shards, opt)

    def _check_owner(self, idx: Index, c: Call) -> None:
        """A peer's Set/Clear leg for a shard this node does not own under
        its installed placement was routed by one a resize replaced: it is
        refused as retryable, so the shard's fragment does not come back
        here."""
        col = c.args.get("_col")
        if isinstance(col, int) and not isinstance(col, bool):
            shard = col // SHARD_WIDTH
            if not self._cluster().owns_shard(self.local_id, idx.name, shard):
                raise TransferCutover(f"shard {shard} of {idx.name} is not this node's under its placement (a resize moved it): retry")

    def _execute_write_by_column(self, idx: Index, c: Call) -> bool:
        """Route a one-column write by the installed placement, and again
        if a resize installed another meanwhile (Set and Clear are
        idempotent)."""
        for _ in range(3):
            cluster = self._cluster()
            changed = self._write_by_column_once(idx, c, cluster)
            if self._cluster().placement_key() == cluster.placement_key():
                break
        return changed

    def _write_by_column_once(self, idx: Index, c: Call, cluster: Cluster) -> bool:
        """A one-column write to every replica owner of its shard. This
        node's copy inside a resize's cutover barrier fails the write with
        TransferCutover (HTTP 503, the client retries), and so does every
        owner answering 503; a peer's 503 is retried by the client first."""
        col = c.args.get("_col")
        if not isinstance(col, int) or isinstance(col, bool):
            raise ExecError(f"{c.name}() column argument required")
        shard = col // SHARD_WIDTH
        owners = cluster.shard_nodes(idx.name, shard)
        changed = False
        errs = []
        failed_nodes = []
        cutover = 0
        for n in owners:
            if n.id == self.local_id and self._cluster().placement_key() != cluster.placement_key():
                continue  # routed by a replaced placement: the caller routes again
            try:
                if n.id == self.local_id:
                    r = super()._execute_call(idx, c, [shard], ExecOptions(remote=True))
                else:
                    r = self.client.query_node(
                        n.uri,
                        idx.name,
                        str(c),
                        shards=[shard],
                        remote=True,
                        timeout=self.query_deadline,
                        deadline=self.query_deadline,
                    )[0]
                changed = changed or bool(r)
            except TransferCutover:
                raise  # this node's copy is in a resize's cutover: the client retries
            except Exception as e:  # noqa: BLE001 - one replica's miss is debt
                errs.append(f"{n.id}: {e}")
                failed_nodes.append(n)
                cutover += getattr(e, "status", None) == 503
        if errs and len(errs) == len(owners):
            if cutover == len(owners):
                raise TransferCutover(f"{c.name}() shard {shard}: every owner is in a resize cutover, retry")
            raise RemoteError("; ".join(errs))
        # a replica missed this write: visible debt, not silent drift
        # (remote replicas only, and only where a second copy exists)
        dropped = [n for n in failed_nodes if n.id != self.local_id]
        if cluster.replica_n > 1:
            for n in dropped:
                # no debt when another placement is installed: the caller
                # routes the write again, to its owners
                if self._cluster().placement_key() == cluster.placement_key():
                    self.holder.record_pending_repair(idx.name, shard, n.id)
        if c.name == "Set":
            self._announce_written_shard(idx, c, shard)
        return changed

    def _announce_written_shard(self, idx: Index, c: Call, shard: int) -> None:
        """Make a shard a write created visible to every node's fan-out."""
        try:
            field_name = self._field_arg_name(c)
        except ExecError:
            return
        f = idx.field(field_name)
        if f is None or shard in f.remote_available_shards:  # announced already
            return
        f.add_remote_available([shard])
        msg = {"type": "available-shards", "index": idx.name, "field": field_name, "shards": [shard]}

        def send(n):
            try:
                self.client.send_message(n.uri, msg)
            except Exception:  # noqa: BLE001 - the next import announces again
                pass

        self._to_peers(send)

    def _broadcast_call(self, idx: Index, c: Call) -> None:
        pql = str(c)

        def send(n):
            try:
                self.client.query_node(
                    n.uri, idx.name, pql, shards=None, remote=True,
                    timeout=self.query_deadline, deadline=self.query_deadline,
                )
            except Exception:  # noqa: BLE001 - attr drift is anti-entropy's
                pass

        self._to_peers(send)

    def _to_peers(self, fn) -> None:
        """fn(node) for every live peer, concurrently: a slow peer must not
        stall a write."""
        peers = [n for n in self._cluster().nodes if n.id != self.local_id and n.state != NODE_STATE_DOWN]
        if not peers:
            return
        if len(peers) == 1:
            fn(peers[0])
            return
        list(self._fanout_pool().map(fn, peers))

    def _topn_fan_out(self, idx: Index, c: Call, shards) -> List[Pair]:
        """One TopN pass across the cluster: every node's untrimmed
        candidates with exact per-node counts, merged."""
        merged: Dict[int, int] = {}
        for p in self._fan_out(idx, c, shards):
            for pair in p or []:
                merged[int(pair.id)] = merged.get(int(pair.id), 0) + int(pair.count)
        pairs = [Pair(id=i, count=cnt) for i, cnt in merged.items()]
        pairs.sort(key=lambda p: (-p.count, p.id))
        return pairs

    def _execute_topn_distributed(self, idx: Index, c: Call, shards, opt: ExecOptions) -> List[Pair]:
        """The coordinator's two-pass TopN: pass 1 collects every node's
        candidates, pass 2 re-counts the merged candidate ids exactly on
        every node."""
        pairs = self._topn_fan_out(idx, c, shards)
        n = c.uint_arg("n")
        if not pairs or c.args.get("ids"):
            return pairs
        other = Call(c.name, dict(c.args), list(c.children))
        other.args["ids"] = sorted(p.id for p in pairs)
        trimmed = self._topn_fan_out(idx, other, shards)
        return trimmed[:n] if n else trimmed

    def _shards_for(self, idx: Index, shards, call: Optional[Call] = None) -> List[int]:
        """With no shard list, every shard the cluster knows of: local
        fragments and the shards peers announced."""
        if shards is not None:
            return super()._shards_for(idx, shards, call)
        return super()._shards_for(idx, idx.shard_list() or [0], call)

    # ------------------------------------------------------------------
    # Shift predecessors held by other nodes
    # ------------------------------------------------------------------

    def _foreign_shards(self, idx: Index, shards) -> List[int]:
        if self._is_single_node():
            return []
        cluster = self._cluster()
        return [s for s in shards if not cluster.owns_shard(self.local_id, idx.name, s)]

    def _read_owners(self, cluster: Cluster, index: str, shard: int) -> List[Any]:
        """The live owners of a shard in the order a read tries them: the
        placement's order, owners whose breaker is open last."""
        owners = [n for n in cluster.shard_nodes(index, shard) if n.state != NODE_STATE_DOWN]
        owners.sort(key=lambda n: n.id != self.local_id and self._breaker_open(n.uri))
        return owners

    @staticmethod
    def _leaf_texts(idx: Index, calls: List[Call]) -> List[str]:
        """The texts of the leaves under a Shift, as _StackedLowering keys
        its fills: each Row/Range call, and All() for the existence row
        that Not and All read. Only a Shift reads a predecessor's words
        into a listed shard; other leaves' predecessor rows stay unread."""
        out: Dict[str, None] = {}

        def walk(c: Call, shifted: bool) -> None:
            shifted = shifted or c.name == "Shift"
            if c.name in ("Row", "Range"):
                if shifted:
                    out[str(c)] = None
                return
            if c.name in ("Not", "All") and shifted and idx.track_existence:
                out["All()"] = None
            for ch in c.children:
                walk(ch, shifted)
            for v in c.args.values():
                if isinstance(v, Call):
                    walk(v, shifted)

        for c in calls:
            walk(c, False)
        return list(out)

    def _pred_fills(self, idx: Index, calls: List[Call], preds: List[int]):
        """Fetch the leaves' rows in the predecessor shards this node does
        not own: one request per owner, of every leaf over its shards (a
        leaf has no Shift, so the owner answers exactly those shards),
        failing over to the shard's next live owner."""
        foreign = self._foreign_shards(idx, preds)
        texts = self._leaf_texts(idx, calls) if foreign else []
        if not texts:
            return None
        cluster = self._cluster()
        pql = "\n".join(texts)
        order = {p: self._read_owners(cluster, idx.name, p) for p in foreign}
        fills: Dict[str, Dict[int, torch.Tensor]] = {t: {} for t in texts}
        pending = list(foreign)
        errors: List[str] = []
        while pending:
            by_node: Dict[str, List[int]] = {}
            for p in pending:
                if not order[p]:
                    raise ExecError(f"shard {p} unavailable for a Shift's carry: {'; '.join(errors)}")
                by_node.setdefault(order[p].pop(0).id, []).append(p)
            pending = []
            for node_id, node_shards in by_node.items():
                try:
                    rows = self.client.query_node(
                        self._uri_of(node_id), idx.name, pql, shards=node_shards, remote=True,
                        timeout=self.query_deadline, deadline=self.query_deadline, device=self.holder.device,
                    )
                except Exception as e:  # noqa: BLE001 - the next owner answers
                    errors.append(f"node {node_id}: {e}")
                    pending.extend(node_shards)
                    continue
                for text, row in zip(texts, rows):
                    for s, words in row.segments.items():
                        fills[text][int(s)] = words
        return fills

    # ------------------------------------------------------------------
    # the result cache across nodes
    # ------------------------------------------------------------------

    def _leg_reads(self, idx: Index, ctx) -> Dict[str, List[int]]:
        """Per node, the shards whose fragments the fan-out reads there:
        each leg's shards and the Shift predecessors its node owns, and
        each predecessor a leg fetches on the owner it fetches it from."""
        cluster = self._cluster()
        legs = cluster.shards_by_node(idx.name, list(ctx.shard_list))
        reads = {nid: set(shards) for nid, shards in legs.items()}
        k = self._count_shifts(ctx.call)
        for nid, shards in legs.items():
            for p in self._shift_preds(sorted(shards), k) if k else ():
                if cluster.owns_shard(nid, idx.name, p):
                    reads[nid].add(p)
                else:
                    owners = self._read_owners(cluster, idx.name, p)
                    if owners:
                        reads.setdefault(owners[0].id, set()).add(p)
        return {nid: sorted(shards) for nid, shards in reads.items()}

    def version_vector(self, idx: Index, ctx, opt: ExecOptions, expect=None):
        """The fan-out's vector: per node, the versions of the fragments
        the fan-out reads there (`_leg_reads`), the local part read
        directly and the peers' over one parallel /internal/versions
        round. None: not cacheable this time (a first sighting of the
        key, an unreachable peer, a local part that already differs from
        `expect`)."""
        if opt.remote or self._is_single_node():
            return super().version_vector(idx, ctx, opt)
        try:
            remaining = self._leg_reads(idx, ctx)
        except Exception:  # noqa: BLE001 - assembly is best effort
            return None
        parts: List[Any] = []
        rpc: List[tuple] = []
        for nid in sorted(remaining):
            node_shards = tuple(remaining[nid])
            if nid == self.local_id:
                parts.append(self.local_version_vector(idx, ctx.views, node_shards, node=nid))
            else:
                rpc.append((nid, node_shards))
                parts.append(None)
        if rpc:
            if expect is not None and not self._parts_match_expect(parts, expect, len(ctx.views)):
                return None
            # the peers' versions cost a round trip: only repeat keys pay it
            if not rcache.RESULT_CACHE.note_candidate(ctx.key):
                return None
            fetched = self._fetch_remote_versions(idx, ctx, rpc)
            if fetched is None:
                return None
            it = iter(fetched)
            parts = [next(it) if p is None else p for p in parts]
        out: List[tuple] = []
        for elems in parts:
            out.extend(elems)
        return tuple(out)

    def clock_vector(self, idx: Index, ctx, opt: ExecOptions):
        """The clock fast path holds where every clock is local (one node,
        remote legs); a coordinator's live on its peers."""
        if opt.remote or self._is_single_node():
            return super().clock_vector(idx, ctx, opt)
        return None

    @staticmethod
    def _parts_match_expect(parts, expect, views_per_node) -> bool:
        """Whether every part collected so far equals its slice of
        `expect` (one element a view per node)."""
        o = 0
        for p in parts:
            if p is not None and tuple(expect[o : o + views_per_node]) != p:
                return False
            o += views_per_node
        return True

    def _fetch_remote_versions(self, idx: Index, ctx, rpc):
        """One parallel /internal/versions round; None when a peer is
        unreachable or finds the call ineligible on its side."""

        def fetch(t):
            nid, node_shards = t
            try:
                resp = self.client.fragment_versions(self._uri_of(nid), idx.name, ctx.text, list(node_shards))
            except Exception:  # noqa: BLE001 - uncacheable this time
                return None
            if not isinstance(resp, dict) or resp.get("views") is None:
                return None
            boot = str(resp.get("boot", ""))
            try:
                shards = tuple(int(s) for s in resp.get("shards", node_shards))
                elems = []
                for item in resp["views"]:
                    if item[0] == "m":
                        elems.append(("m", nid, item[1], item[2]))
                    else:
                        elems.append(
                            ("v", nid, item[1], item[2], (boot, int(item[3])), shards, tuple(int(x) for x in item[4]))
                        )
                return tuple(elems)
            except Exception:  # noqa: BLE001 - a malformed peer payload
                return None

        if len(rpc) == 1:
            fetched = [fetch(rpc[0])]
        else:
            fetched = list(self._fanout_pool().map(fetch, rpc))
        if any(f is None for f in fetched):
            return None
        return fetched

    def versions_payload(self, index_name: str, pql: str, shards):
        """Serve /internal/versions: this node's version vector of one call
        over exactly `shards` (the coordinator lists the fragments read
        here). (shard_list, elements), or None when the call is
        ineligible."""
        idx = self.holder.index(index_name)
        if idx is None:
            return None
        try:
            q = parse(pql)
        except ParseError:
            return None
        if len(q.calls) != 1:
            return None
        c = q.calls[0]
        shard_list = tuple(sorted(int(s) for s in shards))
        ctx = self._cache_spec(idx, c, list(shard_list), ExecOptions(remote=True), reads=shard_list)
        if ctx is None:
            return None
        out = []
        for elem in self.local_version_vector(idx, ctx.views, shard_list):
            if elem[0] == "m":
                out.append(["m", elem[2], elem[3]])
            else:
                out.append(["v", elem[2], elem[3], elem[4], list(elem[6])])
        return list(shard_list), out
