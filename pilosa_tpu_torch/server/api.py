"""API: every operation of one node as a validated method.

The port of pilosa_tpu/server/api.py, without tiering and
subscriptions: query (parse, then execute), schema DDL, the imports
(bits, values, roaring), the exports, the status reads, the cluster
messages and the membership changes (join, remove-node, abort, the job
record, set-coordinator), bound to the port's Holder and (distributed)
Executor.
On a durable holder an import returns once one group commit made all of
its writes durable, and a delete removes the index's or field's files.
String row and column keys in imports translate through the field's and
the index's key stores, and the CSV export writes keys where there are
some. A query is admitted first (sched/admission.py: a concurrency
slot, or a wait in the bounded queue, or a shed as HTTP 429), then a
pure-Count request goes through the Count batcher (exec/batcher.py),
which merges concurrent ones into one multi-root dispatch, and anything
else to the executor, whose result cache serves repeats
(core/resultcache.py).

In a cluster DDL is broadcast to every peer, an import splits by shard
owner (the local share applies at once, each peer gets one frame of
every shard it owns, over the node's import pool) and forwards with
`remote=1`, and a shard an import or a Set created is announced to every
node. A missing replica is not an error while another owner took the
write: it is pending-repair debt, counted in /status and repaid by
anti-entropy (server/node.py `sync_holder`). While the cluster
is DEGRADED every method stays open except the schema deletes, which a
down node could never learn of (DisabledError, HTTP 503); while it is
RESIZING only reads are. A fragment inside a resize's cutover barrier
refuses writes with TransferCutover (HTTP 503 with Retry-After), and an
import shard whose every owner answered so fails the same way, so the
client retries the import. Tracing and
statistics come in later slices; a request that needs one of them (the
`profile` query option) is an ApiError naming what is missing (HTTP 400).
"""

from __future__ import annotations

import dataclasses
import io
import os
import re
import uuid
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.cluster.topology import STATE_DEGRADED, STATE_NORMAL, STATE_RESIZING, Node
from pilosa_tpu_torch.core import roaring_io
from pilosa_tpu_torch.core import wal as walmod
from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.field import FIELD_TYPE_SET, FIELD_TYPE_TIME, FieldOptions
from pilosa_tpu_torch.core.fragment import TransferCutover
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.exec import batcher as batchmod
from pilosa_tpu_torch.exec.executor import ExecOptions, NotFoundError, QueryResponse
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.sched import admission as admod
from pilosa_tpu_torch.sched import cost as costmod
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WIDTH_EXPONENT
from pilosa_tpu_torch.utils.arrays import group_slices


class ApiError(Exception):
    pass


class DisabledError(ApiError):
    """An operation the cluster's state does not allow (HTTP 503)."""


# the header a shed query's trace id rides in (the reference's)
TRACE_HEADER = "X-Pilosa-Trace-Id"


_VIEW_NAME_RE = re.compile(r"[a-z][a-z0-9_]{0,63}")


def _validate_view_name(view: str) -> None:
    """View names become path components in durable holders; anything
    else is rejected, as in the reference."""
    if not _VIEW_NAME_RE.fullmatch(view):
        raise ApiError(f"invalid view name: {view!r}")


class API:
    def __init__(self, server: "NodeServer"):  # noqa: F821
        self.server = server

    @property
    def holder(self):
        return self.server.holder

    @property
    def cluster(self):
        return self.server.cluster

    def _check_write_count(self, n: int) -> None:
        """Reject an import larger than max-writes-per-request (HTTP 400):
        clients are expected to batch."""
        limit = self.server.max_writes_per_request
        if limit and n > limit:
            raise ApiError(
                f"import of {n} writes exceeds max-writes-per-request "
                f"({limit}); split the request into smaller batches"
            )

    def _validate(self, method: str, write: bool = False) -> None:
        """DEGRADED keeps every method of NORMAL except the schema deletes:
        the rejoin repair (a schema push) only adds, so a node that was
        down would never learn of the delete. RESIZING keeps the queries
        that do not write."""
        state = self.server.state
        if state == STATE_NORMAL:
            return
        if state == STATE_DEGRADED:
            if method in ("delete_index", "delete_field"):
                raise DisabledError(f"api method {method!r} not allowed in state {state}: a down node would never learn the delete")
            return
        if state == STATE_RESIZING and method == "query" and not write:
            return
        raise DisabledError(f"api method {method!r} not allowed in state {state}")

    def _broadcast(self, message: dict) -> None:
        """Send a cluster message to every peer."""
        for n in self.cluster.nodes:
            if n.id == self.server.node.id:
                continue
            try:
                self.server.client.send_message(n.uri, message)
            except Exception:  # noqa: BLE001 - the rejoin schema push repairs
                self.server.logger(f"broadcast {message.get('type')} to {n.id} failed")

    def _index_field(self, index: str, field: str):
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        f = idx.field(field)
        if f is None:
            raise NotFoundError(f"field not found: {field}")
        return idx, f

    # -- query ---------------------------------------------------------------

    def query_response(
        self,
        index: str,
        query: str,
        shards: Optional[Sequence[int]] = None,
        headers: Optional[dict] = None,
        column_attrs: bool = False,
        exclude_row_attrs: bool = False,
        exclude_columns: bool = False,
        profile: bool = False,
        remote: bool = False,
    ) -> QueryResponse:
        """Parse the PQL (a ParseError is a 400), admit it (a ShedError is
        a 429; the priority class and the remaining deadline come from the
        X-Pilosa-Priority and X-Pilosa-Deadline headers, and a remote leg
        of a peer's fan-out has a lane of its own), then execute it with
        the query options: row attrs on Row results unless
        `exclude_row_attrs`, no columns with `exclude_columns`, and the
        response's column attr sets with `column_attrs`. Everything past
        admission runs under the ticket's try/finally. `profile` is an
        ApiError: query tracing is not ported."""
        if profile:
            raise ApiError("profile: query tracing is not yet ported")
        self._validate("query")
        query = parse(query)
        opt = ExecOptions(
            remote=remote,
            column_attrs=column_attrs,
            exclude_row_attrs=exclude_row_attrs,
            exclude_columns=exclude_columns,
        )
        # a shed names the trace id the query would have run under
        trace_id = (headers.get(TRACE_HEADER) if headers else None) or uuid.uuid4().hex[:16]
        try:
            ticket = self._admit(index, query, shards, headers, opt)
        except admod.ShedError as e:
            if not e.trace_id:
                e.trace_id = trace_id
            raise
        try:
            resp = self._query_batched(index, query, shards, opt)
            if ticket is not None:
                # past the batcher: no longer anyone's batch mate
                ticket.done_batching()
            if resp is None:
                resp = self.server.executor.execute_response(index, query, shards=shards, opt=opt)
            return resp
        finally:
            if ticket is not None:
                ticket.release()

    def _admit(self, index, query, shards, headers, opt):
        """Estimate the query's device cost and block until the scheduler
        grants a slot (or raise ShedError). Returns the Ticket to release,
        or None when admission is off (max-concurrent-queries 0). A remote
        leg defaults to the internal class and rides the leg lane: a
        coordinator holds its own slot while it waits for its legs."""
        scheduler = self.server.scheduler
        if scheduler is None:
            return None
        cls = deadline = None
        if headers is not None:
            cls = headers.get(admod.PRIORITY_HEADER)
            raw = headers.get(admod.DEADLINE_HEADER)
            if raw:
                try:
                    deadline = float(raw)
                except ValueError:
                    deadline = None
        if opt.remote and not cls:
            cls = admod.CLASS_INTERNAL
        idx = self.holder.index(index)
        qcost = costmod.estimate(idx, query, shards)
        # only batcher-bound traffic feeds the batcher's hold hint: the
        # predicate the routing in _query_batched uses
        batchable = batchmod.batch_eligible(query, shards, opt)
        if not qcost.write and not opt.remote and len(self.cluster.nodes) <= 1:
            # a query about to wait has its extents staged meanwhile (on
            # one node: a leg's shards are warmed by its own node)
            scheduler.maybe_prefetch(lambda: self.server.executor.warm(index, query, shards), index=index)
        return scheduler.admit(
            cls=cls, cost=qcost, deadline=deadline, batchable=batchable, index=index, leg=opt.remote
        )

    def _query_batched(self, index, query, shards, opt) -> Optional[QueryResponse]:
        """A pure-Count request through the group-commit batcher: the
        response, or None when the request is not batchable."""
        if not batchmod.batch_eligible(query, shards, opt):
            return None
        results = self.server.count_batcher.run(
            index,
            query,
            lambda merged: self.server.executor.execute_response(
                index, merged, shards=None, opt=dataclasses.replace(opt)
            ).results,
        )
        return QueryResponse(results=results)

    # -- schema DDL ----------------------------------------------------------

    def create_index(self, name: str, keys: bool = False, track_existence: bool = True, broadcast: bool = True):
        self._validate("create_index", write=True)
        idx = self.holder.create_index_if_not_exists(name, keys=keys, track_existence=track_existence)
        self.server.wire_translation()
        if broadcast:
            self._broadcast({"type": "create-index", "index": name, "keys": keys, "trackExistence": track_existence})
        return idx

    def delete_index(self, name: str, broadcast: bool = True) -> None:
        self._validate("delete_index", write=True)
        try:
            self.holder.delete_index(name)
        except KeyError:
            pass
        self.server.drop_index(name)
        if broadcast:
            self._broadcast({"type": "delete-index", "index": name})

    def create_field(self, index: str, name: str, options: Optional[dict] = None, broadcast: bool = True):
        self._validate("create_field", write=True)
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        f = idx.create_field_if_not_exists(name, FieldOptions(**(options or {})))
        self.server.wire_translation()
        if broadcast:
            self._broadcast({"type": "create-field", "index": index, "field": name, "options": options or {}})
        return f

    def delete_field(self, index: str, name: str, broadcast: bool = True) -> None:
        self._validate("delete_field", write=True)
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        try:
            idx.delete_field(name)
        except KeyError:
            pass
        if broadcast:
            self._broadcast({"type": "delete-field", "index": index, "field": name})

    def schema(self) -> List[dict]:
        return self.holder.schema()

    def apply_schema(self, schema: List[dict]) -> None:
        """Create every index and field of a schema dump that is missing
        (no broadcast: the rejoin repair sends one to each node)."""
        self._validate("apply_schema", write=True)
        for ix in schema:
            opts = ix.get("options", {})
            idx = self.holder.create_index_if_not_exists(
                ix["name"],
                keys=opts.get("keys", False),
                track_existence=opts.get("trackExistence", True),
            )
            for fd in ix.get("fields", []):
                options = _field_options_from_json(fd.get("options", {}))
                idx.create_field_if_not_exists(fd["name"], options)
        self.server.wire_translation()

    # -- imports -------------------------------------------------------------

    def import_bits(
        self,
        index: str,
        field: str,
        rows: Sequence,
        cols: Sequence,
        clear: bool = False,
        timestamps: Optional[Sequence] = None,
        local_only: bool = False,
    ) -> dict:
        """Bulk set-bit import; `timestamps` (strings or unix seconds, None
        for none) fan a time field's bits into its unit views. In a
        cluster the bits go to every owner of their shard (`local_only`:
        a peer's frame, applied here only). Returns {"applied",
        "expected", "errors"}: owner applications made and wanted, and
        what each missing replica said."""
        self._validate("import_bits", write=True)
        if not local_only:  # a replica frame is a slice of a capped request
            self._check_write_count(len(cols))
        idx, f = self._index_field(index, field)
        rows, cols = _translate_import(idx, f, rows, cols)

        def parse_ts(ts):
            return None if ts is None else [None if t is None else timeq.parse_time(t) for t in ts]

        def local_apply(sel, ts):
            with walmod.GROUP_COMMIT.barrier():
                f.import_bits(rows[sel], cols[sel], timestamps=parse_ts(ts), clear=clear)
                idx.track_columns(cols[sel])

        def ship(n, sel, ts, shard):
            self.server.client.import_bits(n.uri, idx.name, f.name, shard, rows[sel], cols[sel], clear, timestamps=ts)

        return self._import_routed(idx, f, cols, timestamps, local_apply, ship, "import", local_only)

    def import_values(
        self, index: str, field: str, cols: Sequence, values: Sequence[int], local_only: bool = False
    ) -> dict:
        self._validate("import_values", write=True)
        if not local_only:
            self._check_write_count(len(cols))
        idx, f = self._index_field(index, field)
        _, cols = _translate_import(idx, f, None, cols)
        values = np.asarray(values, dtype=np.int64)

        def local_apply(sel, _ts):
            with walmod.GROUP_COMMIT.barrier():
                f.import_values(cols[sel], values[sel])
                idx.track_columns(cols[sel])

        def ship(n, sel, _ts, shard):
            self.server.client.import_values(n.uri, idx.name, f.name, shard, cols[sel], values[sel])

        return self._import_routed(idx, f, cols, None, local_apply, ship, "import-value", local_only)

    def _owns_all(self, index: str, shards) -> None:
        """A peer's frame or leg writes only shards this node owns under
        its installed placement; one routed by a placement a resize has
        since replaced is refused as retryable (TransferCutover, 503), so
        no fragment comes back on a node that gave its shard up."""
        cl = self.cluster
        if len(cl.nodes) <= 1:
            return
        me = self.server.node.id
        for s in np.unique(np.asarray(shards, np.uint64)).tolist():
            if not cl.owns_shard(me, index, int(s)):
                raise TransferCutover(f"shard {s} of {index} is not this node's under its placement (a resize moved it): retry")

    def _import_routed(self, idx, f, cols, timestamps, local_apply, ship, kind: str, local_only: bool) -> dict:
        """Apply an import's local share and ship each peer one frame of
        every shard it owns, concurrently on the node's import pool. A
        peer that fails costs pending-repair debt for its shards (with
        replicas) and an error entry each; a shard no owner took raises
        after the shards that did apply are announced. A resize that
        installs another placement meanwhile makes the import run again
        under it (the writes are idempotent), so no owner of the new
        placement misses it."""
        shards = cols >> np.uint64(SHARD_WIDTH_EXPONENT)
        if local_only or len(self.cluster.nodes) <= 1:
            if local_only:
                self._owns_all(idx.name, shards)
            local_apply(slice(None), timestamps)
            n = len(np.unique(shards))
            return {"applied": n, "expected": n, "errors": []}
        for _ in range(3):
            cl = self.cluster
            summary = self._import_once(cl, idx, f, cols, shards, timestamps, local_apply, ship, kind)
            if self.cluster.placement_key() == cl.placement_key():
                break
        return summary

    def _import_once(self, cl, idx, f, cols, shards, timestamps, local_apply, ship, kind: str) -> dict:
        """One routing of an import by the placement of `cl`."""
        summary = {"applied": 0, "expected": 0, "errors": []}
        groups = [(int(s), sl) for s, sl in group_slices(shards)]
        applied = {s: 0 for s, _ in groups}
        errors: Dict[int, List[str]] = {s: [] for s, _ in groups}
        owner_errs: Dict[int, list] = {s: [] for s, _ in groups}
        local, by_node = [], {}
        for s, sl in groups:
            owners = cl.shard_nodes(idx.name, s)
            summary["expected"] += len(owners)
            for n in owners:
                if n.id == self.server.node.id:
                    local.append((s, sl))
                else:
                    by_node.setdefault(n.id, (n, []))[1].append((s, sl))

        def frame(gs):
            sel = np.concatenate([sl for _, sl in gs])
            ts = None if timestamps is None else [timestamps[i] for i in sel.tolist()]
            return sel, ts

        futures = []
        for n, gs in by_node.values():
            sel, ts = frame(gs)
            futures.append((n, gs, self.server.import_pool.submit(ship, n, sel, ts, gs[0][0])))
        if local and self.cluster.placement_key() == cl.placement_key():  # else the caller routes again
            local_apply(*frame(local))
            for s, _ in local:
                applied[s] += 1
        from pilosa_tpu_torch.server.client import ClientError

        for n, gs, fut in futures:
            try:
                fut.result()
                for s, _ in gs:
                    applied[s] += 1
            except ClientError as e:
                for s, _ in gs:
                    errors[s].append(f"{n.id}: {e}")
                    owner_errs[s].append(e)
                    # no debt when another placement is installed: the
                    # caller routes the import again, to its owners
                    if cl.replica_n > 1 and self.cluster.placement_key() == cl.placement_key():
                        self.holder.record_pending_repair(idx.name, s, n.id)
                self.server.logger(f"{kind} shards {sorted(s for s, _ in gs)} to replica {n.id} failed: {e}")
        failed = [(s, errors[s]) for s, _ in groups if not applied[s]]
        if failed and self.cluster.placement_key() != cl.placement_key():
            return summary  # the caller routes the import again
        for s, _ in groups:
            if applied[s]:
                summary["applied"] += applied[s]
                summary["errors"] += errors[s]
        done = [s for s, _ in groups if applied[s]]
        if done:
            self._announce_shards(idx.name, f.name, done)
        if failed:
            shard, errs = failed[0]
            if all(e.status == 503 for e in owner_errs[shard]):
                # every owner was inside a resize's cutover barrier: retryable
                raise TransferCutover(f"{kind} shard {shard}: every owner is in a resize cutover, retry: {errs}")
            raise ApiError(f"{kind} shard {shard}: no owner reachable: {errs}")
        return summary

    def apply_block_deltas(self, index: str, field: str, view: str, shard: int, sets, clears) -> None:
        """An anti-entropy merge's set and clear deltas, each (rows, cols),
        applied to this node's fragment (made if missing)."""
        _, f = self._index_field(index, field)
        _validate_view_name(view)
        f._view_create(view).fragment(shard).apply_deltas(sets, clears)

    def import_roaring(
        self,
        index: str,
        field: str,
        shard: int,
        data: bytes,
        clear: bool = False,
        view: Optional[str] = None,
        local_only: bool = False,
    ) -> int:
        """Bulk ingest of a serialized roaring bitmap (either dialect)
        whose positions are fragment positions row * SHARD_WIDTH + col %
        SHARD_WIDTH, unioned (or cleared) in one batch, into the standard
        view or a named (time) view, on every owner of the shard
        (`local_only`: here only, a peer's forward). Set and time fields
        only: the mutex and BSI layouts need the parsing imports. Returns
        the most bits that changed on any owner reached."""
        self._validate("import_roaring", write=True)
        idx, f = self._index_field(index, field)
        if f.options.type not in (FIELD_TYPE_SET, FIELD_TYPE_TIME):
            raise ApiError(f"cannot import roaring into {f.options.type} field {field!r}")
        view = view or VIEW_STANDARD
        _validate_view_name(view)
        changed = 0
        if local_only:
            self._owns_all(idx.name, [shard])
        owners = [self.server.node] if local_only else self.cluster.shard_nodes(idx.name, shard)
        for n in owners:
            if n.id != self.server.node.id:
                changed = max(
                    changed, self.server.client.import_roaring(n.uri, index, field, shard, data, clear=clear, view=view)
                )
                continue
            positions = roaring_io.decode(data)
            frag = f._view_create(view).fragment(shard)
            with walmod.GROUP_COMMIT.barrier():
                if clear:
                    _, local_changed = frag.import_positions(None, positions)
                else:
                    local_changed, _ = frag.import_positions(positions, None)
                    if len(positions):
                        seen = np.zeros(SHARD_WIDTH, bool)
                        seen[positions % np.uint64(SHARD_WIDTH)] = True
                        idx.track_columns(np.flatnonzero(seen).astype(np.uint64) + np.uint64(shard * SHARD_WIDTH))
            changed = max(changed, local_changed)
        if not local_only and len(self.cluster.nodes) > 1:
            self._announce_shards(index, field, [shard])
        return changed

    def _announce_shards(self, index: str, field: str, shards: List[int]) -> None:
        """Tell every node the shards exist, so each node's fan-out covers
        them: one message for a whole import."""
        msg = {"type": "available-shards", "index": index, "field": field, "shards": list(shards)}
        self.receive_message(msg)
        self._broadcast(msg)

    # -- exports -------------------------------------------------------------

    def export_roaring(self, index: str, field: str, shard: int, view: Optional[str] = None) -> bytes:
        """One fragment as a pilosa-dialect roaring file (the inverse of
        import_roaring)."""
        self._validate("export_roaring")
        _, f = self._index_field(index, field)
        if view is not None:
            _validate_view_name(view)
        v = f.view(view or VIEW_STANDARD)
        frag = v.fragment_if_exists(shard) if v is not None else None
        if frag is None:
            return roaring_io.encode(np.empty(0, dtype=np.uint64))
        rows, cols = frag.pairs()
        return roaring_io.encode(rows * np.uint64(SHARD_WIDTH) + cols)

    def export_csv(self, index: str, field: str, shard: Optional[int] = None) -> str:
        """"row,column" lines of the standard view, shard by shard; a
        keyed field writes row keys, a keyed index column keys (the id
        where an id has no key)."""
        self._validate("export_csv")
        idx, f = self._index_field(index, field)
        v = f.view(VIEW_STANDARD)
        if v is None:
            return ""
        out = io.StringIO()
        for s in [shard] if shard is not None else sorted(v.fragments):
            frag = v.fragment_if_exists(s)
            if frag is None:
                continue
            rows, cols = frag.pairs()
            rows = rows.tolist()
            cols = (cols + np.uint64(s * SHARD_WIDTH)).tolist()
            rkeys = f.translate_store.keys_for_ids(rows) if f.options.keys else [None] * len(rows)
            ckeys = idx.translate_store.keys_for_ids(cols) if idx.keys else [None] * len(cols)
            for r, c, rk, ck in zip(rows, cols, rkeys, ckeys):
                out.write(f"{rk if rk is not None else r},{ck if ck is not None else c}\n")
        return out.getvalue()

    def recalculate_caches(self) -> None:
        """Rebuild every rank cache of the node and ask every peer to."""
        self._validate("recalculate_caches")
        self.holder.recalculate_caches()
        self._broadcast({"type": "recalculate-caches"})

    # -- membership changes ----------------------------------------------------

    def cluster_join(self, node: dict) -> dict:
        """Admit a node: the coordinator starts a resize job that adds it.
        Returns the job record (poll resize_job); a known member's join is
        a no-op."""
        self._validate("cluster_join", write=True)
        joiner = Node.from_json(node)
        if not joiner.id or not joiner.uri:
            raise ApiError("join requires node id and uri")
        # a fresh node calls itself a coordinator; it joins as a member
        joiner.is_coordinator = False
        cur = self.server.cluster.nodes
        if any(n.id == joiner.id for n in cur):
            return {"state": "DONE", "action": "noop", "nodes": [n.to_json() for n in cur]}
        from pilosa_tpu_torch.server.client import ClientError

        try:
            return self.server.start_resize(list(cur) + [joiner], "add-node")
        except ClientError as e:
            raise ApiError(str(e))

    def remove_node(self, node_id: str) -> dict:
        """A resize job without `node_id` (a dead node too). Removing the
        coordinator hands its role to the first remaining node."""
        self._validate("remove_node", write=True)
        cur = self.server.cluster.nodes
        if not any(n.id == node_id for n in cur):
            raise NotFoundError(f"node not in cluster: {node_id}")
        remaining = [
            Node(id=n.id, uri=n.uri, is_coordinator=n.is_coordinator, mesh_group=n.mesh_group)
            for n in cur
            if n.id != node_id
        ]
        if not remaining:
            raise ApiError("cannot remove the last node")
        if not any(n.is_coordinator for n in remaining):
            remaining[0].is_coordinator = True
        from pilosa_tpu_torch.server.client import ClientError

        try:
            return self.server.start_resize(remaining, "remove-node")
        except ClientError as e:
            raise ApiError(str(e))

    def resize_abort(self) -> dict:
        return self.server.abort_resize()

    def resize_job(self) -> dict:
        return self.server.resize_job or {"state": "NONE"}

    def set_coordinator(self, node_id: str) -> dict:
        """Hand the coordinator role to `node_id`: every member must
        acknowledge the new membership, or the old one is put back
        everywhere (two coordinators would be two key-translation
        writers)."""
        self._validate("set_coordinator", write=True)
        cur = self.cluster.nodes
        if not any(n.id == node_id for n in cur):
            raise NotFoundError(f"node not in cluster: {node_id}")

        def copy(coord):
            return [
                Node(id=n.id, uri=n.uri, is_coordinator=coord(n), state=n.state, mesh_group=n.mesh_group) for n in cur
            ]

        members = copy(lambda n: n.id == node_id)
        old = copy(lambda n: n.is_coordinator)
        from pilosa_tpu_torch.server.client import ClientError

        try:
            self.server._send_status(members, members, self.cluster.replica_n, self.server.state, require=True)
        except ClientError as e:
            self.server._send_status(old, old, self.cluster.replica_n, self.server.state, retries=10)
            raise ApiError(f"set-coordinator rolled back: {e}")
        return {"coordinator": node_id}

    # -- node info -----------------------------------------------------------

    def status(self) -> dict:
        return {
            "state": self.server.state,
            "localID": self.server.node.id,
            "clusterID": self.server.cluster_name,
            "nodes": [n.to_json() for n in self.cluster.nodes],
            # replica writes this node's fan-outs dropped, awaiting repair
            "pendingRepairs": self.holder.pending_repair_count(),
            "walStagedPositions": self.holder.staged_position_count(),
            # peer URI -> circuit state: the peers this node shuns
            "breakers": self.server.breakers.snapshot(),
            "health": "/cluster/health",
        }

    def hosts(self) -> List[dict]:
        return [n.to_json() for n in self.cluster.nodes]

    def version(self) -> str:
        return __version__

    def info(self) -> dict:
        """Shard width and CPU counts (physical cores from /proc/cpuinfo
        where it can be read)."""
        logical = os.cpu_count() or 1
        physical = logical
        try:
            pairs = set()
            with open("/proc/cpuinfo") as f:
                phys = core = None
                for line in f:
                    if line.startswith("physical id"):
                        phys = line.split(":")[1].strip()
                    elif line.startswith("core id"):
                        core = line.split(":")[1].strip()
                    elif not line.strip() and phys is not None:
                        pairs.add((phys, core))
                        phys = core = None
            if pairs:
                physical = len(pairs)
        except OSError:
            pass
        return {"shardWidth": SHARD_WIDTH, "cpuPhysicalCores": physical, "cpuLogicalCores": logical}

    def index_info(self, name: str) -> dict:
        idx = self.holder.index(name)
        if idx is None:
            raise NotFoundError(f"index not found: {name}")
        return {
            "name": idx.name,
            "options": {"keys": idx.keys, "trackExistence": idx.track_existence},
            "shardWidth": SHARD_WIDTH,
            "fields": [f.name for f in idx.fields()],
        }

    def shard_nodes(self, index: str, shard: int) -> List[dict]:
        """The owners of a shard of an index, primary first."""
        return [n.to_json() for n in self.cluster.shard_nodes(index, shard)]

    def max_shards(self) -> Dict[str, int]:
        """Per index, one past its highest shard (0 when it has none)."""
        out = {}
        for idx in self.holder.indexes():
            av = idx.available_shards()
            out[idx.name] = (max(av) + 1) if av else 0
        return out

    # -- cluster messages ------------------------------------------------------

    def receive_message(self, msg: dict) -> dict:
        """Apply one cluster message (POST /internal/cluster/message)."""
        t = msg.get("type")
        if t == "create-index":
            self.holder.create_index_if_not_exists(
                msg["index"], keys=msg.get("keys", False), track_existence=msg.get("trackExistence", True)
            )
            self.server.wire_translation()
        elif t == "delete-index":
            try:
                self.holder.delete_index(msg["index"])
            except KeyError:
                pass
            self.server.drop_index(msg["index"])
        elif t == "create-field":
            idx = self.holder.index(msg["index"])
            if idx is not None:
                idx.create_field_if_not_exists(msg["field"], FieldOptions(**msg.get("options", {})))
            self.server.wire_translation()
        elif t == "delete-field":
            idx = self.holder.index(msg["index"])
            if idx is not None:
                try:
                    idx.delete_field(msg["field"])
                except KeyError:
                    pass
        elif t == "available-shards":
            idx = self.holder.index(msg["index"])
            f = idx.field(msg["field"]) if idx is not None else None
            if f is not None:
                f.add_remote_available(msg["shards"])
        elif t == "cluster-status":
            self.server.apply_cluster_status(msg)
        elif t == "node-state":
            self.server.set_node_state(msg["node"], msg["state"])
        elif t == "recalculate-caches":
            self.holder.recalculate_caches()
        elif t == "clean-holder":
            self.server.clean_holder()
        elif t == "resize-quiesce":
            # the cutover barrier on this job's captured fragments
            self.server.quiesce_job_captures(msg.get("job", ""), float(msg.get("ttl", 30.0)))
        elif t == "resize-release":
            # the committed job's teardown: captures end, fragments stay
            self.server.release_job_captures(msg.get("job"))
        elif t == "resize-cleanup":
            # the rollback: what the job created here goes
            self.server.resize_cleanup(msg.get("job", ""), aborting=True)
        else:
            raise ApiError(f"unknown cluster message type {t!r}")
        return {"ok": True}


def _translate_import(idx, f, rows: Optional[Sequence[Any]], cols: Sequence[Any]):
    """Row and column ids as uint64 arrays: string keys (judged by the
    first entry) translate through the field's or the index's key store,
    allocating ids for new keys."""
    if rows is not None:
        if len(rows) and isinstance(rows[0], str):
            if not f.options.keys:
                raise ApiError("row keys on an unkeyed field")
            rows = f.translate_store.translate_keys(list(rows))
        rows = np.asarray(rows, dtype=np.uint64)
    if len(cols) and isinstance(cols[0], str):
        if not idx.keys:
            raise ApiError("column keys on an unkeyed index")
        cols = idx.translate_store.translate_keys(list(cols))
    return rows, np.asarray(cols, dtype=np.uint64)


def _field_options_from_json(o: dict) -> FieldOptions:
    """FieldOptions from the public camelCase option names (snake_case
    accepted too)."""
    return FieldOptions(
        type=o.get("type", "set"),
        cache_type=o.get("cacheType", o.get("cache_type", "ranked")),
        cache_size=o.get("cacheSize", o.get("cache_size", 50000)),
        min=o.get("min", 0),
        max=o.get("max", 0),
        time_quantum=o.get("timeQuantum", o.get("time_quantum", "")),
        keys=o.get("keys", False),
        no_standard_view=o.get("noStandardView", o.get("no_standard_view", False)),
    )
