"""API: every operation of one node as a validated method.

The port's single-node slice of pilosa_tpu/server/api.py: query (parse,
then execute), schema DDL, the imports (bits, values, roaring), the
exports and the status reads, bound to the port's Holder and Executor.
On a durable holder an import returns once one group commit made all of
its writes durable, and a delete removes the index's or field's files.
String row and column keys in imports translate through the field's and
the index's key stores, and the CSV export writes keys where there are
some. A query is admitted first (sched/admission.py: a concurrency
slot, or a wait in the bounded queue, or a shed as HTTP 429), then a
pure-Count request goes through the Count batcher (exec/batcher.py),
which merges concurrent ones into one multi-root dispatch, and anything
else to the executor, whose result cache serves repeats
(core/resultcache.py). Tracing, statistics and every multi-node branch
come in later slices; a request that needs one of them (the `profile`
query option) is an ApiError naming what is missing (HTTP 400).
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
from pilosa_tpu_torch.core import roaring_io
from pilosa_tpu_torch.core import wal as walmod
from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.field import FIELD_TYPE_SET, FIELD_TYPE_TIME, FieldOptions
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.exec import batcher as batchmod
from pilosa_tpu_torch.exec.executor import ExecOptions, NotFoundError, QueryResponse
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.sched import admission as admod
from pilosa_tpu_torch.sched import cost as costmod
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WIDTH_EXPONENT

class ApiError(Exception):
    pass


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
    ) -> QueryResponse:
        """Parse the PQL (a ParseError is a 400), admit it (a ShedError is
        a 429; the priority class and the remaining deadline come from the
        X-Pilosa-Priority and X-Pilosa-Deadline headers), then execute it
        with the query options: row attrs on Row results unless
        `exclude_row_attrs`, no columns with `exclude_columns`, and the
        response's column attr sets with `column_attrs`. Everything past
        admission runs under the ticket's try/finally. `profile` is an
        ApiError: query tracing is not ported."""
        if profile:
            raise ApiError("profile: query tracing is not yet ported")
        query = parse(query)
        opt = ExecOptions(
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
        or None when admission is off (max-concurrent-queries 0)."""
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
        idx = self.holder.index(index)
        qcost = costmod.estimate(idx, query, shards)
        # only batcher-bound traffic feeds the batcher's hold hint: the
        # predicate the routing in _query_batched uses
        batchable = batchmod.batch_eligible(query, shards, opt)
        if not qcost.write:
            # a query about to wait has its extents staged meanwhile
            scheduler.maybe_prefetch(lambda: self.server.executor.warm(index, query, shards), index=index)
        return scheduler.admit(cls=cls, cost=qcost, deadline=deadline, batchable=batchable, index=index)

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

    def create_index(self, name: str, keys: bool = False, track_existence: bool = True):
        return self.holder.create_index_if_not_exists(name, keys=keys, track_existence=track_existence)

    def delete_index(self, name: str) -> None:
        try:
            self.holder.delete_index(name)
        except KeyError:
            pass
        self.server.drop_index(name)

    def create_field(self, index: str, name: str, options: Optional[dict] = None):
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        return idx.create_field_if_not_exists(name, FieldOptions(**(options or {})))

    def delete_field(self, index: str, name: str) -> None:
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        try:
            idx.delete_field(name)
        except KeyError:
            pass

    def schema(self) -> List[dict]:
        return self.holder.schema()

    def apply_schema(self, schema: List[dict]) -> None:
        """Create every index and field of a schema dump that is missing."""
        for ix in schema:
            opts = ix.get("options", {})
            idx = self.create_index(
                ix["name"],
                keys=opts.get("keys", False),
                track_existence=opts.get("trackExistence", True),
            )
            for fd in ix.get("fields", []):
                options = _field_options_from_json(fd.get("options", {}))
                idx.create_field_if_not_exists(fd["name"], options)

    # -- imports -------------------------------------------------------------

    def import_bits(
        self,
        index: str,
        field: str,
        rows: Sequence,
        cols: Sequence,
        clear: bool = False,
        timestamps: Optional[Sequence] = None,
    ) -> dict:
        """Bulk set-bit import; `timestamps` (strings or unix seconds, None
        for none) fan a time field's bits into its unit views. Returns
        {"applied", "expected", "errors"}: on one node every shard of the
        batch is applied once."""
        self._check_write_count(len(cols))
        idx, f = self._index_field(index, field)
        rows, cols = _translate_import(idx, f, rows, cols)
        ts = None if timestamps is None else [None if t is None else timeq.parse_time(t) for t in timestamps]
        with walmod.GROUP_COMMIT.barrier():
            f.import_bits(rows, cols, timestamps=ts, clear=clear)
            idx.track_columns(cols)
        n = len(np.unique(cols >> np.uint64(SHARD_WIDTH_EXPONENT)))
        return {"applied": n, "expected": n, "errors": []}

    def import_values(self, index: str, field: str, cols: Sequence, values: Sequence[int]) -> dict:
        self._check_write_count(len(cols))
        idx, f = self._index_field(index, field)
        _, cols = _translate_import(idx, f, None, cols)
        with walmod.GROUP_COMMIT.barrier():
            f.import_values(cols, np.asarray(values, dtype=np.int64))
            idx.track_columns(cols)
        n = len(np.unique(cols >> np.uint64(SHARD_WIDTH_EXPONENT)))
        return {"applied": n, "expected": n, "errors": []}

    def import_roaring(
        self,
        index: str,
        field: str,
        shard: int,
        data: bytes,
        clear: bool = False,
        view: Optional[str] = None,
    ) -> int:
        """Bulk ingest of a serialized roaring bitmap (either dialect)
        whose positions are fragment positions row * SHARD_WIDTH + col %
        SHARD_WIDTH, unioned (or cleared) in one batch, into the standard
        view or a named (time) view. Set and time fields only: the mutex and
        BSI layouts need the parsing imports. Returns the number of bits
        that changed."""
        idx, f = self._index_field(index, field)
        if f.options.type not in (FIELD_TYPE_SET, FIELD_TYPE_TIME):
            raise ApiError(f"cannot import roaring into {f.options.type} field {field!r}")
        view = view or VIEW_STANDARD
        _validate_view_name(view)
        positions = roaring_io.decode(data)
        frag = f._view_create(view).fragment(shard)
        with walmod.GROUP_COMMIT.barrier():
            if clear:
                _, changed = frag.import_positions(None, positions)
            else:
                changed, _ = frag.import_positions(positions, None)
                if len(positions):
                    seen = np.zeros(SHARD_WIDTH, bool)
                    seen[positions % np.uint64(SHARD_WIDTH)] = True
                    idx.track_columns(np.flatnonzero(seen).astype(np.uint64) + np.uint64(shard * SHARD_WIDTH))
        return changed

    # -- exports -------------------------------------------------------------

    def export_roaring(self, index: str, field: str, shard: int, view: Optional[str] = None) -> bytes:
        """One fragment as a pilosa-dialect roaring file (the inverse of
        import_roaring)."""
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
        """Rebuild every rank cache of the node (one node: nothing to
        broadcast)."""
        self.holder.recalculate_caches()

    # -- node info -----------------------------------------------------------

    def status(self) -> dict:
        return {
            "state": self.server.state,
            "localID": self.server.node.id,
            "clusterID": self.server.cluster_name,
            "nodes": [n.to_json() for n in self.cluster.nodes],
            "pendingRepairs": self.holder.pending_repair_count(),
            "walStagedPositions": self.holder.staged_position_count(),
            "breakers": {},
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
        """The nodes that own a shard of an index: on one node, the node
        itself, for any index and shard."""
        return [n.to_json() for n in self.cluster.nodes]

    def max_shards(self) -> Dict[str, int]:
        """Per index, one past its highest shard (0 when it has none)."""
        out = {}
        for idx in self.holder.indexes():
            av = idx.available_shards()
            out[idx.name] = (max(av) + 1) if av else 0
        return out


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
