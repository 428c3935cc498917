"""Per-query cost estimation for admission control.

The port of pilosa_tpu/sched/cost.py for one node. Admission is weighted
by device memory, not query count: `Count(Row(f=1))` stages one int32
[S, W] row stack while a BSI `Row(v > 7)` stages the field's planes. The
estimator walks the parsed call tree and prices it with the accounting
the executor's budget guard uses (exec/plan.py `stack_budget`): a row
stack is `n_shards * WORDS_PER_ROW * 4` bytes, and no dispatch holds
more than a quarter of the holder's device budget (larger queries are
chunked, so the peak stays at that quarter while the sweep count grows).

BSI: a BSI reference is priced at its plane-streamed slab peak, as the
reference prices it: min(bit depth, `bsistream.slab_planes()`) planes
plus 3 rows (exists, sign and the filter or ladder state). The one
divergence is a signed field 32 bits deep: the reference declines to
stream it and prices its whole stack (depth + 2), while the port streams
it, so it prices the slab peak.

Discounts, as in the reference: a query whose every read call has a
live cached result (core/resultcache.py) costs no device bytes, one
whose calls are cached or repairable costs at most one row stack; the
bytes already resident for the fields the query names are subtracted
and the staged merge bytes its read barrier will merge are added. The
reference's mesh and transport terms (one node here) stay zero.

Estimation never fails a query: any error gives ZERO_COST.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Set

from pilosa_tpu_torch.pql import Call, Query
from pilosa_tpu_torch.shardwidth import WORDS_PER_ROW

# row-stack equivalents charged for tally calls (TopN, GroupBy, Rows)
_TALLY_ROW_EQUIV = 16

# plane rows assumed for a BSI reference whose field cannot be resolved
_DEFAULT_BSI_PLANES = 18

_WRITE_CALLS = frozenset({"Set", "Clear", "Store", "ClearRow", "SetRowAttrs", "SetColumnAttrs"})


@dataclass(frozen=True)
class QueryCost:
    """device_bytes: the estimated peak operand residency of one dispatch;
    sweeps: the estimated dispatches; write: the query mutates (it holds
    a slot but no device weight); transport_ms: the reference's mesh and
    cross-node transport estimate, always 0 on one node."""

    device_bytes: int = 0
    sweeps: int = 0
    write: bool = False
    transport_ms: float = 0.0


ZERO_COST = QueryCost()


def _bsi_planes(idx: Any, field_name: Optional[str]) -> int:
    """Row-stack equivalents a BSI reference holds at its peak: one slab
    of min(depth, slab) planes plus 3 word rows (exec/bsistream.py)."""
    from pilosa_tpu_torch.exec import bsistream

    slab = bsistream.slab_planes()
    if idx is not None and field_name:
        f = idx.field(field_name)
        depth = getattr(f.options, "bit_depth", 0) if f is not None else 0
        if depth:
            return min(depth, slab) + 3
    return min(_DEFAULT_BSI_PLANES, slab + 3)


def _call_rows(idx: Any, c: Call) -> float:
    """Row-stack equivalents the call's operands occupy."""
    if c.name in _WRITE_CALLS:
        return 0.0
    rows = 0.0
    if c.name == "Row":
        conds = c.condition_args()
        if conds:
            for fname in conds:
                rows += _bsi_planes(idx, fname)
        else:
            rows += 1.0
    elif c.name in ("Sum", "Min", "Max"):
        fname = c.args.get("field") or c.args.get("_field")
        rows += _bsi_planes(idx, fname if isinstance(fname, str) else None)
    elif c.name in ("TopN", "GroupBy", "Rows"):
        rows += _TALLY_ROW_EQUIV
    elif c.name == "Not":
        rows += 1.0  # the existence stack
    for child in c.children:
        rows += _call_rows(idx, child)
    for v in c.args.values():
        if isinstance(v, Call):
            rows += _call_rows(idx, v)
    return rows


def _referenced_fields(c: Call, out: Set[str]) -> None:
    """Field names a call tree touches, for scoping the residency discount
    to views this query can reuse."""
    for k in c.args:
        if not k.startswith("_") and k not in ("from", "to"):
            out.add(k)
    fname = c.args.get("field") or c.args.get("_field")
    if isinstance(fname, str):
        out.add(fname)
    for child in c.children:
        _referenced_fields(child, out)
    for v in c.args.values():
        if isinstance(v, Call):
            _referenced_fields(v, out)


def resident_bytes(idx: Any, field_names: Optional[Set[str]] = None) -> int:
    """Device bytes the holder's cache holds for `idx`'s views (stacks
    under each view's owner token), restricted to `field_names`: one
    running total a view (DeviceCache.owner_resident_bytes)."""
    total = 0
    try:
        for name, f in idx._fields.items():
            if field_names is not None and name not in field_names:
                continue
            for v in f.views.values():
                total += idx.dcache.owner_resident_bytes(v._stack_token)
    except Exception:  # noqa: BLE001 - estimation never fails
        return 0
    return total


def staged_merge_bytes(idx: Any, field_names: Optional[Set[str]] = None) -> int:
    """Bytes of staged ingest the next read barrier of these fields may
    merge (8 bytes a position: pending buffers and parked layers), from
    each view's running tally (core/fragment.py StagedTally): one read a
    view, no lock, whatever its shard count."""
    total = 0
    try:
        for name, f in idx._fields.items():
            if field_names is not None and name not in field_names:
                continue
            for v in list(f.views.values()):
                total += v.staged.n * 8
    except Exception:  # noqa: BLE001 - estimation never fails
        return 0
    return total


def _probe_text(idx: Any, c: Call) -> Optional[str]:
    """The call's post-translation text (cache entries are keyed on it)
    for the result-cache probe: row keys resolve read-only; a key with
    no id means no entry can exist (None)."""
    s = str(c)
    if '"' not in s:
        return s
    cc = copy.deepcopy(c)
    if not _probe_translate(idx, cc):
        return None
    return str(cc)


def _probe_translate(idx: Any, c: Call) -> bool:
    for k, v in list(c.args.items()):
        if isinstance(v, Call):
            if not _probe_translate(idx, v):
                return False
        elif isinstance(v, str) and not k.startswith("_") and k not in ("from", "to"):
            f = idx.field(k) if idx is not None else None
            if f is None or not f.options.keys:
                return False
            rid = f.translate_store.find_key(v)
            if rid is None:
                return False
            c.args[k] = rid
    for child in c.children:
        if not _probe_translate(idx, child):
            return False
    return True


def _shard_count(idx: Any, shards: Optional[Sequence[int]]) -> int:
    if shards is not None:
        return max(1, len(shards))
    if idx is not None:
        try:
            return max(1, idx.shard_count())
        except Exception:  # noqa: BLE001 - estimation never fails
            return 1
    return 1


def estimate(idx: Any, query: Any, shards: Optional[Sequence[int]] = None) -> QueryCost:
    """Estimate `query` (a parsed Query or Call, or PQL text) against the
    index object `idx` (None: not created yet)."""
    from pilosa_tpu_torch.core.resultcache import RESULT_CACHE

    try:
        if isinstance(query, str):
            from pilosa_tpu_torch.pql import parse

            query = parse(query)
        calls = query.calls if isinstance(query, Query) else [query]
        stack_bytes = _shard_count(idx, shards) * WORDS_PER_ROW * 4
        # the executor chunks any dispatch whose stacks pass a quarter of
        # the device budget
        dispatch_cap = max(1, idx.dcache.budget_bytes // 4) if idx is not None else 1 << 62
        peak = sweeps = 0
        write = False
        for c in calls:
            if c.name in _WRITE_CALLS:
                write = True
                continue
            raw = int(_call_rows(idx, c) * stack_bytes)
            if raw <= 0:
                continue
            peak = max(peak, min(raw, dispatch_cap))
            sweeps += max(1, math.ceil(raw / dispatch_cap))
        if peak and idx is not None:
            # every read call cached: served from host memory, no bytes;
            # every one cached or repairable: at most one row stack
            scope = getattr(idx, "_cache_scope", None)
            read_calls = [c for c in calls if c.name not in _WRITE_CALLS]
            if scope is not None and read_calls:
                texts = [_probe_text(idx, c) for c in read_calls]
                if all(t is not None and RESULT_CACHE.has_text(scope, t) for t in texts):
                    peak = 0
                elif all(
                    t is not None and (RESULT_CACHE.has_text(scope, t) or RESULT_CACHE.repair_likely(scope, t))
                    for t in texts
                ):
                    peak = min(peak, stack_bytes)
        if peak and idx is not None:
            touched: Set[str] = set()
            for c in calls:
                _referenced_fields(c, touched)
            if touched:
                peak = max(0, peak - resident_bytes(idx, touched))
                peak += staged_merge_bytes(idx, touched)
        return QueryCost(device_bytes=peak, sweeps=sweeps, write=write)
    except Exception:  # noqa: BLE001 - never fail admission on estimation
        return ZERO_COST
