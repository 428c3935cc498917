"""Query executor for one node on one device.

The port of pilosa_tpu/exec/executor.py for the main path: PQL bitmap
trees (Row, Intersect, Union, Difference, Xor, Not, All, Shift, and BSI
condition rows such as Row(v > 10)) lower to stacked plans over [S, W]
device row stacks (exec/plan.py); Count runs the plan_count kernel
(adjacent Counts batch into one MultiCountPlan) and a lone condition row
runs the bsi_range kernel in count mode (exec/bsistream.py); Sum, Min and
Max over int fields run the bsi_sum and bsi_min_max kernels; Set and Clear
write bits and int values; TopN answers unfiltered queries from the rank
caches and filtered ones from one plan plus a device tally per shard
chunk (rows_counts or counts_cross for dense candidates, gather_tally for
sparse ones), pruning candidates by row attrs on the host (attrName,
attrValues); Rows lists a field's row ids from the host row stores, and
GroupBy tallies the cross-product of its children's rows on the card
(exec/groupby.py: counts_cross, gather_and). SetRowAttrs and
SetColumnAttrs write the attribute stores (core/attrs.py); a plain Row
carries its row's attrs, and Options sets excludeRowAttrs,
excludeColumns, columnAttrs and shards for its child. String keys are
translated to ids before execution and ids back to keys after it
(exec/translation.py).

An unknown call raises ExecError. There is no per-shard fallback: a tree
the stacked lowering cannot express is an error here, never a slower
path. Stacks over a quarter of the device
budget halve the shard list; below 16 shards each shard is lowered on
its own and admitted over the budget, where the reference answers
through its per-shard loop.

Lowering stages a query's operands as extents (hbm/residency.py) under
one deferred-eviction session of the holder's device cache, pinned in
the lowering's ExtentTable; the plan releases the pins once its kernels
are queued, and every error path releases them too.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pilosa_tpu_torch.core.field import FIELD_TYPE_BOOL, FIELD_TYPE_INT, FIELD_TYPE_TIME, Field
from pilosa_tpu_torch.core.fragment import BSI_EXISTS_BIT, BSI_OFFSET_BIT, BSI_SIGN_BIT
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.exec import bsistream
from pilosa_tpu_torch.exec import groupby as gb
from pilosa_tpu_torch.exec import plan as planmod
from pilosa_tpu_torch.exec import translation
from pilosa_tpu_torch.exec.plan import (
    BudgetExceeded,
    MultiCountPlan,
    PLeaf,
    PNary,
    PNode,
    PRangeBetween,
    PRangeCmp,
    PRangeEQ,
    PShift,
    PZero,
    SparseView,
    StackedPlan,
)
from pilosa_tpu_torch.hbm.residency import ExtentTable
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.pql import Call, Query, parse
from pilosa_tpu_torch.pql.ast import BETWEEN, GT, GTE, LT, LTE, NEQ
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

DEFAULT_MIN_THRESHOLD = 1


class ExecError(Exception):
    pass


class NotFoundError(ExecError):
    pass


@dataclass
class ExecOptions:
    exclude_row_attrs: bool = False
    exclude_columns: bool = False
    column_attrs: bool = False
    shards: Optional[List[int]] = None
    max_writes: int = 5000


@dataclass
class ColumnAttrSet:
    """One column's attributes on a response asked with columnAttrs=true:
    `key` instead of `id` on a keyed index."""

    id: int = 0
    key: Optional[str] = None
    attrs: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"attrs": self.attrs or {}}
        if self.key is not None:
            out["key"] = self.key
        else:
            out["id"] = self.id
        return out


@dataclass
class QueryResponse:
    """Per-call results, and the column attr sets when columnAttrs=true."""

    results: List[Any]
    column_attr_sets: Optional[List[ColumnAttrSet]] = None


@dataclass
class ValCount:
    """Sum/Min/Max result."""

    value: int
    count: int

    def to_json(self):
        return {"value": self.value, "count": self.count}


@dataclass
class Pair:
    """TopN result entry; `key` is set for a keyed field."""

    id: int
    count: int
    key: Optional[str] = None

    def to_json(self):
        d = {"id": self.id, "count": self.count}
        if self.key is not None:
            d["key"] = self.key
        return d


@dataclass
class FieldRow:
    """One child's row of a GroupBy group; `row_key` for a keyed field."""

    field: str
    row_id: int
    row_key: Optional[str] = None

    def to_json(self):
        if self.row_key:
            return {"field": self.field, "rowKey": self.row_key}
        return {"field": self.field, "rowID": self.row_id}


@dataclass
class GroupCount:
    group: List[FieldRow]
    count: int

    def to_json(self):
        return {"group": [g.to_json() for g in self.group], "count": self.count}

    def compare_key(self):
        return tuple(g.row_id for g in self.group)


@dataclass
class _TopNSpec:
    f: Field
    n: int
    ids: Optional[list]
    threshold: int
    tanimoto: int
    src_call: Optional[Call]
    attr_name: Optional[str] = None
    filters: Optional[set] = None


# TopN dispatch accounting: the batched path issues O(1) device tallies
# per shard chunk; `chunks` counts the filter's budget-sized shard chunks
TOPN_STATS = {"batched": 0, "tally_evals": 0, "one_pass": 0, "chunks": 0}


class _TallyBundle:
    """Prepared filtered-TopN tally inputs: the dense/sparse candidate split
    and the sparse rows' device gather entries (idx, mask, starts, ends)."""

    __slots__ = ("dense_rows", "sparse_rows", "dev")

    def __init__(self, dense_rows, sparse_rows, dev):
        self.dense_rows = dense_rows
        self.sparse_rows = sparse_rows
        self.dev = dev

    @property
    def nbytes(self) -> int:
        if self.dev is None:
            return 64
        return sum(t.numel() * 4 for t in self.dev)


class _StackedLowering:
    """Lower a PQL bitmap call tree to plan nodes over stacked [S, W]
    operands. Semantic errors raise ExecError; absent rows/views lower to
    PZero. `collect` walks the tree recording touched views without
    staging (the pre-pass of compacted lowering)."""

    def __init__(
        self,
        ex: "Executor",
        idx: Index,
        shards: List[int],
        collect: bool = False,
        no_sparse_guard: bool = False,
        over_budget: bool = False,
    ):
        self.ex = ex
        self.idx = idx
        self.shards = list(shards)
        self.operands: List[torch.Tensor] = []
        self._call_memo: Dict[int, PNode] = {}
        self._leaf_memo: Dict[Tuple, PNode] = {}
        self.collect = collect
        self.no_sparse_guard = no_sparse_guard
        # stage over the budget guard (the executor's per-shard pass)
        self.over_budget = over_budget
        self.views: Dict[int, Any] = {}
        # pins on the staged operands' extents, released by the plan
        self.extents = ExtentTable(idx.dcache)

    def _stack_guard(self, view, mult: int = 1) -> None:
        n = len(self.shards)
        if n >= 64 and not self.no_sparse_guard:
            present = sum(1 for s in self.shards if view.fragment_if_exists(s) is not None)
            if present and present * 8 < n:
                raise SparseView("sparse view: stacked form would densify")
        if not self.over_budget and n * WORDS_PER_ROW * 4 * mult > planmod.stack_budget(self.idx.dcache):
            raise BudgetExceeded("stack exceeds device budget")

    def _view_leaf(self, view, row_id: int) -> PNode:
        key = ("row", id(view), row_id)
        node = self._leaf_memo.get(key)
        if node is None:
            self.views.setdefault(id(view), view)
            if self.collect:
                node = PLeaf(0)
            else:
                self._stack_guard(view)
                arr = view.row_stack(row_id, self.shards, extents=self.extents)
                if arr is None:
                    node = PZero()
                else:
                    self.operands.append(arr)
                    node = PLeaf(len(self.operands) - 1)
            self._leaf_memo[key] = node
        return node

    def _plane_slot(self, view, bit_depth: int) -> Optional[int]:
        """Operand slot of the view's [D, S, W] magnitude plane stack, or
        None when no listed shard has a fragment."""
        key = ("planes", id(view), bit_depth)
        if key not in self._leaf_memo:
            self.views.setdefault(id(view), view)
            if self.collect:
                self._leaf_memo[key] = 0
            else:
                self._stack_guard(view, mult=bit_depth)
                arr = view.plane_stack(
                    range(BSI_OFFSET_BIT, BSI_OFFSET_BIT + bit_depth), self.shards, extents=self.extents
                )
                if arr is None:
                    self._leaf_memo[key] = None
                else:
                    self.operands.append(arr)
                    self._leaf_memo[key] = len(self.operands) - 1
        return self._leaf_memo[key]

    def lower(self, c: Call) -> PNode:
        node = self._call_memo.get(id(c))
        if node is None:
            node = self._call_memo[id(c)] = self._lower(c)
        return node

    def _lower(self, c: Call) -> PNode:
        name = c.name
        if name in ("Row", "Range"):
            return self._lower_row(c)
        if name == "Intersect":
            if not c.children:
                raise ExecError("empty Intersect query is currently not supported")
            ch = tuple(self.lower(x) for x in c.children)
            if any(isinstance(x, PZero) for x in ch):
                return PZero()
            return ch[0] if len(ch) == 1 else PNary("and", ch)
        if name in ("Union", "Xor"):
            ch = tuple(x for x in (self.lower(x) for x in c.children) if not isinstance(x, PZero))
            if not ch:
                return PZero()
            if len(ch) == 1:
                return ch[0]
            return PNary("or" if name == "Union" else "xor", ch)
        if name == "Difference":
            if not c.children:
                return PZero()
            ch = tuple(self.lower(x) for x in c.children)
            if isinstance(ch[0], PZero):
                return PZero()
            rest = tuple(x for x in ch[1:] if not isinstance(x, PZero))
            if not rest:
                return ch[0]
            return PNary("andnot", (ch[0],) + rest)
        if name == "Not":
            if not self.idx.track_existence:
                raise ExecError("Not() query requires existence tracking to be enabled")
            if len(c.children) != 1:
                raise ExecError("Not() requires a single bitmap input")
            exists = self._existence_leaf()
            if isinstance(exists, PZero):
                return PZero()
            child = self.lower(c.children[0])
            if isinstance(child, PZero):
                return exists
            return PNary("andnot", (exists, child))
        if name == "All":
            return self._existence_leaf()
        if name == "Shift":
            if len(c.children) != 1:
                raise ExecError("Shift() requires a single bitmap input")
            n = c.int_arg("n")
            n = 1 if n is None else n
            child = self.lower(c.children[0])
            if isinstance(child, PZero):
                return PZero()
            return PShift(child, n, self._prev_idx())
        raise ExecError(f"unknown call: {name}")

    def _existence_leaf(self) -> PNode:
        ef = self.idx.existence_field()
        if ef is None:
            raise ExecError("existence field not available")
        v = ef.view(VIEW_STANDARD)
        if v is None:
            return PZero()
        return self._view_leaf(v, 0)

    def _prev_idx(self) -> Tuple[int, ...]:
        """Stack index of shard_id-1 per stack position (-1 = absent)."""
        pos = {s: i for i, s in enumerate(self.shards)}
        return tuple(pos.get(s - 1, -1) for s in self.shards)

    def _lower_row(self, c: Call) -> PNode:
        ex, idx = self.ex, self.idx
        if c.has_conditions():
            return self._lower_row_bsi(c)
        field_name = ex._field_arg_name(c)
        f = ex._field_of(idx, field_name)
        row_id = c.args.get(field_name)
        if isinstance(row_id, bool):
            if f.options.type != FIELD_TYPE_BOOL:
                raise ExecError("Row() bool value requires a bool field")
            row_id = 1 if row_id else 0
        if not isinstance(row_id, int):
            if isinstance(row_id, str):
                raise ExecError(f"string row key {row_id!r} requires field keys (translation)")
            raise ExecError("Row() must specify a row")
        if f.options.type == FIELD_TYPE_BOOL and row_id not in (0, 1):
            raise ExecError("Row() bool field expects row 0 or 1")
        from_arg, to_arg = c.args.get("from"), c.args.get("to")
        if from_arg is None and to_arg is None:
            v = f.view(VIEW_STANDARD)
            if v is None:
                return PZero()
            return self._view_leaf(v, row_id)
        # a time range: the union of the row over the minimal covering set
        # of the quantum's views (an open bound takes the field's span)
        if f.options.type != FIELD_TYPE_TIME:
            raise ExecError(f"field {field_name} is not a time field")
        from_t = timeq.parse_time(from_arg) if from_arg is not None else None
        to_t = timeq.parse_time(to_arg) if to_arg is not None else None
        if from_t is None or to_t is None:
            lo, hi = ex._field_time_bounds(f)
            if lo is None:
                return PZero()
            from_t = from_t or lo
            to_t = to_t or hi
        leaves = []
        for vname in timeq.views_by_time_range(VIEW_STANDARD, from_t, to_t, f.options.time_quantum):
            v = f.view(vname)
            if v is None:
                continue
            leaf = self._view_leaf(v, row_id)
            if not isinstance(leaf, PZero):
                leaves.append(leaf)
        if not leaves:
            return PZero()
        return leaves[0] if len(leaves) == 1 else PNary("or", tuple(leaves))

    # -- BSI condition rows --------------------------------------------------

    def _lower_row_bsi(self, c: Call) -> PNode:
        """A condition row over an int field: the sign/saturation
        decomposition of the predicate, emitted as range nodes over the
        field's [D, S, W] plane stack (one bsi_range launch each)."""
        ex, idx = self.ex, self.idx
        conds = c.condition_args()
        if len(c.args) != 1 or len(conds) != 1:
            raise ExecError("Row(): exactly one condition required")
        field_name, cond = next(iter(conds.items()))
        f = ex._field_of(idx, field_name)
        if f.options.type != FIELD_TYPE_INT:
            raise ExecError(f"field {field_name} is not an int field")
        o = f.options
        bsiv = f.view(f.bsi_view_name())
        if bsiv is None:
            return PZero()
        exists = self._view_leaf(bsiv, BSI_EXISTS_BIT)
        if isinstance(exists, PZero):
            return PZero()
        # unsigned fields (min >= base) never store a sign bit
        sign = self._view_leaf(bsiv, BSI_SIGN_BIT) if bsistream._signed_field(f) else None
        planes = self._plane_slot(bsiv, o.bit_depth)
        if planes is None:
            return PZero()
        b = _BsiRows(exists, sign, planes)

        if cond.op == NEQ and cond.value is None:  # != null
            return exists
        if cond.op == BETWEEN:
            lo, hi = cond.int_pair()
            blo, bhi, out_of_range = f.base_value_between(lo, hi)
            if out_of_range:
                return PZero()
            if lo <= o.min and hi >= o.max:
                return exists
            return self._between(b, blo, bhi)

        if not isinstance(cond.value, int) or isinstance(cond.value, bool):
            raise ExecError("Row(): conditions only support integer values")
        value = cond.value
        op = bsistream.COND_OP_NAME[cond.op]
        base_value, out_of_range = f.base_value(op, value)
        if out_of_range and cond.op != NEQ:
            return PZero()
        if (
            (cond.op == LT and value > o.max)
            or (cond.op == LTE and value >= o.max)
            or (cond.op == GT and value < o.min)
            or (cond.op == GTE and value <= o.min)
        ):
            return exists
        if out_of_range and cond.op == NEQ:
            return exists
        return self._range_op(b, op, base_value)

    @staticmethod
    def _pos_neg(b: "_BsiRows") -> Tuple[PNode, PNode]:
        if b.sign is None:
            return b.exists, PZero()
        return PNary("andnot", (b.exists, b.sign)), PNary("and", (b.exists, b.sign))

    def _range_op(self, b: "_BsiRows", op: str, predicate: int) -> PNode:
        upred = abs(predicate)
        positives, negatives = self._pos_neg(b)
        if op in ("eq", "neq"):
            eq = b.node(PRangeEQ, "neg" if predicate < 0 else "pos", pred=upred)
            if op == "eq":
                return eq
            return b.exists if isinstance(eq, PZero) else PNary("andnot", (b.exists, eq))
        if op in ("lt", "lte"):
            allow_eq = op == "lte"
            if predicate > 0 or (predicate == 0 and allow_eq):
                pos = b.node(PRangeCmp, "pos", kind="lt", pred=upred, allow_eq=allow_eq)
                return _or(negatives, pos)
            if predicate == 0:  # strict < 0
                return negatives
            return b.node(PRangeCmp, "neg", kind="gt", pred=upred, allow_eq=allow_eq)
        if op in ("gt", "gte"):
            allow_eq = op == "gte"
            if predicate > 0 or (predicate == 0 and allow_eq):
                return b.node(PRangeCmp, "pos", kind="gt", pred=upred, allow_eq=allow_eq)
            if predicate == 0:  # strict > 0
                return b.node(PRangeCmp, "pos", kind="gt", pred=upred, allow_eq=False)
            neg = b.node(PRangeCmp, "neg", kind="lt", pred=upred, allow_eq=allow_eq)
            return _or(positives, neg)
        raise ExecError(f"invalid range op {op!r}")

    @staticmethod
    def _between(b: "_BsiRows", pmin: int, pmax: int) -> PNode:
        if pmin >= 0:
            return b.node(PRangeBetween, "pos", lo=abs(pmin), hi=abs(pmax))
        if pmax < 0:
            return b.node(PRangeBetween, "neg", lo=abs(pmax), hi=abs(pmin))
        pos = b.node(PRangeCmp, "pos", kind="lt", pred=abs(pmax), allow_eq=True)
        neg = b.node(PRangeCmp, "neg", kind="lt", pred=abs(pmin), allow_eq=True)
        return _or(pos, neg)


@dataclass(frozen=True)
class _BsiRows:
    """The operands of an int field's range nodes: the exists leaf, the
    sign leaf (None for an unsigned field) and the plane-stack slot."""

    exists: PNode
    sign: Optional[PNode]
    planes: int

    def node(self, cls, sel: str, **kw) -> PNode:
        """A range node over the base mask `sel` (pos or neg); an unsigned
        field's pos mask is all of exists and its neg mask is empty."""
        if self.sign is None:
            if sel == "neg":
                return PZero()
            sel = "consider"
        return cls(exists=self.exists, sign=self.sign, sel=sel, planes=self.planes, **kw)


def _or(a: PNode, b: PNode) -> PNode:
    if isinstance(a, PZero):
        return b
    if isinstance(b, PZero):
        return a
    return PNary("or", (a, b))


class Executor:
    """Single-node executor over a port Holder."""

    _EMPTY = "empty"  # sentinel: nothing materialized in the shard range

    def __init__(self, holder: Holder):
        self.holder = holder

    # ------------------------------------------------------------------
    # entry
    # ------------------------------------------------------------------

    def execute(
        self,
        index_name: str,
        query: Union[str, Query],
        shards: Optional[Sequence[int]] = None,
        opt: Optional[ExecOptions] = None,
    ) -> List[Any]:
        return self.execute_response(index_name, query, shards, opt).results

    def execute_response(
        self,
        index_name: str,
        query: Union[str, Query],
        shards: Optional[Sequence[int]] = None,
        opt: Optional[ExecOptions] = None,
    ) -> QueryResponse:
        # a private copy: Options(columnAttrs=...) sets the query's
        # columnAttrs, which must not leak to the caller's options
        opt = replace(opt) if opt is not None else ExecOptions()
        if isinstance(query, str):
            query = parse(query)
        idx = self.holder.index(index_name)
        if idx is None:
            raise NotFoundError(f"index not found: {index_name}")
        if query.write_call_n() > opt.max_writes:
            raise ExecError("too many writes in a single request")
        if shards is None:
            shards = opt.shards
        translation.translate_query(idx, query)
        results: List[Any] = []
        calls = query.calls
        i = 0
        while i < len(calls):
            # a run of adjacent Counts evaluates as one multi-root plan
            j = i
            while j < len(calls) and calls[j].name == "Count" and len(calls[j].children) == 1:
                j += 1
            if j - i >= 2:
                batch = self._execute_count_batch(idx, calls[i:j], shards)
                if batch is None:
                    batch = [self._execute_call(idx, cc, shards, opt) for cc in calls[i:j]]
                results.extend(batch)
                i = j
                continue
            results.append(self._execute_call(idx, calls[i], shards, opt))
            i += 1
        resp = QueryResponse(results=results)
        if opt.column_attrs:
            resp.column_attr_sets = self._column_attr_sets(idx, results)
        resp.results = translation.translate_results(idx, query, results)
        return resp

    @staticmethod
    def _column_attr_sets(idx: Index, results) -> List[ColumnAttrSet]:
        """The attrs of every column set in any Row result, in column
        order. Built from the store's side: its sorted ids are looked up
        in each Row's words on the Row's device (one gather), so the cost
        follows the attributed columns, not the Row's columns. Columns
        excluded by excludeColumns have no segments, hence no attrs."""
        store = idx.column_attr_store
        ids = store.ids_array()
        hit = np.zeros(len(ids), bool)
        if len(ids):
            for r in results:
                if isinstance(r, Row) and r.segments:
                    hit |= r.includes_many(ids)
        cols = ids[hit].tolist()
        if idx.keys:
            keys = idx.translate_store.keys_for_ids(cols)
            return [ColumnAttrSet(key=k, attrs=a) for k, a in zip(keys, store.attrs_many(cols)) if a]
        return [ColumnAttrSet(id=c, attrs=a) for c, a in zip(cols, store.attrs_many(cols)) if a]

    def _shards_for(self, idx: Index, shards, call: Optional[Call] = None) -> List[int]:
        s = list(shards) if shards is not None else (sorted(idx.available_shards()) or [0])
        if call is not None:
            # Shift carries bits into following shards: include them
            k = self._count_shifts(call)
            if k:
                ext = set(s)
                for sh in s:
                    ext.update(range(sh + 1, sh + 1 + k))
                s = sorted(ext)
        return s

    def _execute_call(self, idx: Index, c: Call, shards, opt: ExecOptions):
        name = c.name
        if name == "Options":
            return self._execute_options(idx, c, shards, opt)
        if name == "SetRowAttrs":
            return self._execute_set_row_attrs(idx, c)
        if name == "SetColumnAttrs":
            return self._execute_set_column_attrs(idx, c)
        if name not in ("Set", "Clear"):
            shards = self._shards_for(idx, shards, c)
        if name == "Count":
            return self._execute_count(idx, c, shards)
        if name == "Set":
            return self._execute_set(idx, c)
        if name == "Clear":
            return self._execute_clear(idx, c)
        if name == "TopN":
            return self._execute_topn(idx, c, shards)
        if name == "Sum":
            return self._execute_bsi_aggregate(idx, c, shards, "sum")
        if name == "Min":
            return self._execute_bsi_aggregate(idx, c, shards, "min")
        if name == "Max":
            return self._execute_bsi_aggregate(idx, c, shards, "max")
        if name == "Rows":
            return self._execute_rows(idx, c, shards)
        if name == "GroupBy":
            return self._execute_group_by(idx, c, shards)
        if name == "MinRow":
            return self._execute_min_max_row(idx, c, shards, is_min=True)
        if name == "MaxRow":
            return self._execute_min_max_row(idx, c, shards, is_min=False)
        if name == "ClearRow":
            return self._execute_clear_row(idx, c, shards)
        if name == "Store":
            return self._execute_store(idx, c, shards)
        return self._execute_bitmap_call(idx, c, shards, opt)

    # ------------------------------------------------------------------
    # lowering
    # ------------------------------------------------------------------

    def _count_shifts(self, c: Call) -> int:
        n = 1 if c.name == "Shift" else 0
        n += sum(self._count_shifts(ch) for ch in c.children)
        n += sum(self._count_shifts(v) for v in c.args.values() if isinstance(v, Call))
        return n

    @staticmethod
    def _lower_all(low: "_StackedLowering", calls: List[Call]) -> List[PNode]:
        """Lower the trees in one deferred-eviction session (staging
        operand k must not evict operand k + 1's extents); on any error
        the lowering's pins are released."""
        try:
            with low.idx.dcache.deferred_eviction():
                return [low.lower(c) for c in calls]
        except BaseException:
            low.extents.release()
            raise

    def _lower_roots(self, idx: Index, calls: List[Call], shard_list, over_budget: bool = False):
        """Lower call trees over ONE shared operand set. Returns (roots,
        lowering, n_out, out_shards) or the _EMPTY sentinel when no operand
        is materialized anywhere; BudgetExceeded propagates unless
        `over_budget` admits the stacks over the budget guard."""
        shard_list = list(shard_list)
        # Shift reads the previous shard's bits for its carry: stack the
        # predecessors of an explicit shard subset too (output excludes them)
        k = max(self._count_shifts(c) for c in calls)
        aug = shard_list
        if k:
            present = set(shard_list)
            extra = []
            for s in shard_list:
                for p in range(max(0, s - k), s):
                    if p not in present:
                        present.add(p)
                        extra.append(p)
            aug = shard_list + sorted(extra)
        low = _StackedLowering(self, idx, aug, over_budget=over_budget)
        try:
            roots = self._lower_all(low, calls)
        except SparseView:
            return self._lower_roots_compacted(idx, calls, shard_list, aug, k, over_budget)
        if not low.operands:
            low.extents.release()
            return self._EMPTY
        return roots, low, len(shard_list), shard_list

    def _lower_roots_compacted(self, idx: Index, calls: List[Call], shard_list, aug, k: int, over_budget: bool):
        """SparseView recovery: keep only shards where a touched view is
        materialized (plus up to k Shift relay successors) and re-lower."""
        collect = _StackedLowering(self, idx, aug, collect=True)
        for c in calls:
            collect.lower(c)
        views = list(collect.views.values())
        keep = {s for s in aug if any(v.fragment_if_exists(s) is not None for v in views)}
        if k:
            aug_set = set(aug)
            for s in sorted(keep):
                for t in range(s + 1, s + 1 + k):
                    if t in aug_set:
                        keep.add(t)
        compact = [s for s in aug if s in keep]
        if not compact:
            return self._EMPTY
        req = set(shard_list)
        n_out = sum(1 for s in compact if s in req)
        low = _StackedLowering(self, idx, compact, no_sparse_guard=True, over_budget=over_budget)
        roots = self._lower_all(low, calls)
        if not low.operands:
            low.extents.release()
            return self._EMPTY
        # requested shards precede the extras in `compact`
        return roots, low, n_out, compact[:n_out]

    def _lower_plans(self, idx: Index, c: Call, shard_list) -> List[StackedPlan]:
        """One stacked plan when the operands fit the device budget; a
        handful of shard-axis chunks when they do not; [] when empty."""

        def one(chunk, over_budget):
            lowered = self._lower_roots(idx, [c], chunk, over_budget)
            if lowered is self._EMPTY:
                return []
            roots, low, n_out, out_shards = lowered
            return [StackedPlan(roots[0], low.operands, n_out, out_shards, extents=low.extents)]

        return self._chunk_by_budget(list(shard_list), one)

    # below this many shards, budget halving gives way to one shard at a
    # time (the reference's per-shard loop takes over there)
    _MIN_CHUNK = 16

    @staticmethod
    def _release_chunk_extents(items) -> None:
        """Unpin the extents of lowered chunk results never dispatched."""
        for it in items or ():
            rel = getattr(it, "release_extents", None)
            if rel is not None:
                rel()

    @staticmethod
    def _chunk_by_budget(shard_list, lower_one):
        """lower_one(chunk, over_budget) -> a list of per-chunk results;
        BudgetExceeded halves the shard list, and below _MIN_CHUNK shards
        each shard is lowered alone with `over_budget` True: its guards
        admit the stacks over the budget. A failing half releases the
        other half's pins."""
        if not shard_list:
            return []
        try:
            return lower_one(shard_list, False)
        except BudgetExceeded:
            pass
        if len(shard_list) < Executor._MIN_CHUNK:
            out: List[Any] = []
            try:
                for s in shard_list:
                    out.extend(lower_one([s], True))
            except BaseException:
                Executor._release_chunk_extents(out)
                raise
            return out
        mid = len(shard_list) // 2
        left = Executor._chunk_by_budget(shard_list[:mid], lower_one)
        try:
            return left + Executor._chunk_by_budget(shard_list[mid:], lower_one)
        except BaseException:
            Executor._release_chunk_extents(left)
            raise

    # ------------------------------------------------------------------
    # bitmap calls
    # ------------------------------------------------------------------

    def _execute_bitmap_call(self, idx: Index, c: Call, shards, opt: ExecOptions) -> Row:
        """One plan_rows launch per shard chunk gives the result words and
        each shard's count; the non-empty shards' rows of that fresh stack
        are the Row's segments. They are views of the stack, so a Row
        keeps its chunk's whole stack (Shift predecessor rows included)
        alive on the card, outside the device cache's budget, for as long
        as it is held; where fewer than half of the stack's rows are
        non-empty, one index_select copies them into a stack of their own
        first, so a Row never holds more than twice its words."""
        shard_list = self._shards_for(idx, shards)
        segments = {}
        for sp in self._lower_plans(idx, c, shard_list):
            stack, counts = sp.rows_counted()
            counts = counts[: sp.n_shards].cpu().tolist()
            planmod.STATS["host_reads"] += 1
            keep = [i for i in range(sp.n_shards) if counts[i]]
            pos = keep
            if 2 * len(keep) < stack.shape[0]:
                stack = stack.index_select(0, torch.tensor(keep, dtype=torch.int64, device=stack.device))
                pos = range(len(keep))
            for i, j in zip(keep, pos):
                segments[sp.out_shards[i]] = stack[j]
        return self._finish_bitmap_row(idx, c, Row(segments), opt)

    def _finish_bitmap_row(self, idx: Index, c: Call, row: Row, opt: ExecOptions) -> Row:
        """A plain Row() (no condition) carries its row's attrs, unless
        excludeRowAttrs; excludeColumns drops every segment."""
        if c.name == "Row" and not c.has_conditions():
            if opt.exclude_row_attrs:
                row.attrs = {}
            else:
                fname = next((k for k in c.args if not k.startswith("_") and k not in ("from", "to")), None)
                f = idx.field(fname) if fname else None
                if f is not None:
                    rid = c.args.get(fname)
                    if isinstance(rid, int) and not isinstance(rid, bool):
                        row.attrs = f.row_attr_store.attrs(rid)
        if opt.exclude_columns:
            row.segments = {}
        return row

    def _field_of(self, idx: Index, name: str) -> Field:
        f = idx.field(name)
        if f is None:
            raise NotFoundError(f"field not found: {name}")
        return f

    @staticmethod
    def _field_time_bounds(f: Field):
        """The span the field's time views cover: (start, end) or (None,
        None) without time views."""
        return timeq.min_max_view_times(f.views.keys(), f.options.time_quantum)

    def _field_arg_name(self, c: Call) -> str:
        for k in c.args:
            if not k.startswith("_") and k not in ("from", "to"):
                return k
        raise ExecError(f"{c.name}() argument required: field")

    # ------------------------------------------------------------------
    # Count
    # ------------------------------------------------------------------

    def _execute_count_batch(self, idx: Index, calls: List[Call], shards) -> Optional[List[int]]:
        """N adjacent Counts as one multi-root dispatch + one [N, S] read;
        None sends the caller to per-call execution."""
        children = []
        for c in calls:
            if len(c.children) != 1:
                raise ExecError("Count() only accepts a single bitmap input")
            children.append(c.children[0])
        # every call must agree on its shard list (Shift extends theirs)
        lists = [self._shards_for(idx, shards, c) for c in calls]
        if any(lst != lists[0] for lst in lists[1:]):
            return None
        try:
            lowered = self._lower_roots(idx, children, lists[0])
        except BudgetExceeded:
            return None  # per-call execution chunks each count instead
        if lowered is self._EMPTY:
            return [0] * len(calls)
        roots, low, n_out, out_shards = lowered
        return MultiCountPlan(roots, low.operands, n_out, out_shards, extents=low.extents).counts()

    def _execute_count(self, idx: Index, c: Call, shards) -> int:
        if len(c.children) != 1:
            raise ExecError("Count() only accepts a single bitmap input")
        shard_list = self._shards_for(idx, shards)
        child = c.children[0]
        if child.name in ("Row", "Range") and child.has_conditions():
            # a lone condition: bsi_range in count mode, one launch per
            # decomposition job (exec/bsistream.py)
            counted = bsistream.count_range(self, idx, child, shard_list)
            if counted is not None:
                return counted
        # one dispatch + one [S] host read per budget-sized shard chunk
        return sum(sp.count() for sp in self._lower_plans(idx, child, shard_list))

    # ------------------------------------------------------------------
    # Sum / Min / Max (int fields)
    # ------------------------------------------------------------------

    def _execute_bsi_aggregate(self, idx: Index, c: Call, shards, kind: str) -> ValCount:
        field_name = c.string_arg("field") or self._field_arg_name(c)
        f = self._field_of(idx, field_name)
        if f.options.type != FIELD_TYPE_INT:
            raise ExecError(f"field {field_name} is not an int field")
        return bsistream.aggregate(self, idx, c, f, self._shards_for(idx, shards), kind)

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------

    def _execute_set(self, idx: Index, c: Call) -> bool:
        col = c.args.get("_col")
        if not isinstance(col, int):
            raise ExecError("Set() column argument required (or keys not enabled)")
        field_name = self._field_arg_name(c)
        f = self._field_of(idx, field_name)
        if f.options.type == FIELD_TYPE_INT:
            value = c.int_arg(field_name)
            if value is None:
                raise ExecError("Set() int field requires an integer value")
            changed = f.set_value(col, value)
        else:
            row_id = c.args.get(field_name)
            if f.options.type == FIELD_TYPE_BOOL:
                if not isinstance(row_id, bool):
                    raise ExecError("Set() bool field requires true/false")
                row_id = 1 if row_id else 0
            if not isinstance(row_id, int):
                raise ExecError("Set() row argument required")
            ts = c.args.get("_timestamp")
            changed = f.set_bit(row_id, col, timeq.parse_time(ts) if ts is not None else None)
        idx.track_columns(np.array([col], np.uint64))
        return changed

    def _execute_clear(self, idx: Index, c: Call) -> bool:
        col = c.args.get("_col")
        if not isinstance(col, int):
            raise ExecError("Clear() column argument required")
        field_name = self._field_arg_name(c)
        f = self._field_of(idx, field_name)
        if f.options.type == FIELD_TYPE_INT:
            return f.clear_value(col)
        row_id = c.args.get(field_name)
        if f.options.type == FIELD_TYPE_BOOL and isinstance(row_id, bool):
            row_id = 1 if row_id else 0
        if not isinstance(row_id, int):
            raise ExecError("Clear() row argument required")
        return f.clear_bit(row_id, col)

    def _execute_clear_row(self, idx: Index, c: Call, shards) -> bool:
        """Clear one row in every view of a set, time, mutex or bool field
        (each write drops the stacks covering its view and shard)."""
        field_name = self._field_arg_name(c)
        f = self._field_of(idx, field_name)
        if f.options.type not in ("set", "time", "mutex", "bool"):
            raise ExecError(f"ClearRow() is not supported on {f.options.type} fields")
        row_id = c.args.get(field_name)
        if f.options.type == FIELD_TYPE_BOOL and isinstance(row_id, bool):
            row_id = 1 if row_id else 0
        if not isinstance(row_id, int):
            raise ExecError("ClearRow() row argument required")
        changed = False
        base = np.uint64(row_id) * np.uint64(SHARD_WIDTH)
        shard_list = self._shards_for(idx, shards)
        for v in list(f.views.values()):
            for shard in shard_list:
                frag = v.fragment_if_exists(shard)
                if frag is None:
                    continue
                pos = frag.row_positions(row_id)
                if len(pos):
                    frag.import_positions(None, base + pos.astype(np.uint64))
                    changed = True
        return changed

    def _execute_store(self, idx: Index, c: Call, shards) -> bool:
        """Store(<bitmap>, f=row): overwrite a set field's row with the
        bitmap, shard by shard (a fragment for every listed shard). The
        bitmap comes from one plan_rows launch per shard chunk; only its
        non-empty shards' words come to the host."""
        if len(c.children) != 1:
            raise ExecError("Store() requires a single bitmap input")
        field_name = self._field_arg_name(c)
        f = self._field_of(idx, field_name)
        if f.options.type != "set":
            # only set fields: a stored row would break the one-row-per-
            # column rule of mutex and bool fields
            raise ExecError("Store() is only supported on set fields")
        row_id = c.args.get(field_name)
        if not isinstance(row_id, int):
            raise ExecError("Store() row argument required")
        shard_list = self._shards_for(idx, shards)
        words: Dict[int, np.ndarray] = {}
        for sp in self._lower_plans(idx, c.children[0], shard_list):
            stack, counts = sp.rows_counted()
            live = [i for i, n in enumerate(counts[: sp.n_shards].cpu().tolist()) if n]
            host = stack[live].cpu().numpy().view(np.uint32)
            planmod.STATS["host_reads"] += 2
            for k, i in enumerate(live):
                words[sp.out_shards[i]] = host[k]
        v = f._view_create(VIEW_STANDARD)
        base = np.uint64(row_id) * np.uint64(SHARD_WIDTH)
        changed = False
        for shard in shard_list:
            w = words.get(shard)
            new_pos = np.empty(0, np.uint64)
            if w is not None:
                new_pos = np.flatnonzero(np.unpackbits(w.view(np.uint8), bitorder="little")).astype(np.uint64)
            frag = v.fragment(shard)
            old_pos = frag.row_positions(row_id).astype(np.uint64)
            to_set = np.setdiff1d(new_pos, old_pos)
            to_clear = np.setdiff1d(old_pos, new_pos)
            if len(to_set) or len(to_clear):
                frag.import_positions(
                    base + to_set if len(to_set) else None,
                    base + to_clear if len(to_clear) else None,
                )
                changed = True
        return changed

    # ------------------------------------------------------------------
    # attributes and Options
    # ------------------------------------------------------------------

    def _execute_set_row_attrs(self, idx: Index, c: Call) -> None:
        f = self._field_of(idx, c.args.get("_field"))
        row_id = c.args.get("_row")
        if not isinstance(row_id, int):
            raise ExecError("SetRowAttrs() row argument required")
        f.row_attr_store.set_attrs(row_id, {k: v for k, v in c.args.items() if k not in ("_field", "_row")})
        return None

    def _execute_set_column_attrs(self, idx: Index, c: Call) -> None:
        col = c.args.get("_col")
        if not isinstance(col, int):
            raise ExecError("SetColumnAttrs() column argument required")
        idx.column_attr_store.set_attrs(col, {k: v for k, v in c.args.items() if k != "_col"})
        return None

    def _execute_options(self, idx: Index, c: Call, shards, opt: ExecOptions):
        """Options(<call>, excludeRowAttrs=, excludeColumns=, columnAttrs=,
        shards=[...]): the child runs under options of its own; its
        columnAttrs holds for the whole response."""
        if len(c.children) != 1:
            raise ExecError("Options() requires a single child query")
        new_opt = ExecOptions(
            exclude_row_attrs=bool(c.args.get("excludeRowAttrs", opt.exclude_row_attrs)),
            exclude_columns=bool(c.args.get("excludeColumns", opt.exclude_columns)),
            column_attrs=bool(c.args.get("columnAttrs", opt.column_attrs)),
            max_writes=opt.max_writes,
        )
        opt.column_attrs = new_opt.column_attrs
        s = c.args.get("shards")
        if s is not None:
            if not isinstance(s, list):
                raise ExecError("Options() shards must be a list")
            shards = [int(x) for x in s]
        return self._execute_call(idx, c.children[0], shards, new_opt)

    # ------------------------------------------------------------------
    # MinRow / MaxRow
    # ------------------------------------------------------------------

    def _execute_min_max_row(self, idx: Index, c: Call, shards, is_min: bool) -> dict:
        """The lowest (highest) row of a field that holds a bit (within
        the filter, when given). Unfiltered, it is read from the host row
        stores with count 1; filtered, candidates are tallied against one
        filter stack from the extreme end in windows, and the first row
        with any filtered bit wins."""
        field_name = c.string_arg("field") or c.string_arg("_field")
        if field_name is None:
            field_name = self._field_arg_name(c)
        f = self._field_of(idx, field_name)
        v = f.view(VIEW_STANDARD)
        shard_list = self._shards_for(idx, shards)
        if c.children and v is not None:
            return self._min_max_row_filtered(idx, v, c.children[0], shard_list, is_min)
        best_row = None
        if v is not None:
            for shard in shard_list:
                frag = v.fragment_if_exists(shard)
                ids = frag.row_ids() if frag is not None else None
                if not ids:
                    continue
                rid = min(ids) if is_min else max(ids)
                if best_row is None or (rid < best_row if is_min else rid > best_row):
                    best_row = rid
        return {"id": 0 if best_row is None else best_row, "count": 0 if best_row is None else 1}

    def _min_max_row_filtered(self, idx: Index, view, filter_call: Call, shard_list, is_min: bool) -> dict:
        """The filtered walk over shard chunks: a filter stack over the
        budget splits the shard axis (_chunk_by_budget), each chunk walks
        on its own, and the extreme row of the chunks wins with the count
        of every chunk whose own extreme row it is (where it has filtered
        bits, no row beyond it has any)."""
        present = [(s, frag) for s in shard_list if (frag := view.fragment_if_exists(s)) is not None]
        if not present:
            return {"id": 0, "count": 0}
        view.sync_pending(frags=[frag for _, frag in present])
        frag_of = dict(present)

        def walk(chunk, over_budget):
            return [self._min_max_row_walk(idx, view, filter_call, [(s, frag_of[s]) for s in chunk], is_min, over_budget)]

        bests = [b for b in self._chunk_by_budget(list(frag_of), walk) if b is not None]
        if not bests:
            return {"id": 0, "count": 0}
        rid = (min if is_min else max)(r for r, _ in bests)
        return {"id": rid, "count": sum(n for r, n in bests if r == rid)}

    def _min_max_row_walk(self, idx: Index, view, filter_call: Call, present, is_min: bool, over_budget: bool):
        """(row, count) of the extreme row with filtered bits in these
        shards, or None: candidates are tallied against one filter stack
        from the extreme end in windows, and the first row with any
        filtered bit wins."""
        present, sp = self._stacked_filter(idx, filter_call, present, over_budget)
        if not present:
            return None
        src_stack, src_counts = sp.rows_counted()
        if not int(src_counts.sum().item()):
            return None  # the filter matches nothing
        cand: set = set()
        for _, frag in present:
            cand.update(frag.row_ids())
        ordered = sorted(cand, reverse=not is_min)
        chunk = self._candidate_window(idx, len(present))
        for i in range(0, len(ordered), chunk):
            order, fused = self._topn_icounts_raw(view, ordered[i : i + chunk], present, src_stack)
            totals = dict(zip(order, fused.sum(axis=1).tolist()))
            for rid in ordered[i : i + chunk]:
                if totals[rid]:
                    return rid, int(totals[rid])
        return None

    @staticmethod
    def _candidate_window(idx: Index, n_shards: int) -> int:
        """Candidate rows per tally round of the MinRow/MaxRow walk: as
        many [S, W] rows as a quarter of the device budget holds, between
        16 and 4096."""
        row_bytes = max(1, n_shards) * WORDS_PER_ROW * 4
        cap = max(1, idx.dcache.budget_bytes // 4)
        return int(min(4096, max(16, cap // row_bytes)))

    # ------------------------------------------------------------------
    # TopN (two-pass protocol)
    # ------------------------------------------------------------------

    def _execute_topn(self, idx: Index, c: Call, shards) -> List[Pair]:
        ids_arg = c.args.get("ids")
        n = c.uint_arg("n")
        if not ids_arg:
            # one pass: the batched tally already holds exact counts for
            # every candidate in every present shard
            pairs = self._topn_local_full(idx, c, shards)
            if pairs is not None:
                return pairs[:n] if n else pairs
        pairs = self._topn_shards(idx, c, shards)
        if not pairs or ids_arg:
            return pairs
        # second pass: exact counts for the candidate ids
        other = Call(c.name, dict(c.args), list(c.children))
        other.args["ids"] = sorted(p.id for p in pairs)
        trimmed = self._topn_shards(idx, other, shards)
        return trimmed[:n] if n else trimmed

    def _topn_local_full(self, idx: Index, c: Call, shards) -> Optional[List[Pair]]:
        """Both TopN passes against ONE device tally per shard chunk
        (filtered queries without Tanimoto); None sends the caller to the
        two-pass path."""
        spec = self._topn_parse(idx, c)
        if spec.src_call is None or spec.tanimoto > 0:
            return None
        vp = self._topn_present(spec, self._shards_for(idx, shards))
        if vp is None:
            return []
        v, present = vp
        TOPN_STATS["one_pass"] += 1
        thr = np.uint64(max(spec.threshold, 1))
        # pass 1 survivors: threshold and attr prunes over the rank-cache
        # arrays (a shard without filter bits tallies 0 for every row)
        tops = [frag.cache_top_arrays() for _, frag in present]
        allowed = self._topn_attr_mask(spec, [r for r, _ in tops])
        surv = []
        for rids, cnts in tops:
            m = cnts >= thr
            if allowed is not None and m.any():
                m &= allowed(rids)
            surv.append((rids[m], cnts[m]))
        cand = np.unique(np.concatenate([s[0] for s in surv]))
        if not len(cand):
            return []
        ic_mat = self._topn_filtered_counts(idx, v, spec.src_call, present, [int(x) for x in cand])
        n1 = spec.n
        merged_mask = np.zeros(len(cand), bool)
        for j, (srids, scnts) in enumerate(surv):
            if not len(srids):
                continue
            pos = np.searchsorted(cand, srids)
            ic = ic_mat[pos, j]
            if n1 == 0 or len(srids) <= n1:
                merged_mask[pos[ic >= thr]] = True
                continue
            # exact cache-order walk with the reference's early stop
            taken = 0
            low = None
            for i in range(len(srids)):
                count = int(ic[i])
                if taken < n1:
                    if count < int(thr):
                        continue
                    merged_mask[pos[i]] = True
                    taken += 1
                    low = count if low is None or count < low else low
                    continue
                if low < int(thr) or int(scnts[i]) < low:
                    break
                if count < low:
                    continue
                merged_mask[pos[i]] = True
        if not merged_mask.any():
            return []
        # pass 2: a (row, shard) cell contributes iff it passes threshold
        sel = np.flatnonzero(merged_mask)
        take = ic_mat[sel] >= thr
        totals = (ic_mat[sel] * take).sum(axis=1, dtype=np.uint64)
        pairs = [Pair(id=int(cand[i]), count=int(t)) for i, t in zip(sel, totals) if t > 0]
        pairs.sort(key=lambda p: (-p.count, p.id))
        return pairs

    def _topn_parse(self, idx: Index, c: Call) -> _TopNSpec:
        field_name = c.args.get("_field")
        f = self._field_of(idx, field_name)
        if f.options.type == FIELD_TYPE_INT:
            raise ExecError(f"cannot compute TopN() on integer field: {field_name!r}")
        if f.options.cache_type == "none":
            raise ExecError(f'cannot compute TopN(), field has no cache: "{field_name}"')
        tanimoto = c.uint_arg("tanimotoThreshold") or 0
        if tanimoto > 100:
            raise ExecError("Tanimoto Threshold is from 1 to 100 only")
        if len(c.children) > 1:
            raise ExecError("TopN() can only have one input bitmap")
        attr_name = c.args.get("attrName")
        attr_values = c.args.get("attrValues")
        filters = None
        if attr_name and attr_values:
            filters = {fv for fv in attr_values if fv is not None}
        return _TopNSpec(
            f=f,
            n=c.uint_arg("n") or 0,
            ids=c.args.get("ids"),
            threshold=c.uint_arg("threshold") or DEFAULT_MIN_THRESHOLD,
            tanimoto=tanimoto,
            src_call=c.children[0] if c.children else None,
            attr_name=attr_name,
            filters=filters,
        )

    @staticmethod
    def _topn_attr_ok(spec: _TopNSpec, rid: int) -> bool:
        """Whether row `rid`'s attr `attrName` is one of `attrValues`: the
        host prune of candidates by row attrs."""
        val = spec.f.row_attr_store.attrs(rid).get(spec.attr_name)
        return val is not None and val in spec.filters

    @staticmethod
    def _topn_attr_mask(spec: _TopNSpec, row_arrays):
        """None without an attr filter; else a function from a row-id
        array (a subset of `row_arrays`' rows) to its allowed mask, each
        distinct row looked up once."""
        if spec.filters is None:
            return None
        uniq = np.unique(np.concatenate(row_arrays))
        ok = np.fromiter((Executor._topn_attr_ok(spec, int(r)) for r in uniq), bool, len(uniq))
        return lambda rids: ok[np.searchsorted(uniq, rids)]

    def _topn_pool(self, spec: _TopNSpec, frag) -> Tuple[int, list]:
        """One shard's candidate pool in rank order: explicit ids read
        exact counts (no truncation, n=0); otherwise the rank cache."""
        if spec.ids:
            ids = [int(i) for i in spec.ids]
            counts = frag.cache_counts_exact(np.asarray(ids, np.uint64))
            if counts is None:
                counts = frag.row_counts_host(ids)
            pairs = [(rid, int(cnt)) for rid, cnt in zip(ids, counts) if cnt > 0]
            pairs.sort(key=lambda p: (-p[1], p[0]))
            return 0, pairs
        return spec.n, frag.cache_top()

    @staticmethod
    def _topn_survivors(spec: _TopNSpec, pairs, use_tan: bool, src_count: int):
        if use_tan:
            min_tan = src_count * spec.tanimoto / 100.0
            max_tan = src_count * 100.0 / spec.tanimoto
        survivors: List[Tuple[int, int]] = []
        for rid, cnt in pairs:
            if cnt == 0:
                continue
            if use_tan:
                if not (min_tan < cnt < max_tan):
                    continue
            elif cnt < spec.threshold:
                continue
            if spec.filters is not None and not Executor._topn_attr_ok(spec, rid):
                continue
            survivors.append((rid, cnt))
        return survivors

    @staticmethod
    def _topn_select(spec: _TopNSpec, n: int, survivors, src_count: int, icounts):
        """The per-shard heap selection with a filter bitmap: a min-heap
        caps the result at n; cache rank order bounds the remaining
        candidates once it is full. Returns (count, rid) tuples."""
        use_tan = spec.tanimoto > 0
        results: List[Tuple[int, int]] = []
        for rid, cnt in survivors:
            if n == 0 or len(results) < n:
                count = icounts[rid]
                if count == 0:
                    continue
                if use_tan:
                    t = math.ceil(count * 100 / (cnt + src_count - count))
                    if t <= spec.tanimoto:
                        continue
                elif count < spec.threshold:
                    continue
                heapq.heappush(results, (count, rid))
                continue
            low = results[0][0]
            if low < spec.threshold or cnt < low:
                break
            count = icounts[rid]
            if count < low:
                continue
            heapq.heappush(results, (count, rid))
        return results

    def _topn_shards(self, idx: Index, c: Call, shards) -> List[Pair]:
        spec = self._topn_parse(idx, c)
        merged = self._topn_merged_batched(spec, idx, self._shards_for(idx, shards))
        pairs = [Pair(id=i, count=cnt) for i, cnt in merged.items()]
        pairs.sort(key=lambda p: (-p.count, p.id))
        return pairs

    def _topn_merged_batched(self, spec: _TopNSpec, idx: Index, shard_list) -> Dict[int, int]:
        """All shards' TopN tallies, batched: candidates from the rank
        caches; a filter bitmap lowers to one plan per budget-sized shard
        chunk, and each chunk's survivors' intersection counts come from
        one device tally (per-shard selections add across chunks)."""
        vp = self._topn_present(spec, shard_list)
        if vp is None:
            return {}
        v, present = vp
        TOPN_STATS["batched"] += 1
        if spec.src_call is None:
            return self._topn_merged_hostfast(spec, present)
        merged: Dict[int, int] = {}
        self._topn_filter_chunks(
            idx, spec.src_call, present, lambda sub, src_stack: self._topn_merge_chunk(spec, v, sub, src_stack, merged)
        )
        return merged

    def _topn_merge_chunk(self, spec: _TopNSpec, v, present, src_stack, merged: Dict[int, int]) -> None:
        """Add one shard chunk's per-shard TopN selections to `merged`."""
        use_tan = spec.tanimoto > 0
        src_counts = None
        if use_tan:
            TOPN_STATS["tally_evals"] += 1
            src_counts = kernels.rows_counts(src_stack).cpu().numpy()[: len(present)]
        pools = []
        cand_union: Dict[int, None] = {}
        for j, (_, frag) in enumerate(present):
            n, pairs = self._topn_pool(spec, frag)
            sc = int(src_counts[j]) if use_tan else 0
            survivors = self._topn_survivors(spec, pairs, use_tan, sc)
            pools.append((n, survivors, sc))
            for rid, _ in survivors:
                cand_union[rid] = None
        ic_rows: Dict[int, np.ndarray] = {}
        if cand_union:
            order, fused = self._topn_icounts_raw(v, sorted(cand_union), present, src_stack)
            ic_rows = {rid: fused[k] for k, rid in enumerate(order)}
        for j, (n, survivors, sc) in enumerate(pools):
            icounts = {rid: int(ic_rows[rid][j]) for rid, _ in survivors}
            for count, rid in self._topn_select(spec, n, survivors, sc, icounts):
                merged[rid] = merged.get(rid, 0) + count

    def _topn_filter_chunks(self, idx: Index, filter_call: Call, present, tally) -> None:
        """Lower the filter over the present shards in budget-sized chunks
        (_chunk_by_budget: halves, then single shards over the budget, as
        the reference's per-shard route answers) and call tally(sub,
        src_stack) for each chunk with filter bits, `sub` its present
        (shard, fragment) pairs; each chunk's stack is tallied before the
        next is lowered."""
        frag_of = dict(present)

        def one(chunk, over_budget):
            sub, sp = self._stacked_filter(idx, filter_call, [(s, frag_of[s]) for s in chunk], over_budget)
            if sub:
                tally(sub, sp.rows_full())
            return [len(sub)]

        TOPN_STATS["chunks"] += len(self._chunk_by_budget(list(frag_of), one))

    def _topn_filtered_counts(self, idx: Index, view, filter_call: Call, present, cand: List[int]) -> np.ndarray:
        """uint64[len(cand), len(present)]: each candidate row's count
        within the filter in each present shard, the chunks' columns
        merged on the host (0 where the filter is empty)."""
        ic = np.zeros((len(cand), len(present)), np.uint64)
        col_of = {s: j for j, (s, _) in enumerate(present)}
        row_of = {rid: k for k, rid in enumerate(cand)}

        def tally(sub, src_stack) -> None:
            if cand:
                order, fused = self._topn_icounts_raw(view, cand, sub, src_stack)
                ic[np.ix_([row_of[r] for r in order], [col_of[s] for s, _ in sub])] = fused

        self._topn_filter_chunks(idx, filter_call, present, tally)
        return ic

    @staticmethod
    def _topn_merged_hostfast(spec: _TopNSpec, present) -> Dict[int, int]:
        """The no-filter merge: counts are exact host metadata, so both
        passes are vectorized rank-cache walks with no device work."""
        merged: Dict[int, int] = {}
        if spec.ids:
            # explicit ids: no truncation; per shard, counts >= threshold
            ids = [int(i) for i in spec.ids]
            allowed = Executor._topn_attr_mask(spec, [np.asarray(ids, np.uint64)])
            if allowed is not None:
                ids = [rid for rid, ok in zip(ids, allowed(np.asarray(ids, np.uint64))) if ok]
            if not ids:
                return merged
            ids_arr = np.asarray(ids, np.uint64)
            totals = np.zeros(len(ids), np.uint64)
            thr = np.uint64(spec.threshold)
            for _, frag in present:
                c = frag.cache_counts_exact(ids_arr)
                if c is None:
                    c = frag.row_counts_host(ids)
                c[c < thr] = 0
                totals += c
            for rid, cnt in zip(ids, totals):
                if cnt:
                    merged[rid] = merged.get(rid, 0) + int(cnt)
            return merged
        # pass 1: per-shard top-n of the rank cache (sorted descending, so
        # the threshold cut is a prefix), merged with one bincount
        n = spec.n
        thr = np.uint64(max(spec.threshold, 1))
        sel_rids, sel_cnts = [], []
        tops = [frag.cache_top_arrays() for _, frag in present]
        allowed = Executor._topn_attr_mask(spec, [r for r, _ in tops])
        for rids, cnts in tops:
            end = int(np.searchsorted(-cnts.view(np.int64), -int(thr), "right"))
            rids, cnts = rids[:end], cnts[:end]
            if allowed is not None and len(rids):
                m = allowed(rids)
                rids, cnts = rids[m], cnts[m]
            if n and len(rids) > n:
                rids, cnts = rids[:n], cnts[:n]
            if len(rids):
                sel_rids.append(rids)
                sel_cnts.append(cnts)
        if sel_rids:
            uniq, inv = np.unique(np.concatenate(sel_rids), return_inverse=True)
            # float64 weights are exact below 2^53
            totals = np.bincount(inv, weights=np.concatenate(sel_cnts).astype(np.float64))
            for rid, t in zip(uniq, totals):
                merged[int(rid)] = int(t)
        return merged

    def _topn_present(self, spec: _TopNSpec, shard_list):
        """(standard view, present (shard, fragment) pairs), or None when
        the view or every listed fragment is absent."""
        v = spec.f.view(VIEW_STANDARD)
        if v is None:
            return None
        present = [(s, frag) for s in shard_list if (frag := v.fragment_if_exists(s)) is not None]
        if not present:
            return None
        v.sync_pending(frags=[frag for _, frag in present])
        return v, present

    def _stacked_filter(self, idx: Index, filter_call: Call, present, over_budget: bool):
        """Lower a filter bitmap over the present fragments' shards.
        Returns (present, plan), `present` restricted to the plan's
        out_shards when compaction dropped shards (they hold no filter
        bits); ([], None) when the filter is empty everywhere. Stacks over
        the budget raise BudgetExceeded unless `over_budget`: callers
        walk _chunk_by_budget's shard chunks."""
        pshards = [s for s, _ in present]
        lowered = self._lower_roots(idx, [filter_call], pshards, over_budget=over_budget)
        if lowered is self._EMPTY:
            return [], None
        roots, low, n_out, out_shards = lowered
        sp = StackedPlan(roots[0], low.operands, n_out, out_shards, extents=low.extents)
        if sp.out_shards != pshards:
            outs = set(sp.out_shards)
            present = [(s, frag) for s, frag in present if s in outs]
        return present, sp

    def _topn_icounts_raw(self, view, cand: List[int], present, src_stack):
        """Intersection counts of every candidate row with the filter in
        every present shard, with ONE host read: (row order, uint64[R, S]).
        Rows sparse in every present shard tally only their live words
        (gather_tally); rows dense anywhere go through [R_c, S, W] plane
        stacks (rows_counts)."""
        pshards = tuple(s for s, _ in present)
        n_present = len(present)
        s_full, w = src_stack.shape
        bundle = view.dcache.get_or_build(
            view._stack_key("topn_sparse", tuple(cand), pshards),
            lambda: self._topn_tally_build(cand, present, w, src_stack.device),
        )
        parts: List[torch.Tensor] = []
        order: List[int] = []
        with planmod.dispatch_mutex():
            r_c = gb.gmax(s_full, w)
            for i in range(0, len(bundle.dense_rows), r_c):
                ids = bundle.dense_rows[i : i + r_c]
                table = ExtentTable(view.dcache)
                try:
                    planes = view.plane_stack(ids, pshards, extents=table)
                    TOPN_STATS["tally_evals"] += 1
                    counts = kernels.counts_cross(src_stack[None, : planes.shape[1]], planes)[0]
                finally:
                    table.release()
                parts.append(counts[:, :n_present])
                order.extend(ids)
            if bundle.sparse_rows:
                n_sparse = len(bundle.sparse_rows)
                if bundle.dev is None:
                    parts.append(
                        torch.zeros((n_sparse, n_present), dtype=torch.int32, device=src_stack.device)
                    )
                else:
                    TOPN_STATS["tally_evals"] += 1
                    seg = kernels.gather_tally(src_stack, *bundle.dev)
                    parts.append(seg.reshape(n_present, n_sparse).T)
                order.extend(bundle.sparse_rows)
            if not order:
                return [], np.empty((0, n_present), np.uint64)
            fused = torch.cat(parts).cpu().numpy().astype(np.uint64)
            planmod.STATS["host_reads"] += 1
        return order, fused

    @staticmethod
    def _topn_tally_build(cand: List[int], present, w: int, device) -> _TallyBundle:
        """Split candidates into dense (a dense rep in any present shard)
        and sparse rows, and fold the sparse rows' live bits into sorted
        (word index, mask) entries with segment bounds, one segment per
        (present shard j, sparse row k) at j * n_sparse + k. Shard-major:
        every row's entries for shard j lie next to each other, so the
        gather_tally kernel's warps in flight gather from the same few
        shards' words at once and L2 serves each word's sector to all
        the rows that need it."""
        r_all = len(cand)
        n_present = len(present)
        cats, lens = [], []
        for _, frag in present:
            c_, l_ = frag.rows_sparse_concat(cand)
            cats.append(c_)
            lens.append(l_)
        lens_mat = np.stack(lens)  # [S, R]; -1 marks a dense rep
        dense_mask = (lens_mat < 0).any(axis=0)
        if int(np.clip(lens_mat, 0, None).sum()) >= 1 << 27:
            dense_mask = np.ones(r_all, bool)  # keep int32 segment sums exact
        dense_rows = [rid for i, rid in enumerate(cand) if dense_mask[i]]
        sparse_rows = [rid for i, rid in enumerate(cand) if not dense_mask[i]]
        dev = None
        if sparse_rows:
            n_sparse = len(sparse_rows)
            k_of = np.full(r_all, -1, np.int64)
            k_of[~dense_mask] = np.arange(n_sparse)
            wkey_parts, bit_parts = [], []
            for j in range(n_present):
                l_ = np.clip(lens_mat[j], 0, None)
                if not l_.sum():
                    continue
                rows_per_el = np.repeat(np.arange(r_all), l_)
                keep = ~dense_mask[rows_per_el]
                pos = cats[j][keep].astype(np.int64)
                seg = j * n_sparse + k_of[rows_per_el[keep]]
                wkey_parts.append(seg * w + (pos >> 5))
                bit_parts.append(np.uint32(1) << (pos & np.int64(31)).astype(np.uint32))
            if wkey_parts:
                wkeys = np.concatenate(wkey_parts)
                bits = np.concatenate(bit_parts)
                o = np.argsort(wkeys, kind="stable")
                sk, sb = wkeys[o], bits[o]
                new_grp = np.empty(len(sk), bool)
                new_grp[0] = True
                np.not_equal(sk[1:], sk[:-1], out=new_grp[1:])
                gstart = np.flatnonzero(new_grp)
                masks = np.bitwise_or.reduceat(sb, gstart)
                uk = sk[gstart]
                seg_of = uk // w
                idx = ((seg_of // n_sparse) * w + uk % w).astype(np.int32)
                segs = np.arange(n_sparse * n_present)
                starts = np.searchsorted(seg_of, segs, "left").astype(np.int32)
                ends = np.searchsorted(seg_of, segs, "right").astype(np.int32)
                dev = tuple(
                    torch.from_numpy(a).to(device)
                    for a in (idx, masks.view(np.int32), starts, ends)
                )
        return _TallyBundle(dense_rows, sparse_rows, dev)

    # ------------------------------------------------------------------
    # Rows / GroupBy
    # ------------------------------------------------------------------

    def _execute_rows(self, idx: Index, c: Call, shards) -> List[int]:
        """The sorted ids of the field's rows that hold a bit (in `column`
        when given) in any listed shard, after `previous`, at most
        `limit`. Read from the host row stores: no device work."""
        field_name = c.string_arg("field") or c.args.get("_field")
        if not field_name:
            raise ExecError("Rows() field required")
        col = c.uint_arg("column")
        if col is not None:
            shards = [col // SHARD_WIDTH]
        limit = c.uint_arg("limit")
        f = self._field_of(idx, field_name)
        views = [v for vname in self._rows_views(f, c) if (v := f.view(vname)) is not None]
        merged: set = set()
        for shard in self._shards_for(idx, shards):
            for v in views:
                frag = v.fragment_if_exists(shard)
                if frag is None:
                    continue
                ids = frag.row_ids()
                if col is not None:
                    merged.update(r for r in ids if frag.contains(r, col % SHARD_WIDTH))
                elif ids:
                    counts = frag.row_counts_host(ids)
                    merged.update(r for r, n in zip(ids, counts) if n)
        out = sorted(merged)
        prev = c.uint_arg("previous")
        if prev is not None:
            out = [r for r in out if r > prev]
        if limit is not None:
            out = out[:limit]
        return out

    def _rows_views(self, f: Field, c: Call) -> List[str]:
        """The views Rows lists: a time field's minimal covering set for
        `from`/`to` (an open bound takes the field's span; every time view
        without a standard view), else the standard view."""
        from_arg, to_arg = c.args.get("from"), c.args.get("to")
        o = f.options
        if o.type != FIELD_TYPE_TIME or (from_arg is None and to_arg is None and not o.no_standard_view):
            return [VIEW_STANDARD]
        if not o.time_quantum:
            return []
        lo, hi = self._field_time_bounds(f)
        if lo is None:
            return []
        from_t = timeq.parse_time(from_arg) if from_arg is not None else lo
        to_t = timeq.parse_time(to_arg) if to_arg is not None else hi
        return timeq.views_by_time_range(VIEW_STANDARD, from_t, to_t, o.time_quantum)

    def _execute_group_by(self, idx: Index, c: Call, shards) -> List[GroupCount]:
        if not c.children:
            raise ExecError("need at least one child call")
        for child in c.children:
            if child.name != "Rows":
                raise ExecError(
                    f"'{child.name}' is not a valid child query for GroupBy, must be 'Rows'"
                )
        limit = c.uint_arg("limit")
        filter_call = c.args.get("filter")
        if filter_call is not None and not isinstance(filter_call, Call):
            raise ExecError("GroupBy filter must be a query")

        # The cursor: per-child Rows(previous=) plus the list form
        # previous=[...]; both resume the sorted cross-product after the
        # previous group (a lexicographic >= against the anchor below).
        prevs: List[Optional[int]] = [ch.uint_arg("previous") for ch in c.children]
        gprev = c.args.get("previous")
        if gprev is not None:
            # translate_call reports shape errors first; this guards
            # direct calls with an untranslated tree
            if not isinstance(gprev, list) or len(gprev) != len(c.children):
                raise ExecError("GroupBy previous must be a list with one entry per child")
            for i, pv in enumerate(gprev):
                if prevs[i] is None:
                    prevs[i] = int(pv)

        # Each child's row universe. Without a child limit or column, its
        # previous must not prune the list (a non-last child's previous
        # row still heads later groups); with one, Rows applies previous
        # before limit and the pruned list is the universe.
        child_fields = []
        child_rows: List[List[int]] = []
        for child in c.children:
            child_fields.append(child.string_arg("field") or child.args.get("_field"))
            saved_prev = None
            if "limit" not in child.args and "column" not in child.args:
                saved_prev = child.args.pop("previous", None)
            try:
                child_rows.append(self._execute_rows(idx, child, shards))
            finally:
                if saved_prev is not None:
                    child.args["previous"] = saved_prev
            if not child_rows[-1]:
                return []

        anchor: Optional[Tuple[int, ...]] = None
        if any(p is not None for p in prevs):
            # children without a previous anchor at their first row, the
            # last child one past its previous; groups >= the anchor stay
            last = len(c.children) - 1
            anchor = tuple(
                (prevs[i] + (1 if i == last else 0)) if prevs[i] is not None else child_rows[i][0]
                for i in range(len(c.children))
            )
            # first rows below anchor[0] head only groups below it
            child_rows[0] = [r for r in child_rows[0] if r >= anchor[0]]
            if not child_rows[0]:
                return []

        merged = self._group_by_stacked(
            idx, child_fields, child_rows, filter_call, self._shards_for(idx, shards)
        )
        if anchor is not None:
            merged = {k: v for k, v in merged.items() if k >= anchor}
        out = [
            GroupCount(
                group=[FieldRow(field=fn, row_id=rid) for fn, rid in zip(child_fields, key)],
                count=cnt,
            )
            for key, cnt in merged.items()
            if cnt > 0
        ]
        out.sort(key=lambda g: g.compare_key())
        offset = c.uint_arg("offset")
        if offset:
            out = out[offset:]
        if limit is not None:
            out = out[:limit]
        return out

    def _group_by_stacked(
        self, idx: Index, child_fields, child_rows, filter_call, shard_list
    ) -> Dict[Tuple[int, ...], int]:
        """The GroupBy tally over stacked [R, S, W] child planes and the
        filter's [S, W] rows (the rows plan, Shift included), on the
        shards where every child has a fragment (only there can a group
        hold a bit). Stacks over the device budget split the shard list;
        group counts add across the pieces."""
        child_views = []
        for fname in child_fields:
            v = self._field_of(idx, fname).view(VIEW_STANDARD)
            if v is None:
                return {}
            child_views.append(v)
        gb_shards = [
            s for s in shard_list if all(v.fragment_if_exists(s) is not None for v in child_views)
        ]

        def one(chunk, over_budget) -> List[Dict[Tuple[int, ...], int]]:
            budget = None if over_budget else planmod.stack_budget(idx.dcache)
            filt = None
            if filter_call is not None:
                lowered = self._lower_roots(idx, [filter_call], chunk, over_budget)
                if lowered is self._EMPTY:
                    return []  # the filter matches nothing here
                roots, low, n_out, out_shards = lowered
                filt = StackedPlan(roots[0], low.operands, n_out, out_shards, extents=low.extents).rows()
                chunk = out_shards  # compaction dropped shards without filter bits
            table = ExtentTable(idx.dcache)
            try:
                planes_list = []
                with idx.dcache.deferred_eviction():
                    for v, rows in zip(child_views, child_rows):
                        if budget is not None and len(chunk) * WORDS_PER_ROW * 4 * len(rows) > budget:
                            raise BudgetExceeded("GroupBy plane stack exceeds the device budget")
                        planes_list.append(v.plane_stack(rows, chunk, extents=table))
                with planmod.dispatch_mutex():
                    return [gb.group_by_device(planes_list, child_rows, filt)]
            finally:
                table.release()

        merged: Dict[Tuple[int, ...], int] = {}
        for part in self._chunk_by_budget(gb_shards, one):
            for key, cnt in part.items():
                merged[key] = merged.get(key, 0) + cnt
        return merged
