"""Stacked query plans: a whole PQL bitmap tree evaluated over [S, W]
device row stacks (one row across S shards) in one dispatch.

The port of pilosa_tpu/exec/plan.py. The executor lowers a bitmap call
tree to a small static tree of plan nodes over operand stacks; this module
evaluates it:

- count / total / shard_counts run the plan_count kernel, and a
  MultiCountPlan's roots one plan_count_multi launch: the tree is
  compiled to a postfix program over any number of leaf stacks and
  evaluated word by word on the card with nothing intermediate written to
  memory, giving exact int64 per-shard counts. `total` sums them on the
  device (exact, so the reference's halfword pair is not needed).
- row mode (rows / rows_counted / rows_full) runs the plan_rows kernel:
  the same program, storing the result words and each row's count, with
  a PShift over a leaf as a shifted leaf (its overflow carried into the
  next shard's row); a PShift over any other subtree first materializes
  that subtree with its own plan_rows launch. The result is always a
  fresh tensor, never an operand, so no caller reads a cached entry
  after its pins are gone.
- in count mode a PShift enters plan_count as its plan_rows result; a
  Shift root is counted by that plan_rows launch alone.
- BSI condition rows (PRangeEQ / PRangeCmp / PRangeBetween) are
  materialized by the bsi_range kernel in rows mode and enter either
  kernel as leaves.

STATS counts dispatches (`evals`) and blocking device->host reads
(`host_reads`); one dispatch lock serializes them.

A plan carries the ExtentTable (hbm/residency.py) of the pins its
lowering took on its operands' extents and releases it in each dispatch
method's `finally`, once its kernels are queued (release is idempotent;
a released plan still runs, since it holds its operand tensors).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.ops import kernels

STATS = {"evals": 0, "host_reads": 0}

_DISPATCH_MU = threading.Lock()


def reset_stats() -> None:
    STATS["evals"] = 0
    STATS["host_reads"] = 0


def dispatch_mutex() -> threading.Lock:
    return _DISPATCH_MU


class Unsupported(Exception):
    """A call shape with no stacked form."""


class BudgetExceeded(Unsupported):
    """The stacks for this shard list would exceed the device budget; the
    executor splits the shard axis and evaluates chunked plans."""


def stack_budget(cache) -> int:
    """The bytes one query's stacks over one shard chunk may take: a
    quarter of the device budget. The executor's per-shard pass (below
    16 shards) lowers with its guards off instead (`over_budget`): the
    device cache admits a single entry over budget."""
    return cache.budget_bytes // 4


class SparseView(Unsupported):
    """A view is materialized in too few of the requested shards for a
    dense stack to be economical; the executor re-lowers over a compacted
    shard list."""


# ---------------------------------------------------------------------------
# Plan nodes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PNode:
    pass


@dataclass(frozen=True)
class PLeaf(PNode):
    """Operand reference: operands[slot] is an int32[S, W] row stack."""

    slot: int


@dataclass(frozen=True)
class PNary(PNode):
    """n-ary set algebra; op in {and, or, xor, andnot}. andnot folds left:
    c0 &~ c1 &~ c2 ..."""

    op: str
    children: Tuple[PNode, ...]


@dataclass(frozen=True)
class PShift(PNode):
    """Shift bits up by n within each shard, carrying overflow into the
    following shard. prev_idx[i] is the stack index holding shard_id-1 for
    stack position i, or -1 when that shard is absent."""

    child: PNode
    n: int
    prev_idx: Tuple[int, ...]


@dataclass(frozen=True)
class PRangeEQ(PNode):
    """BSI magnitude == pred within the base mask. The mask is formed from
    the `exists` node and the `sign` node (None: an unsigned field) by
    `sel` in {consider, pos, neg}; `planes` is the operand slot of the
    int32[D, S, W] plane stack. Predicates are plain ints (nothing is
    traced)."""

    exists: PNode
    sign: Optional[PNode]
    sel: str
    planes: int
    pred: int


@dataclass(frozen=True)
class PRangeCmp(PNode):
    """BSI magnitude < (kind lt) or > (kind gt) pred, or <= / >= with
    allow_eq, within the base mask (as PRangeEQ)."""

    kind: str
    exists: PNode
    sign: Optional[PNode]
    sel: str
    planes: int
    pred: int
    allow_eq: bool


@dataclass(frozen=True)
class PRangeBetween(PNode):
    """BSI lo <= magnitude <= hi within the base mask (as PRangeEQ)."""

    exists: PNode
    sign: Optional[PNode]
    sel: str
    planes: int
    lo: int
    hi: int


_RANGE_NODES = (PRangeEQ, PRangeCmp, PRangeBetween)


@dataclass(frozen=True)
class PZero(PNode):
    """All-zero stack (absent rows)."""


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def _shape(operands: Sequence[torch.Tensor]) -> Tuple[int, int]:
    return tuple(operands[0].shape)


def _rows(node: PNode, operands, memo: Dict[int, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row mode: the node's fresh [S, W] result words and per-row counts
    from one plan_rows launch (none for an all-zero node)."""
    leaves, shifts, prog = _compile(node, operands, memo, rows_mode=True)
    if not leaves:
        s, w = _shape(operands)
        dev = operands[0].device
        return torch.zeros((s, w), dtype=torch.int32, device=dev), torch.zeros(s, dtype=torch.int64, device=dev)
    return kernels.plan_rows(leaves, shifts, prog)


def _input(node: PNode, operands, memo: Dict[int, torch.Tensor]) -> torch.Tensor:
    """The [S, W] words a node feeds a kernel as a leaf: an operand as it
    is, a range node's bsi_range rows, any other node's plan_rows result
    (each computed once per evaluation)."""
    if isinstance(node, PLeaf):
        return operands[node.slot]
    hit = memo.get(id(node))
    if hit is None:
        if isinstance(node, _RANGE_NODES):
            hit = _range_rows(node, operands, memo)
        else:
            hit = _rows(node, operands, memo)[0]
        memo[id(node)] = hit
    return hit


def _range_rows(node: PNode, operands, memo) -> torch.Tensor:
    """A range node's [S, W] result words from one bsi_range launch."""
    exists = _input(node.exists, operands, memo)
    sign = None if node.sign is None else _input(node.sign, operands, memo)
    planes = operands[node.planes]
    if isinstance(node, PRangeEQ):
        kind, allow_eq, p0, p1 = "eq", False, node.pred, 0
    elif isinstance(node, PRangeCmp):
        kind, allow_eq, p0, p1 = node.kind, node.allow_eq, node.pred, 0
    else:
        kind, allow_eq, p0, p1 = "between", False, node.lo, node.hi
    return kernels.bsi_range(planes, exists, sign, node.sel, kind, allow_eq, p0, p1, "rows")


def _need(node: PNode, memo: Dict[int, int]) -> int:
    """Operand-stack entries the postfix program of `node` needs when each
    n-ary node emits its children deepest first: at most
    floor(log2(leaf occurrences)) + 1."""
    hit = memo.get(id(node))
    if hit is None:
        hit = 1
        if isinstance(node, PNary):
            ds = sorted((_need(c, memo) for c in node.children), reverse=True)
            hit = max(ds[0], 1 + ds[1]) if len(ds) > 1 else ds[0]
        memo[id(node)] = hit
    return hit


def _compile(root: PNode, operands, memo: Dict[int, torch.Tensor], rows_mode: bool = False):
    """Postfix program for the plan_count (rows_mode False) or plan_rows
    kernel: (leaf stacks, their shifts, program). Range nodes enter as
    their bsi_range rows. A PShift enters plan_rows as a shifted leaf:
    its child's stack when the child is a leaf, else the child's plan_rows
    result (a launch first); it enters plan_count as its own plan_rows
    result.

    Each n-ary node folds its children into the value on top of the stack,
    deepest child first, so the stack depth grows with the log of the
    tree's size, not with its width or nesting. and/or/xor reorder freely;
    for andnot (c0 &~ c1 &~ ...) the subtracted children met before c0 are
    or-ed together, c0 then takes `rev_andnot` against that union, and
    the rest fold with `andnot`."""
    leaves: List[torch.Tensor] = []
    shifts: List[Optional[Tuple[int, Tuple[int, ...]]]] = []
    leaf_of: Dict[Tuple[str, int], int] = {}
    prog: List[int] = []
    need: Dict[int, int] = {}

    def leaf(key: Tuple[str, int], make, shift=None) -> None:
        i = leaf_of.get(key)
        if i is None:
            i = leaf_of[key] = len(leaves)
            leaves.append(make())
            shifts.append(shift)
        prog.append(i)

    def emit(node: PNode) -> None:
        if isinstance(node, PLeaf):
            leaf(("slot", node.slot), lambda: operands[node.slot])
        elif isinstance(node, PZero):
            prog.append(kernels.PUSH_ZERO)
        elif isinstance(node, PNary):
            ch = node.children
            order = sorted(range(len(ch)), key=lambda i: -_need(ch[i], need))
            head_seen = False
            for k, i in enumerate(order):
                emit(ch[i])
                if node.op != "andnot":
                    op = node.op
                elif i == 0:
                    head_seen, op = True, "rev_andnot"
                else:
                    op = "andnot" if head_seen else "or"
                if k:
                    prog.append(kernels.BINOPS[op])
        elif isinstance(node, PShift) and rows_mode:
            kernels.check_shift(node.n, _shape(operands)[1])
            leaf(("shift", id(node)), lambda: _input(node.child, operands, memo), (node.n, node.prev_idx))
        elif isinstance(node, (PShift,) + _RANGE_NODES):
            leaf(("node", id(node)), lambda: _input(node, operands, memo))
        else:
            raise AssertionError(type(node))

    emit(root)
    return leaves, shifts, prog


def _root_counts(root: PNode, operands, n_shards: int) -> torch.Tensor:
    """int64[n_shards] per-shard counts of one root, on the device. A
    Shift root is counted by the plan_rows launch that shifts it: its
    result's row counts, with no plan_count pass over that result."""
    if isinstance(root, PShift):
        return _rows(root, operands, {})[1][:n_shards]
    leaves, _, prog = _compile(root, operands, {})
    if not leaves:  # the root is all-zero
        return torch.zeros(n_shards, dtype=torch.int64, device=operands[0].device)
    return kernels.plan_count(leaves, prog, n_shards)


class _Pinned:
    """The extent release every plan shares."""

    __slots__ = ()

    def release_extents(self) -> None:
        """Unpin this plan's operand extents (idempotent); the executor's
        error paths call it too, so a plan never dispatched leaks none."""
        if self.extents is not None:
            self.extents.release()


class StackedPlan(_Pinned):
    """A lowered plan plus its operand stacks, ready to evaluate.

    `out_shards` maps output stack positions 0..n_shards-1 back to shard
    ids (compacted lowering covers only present shards); stack rows past
    n_shards are Shift predecessors the output excludes."""

    __slots__ = ("root", "operands", "n_shards", "out_shards", "extents")

    def __init__(self, root, operands, n_shards, out_shards=None, extents=None):
        self.root = root
        self.operands = operands
        self.n_shards = n_shards
        self.out_shards = out_shards
        self.extents = extents

    def _counts(self) -> torch.Tensor:
        STATS["evals"] += 1
        try:
            return _root_counts(self.root, self.operands, self.n_shards)
        finally:
            self.release_extents()

    def count(self) -> int:
        """Total count: one dispatch + one [S] host read, summed exactly."""
        with _DISPATCH_MU:
            counts = self._counts()
            STATS["host_reads"] += 1
            return int(counts.cpu().sum())

    def total(self) -> int:
        """Grand total reduced on the device: one dispatch + one scalar read."""
        with _DISPATCH_MU:
            total = self._counts().sum()
            STATS["host_reads"] += 1
            return int(total.item())

    def shard_counts(self) -> np.ndarray:
        with _DISPATCH_MU:
            counts = self._counts()
            STATS["host_reads"] += 1
            return counts.cpu().numpy()

    def rows_counted(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fresh result stack, Shift predecessor rows included, and
        its per-row counts (int64, on the device): one plan_rows launch
        for the root, after one per Shift over a subtree."""
        with _DISPATCH_MU:
            STATS["evals"] += 1
            try:
                return _rows(self.root, self.operands, {})
            finally:
                self.release_extents()

    def rows_full(self) -> torch.Tensor:
        """Materialized result stack, Shift predecessor rows included."""
        return self.rows_counted()[0]

    def rows(self) -> torch.Tensor:
        """Materialized [n_shards, W] result stack."""
        return self.rows_full()[: self.n_shards]


def _multi_counts(roots: Sequence[PNode], operands, n_shards: int) -> torch.Tensor:
    """int64[N, n_shards] per-shard counts of several roots, on the
    device: every root but a Shift root in one plan_count_multi launch
    (more only where the distinct leaves outgrow one launch's shared
    memory), each leaf read once for all of them; range and Shift
    subtrees are computed once for every root that holds them (one
    memo). A Shift root is counted by its own plan_rows launch, and a
    root that alone reads more leaves than a launch holds by its own
    plan_count launch, as in _root_counts."""
    memo: Dict[int, torch.Tensor] = {}
    leaves: List[torch.Tensor] = []
    slot_of: Dict[int, int] = {}
    progs: List[List[int]] = []
    which: List[int] = []
    out: List[Optional[torch.Tensor]] = [None] * len(roots)
    for r, root in enumerate(roots):
        if isinstance(root, PShift):
            out[r] = _rows(root, operands, memo)[1][:n_shards]
            continue
        own, _, prog = _compile(root, operands, memo)
        if own and not kernels.fits_multi(prog):
            out[r] = kernels.plan_count(own, prog, n_shards)
            continue
        remap = []
        for t in own:
            i = slot_of.get(id(t))
            if i is None:
                i = slot_of[id(t)] = len(leaves)
                leaves.append(t)
            remap.append(i)
        progs.append([remap[i] if i >= 0 else i for i in prog])
        which.append(r)
    if progs:
        if leaves:
            counts = kernels.plan_count_multi(leaves, progs, n_shards)
        else:  # every such root is all-zero
            counts = torch.zeros((len(progs), n_shards), dtype=torch.int64, device=operands[0].device)
        for k, r in enumerate(which):
            out[r] = counts[k]
    return torch.stack(out) if len(which) < len(roots) else counts


class MultiCountPlan(_Pinned):
    """Several lowered roots over one shared operand set: a multi-Count
    query as one dispatch (one plan_count_multi launch for all roots but
    Shift roots) and one [N, S] host read. The reference pads a batch to
    a power of two with all-zero roots so XLA compiles one program per
    size family; a hand-written kernel has no compile cache to serve, so
    the port runs exactly the roots it is given."""

    __slots__ = ("roots", "operands", "n_shards", "out_shards", "extents")

    def __init__(self, roots, operands, n_shards, out_shards=None, extents=None):
        self.roots = list(roots)
        self.operands = operands
        self.n_shards = n_shards
        self.out_shards = out_shards
        self.extents = extents

    def _counts(self) -> torch.Tensor:
        STATS["evals"] += 1
        try:
            return _multi_counts(self.roots, self.operands, self.n_shards)
        finally:
            self.release_extents()

    def counts(self) -> List[int]:
        with _DISPATCH_MU:
            h = self._counts().cpu()
            STATS["host_reads"] += 1
        return [int(x) for x in h.sum(dim=1)]

    def totals(self) -> List[int]:
        with _DISPATCH_MU:
            h = self._counts().sum(dim=1).cpu()
            STATS["host_reads"] += 1
        return [int(x) for x in h]
