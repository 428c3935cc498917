"""Whole-field BSI aggregates and single-condition range counts.

The port of pilosa_tpu/exec/bsistream.py. Each shard chunk stages the
field's [D, S, W] plane stack and its [S, W] word rows (exists, and sign
for a signed field) once, then answers with ONE kernel launch over the
whole stack and one small host read:

- Sum: bsi_sum, the exact [1 + 2D] tally combined on the host as
  sum_d 2^d (pos_d - neg_d) + count * base;
- Min/Max: bsi_min_max, the virtual-key ladder reduced in the kernel,
  decoded on the host;
- Count(Row(<condition>)): one bsi_range launch in count mode per job of
  the predicate's sign/saturation decomposition (`_decompose`), plus the
  plain mask terms counted by plan_count, combined with +/-1 weights.

The kernels read every plane word once per word group, so the reference's
slab streaming (carried-state step/finish programs, the bsi-slab-planes
knob) is not ported. The shard axis is still chunked under the device
budget: (D + 3) x S x W x 4 bytes must fit a quarter of it. A chunk's
stacks are staged as extents in one deferred-eviction session, pinned
until its launches are queued.

Fields whose range cannot store negatives (min >= base) skip the sign row
entirely; a signed field 32 bits deep keys Min/Max on 33 bits, which the
kernel's 64-bit key holds. An aggregate's filter lowers through the
executor's stacked lowering over the chunk's shards plus each one's
Shift predecessors, so a Shift in the filter carries across shards (and
across chunk boundaries: each chunk reads its predecessors from
storage); a non-call `filter=` argument is no filter, as in the
reference.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from pilosa_tpu_torch.core.fragment import BSI_EXISTS_BIT, BSI_OFFSET_BIT, BSI_SIGN_BIT
from pilosa_tpu_torch.exec import plan as planmod
from pilosa_tpu_torch.exec.plan import BudgetExceeded, StackedPlan
from pilosa_tpu_torch.hbm.residency import ExtentTable
from pilosa_tpu_torch.ops import bsi as obsi
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.pql.ast import BETWEEN, EQ, GT, GTE, LT, LTE, NEQ
from pilosa_tpu_torch.shardwidth import WORDS_PER_ROW

_EMPTY = "empty"  # chunk sentinel: no data -> zero contribution

# decomposition sentinel: the predicate provably matches nothing
_ZERO = ((), (), (), ())

# condition operators by the names Field.base_value takes
COND_OP_NAME = {EQ: "eq", NEQ: "neq", LT: "lt", LTE: "lte", GT: "gt", GTE: "gte"}

# plan_count programs over the leaves [exists, sign] for the mask terms
_MASK_PROGRAMS = {
    "consider": [0],
    "pos": [0, 1, kernels.BINOPS["andnot"]],
    "neg": [0, 1, kernels.BINOPS["and"]],
}


def _chunk_guard(idx, n_shards: int, depth: int, over_budget: bool) -> None:
    """The whole-stack budget guard: the planes plus the word rows
    (exists, sign, filter) must fit a quarter of the device budget, or
    the caller halves the shard axis (the per-shard pass skips it)."""
    if not over_budget and (depth + 3) * n_shards * WORDS_PER_ROW * 4 > planmod.stack_budget(idx.dcache):
        raise BudgetExceeded("BSI stack exceeds the device budget")


def _signed_field(f) -> bool:
    """Whether the field can store negative base values: stored =
    value - base and every write is range-checked against [min, max], so
    min >= base keeps the sign row empty forever."""
    return f.options.min < f.options.base


def _field_rows(bsiv, shards, signed_: bool, table: ExtentTable):
    """(exists, sign) [S, W] stacks for one shard chunk; sign is None for
    unsigned fields."""
    exists = bsiv.row_stack(BSI_EXISTS_BIT, shards, extents=table)
    if exists is None:
        return None, None
    sign = bsiv.row_stack(BSI_SIGN_BIT, shards, extents=table) if signed_ else None
    return exists, sign


def _planes(bsiv, depth: int, shards, table: ExtentTable) -> torch.Tensor:
    return bsiv.plane_stack(range(BSI_OFFSET_BIT, BSI_OFFSET_BIT + depth), shards, extents=table)


def _filter_rows(ex, idx, filter_call, shards, over_budget: bool):
    """An aggregate's filter bitmap over `shards`: (the shards where it
    has bits, in order, and their [S', W] rows), or _EMPTY when it
    matches nothing. The lowering stacks each shard's Shift predecessors
    too (their rows carry into it) and drops shards without filter bits."""
    lowered = ex._lower_roots(idx, [filter_call], list(shards), over_budget)
    if lowered is ex._EMPTY:
        return _EMPTY
    roots, low, n_out, out_shards = lowered
    return out_shards, StackedPlan(roots[0], low.operands, n_out, out_shards, extents=low.extents).rows()


# ---------------------------------------------------------------------------
# Sum / Min / Max
# ---------------------------------------------------------------------------


def aggregate(ex, idx, c, f, shard_list: Sequence[int], kind: str):
    """Whole-field BSI aggregate (kind in sum|min|max) as a ValCount."""
    from pilosa_tpu_torch.exec import executor as exmod

    depth = f.options.bit_depth
    signed_ = _signed_field(f)
    bsiv = f.view(f.bsi_view_name())
    if bsiv is None or not shard_list or depth <= 0:
        return exmod.ValCount(0, 0)
    filter_call = None
    if len(c.children) == 1:
        filter_call = c.children[0]
    elif isinstance(c.args.get("filter"), exmod.Call):
        filter_call = c.args["filter"]
    # each shard's filter rows may stack k Shift predecessors of their own
    k = ex._count_shifts(filter_call) if filter_call is not None else 0
    # shards without a BSI fragment contribute nothing
    bsi_shards = [s for s in shard_list if bsiv.fragment_if_exists(s) is not None]
    if not bsi_shards:
        return exmod.ValCount(0, 0)

    def one(chunk, over_budget):
        _chunk_guard(idx, len(chunk), depth + k, over_budget)
        return [_aggregate_chunk(ex, idx, bsiv, filter_call, chunk, kind, depth, signed_, over_budget)]

    parts = ex._chunk_by_budget(list(bsi_shards), one)
    count = 0
    total = 0
    best: Optional[Tuple[int, int]] = None  # (value, count) for min/max
    for part in parts:
        if part == _EMPTY:
            continue
        if kind == "sum":
            count += part[0]
            total += part[1]
            continue
        val, cnt = part
        if best is None or ((val < best[0]) if kind == "min" else (val > best[0])):
            best = (val, cnt)
        elif val == best[0]:
            best = (val, best[1] + cnt)
    if kind == "sum":
        return exmod.ValCount(value=total + count * f.options.base, count=count)
    if best is None:
        return exmod.ValCount(0, 0)
    return exmod.ValCount(value=best[0] + f.options.base, count=best[1])


def _aggregate_chunk(ex, idx, bsiv, filter_call, chunk, kind: str, depth: int, signed_: bool, over_budget: bool):
    """One shard chunk: (count, signed magnitude sum) for sum, (value,
    count) for min/max, or _EMPTY. The filter is evaluated first, and the
    field's stacks cover only the shards where it has bits."""
    filt = None
    if filter_call is not None:
        lowered = _filter_rows(ex, idx, filter_call, chunk, over_budget)
        if lowered is _EMPTY:
            return _EMPTY
        chunk, filt = lowered
    table = ExtentTable(idx.dcache)
    try:
        with idx.dcache.deferred_eviction():
            exists, sign = _field_rows(bsiv, chunk, signed_, table)
            if exists is None:
                return _EMPTY
            planes = _planes(bsiv, depth, chunk, table)
        return _aggregate_launch(planes, exists, sign, filt, kind, depth, signed_)
    finally:
        table.release()


def _aggregate_launch(planes, exists, sign, filt, kind: str, depth: int, signed_: bool):
    if kind == "sum":
        return obsi.combine_sum(kernels.bsi_sum(planes, exists, sign, filt).cpu().tolist())
    is_min = kind == "min"
    host = kernels.bsi_min_max(planes, exists, sign, filt, is_min).cpu().tolist()
    val, cnt, any_ = obsi.decode_min_max(host, depth, is_min, signed_)
    if not any_ or cnt == 0:
        return _EMPTY
    return val, cnt


# ---------------------------------------------------------------------------
# single-condition Range/Between counts
# ---------------------------------------------------------------------------


def count_range(ex, idx, c, shard_list: Sequence[int]) -> Optional[int]:
    """Count(Row(<single BSI condition>)). Returns None for shapes this
    path does not own; the caller's plan lowering then raises the same
    errors the reference does."""
    from pilosa_tpu_torch.core.field import FIELD_TYPE_INT

    if not shard_list:
        return None
    conds = c.condition_args()
    if len(c.args) != 1 or len(conds) != 1 or c.children:
        return None
    field_name, cond = next(iter(conds.items()))
    f = idx.field(field_name)
    if f is None or f.options.type != FIELD_TYPE_INT:
        return None
    depth = f.options.bit_depth
    if depth <= 0 or depth > obsi.MAX_DEPTH:
        return None
    signed_ = _signed_field(f)
    bsiv = f.view(f.bsi_view_name())
    if bsiv is None:
        return 0
    dec = _decompose(f, cond, signed_)
    if dec is None:
        return None
    if dec == _ZERO:
        return 0
    jobs, preds, job_weights, extras = dec
    bsi_shards = [s for s in shard_list if bsiv.fragment_if_exists(s) is not None]
    if not bsi_shards:
        return 0

    def one(chunk, over_budget):
        _chunk_guard(idx, len(chunk), depth if jobs else 1, over_budget)
        return [_count_chunk(bsiv, chunk, depth, signed_, jobs, preds, job_weights, extras)]

    return sum(ex._chunk_by_budget(list(bsi_shards), one))


def _decompose(f, cond, signed_: bool):
    """The sign/saturation decomposition of one condition (the same as
    the plan lowering's): (jobs, preds, job_weights, extras), where jobs
    = ((kind, mask_sel, allow_eq), ...), preds are the uint32 magnitudes
    aligned with the jobs (two for between), and job_weights and extras
    ((sel, weight), ...) carry the +/-1 host-combine weights. For unsigned
    fields "pos" becomes "consider" and "neg" terms drop. Returns None for
    shapes this path does not own, _ZERO when nothing can match."""
    o = f.options

    def final(jobs, preds, weights, extras):
        if signed_:
            return tuple(jobs), tuple(preds), tuple(weights), tuple(extras)
        jobs2, preds2, weights2 = [], [], []
        off = 0
        for job, w in zip(jobs, weights):
            npred = 2 if job[0] == "between" else 1
            if job[1] != "neg":
                jobs2.append((job[0], "consider" if job[1] == "pos" else job[1], job[2]))
                preds2.extend(preds[off : off + npred])
                weights2.append(w)
            off += npred
        extras2 = tuple(("consider" if sel == "pos" else sel, w) for sel, w in extras if sel != "neg")
        return tuple(jobs2), tuple(preds2), tuple(weights2), extras2

    consider_only = final([], [], [], [("consider", 1)])

    if cond.op == NEQ and cond.value is None:  # != null
        return consider_only
    if cond.op == BETWEEN:
        lo, hi = cond.int_pair()
        blo, bhi, out_of_range = f.base_value_between(lo, hi)
        if out_of_range:
            return _ZERO
        if lo <= o.min and hi >= o.max:
            return consider_only
        if blo >= 0:
            return final([("between", "pos", False)], [abs(blo), abs(bhi)], [1], [])
        if bhi < 0:
            return final([("between", "neg", False)], [abs(bhi), abs(blo)], [1], [])
        return final(
            [("lt", "pos", True), ("lt", "neg", True)], [abs(bhi), abs(blo)], [1, 1], []
        )

    if not isinstance(cond.value, int) or isinstance(cond.value, bool):
        return None
    value = cond.value
    op = COND_OP_NAME[cond.op]
    base_value, out_of_range = f.base_value(op, value)
    if out_of_range and cond.op != NEQ:
        return _ZERO
    if (
        (cond.op == LT and value > o.max)
        or (cond.op == LTE and value >= o.max)
        or (cond.op == GT and value < o.min)
        or (cond.op == GTE and value <= o.min)
    ):
        return consider_only
    if out_of_range and cond.op == NEQ:
        return consider_only
    upred = abs(base_value)
    if op in ("eq", "neq"):
        sel = "neg" if base_value < 0 else "pos"
        if op == "eq":
            return final([("eq", sel, False)], [upred], [1], [])
        return final([("eq", sel, False)], [upred], [-1], [("consider", 1)])
    if op in ("lt", "lte"):
        allow_eq = op == "lte"
        if base_value > 0 or (base_value == 0 and allow_eq):
            return final([("lt", "pos", allow_eq)], [upred], [1], [("neg", 1)])
        if base_value == 0:  # strict < 0
            return final([], [], [], [("neg", 1)])
        return final([("gt", "neg", allow_eq)], [upred], [1], [])
    allow_eq = op == "gte"
    if base_value > 0 or (base_value == 0 and allow_eq):
        return final([("gt", "pos", allow_eq)], [upred], [1], [])
    if base_value == 0:  # strict > 0
        return final([("gt", "pos", False)], [upred], [1], [])
    return final([("lt", "neg", allow_eq)], [upred], [1], [("pos", 1)])


def _count_chunk(bsiv, chunk, depth: int, signed_: bool, jobs, preds, job_weights, extras) -> int:
    """One shard chunk's count: one bsi_range launch per job and one
    plan_count launch per mask term, one host read, exact +/- combine."""
    if not jobs and not extras:
        return 0
    table = ExtentTable(bsiv.dcache)
    try:
        with bsiv.dcache.deferred_eviction():
            exists, sign = _field_rows(bsiv, chunk, signed_, table)
            if exists is None:
                return 0
            planes = _planes(bsiv, depth, chunk, table) if jobs else None
        return _count_launch(planes, exists, sign, len(chunk), jobs, preds, job_weights, extras)
    finally:
        table.release()


def _count_launch(planes, exists, sign, n_shards: int, jobs, preds, job_weights, extras) -> int:
    terms = []
    if jobs:
        off = 0
        for kind, sel, allow_eq in jobs:
            npred = 2 if kind == "between" else 1
            p = list(preds[off : off + npred]) + [0]
            off += npred
            terms.append(
                kernels.bsi_range(planes, exists, sign, sel, kind, allow_eq, p[0], p[1], "count")
            )
    leaves = [exists] if sign is None else [exists, sign]
    for sel, _ in extras:
        terms.append(kernels.plan_count(leaves, _MASK_PROGRAMS[sel], n_shards))
    host = torch.stack(terms).sum(dim=1).cpu().tolist()
    weights = list(job_weights) + [w for _, w in extras]
    return sum(w * int(t) for w, t in zip(weights, host))
