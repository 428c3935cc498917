"""Plane-streamed BSI aggregates and single-condition range counts.

The port of pilosa_tpu/exec/bsistream.py. A field's magnitude planes are
staged and reduced in SLABS of at most `slab_planes()` consecutive planes
(the `[bsi] slab-planes` knob, `--bsi-slab-planes`, or
PILOSA_TPU_BSI_SLAB_PLANES; default 16), so a query holds one slab of
planes on the card at a time, however deep the field. Each shard chunk
stages its word rows (exists, sign for a signed field, the filter) once,
then walks the slabs:

- Sum: one bsi_sum launch a slab (the reference's sum_stream_slab);
  each slab's [1 + 2d] tally is weighted by 2^lo on the host, and the
  count is any one slab's; one host read a chunk;
- Min/Max: one bsi_min_max_step launch a slab, MSB first, carrying the
  ladder's (fa, va) words between slabs; the last slab's launch reduces
  them in the kernel (the reference's separate finish program); a field
  at or under the slab is one bsi_min_max launch;
- Count(Row(<condition>)): one bsi_range_step launch a slab, MSB first,
  advancing every job of the predicate's sign/saturation decomposition
  (`_decompose`) together; the last slab's launch counts each job's
  result and the plain mask terms, combined on the host with +/-1
  weights; a decomposition with no ladder job is one plan_count launch a
  mask term and stages no plane.

Each slab stages in its own deferred-eviction session with its own
ExtentTable, released once its launch is queued, and the slab's tensor is
dropped before the next slab is staged: earlier slabs' extents stay in
the cache's LRU unpinned, evictable like any cached row. The counters
`slabs`, `slab_bytes` (plane bytes the slabs held) and `plane_dispatches`
(the launches above) count as the reference's do, except that the
reference's finish dispatches are folded into the last step here.

The shard axis is chunked only when one slab over the chunk misses a
quarter of the device budget (`_slab_guard`). Fields whose range cannot
store negatives (min >= base) skip the sign row entirely; a signed field
32 bits deep keys Min/Max on 33 bits, carried as int64 from its first
slab (the reference declines to stream that shape and stages its whole
stack). An aggregate's filter lowers through the executor's stacked
lowering over the chunk's shards plus each one's Shift predecessors, so
a Shift in the filter carries across shards (and across chunk
boundaries: each chunk reads its predecessors from storage); a non-call
`filter=` argument is no filter, as in the reference.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from pilosa_tpu_torch.core.fragment import BSI_EXISTS_BIT, BSI_OFFSET_BIT, BSI_SIGN_BIT
from pilosa_tpu_torch.exec import plan as planmod
from pilosa_tpu_torch.exec.plan import BudgetExceeded, StackedPlan
from pilosa_tpu_torch.hbm.residency import ExtentTable
from pilosa_tpu_torch.ops import bsi as obsi
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.pql.ast import BETWEEN, EQ, GT, GTE, LT, LTE, NEQ
from pilosa_tpu_torch.shardwidth import WORDS_PER_ROW

_DEFAULT_SLAB_PLANES = 16


def _env_slab_planes() -> int:
    """PILOSA_TPU_BSI_SLAB_PLANES, or the default where it is unset, not
    an int, or <= 0 (as configure() takes it)."""
    raw = os.environ.get("PILOSA_TPU_BSI_SLAB_PLANES")
    try:
        v = int(raw) if raw else _DEFAULT_SLAB_PLANES
    except ValueError:
        return _DEFAULT_SLAB_PLANES
    return v if v > 0 else _DEFAULT_SLAB_PLANES


_slab_planes = _env_slab_planes()

_stats_mu = threading.Lock()
_counters: Dict[str, int] = {
    "slabs": 0,  # plane slabs staged by streamed aggregates and counts
    "slab_bytes": 0,  # plane bytes those slabs held (resident or staged)
    "plane_dispatches": 0,  # launches of the streamed path, mask counts included
}


def configure(slab_planes: Optional[int] = None) -> None:
    """Install the server's [bsi] knob (cli/config.py -> server/node.py);
    process-global like the [hbm] knobs. slab_planes <= 0 restores the
    default."""
    global _slab_planes
    if slab_planes is not None:
        _slab_planes = int(slab_planes) if slab_planes > 0 else _DEFAULT_SLAB_PLANES


def slab_planes() -> int:
    return _slab_planes


def _bump(key: str, value: int = 1) -> None:
    with _stats_mu:
        _counters[key] += value


def stats_snapshot() -> Dict[str, int]:
    with _stats_mu:
        return dict(_counters)


def reset_stats() -> None:
    with _stats_mu:
        for k in _counters:
            _counters[k] = 0


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


def _slab_guard(idx, n_shards: int, rows: int, over_budget: bool) -> None:
    """The slab-peak budget guard: `rows` [S, W] rows over the chunk must
    fit a quarter of the device budget, or the caller halves the shard
    axis (the per-shard pass skips it). The callers count what a chunk
    holds at once: min(depth, slab) planes of one slab; exists, sign and
    the filter (three, as the reference counts them); the filter's Shift
    predecessor rows; and the ladder state a streamed path carries between
    slabs (Min/Max: fa and va, two rows more for a 64-bit va; a range
    count: every job's result and keeps, ops.bsi.range_state_rows; none
    for Sum or a field at or under the slab). A slab that spans several
    extents is joined by one torch.cat, a transient slab-sized copy on top
    of these rows, not counted (the reference reads its parts in place)."""
    if not over_budget and rows * n_shards * WORDS_PER_ROW * 4 > planmod.stack_budget(idx.dcache):
        raise BudgetExceeded("BSI slab exceeds the device budget")


def _slabs(depth: int, slab: int):
    """(first, last, lo, d) of each slab of planes [lo, lo + d), MSB first."""
    los = list(range(0, depth, slab))[::-1]
    for n, lo in enumerate(los):
        yield n == 0, n == len(los) - 1, lo, min(slab, depth - lo)


def _slab_launch(bsiv, chunk, lo: int, d: int, launch):
    """Stage planes [lo, lo + d) over `chunk` in a session of their own,
    return launch(planes) and release the slab's pins once the launch is
    queued; the caller keeps no reference to the planes."""
    table = ExtentTable(bsiv.dcache)
    try:
        with bsiv.dcache.deferred_eviction():
            planes = bsiv.plane_stack(range(BSI_OFFSET_BIT + lo, BSI_OFFSET_BIT + lo + d), chunk, extents=table)
        _bump("slabs")
        _bump("slab_bytes", planes.numel() * 4)
        _bump("plane_dispatches")
        return launch(planes)
    finally:
        table.release()


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

    slab = _slab_planes
    state_rows = 0
    if kind != "sum" and depth > slab:
        state_rows = 3 if obsi.min_max_wide(depth + signed_) else 2

    def one(chunk, over_budget):
        _slab_guard(idx, len(chunk), min(depth, slab) + 3 + k + state_rows, over_budget)
        return [_aggregate_chunk(ex, idx, bsiv, filter_call, chunk, kind, depth, signed_, slab, over_budget)]

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


def _aggregate_chunk(ex, idx, bsiv, filter_call, chunk, kind: str, depth: int, signed_: bool, slab: int, over_budget: bool):
    """One shard chunk: (count, signed magnitude sum) for sum, (value,
    count) for min/max, or _EMPTY. The filter is evaluated first, and the
    field's rows and slabs cover only the shards where it has bits."""
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
        if kind == "sum":
            return _sum_slabs(bsiv, chunk, exists, sign, filt, depth, slab)
        return _min_max_slabs(bsiv, chunk, exists, sign, filt, kind == "min", depth, signed_, slab)
    finally:
        table.release()


def _sum_slabs(bsiv, chunk, exists, sign, filt, depth: int, slab: int):
    """One bsi_sum launch a slab, one host read: the count (every slab's
    tally has it; the bottom slab's is taken) and sum_slabs 2^lo (pos -
    neg)."""
    tallies, los = [], []
    for _, _, lo, d in _slabs(depth, slab):
        tallies.append(_slab_launch(bsiv, chunk, lo, d, lambda planes: kernels.bsi_sum(planes, exists, sign, filt)))
        los.append(lo)
    host = torch.cat(tallies).cpu().tolist()
    count, total, off = 0, 0, 0
    for lo, t in zip(los, tallies):
        count, part = obsi.combine_sum(host[off : off + t.numel()])
        off += t.numel()
        total += part << lo
    return count, total


def _min_max_slabs(bsiv, chunk, exists, sign, filt, is_min: bool, depth: int, signed_: bool, slab: int):
    """Min/Max over the slabs, MSB first: one bsi_min_max launch for a
    field at or under the slab, else one bsi_min_max_step a slab; one
    host read."""
    if depth <= slab:
        out = _slab_launch(bsiv, chunk, 0, depth, lambda planes: kernels.bsi_min_max(planes, exists, sign, filt, is_min))
    else:
        out = None
        for first, last, lo, d in _slabs(depth, slab):
            out = _slab_launch(
                bsiv, chunk, lo, d,
                lambda planes, first=first, last=last, state=out: kernels.bsi_min_max_step(
                    planes, exists, sign, filt, state, is_min, first, last, depth + signed_
                ),
            )
    val, cnt, any_ = obsi.decode_min_max(out.cpu().tolist(), depth, is_min, signed_)
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

    slab = _slab_planes
    rows = 4  # no ladder job: the word rows and one plane, as the reference prices it
    if jobs:
        rows = min(depth, slab) + 3 + (obsi.range_state_rows(jobs) if depth > slab else 0)

    def one(chunk, over_budget):
        _slab_guard(idx, len(chunk), rows, over_budget)
        return [_count_chunk(bsiv, chunk, depth, signed_, slab, jobs, preds, job_weights, extras)]

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


def _count_chunk(bsiv, chunk, depth: int, signed_: bool, slab: int, jobs, preds, job_weights, extras) -> int:
    """One shard chunk's count: one bsi_range_step launch a slab, MSB
    first, the last counting every job and mask term; or, with no ladder
    job, one plan_count launch a mask term. One host read, exact +/-
    combine."""
    if not jobs and not extras:
        return 0
    table = ExtentTable(bsiv.dcache)
    try:
        with bsiv.dcache.deferred_eviction():
            exists, sign = _field_rows(bsiv, chunk, signed_, table)
        if exists is None:
            return 0
        if jobs:
            out = None
            for first, last, lo, d in _slabs(depth, slab):
                out = _slab_launch(
                    bsiv, chunk, lo, d,
                    lambda planes, first=first, last=last, lo=lo, state=out: kernels.bsi_range_step(
                        planes, exists, sign, state, jobs, preds, lo, first, last, [sel for sel, _ in extras]
                    ),
                )
        else:
            leaves = [exists] if sign is None else [exists, sign]
            terms = []
            for sel, _ in extras:
                _bump("plane_dispatches")
                terms.append(kernels.plan_count(leaves, _MASK_PROGRAMS[sel], len(chunk)).sum())
            out = torch.stack(terms)
        host = out.cpu().tolist()
    finally:
        table.release()
    weights = list(job_weights) + [w for _, w in extras]
    return sum(w * int(t) for w, t in zip(weights, host))
