"""Plain-PyTorch BSI (bit-sliced index) arithmetic: the port's twin of
pilosa_tpu/ops/bsi.py, and the oracle of the BSI kernels in ops/kernels.py.

An int field stores `value - base` as sign + magnitude: `planes` is an
int32[D, S, W] stack (plane d = magnitude bit d), `exists`, `sign` and
`filt` are int32[S, W] word stacks. Words hold the reference's uint32
bits; every right shift on them masks to a logical shift (ops/bitmap.py).
`sign` is None for an unsigned field (min >= base: the sign row is empty
forever), and `filt` None means no filter.

Predicates are host ints, not traced scalars, so the range ladders branch
on predicate bits in Python. Counts are exact int64, so the reference's
halfword pairs (`_total_pair`, `pair_value`) are not needed; decoded
values equal the reference's Python ints.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pilosa_tpu_torch.ops.bitmap import popcount_rows, popcount_words

# magnitude planes the kernels take: words are 32 bits
MAX_DEPTH = 32


def job_mask(exists, sign, filt, sel: str) -> torch.Tensor:
    """consider = exists & filt; "pos" and "neg" split it by the sign row
    (an unsigned field's "neg" mask is empty)."""
    consider = exists if filt is None else exists & filt
    if sel == "consider":
        return consider
    if sel == "pos":
        return consider if sign is None else consider & ~sign
    if sel == "neg":
        return torch.zeros_like(consider) if sign is None else consider & sign
    raise ValueError(f"unknown mask selector {sel!r}")


# ---------------------------------------------------------------------------
# Sum
# ---------------------------------------------------------------------------


def sum_counts_stacked(planes, exists, sign=None, filt=None) -> torch.Tensor:
    """Per-shard BSI sum tally, int64[1 + 2D, S]: row 0 the considered
    count, rows 1..D the positive-branch plane counts, rows D+1..2D the
    negative branch. The host combines sum = sum_d 2^d (pos_d - neg_d)."""
    d = planes.shape[0]
    consider = job_mask(exists, sign, filt, "consider")
    prow = job_mask(exists, sign, filt, "pos")
    rows = [popcount_rows(consider)]
    rows += [popcount_rows(planes[i] & prow) for i in range(d)]
    if sign is None:
        rows += [torch.zeros_like(rows[0])] * d
    else:
        nrow = consider & sign
        rows += [popcount_rows(planes[i] & nrow) for i in range(d)]
    return torch.stack(rows)


def combine_sum(counts) -> Tuple[int, int]:
    """(count, signed magnitude sum) from a [1 + 2D] tally, exactly."""
    counts = [int(x) for x in counts]
    d = (len(counts) - 1) // 2
    total = sum((counts[1 + i] - counts[1 + d + i]) << i for i in range(d))
    return counts[0], total


# ---------------------------------------------------------------------------
# Min / Max: the word-local virtual-key ladder
# ---------------------------------------------------------------------------


def min_max_stream(planes, exists, sign=None, filt=None, is_min: bool = True) -> torch.Tensor:
    """Signed or unsigned Min/Max as one max-ladder over a virtual key:
    for a signed field the key's top bit is the sign step (for Min a
    negative value outranks every positive one), then one bit per plane,
    complemented where a smaller magnitude must rank higher. Within each
    word `fa` narrows to the columns holding the word's best key and `va`
    builds that key; the best key over all words is the answer and its
    count the popcount of `fa` over the words that reach it. Returns
    int64[3] = [best key, any, count]."""
    mask = job_mask(exists, sign, filt, "consider")
    fa = mask
    va = torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)
    if sign is not None:
        top = mask & (sign if is_min else ~sign)
        nz = top != 0
        fa = torch.where(nz, top, fa)
        va = nz.to(torch.int64)
        tx = ~sign if is_min else sign
    for k in reversed(range(planes.shape[0])):
        p = planes[k]
        if sign is not None:
            t = p ^ tx
        else:
            t = ~p if is_min else p
        ra = fa & t
        nz = ra != 0
        fa = torch.where(nz, ra, fa)
        va = (va << 1) | nz.to(torch.int64)
    valid = mask != 0
    best = torch.where(valid, va, torch.full_like(va, -1)).max()
    at_best = valid & (va == best)
    cnt = torch.where(at_best, popcount_words(fa), torch.zeros_like(fa)).sum(dtype=torch.int64)
    any_ = valid.any().to(torch.int64)
    return torch.stack([best.clamp(min=0), any_, cnt])


def decode_min_max(host, bit_depth: int, is_min: bool, signed_: bool) -> Tuple[int, int, bool]:
    """(value, count, any) of a min/max result [best key, any, count]."""
    if not int(host[1]):
        return 0, 0, False
    key = int(host[0])
    cnt = int(host[2])
    low_mask = (1 << bit_depth) - 1
    if not signed_:
        mag = ((low_mask - key) & low_mask) if is_min else key
        return mag, cnt, True
    top = (key >> bit_depth) & 1
    low = key & low_mask
    if is_min:
        negative = bool(top)
        mag = low if negative else (low_mask - low)
    else:
        negative = not top
        mag = (low_mask - low) if negative else low
    return (-mag if negative else mag), cnt, True


# ---------------------------------------------------------------------------
# Range ladders over magnitudes (predicates are non-negative host ints)
# ---------------------------------------------------------------------------


def _bit(p: int, i: int) -> bool:
    return bool((p >> i) & 1)


def range_eq_unsigned(base, planes, upredicate: int) -> torch.Tensor:
    """Columns of base whose magnitude == upredicate."""
    b = base
    for i in reversed(range(planes.shape[0])):
        row = planes[i]
        b = b & row if _bit(upredicate, i) else b & ~row
    return b


def range_lt_unsigned(filt, planes, upredicate: int, allow_equality: bool) -> torch.Tensor:
    """Columns of filt with magnitude < (or <=) upredicate: the keep /
    leading-zeros ladder. A strict `< 0` is empty (pilosa_tpu corrects the
    upstream ladder, which returned the 0-valued columns there)."""
    keep = torch.zeros_like(filt)
    leading_zeros = True
    for i in reversed(range(planes.shape[0])):
        row = planes[i]
        bit_is_zero = not _bit(upredicate, i)
        in_lz_skip = leading_zeros and bit_is_zero
        leading_zeros = in_lz_skip
        if i == 0 and not allow_equality:
            return keep if bit_is_zero else filt & ~(row & ~keep)
        if in_lz_skip:
            filt = filt & ~row
        elif bit_is_zero:
            filt = filt & ~(row & ~keep)
        elif i > 0:
            keep = keep | (filt & ~row)
    return filt


def range_gt_unsigned(filt, planes, upredicate: int, allow_equality: bool) -> torch.Tensor:
    """Columns of filt with magnitude > (or >=) upredicate."""
    keep = torch.zeros_like(filt)
    for i in reversed(range(planes.shape[0])):
        row = planes[i]
        bit_is_one = _bit(upredicate, i)
        if i == 0 and not allow_equality:
            return keep if bit_is_one else filt & ~((filt & ~row) & ~keep)
        if bit_is_one:
            filt = filt & ~((filt & ~row) & ~keep)
        elif i > 0:
            keep = keep | (filt & row)
    return filt


def range_between_unsigned(filt, planes, umin: int, umax: int) -> torch.Tensor:
    """Columns of filt with umin <= magnitude <= umax: the >= and <=
    ladders in one pass."""
    keep1 = torch.zeros_like(filt)
    keep2 = torch.zeros_like(filt)
    for i in reversed(range(planes.shape[0])):
        row = planes[i]
        if _bit(umin, i):
            filt = filt & ~((filt & ~row) & ~keep1)
        elif i > 0:
            keep1 = keep1 | (filt & row)
        if not _bit(umax, i):
            filt = filt & ~(row & ~keep2)
        elif i > 0:
            keep2 = keep2 | (filt & ~row)
    return filt


def range_single(
    planes, base, sign: Optional[torch.Tensor], sel: str, kind: str, allow_eq: bool,
    p0: int, p1: int, mode: str,
) -> torch.Tensor:
    """One ladder from the base mask job_mask(base, sign, None, sel):
    int32[S, W] result words (mode "rows") or int64[S] per-shard counts
    (mode "count")."""
    m = job_mask(base, sign, None, sel)
    if kind == "eq":
        res = range_eq_unsigned(m, planes, p0)
    elif kind == "lt":
        res = range_lt_unsigned(m, planes, p0, allow_eq)
    elif kind == "gt":
        res = range_gt_unsigned(m, planes, p0, allow_eq)
    elif kind == "between":
        res = range_between_unsigned(m, planes, p0, p1)
    else:
        raise ValueError(f"unknown range kind {kind!r}")
    return res if mode == "rows" else popcount_rows(res)


# ---------------------------------------------------------------------------
# Slab steps: the ladders above with their state carried between slabs
# ---------------------------------------------------------------------------
#
# The port of pilosa_tpu/ops/bsi.py min_max_stream_step/_finish and
# range_stream_step/_finish/_single, and the twins of the step kernels.
# A field's planes arrive as slabs of consecutive planes, MSB first
# (`lo` is the absolute index of planes[0]); `first` builds the state
# from the word rows, `last` reduces it to the result instead of
# returning it. first and last together are the whole-stack ladder.


def min_max_wide(key_bits: int) -> bool:
    """Whether a Min/Max key of `key_bits` bits (depth, plus one for a
    signed field) needs an int64 `va`; up to 32 bits it is int32 words."""
    return key_bits > 32


def _min_max_reduce(fa, va) -> torch.Tensor:
    """[best key, any, count] over the words: fa != 0 exactly where the
    word has a considered column (the ladder narrows fa only to a
    non-empty subset)."""
    valid = fa != 0
    best = torch.where(valid, va, torch.full_like(va, -1)).max()
    at_best = valid & (va == best)
    cnt = torch.where(at_best, popcount_words(fa), torch.zeros_like(fa)).sum(dtype=torch.int64)
    return torch.stack([best.clamp(min=0), valid.any().to(torch.int64), cnt])


def min_max_step(planes, exists, sign, filt, state, is_min: bool, first: bool, last: bool, key_bits: int):
    """One slab of the virtual-key ladder of min_max_stream. `state` is
    None on the first slab, else the (fa int32[S, W], va [S, W]) the
    previous slab returned; va is int64 where min_max_wide(key_bits),
    else the key's low 32 bits as int32 words. Returns the next state,
    or with `last` the int64[3] = [best key, any, count]."""
    wide = min_max_wide(key_bits)
    if first:
        mask = job_mask(exists, sign, filt, "consider")
        fa = mask
        va = torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)
        if sign is not None:
            top = mask & (sign if is_min else ~sign)
            nz = top != 0
            fa = torch.where(nz, top, fa)
            va = nz.to(torch.int64)
    else:
        fa, va = state
        va = va.to(torch.int64)
        if not wide:
            va = va & 0xFFFFFFFF
    if sign is not None:
        tx = ~sign if is_min else sign
    else:
        tx = torch.full_like(fa, -1 if is_min else 0)
    for k in reversed(range(planes.shape[0])):
        ra = fa & (planes[k] ^ tx)
        nz = ra != 0
        fa = torch.where(nz, ra, fa)
        va = (va << 1) | nz.to(torch.int64)
    if last:
        return _min_max_reduce(fa, va)
    return fa, (va if wide else va.to(torch.int32))


# state words a range job carries: its result so far, then its keeps
RANGE_STATE_ROWS = {"eq": 1, "lt": 2, "gt": 2, "between": 3}


def range_state_rows(jobs) -> int:
    return sum(RANGE_STATE_ROWS[kind] for kind, _, _ in jobs)


def range_npreds(kind: str) -> int:
    return 2 if kind == "between" else 1


def lt_leading_zeros(p: int, top: int) -> bool:
    """The lt ladder's leading-zeros flag on entering plane top - 1:
    every bit of the predicate from `top` up is zero."""
    return (p >> top) == 0


def _ladder_plane(kind, allow_eq, i, b0, b1, lz, row, f, keep, keep2):
    """One plane (absolute index i) of a range ladder: range_eq/lt/gt/
    between_unsigned's loop body. Returns (f, keep, keep2, lz)."""
    if kind == "eq":
        return (f & row if b0 else f & ~row), keep, keep2, lz
    if kind == "lt":
        in_lz_skip = lz and not b0
        if i == 0 and not allow_eq:
            return (f & ~(row & ~keep) if b0 else keep), keep, keep2, in_lz_skip
        if in_lz_skip:
            f = f & ~row
        elif not b0:
            f = f & ~(row & ~keep)
        elif i > 0:
            keep = keep | (f & ~row)
        return f, keep, keep2, in_lz_skip
    if kind == "gt":
        if i == 0 and not allow_eq:
            return (keep if b0 else f & ~((f & ~row) & ~keep)), keep, keep2, lz
        if b0:
            f = f & ~((f & ~row) & ~keep)
        elif i > 0:
            keep = keep | (f & row)
        return f, keep, keep2, lz
    if kind == "between":
        if b0:
            f = f & ~((f & ~row) & ~keep)
        elif i > 0:
            keep = keep | (f & row)
        if not b1:
            f = f & ~(row & ~keep2)
        elif i > 0:
            keep2 = keep2 | (f & ~row)
        return f, keep, keep2, lz
    raise ValueError(f"unknown range kind {kind!r}")


def range_step(planes, exists, sign, state, jobs, preds, lo: int, first: bool, last: bool, extras=()):
    """Every job of a condition's decomposition advanced over one slab,
    each slab plane read once for all of them. jobs = ((kind, sel,
    allow_eq), ...) and preds (two magnitudes for between) as
    exec/bsistream.py `_decompose` gives them; every predicate is below
    2^(top plane + 1). `state` is None on the first slab, else the
    int32[range_state_rows(jobs), S, W] the previous slab returned (per
    job: its result words, then its keeps). Returns the next state, or
    with `last` int64[len(jobs) + len(extras)]: the popcount of each
    job's result, then of each extra mask job_mask(exists, sign, None,
    sel)."""
    d = planes.shape[0]
    out = []
    row = 0
    off = 0
    for kind, sel, allow_eq in jobs:
        n = RANGE_STATE_ROWS[kind]
        if first:
            f = job_mask(exists, sign, None, sel)
            keep = keep2 = torch.zeros_like(f)
        else:
            f = state[row]
            keep = state[row + 1] if n > 1 else None
            keep2 = state[row + 2] if n > 2 else None
        p0 = preds[off]
        p1 = preds[off + 1] if kind == "between" else 0
        lz = lt_leading_zeros(p0, lo + d)
        for k in reversed(range(d)):
            i = lo + k
            f, keep, keep2, lz = _ladder_plane(kind, allow_eq, i, _bit(p0, i), _bit(p1, i), lz, planes[k], f, keep, keep2)
        out.append((f, keep, keep2)[:n])
        row += n
        off += range_npreds(kind)
    if last:
        terms = [popcount_words(st[0]).sum(dtype=torch.int64) for st in out]
        terms += [popcount_words(job_mask(exists, sign, None, sel)).sum(dtype=torch.int64) for sel in extras]
        return torch.stack(terms) if terms else torch.zeros(0, dtype=torch.int64)
    return torch.stack([w for st in out for w in st])
