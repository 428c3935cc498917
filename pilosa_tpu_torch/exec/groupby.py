"""Device GroupBy: the batched cross-product tally over stacked row planes.

The port of pilosa_tpu/exec/groupby.py. At depth d one counts_cross
launch computes popcount(acc[g] & planes[r]) per shard for every live
prefix g and every candidate row r of child d, and one host read prunes
the zero groups before the next depth; the number of launches grows with
the depth and the prefix chunks, not with the number of groups.

Shapes: child k's candidate rows are an int32[R_k, S, W] plane stack
(View.plane_stack); the live prefixes of a depth are an int32[G, S, W]
accumulator with G at most `gmax(S, W)` (TILE_BYTES of words). Per-shard
counts are int32 (a shard holds at most 2^20 bits) and are summed over the
shard axis in int64 on the card before the read.

Small cross-products take the one-shot path: every prefix is built on
the card (gather_and), the last level is tallied, and one read returns
all the counts. Larger ones descend depth-first in chunks of at most gmax
prefixes, pruning zero groups at each level.

Kernels: counts_cross (G > 1) and rows_counts (G = 1) for the cross
tallies, count2 for the unfiltered per-row counts, gather_and for every
AND of selected rows. Selecting rows without a filter is a plain
index_select: there is nothing to fuse.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.ops import kernels

# bytes of one prefix tile (prefixes x shards x words)
TILE_BYTES = 256 << 20
# cap on the one-shot path's [G, R_last, S] count read
ONESHOT_READ_BYTES = 64 << 20


def gmax(s: int, w: int) -> int:
    """Prefixes (or candidate rows) per tile for [S, W] stacks."""
    return max(1, TILE_BYTES // (s * w * 4))


def _totals(counts: torch.Tensor) -> np.ndarray:
    """Per-shard int32 counts summed over the last axis in int64, read."""
    return counts.sum(dim=-1, dtype=torch.int64).cpu().numpy()


def _row_totals(planes: torch.Tensor) -> np.ndarray:
    """int64[R]: the bits of each row of an [R, S, W] stack (one count2
    launch for all of them)."""
    return kernels.count2_segments([planes[i] for i in range(planes.shape[0])], None, "none").cpu().numpy()


def _select(planes: torch.Tensor, idx: np.ndarray, filt: Optional[torch.Tensor]) -> torch.Tensor:
    """planes[idx], each row ANDed with the [S, W] filter when one is set."""
    if filt is None:
        return planes.index_select(0, torch.from_numpy(idx).to(planes.device))
    return kernels.gather_and(planes, idx, filt[None], np.zeros(len(idx), np.int64))


def group_by_device(
    planes_list: Sequence[torch.Tensor],
    row_lists: Sequence[Sequence[int]],
    filt: Optional[torch.Tensor] = None,
) -> Dict[Tuple[int, ...], int]:
    """Tally the GroupBy cross-product on the card.

    planes_list[k] is the int32[R_k, S, W] stack of child k's candidate
    rows, row_lists[k] their row ids, filt an optional int32[S, W] filter
    stack over the same shards. Returns {(row0, row1, ...): count} over
    all shards with zero-count groups left out."""
    merged: Dict[Tuple[int, ...], int] = {}
    if not planes_list or any(p.shape[0] == 0 for p in planes_list):
        return merged
    s, w = planes_list[0].shape[-2], planes_list[0].shape[-1]
    g_max = gmax(s, w)
    g_pre = 1
    for p in planes_list[:-1]:
        g_pre *= int(p.shape[0])
    if g_pre <= g_max and g_pre * int(planes_list[-1].shape[0]) * s * 4 <= ONESHOT_READ_BYTES:
        return _group_by_oneshot(planes_list, row_lists, filt)

    # depth 0: every candidate row of the first child
    first = planes_list[0]
    h = _totals(kernels.counts_cross(filt[None], first))[0] if filt is not None else _row_totals(first)
    live = np.flatnonzero(h)
    if len(planes_list) == 1:
        for i in live:
            merged[(int(row_lists[0][i]),)] = int(h[i])
        return merged
    for start in range(0, len(live), g_max):
        idx = live[start : start + g_max]
        acc = _select(first, idx, filt)
        prefixes = [(int(row_lists[0][i]),) for i in idx]
        _descend(1, acc, prefixes, planes_list, row_lists, merged, g_max)
    return merged


def _group_by_oneshot(
    planes_list: Sequence[torch.Tensor],
    row_lists: Sequence[Sequence[int]],
    filt: Optional[torch.Tensor],
) -> Dict[Tuple[int, ...], int]:
    """The whole cross-product built on the card and read once."""
    merged: Dict[Tuple[int, ...], int] = {}
    acc = planes_list[0]
    if filt is not None:
        acc = _select(acc, np.arange(acc.shape[0]), filt)
    keys: List[Tuple[int, ...]] = [(int(r),) for r in row_lists[0]]
    for d in range(1, len(planes_list) - 1):
        g, r = acc.shape[0], planes_list[d].shape[0]
        # row g * R + r of the expansion is prefix g with row r
        acc = kernels.gather_and(acc, np.repeat(np.arange(g), r), planes_list[d], np.tile(np.arange(r), g))
        keys = [k + (int(x),) for k in keys for x in row_lists[d]]
    if len(planes_list) == 1:
        for i, cnt in enumerate(_row_totals(acc)):
            if cnt:
                merged[keys[i]] = int(cnt)
        return merged
    last_rows = row_lists[-1]
    h = _totals(kernels.counts_cross(acc, planes_list[-1]))  # [G, R_last]
    for g, r in zip(*np.nonzero(h)):
        merged[keys[g] + (int(last_rows[r]),)] = int(h[g, r])
    return merged


def _descend(
    depth: int,
    acc: torch.Tensor,
    prefixes: List[Tuple[int, ...]],
    planes_list: Sequence[torch.Tensor],
    row_lists: Sequence[Sequence[int]],
    merged: Dict[Tuple[int, ...], int],
    g_max: int,
) -> None:
    planes = planes_list[depth]
    h = _totals(kernels.counts_cross(acc, planes))
    gs, rs = np.nonzero(h)
    if depth == len(planes_list) - 1:
        for g, r in zip(gs, rs):
            key = prefixes[g] + (int(row_lists[depth][r]),)
            merged[key] = merged.get(key, 0) + int(h[g, r])
        return
    for start in range(0, len(gs), g_max):
        gi = gs[start : start + g_max]
        ri = rs[start : start + g_max]
        acc2 = kernels.gather_and(acc, gi, planes, ri)
        pfx = [prefixes[g] + (int(row_lists[depth][r]),) for g, r in zip(gi, ri)]
        _descend(depth + 1, acc2, pfx, planes_list, row_lists, merged, g_max)
