"""Anti-entropy: the block diff and the majority-vote block merge.

The port of pilosa_tpu/cluster/antientropy.py. Two replicas of a
fragment compare per-block digests (core/blocks.py); each block whose
digests differ is merged across every replica reached: a (row, col)
pair survives with at least (n+1)//2 votes, so at n = 2 an even split
sets the bit and two replicas converge to their union (fragment.go:1917
"If there is an even split then a set is used"). A Clear that one of two
replicas missed therefore comes back after the merge, as in the
reference. The merge returns each replica's set and clear deltas; the
node applies them through `Fragment.apply_deltas`, the ordinary write
path. Host work in numpy, as in the reference: the digests and the vote
read the fragments' host row stores. The vote sorts every replica's
pairs at once (one lexsort over row, col and replica) where the
reference sorts structured (row, col) records, which numpy compares
field by field; the deltas are the same.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from pilosa_tpu_torch.core.blocks import (  # noqa: F401  (re-exported)
    HASH_BLOCK_SIZE,
    block_checksums,
    block_id_of,
)

Pairs = Tuple[np.ndarray, np.ndarray]


def diff_blocks(local: Dict[int, bytes], remote: Dict[int, bytes]) -> List[int]:
    """Block ids whose digests differ between two replicas, sorted."""
    return sorted(bid for bid in set(local) | set(remote) if local.get(bid) != remote.get(bid))


def merge_block(block_id: int, replicas: Sequence[Pairs]) -> Tuple[List[Pairs], List[Pairs]]:
    """Majority-vote merge of one block. `replicas[i]` is replica i's
    (rows, cols) in the block (pairs outside rows [block_id*100,
    (block_id+1)*100) are ignored). Returns (sets, clears): per replica,
    the (rows, cols) that bring it to the consensus, sorted by row, then
    column, as the reference returns them."""
    n = len(replicas)
    majority = (n + 1) // 2
    lo = np.uint64(block_id * HASH_BLOCK_SIZE)
    hi = np.uint64((block_id + 1) * HASH_BLOCK_SIZE)
    rs, cs, reps = [], [], []
    for i, (rows, cols) in enumerate(replicas):
        rows = np.asarray(rows, dtype=np.uint64)
        cols = np.asarray(cols, dtype=np.uint64)
        keep = (rows >= lo) & (rows < hi)
        rs.append(rows[keep])
        cs.append(cols[keep])
        reps.append(np.full(len(rs[-1]), i, np.int64))
    r = np.concatenate(rs) if rs else np.empty(0, np.uint64)
    c = np.concatenate(cs) if cs else np.empty(0, np.uint64)
    rep = np.concatenate(reps) if reps else np.empty(0, np.int64)
    # one sort by (row, col, replica): equal pairs are adjacent, a
    # replica's duplicates next to each other
    order = np.lexsort((rep, c, r))
    r, c, rep = r[order], c[order], rep[order]
    same_pair = (r[1:] == r[:-1]) & (c[1:] == c[:-1])
    keep = np.ones(len(r), bool)
    keep[1:] = ~(same_pair & (rep[1:] == rep[:-1]))
    r, c, rep = r[keep], c[keep], rep[keep]
    first = np.ones(len(r), bool)
    first[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    pair = np.cumsum(first) - 1  # each entry's index in the union
    ur, uc = r[first], c[first]
    consensus = np.bincount(pair, minlength=len(ur)) >= majority
    member = np.zeros((n, len(ur)), bool)
    member[rep, pair] = True
    sets: List[Pairs] = []
    clears: List[Pairs] = []
    for m in member:
        to_set = consensus & ~m
        to_clear = ~consensus & m
        sets.append((ur[to_set], uc[to_set]))
        clears.append((ur[to_clear], uc[to_clear]))
    return sets, clears
