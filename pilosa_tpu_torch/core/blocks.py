"""Block checksums for comparing a fragment's replicas.

The port's copy of pilosa_tpu/core/blocks.py, digest for digest: a
fragment's (row, in-shard column) pairs fall in blocks of HASH_BLOCK_SIZE
rows (the reference's fragment.go:81 HashBlockSize), and each block's
digest is blake2b-16 over its sorted uint64 rows, then its cols. Two
nodes compare these digests to find the blocks where their copies of a
fragment differ (cluster/antientropy.py). Host work over the fragment's
row store: nothing is staged on the device.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import numpy as np

HASH_BLOCK_SIZE = 100  # rows per block (fragment.go:81)


def block_id_of(row_id: int) -> int:
    return row_id // HASH_BLOCK_SIZE


def block_checksums(rows_cols: Tuple[np.ndarray, np.ndarray]) -> Dict[int, bytes]:
    """{block id: 16-byte digest} of (rows, in-shard cols) pairs; a block
    with no bits is absent, as in the reference."""
    rows, cols = rows_cols
    if len(rows) == 0:
        return {}
    rows = np.asarray(rows, dtype=np.uint64)
    cols = np.asarray(cols, dtype=np.uint64)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    block_ids = (rows // HASH_BLOCK_SIZE).astype(np.int64)
    out: Dict[int, bytes] = {}
    boundaries = np.nonzero(np.diff(block_ids))[0] + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [len(rows)]))
    for s, e in zip(starts, ends):
        h = hashlib.blake2b(digest_size=16)
        h.update(rows[s:e].tobytes())
        h.update(cols[s:e].tobytes())
        out[int(block_ids[s])] = h.digest()
    return out
