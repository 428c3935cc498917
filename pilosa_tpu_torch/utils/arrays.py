"""Small vectorized array helpers shared across the ingest paths."""

from __future__ import annotations

import numpy as np


def group_slices(keys: np.ndarray):
    """Yield (key, index_array) for each distinct value in `keys`.

    ONE stable argsort + boundary scan instead of a boolean mask per
    group — O(n log n) total, vs the O(n x n_groups) rescan the mask
    pattern costs (bulk imports group a batch by shard and then by row,
    so n_groups can be ~10^3 per call). Index arrays preserve the
    original intra-group order (stable sort), so callers relying on
    first/last-occurrence semantics are unaffected."""
    keys = np.asarray(keys)
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    uniq, starts = np.unique(sorted_keys, return_index=True)
    bounds = np.append(starts, len(sorted_keys))
    for i, k in enumerate(uniq):
        yield k, order[bounds[i] : bounds[i + 1]]
