"""Per-fragment row-rank caches for TopN.

Reference: cache.go — `ranked` (sorted bitmapPairs, bounded at cacheSize,
recalculated after a threshold of updates, cache.go:136-300), `lru`
(groupcache fork, cache.go:58-130), `none`; a durable fragment keeps
its cache in a `.cache` sidecar of the reference's format
(`write_cache`/`read_cache`).

TPU-first shift: the reference's caches hold *approximate* counts refreshed
from fragment scans. Here row cardinalities are already exact host metadata
(rowstore.RowBits tracks its count), so the cache is pure bookkeeping: it
bounds *which* rows are TopN candidates (top cache_size by count — the same
approximation contract as the reference) while counts stay exact. Unfiltered
TopN then answers from the cache with no device pass at all; filtered TopN
tallies only the cache's candidate rows on device.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

CACHE_TYPE_RANKED = "ranked"
CACHE_TYPE_LRU = "lru"
CACHE_TYPE_NONE = "none"

DEFAULT_CACHE_SIZE = 50_000  # reference: field.go:48 DefaultCacheSize

# recalculate/prune after this fraction of cache_size updates
# (reference: cache.go thresholdFactor)
_RECALC_FACTOR = 0.1

# sidecar magic; the byte after it is the pruned flag
_MAGIC = b"PTCACHE2"


class RankCache:
    """Bounded row->count map that keeps the top `max_size` rows by count."""

    cache_type = CACHE_TYPE_RANKED

    def __init__(self, max_size: int = DEFAULT_CACHE_SIZE):
        self.max_size = max(int(max_size), 1)
        self._counts: Dict[int, int] = {}
        self._updates = 0
        self._top: Optional[List[Tuple[int, int]]] = None  # desc (count, id)
        # True once any row was dropped for capacity: the cache is then an
        # approximation, not a complete row->count map. TopN's pass-2 fast
        # path reads exact cardinalities straight from an unpruned cache.
        self.pruned = False

    def __len__(self) -> int:
        return len(self._counts)

    def add(self, row_id: int, count: int) -> None:
        """Record a row's (exact) cardinality; count 0 evicts."""
        if count <= 0:
            self._counts.pop(row_id, None)
        else:
            self._counts[row_id] = count
        self._top = None
        self._updates += 1
        if self._updates > self.max_size * _RECALC_FACTOR and (
            len(self._counts) > self.max_size
        ):
            self.recalculate()

    def bulk_add(self, pairs) -> None:
        for row_id, count in pairs:
            if count > 0:
                self._counts[int(row_id)] = int(count)
        self._top = None
        self.recalculate()

    def add_many(self, pairs) -> None:
        """add() for a whole batch with ONE memo drop and ONE threshold
        check — the ingest fast path reconciles every touched row of a
        bulk import here instead of poking the cache once per row."""
        counts = self._counts
        n = 0
        for row_id, count in pairs:
            if count <= 0:
                counts.pop(row_id, None)
            else:
                counts[row_id] = count
            n += 1
        if not n:
            return
        self._top = None
        self._updates += n
        if self._updates > self.max_size * _RECALC_FACTOR and (
            len(counts) > self.max_size
        ):
            self.recalculate()

    def get(self, row_id: int) -> int:
        return self._counts.get(row_id, 0)

    def ids(self) -> List[int]:
        return list(self._counts)

    def recalculate(self) -> None:
        """Prune to the top max_size rows (reference: cache.go:221)."""
        if len(self._counts) > self.max_size:
            keep = sorted(self._counts.items(), key=lambda kv: (-kv[1], kv[0]))
            self._counts = dict(keep[: self.max_size])
            self.pruned = True
        self._updates = 0
        self._top = None

    def top(self) -> List[Tuple[int, int]]:
        """(row_id, count) pairs, highest count first (ties: lowest id)."""
        if self._top is None:
            self.recalculate()
            self._top = sorted(self._counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return self._top

    def clear(self) -> None:
        self._counts.clear()
        self._updates = 0
        self._top = None
        self.pruned = False


class LRUCache(RankCache):
    """Recently-updated-rows cache: same interface, but the bound evicts the
    least recently *added* row instead of the lowest count
    (reference: cache.go:58-130 lruCache)."""

    cache_type = CACHE_TYPE_LRU

    def add(self, row_id: int, count: int) -> None:
        if count <= 0:
            self._counts.pop(row_id, None)
        else:
            # dict preserves insertion order; re-insert = touch
            self._counts.pop(row_id, None)
            self._counts[row_id] = count
            self._evict()
        self._top = None

    def add_many(self, pairs) -> None:
        # recently-updated semantics need the per-add touch/evict order
        for row_id, count in pairs:
            self.add(row_id, count)

    def _evict(self) -> None:
        while len(self._counts) > self.max_size:
            self._counts.pop(next(iter(self._counts)))
            self.pruned = True

    def recalculate(self) -> None:
        self._evict()  # bulk loads must still honor the lru bound
        self._updates = 0
        self._top = None


class NoCache:
    """cache_type 'none': TopN is disabled on the field."""

    cache_type = CACHE_TYPE_NONE
    max_size = 0

    def __len__(self) -> int:
        return 0

    def add(self, row_id: int, count: int) -> None:
        pass

    def bulk_add(self, pairs) -> None:
        pass

    def add_many(self, pairs) -> None:
        pass

    def get(self, row_id: int) -> int:
        return 0

    def ids(self) -> List[int]:
        return []

    def recalculate(self) -> None:
        pass

    def top(self) -> List[Tuple[int, int]]:
        return []

    def clear(self) -> None:
        pass


def make_cache(cache_type: str, size: int = DEFAULT_CACHE_SIZE):
    if cache_type == CACHE_TYPE_RANKED:
        return RankCache(size)
    if cache_type == CACHE_TYPE_LRU:
        return LRUCache(size)
    if cache_type == CACHE_TYPE_NONE:
        return NoCache()
    raise ValueError(f"unknown cache type: {cache_type!r}")


# -- persistence (.cache sidecar; reference cache.go:291 WriteTo) -----------


def write_cache(path: str, cache) -> None:
    """Write the cache's (row, count) pairs in rank order with its pruned
    flag: a pruned cache reloaded as complete would answer 0 for the rows
    it dropped."""
    pairs = cache.top()
    tmp = path + ".temp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<BI", 1 if cache.pruned else 0, len(pairs)))
        for row_id, count in pairs:
            f.write(struct.pack("<QQ", row_id, count))
    os.replace(tmp, path)


def read_cache(path: str, cache) -> bool:
    """Load a sidecar into `cache`; False if it is absent or unreadable
    (the caller then rebuilds from exact counts)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return False
    if len(data) < 13 or data[:8] != _MAGIC:
        return False
    pruned, n = struct.unpack_from("<BI", data, 8)
    if len(data) < 13 + 16 * n:
        return False
    cache.clear()
    cache.bulk_add(struct.iter_unpack("<QQ", data[13 : 13 + 16 * n]))
    if pruned:
        cache.pruned = True
    return True
