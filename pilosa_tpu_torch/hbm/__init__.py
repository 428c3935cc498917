"""Device residency: extent-granular paging and pins (hbm/residency.py).

The layer between core and exec: core/devcache.py is the byte ledger
(LRU, pins, shard coverage); this package decides what it holds for the
stacked query path. The reference's prefetcher is not ported yet: the
admission queue that feeds it comes with the scheduler.
"""

from pilosa_tpu_torch.hbm.residency import (
    ExtentTable,
    configure,
    extent_rows,
    stage_plane_stack,
    stage_row_stack,
    stats_snapshot,
)

__all__ = [
    "ExtentTable",
    "configure",
    "extent_rows",
    "stage_plane_stack",
    "stage_row_stack",
    "stats_snapshot",
]
