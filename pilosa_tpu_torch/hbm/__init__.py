"""Device residency: extent-granular paging and pins (hbm/residency.py).

The layer between core and exec: core/devcache.py is the byte ledger
(LRU, pins, shard coverage); this package decides what it holds for the
stacked query path; hbm/prefetch.py stages queued queries' operands in
the background (fed by sched/admission.py).
"""

from pilosa_tpu_torch.hbm.prefetch import Prefetcher
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
    "Prefetcher",
    "configure",
    "extent_rows",
    "stage_plane_stack",
    "stage_row_stack",
    "stats_snapshot",
]
