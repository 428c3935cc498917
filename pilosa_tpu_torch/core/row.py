"""Row: a cross-shard query-result bitmap, shard -> int32 device words.

The port of pilosa_tpu/core/row.py. `count()` counts every segment with
one count2 launch and reads the per-segment counts back once, summed
exactly on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitmap as ob
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


class Row:
    __slots__ = ("segments", "attrs", "keys")

    def __init__(self, segments: Optional[Dict[int, torch.Tensor]] = None):
        self.segments: Dict[int, torch.Tensor] = dict(segments or {})
        self.attrs: Optional[dict] = None
        self.keys: Optional[List[str]] = None

    # -- reads -------------------------------------------------------------

    def count(self) -> int:
        if not self.segments:
            return 0
        # one count2 launch for every segment (exact per-segment counts),
        # one host read for all of them
        counts = kernels.count2_segments(list(self.segments.values()), None, "none")
        return int(counts.cpu().sum())

    def any(self) -> bool:
        return any(bool(ob.any_set(w)) for w in self.segments.values())

    def columns(self) -> np.ndarray:
        """Sorted absolute column ids (host)."""
        cols = []
        for shard in sorted(self.segments):
            pos = ob.unpack_positions(ob.to_host(self.segments[shard]))
            if len(pos):
                cols.append(pos + np.uint64(shard) * np.uint64(SHARD_WIDTH))
        return np.concatenate(cols) if cols else np.empty(0, np.uint64)

    def shards(self) -> List[int]:
        return sorted(self.segments)

    def segment(self, shard: int):
        return self.segments.get(shard)

    def includes(self, col: int) -> bool:
        words = self.segments.get(col // SHARD_WIDTH)
        if words is None:
            return False
        pos = col % SHARD_WIDTH
        return bool((int(ob.to_host(words)[pos >> 5]) >> (pos & 31)) & 1)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Row):
            return NotImplemented
        return self.columns().tolist() == other.columns().tolist()

    def __repr__(self) -> str:
        return f"Row(shards={self.shards()}, count={self.count()})"
