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
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW


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
        """Sorted absolute column ids (host). The set bits are found on the
        row's device, 64 segments at a time (at most 256 MiB of scratch);
        only the column ids come to the host."""
        shards = sorted(self.segments)
        out = [np.empty(0, np.uint64)]
        for i in range(0, len(shards), 64):
            chunk = shards[i : i + 64]
            words = torch.stack([self.segments[s] for s in chunk]).reshape(-1)
            nz = torch.nonzero(words).reshape(-1)
            bit = torch.arange(32, dtype=torch.int32, device=words.device)
            word_i, bit_i = torch.nonzero((words[nz].unsqueeze(1) >> bit) & 1, as_tuple=True)
            w = nz[word_i]
            base = torch.tensor(chunk, dtype=torch.int64, device=words.device)[w // WORDS_PER_ROW] * SHARD_WIDTH
            out.append((base + (w % WORDS_PER_ROW) * 32 + bit_i).cpu().numpy().astype(np.uint64))
        return np.concatenate(out)

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
