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

    def includes_many(self, cols: np.ndarray) -> np.ndarray:
        """bool[len(cols)]: which of the sorted uint64 column ids are set.
        The words are gathered on the row's device, 256 segments at a
        time (at most 32 MiB of scratch), one host read per chunk; the
        cost follows len(cols), not the row's columns."""
        out = np.zeros(len(cols), bool)
        shard_of = (cols // np.uint64(SHARD_WIDTH)).astype(np.int64)
        shards = [s for s in np.unique(shard_of).tolist() if s in self.segments]
        for i in range(0, len(shards), 256):
            chunk = shards[i : i + 256]
            lo = np.searchsorted(shard_of, chunk[0], "left")
            hi = np.searchsorted(shard_of, chunk[-1], "right")
            ids = np.asarray(chunk, np.int64)
            slot = np.minimum(np.searchsorted(ids, shard_of[lo:hi]), len(ids) - 1)
            sel = np.flatnonzero(ids[slot] == shard_of[lo:hi])
            bit = (cols[lo:hi][sel] % np.uint64(SHARD_WIDTH)).astype(np.int64)
            words = torch.stack([self.segments[s] for s in chunk]).reshape(-1)
            dev = words.device
            w_idx = torch.from_numpy(slot[sel] * WORDS_PER_ROW + (bit >> 5)).to(dev)
            got = (words[w_idx] >> torch.from_numpy(bit & 31).to(dev, torch.int32)) & 1
            out[lo + sel] = got.cpu().numpy().astype(bool)
        return out

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
