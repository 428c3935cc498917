"""View: groups fragments by shard for one view of a field.

The port of pilosa_tpu/core/view.py: fragment lookup, the read barrier
over staged writes, the staged bulk-ingest router, and the row and plane
stacks the stacked query path stages on the device. A durable view keeps
its fragments under `<path>/fragments/<shard>` (.snap, .wal, .cache) and
opens every fragment found there. The coherence hub, the result cache and
extent patching are not ported; a mutation drops the view's device stacks
wholesale.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from pilosa_tpu_torch.core import wal as walmod
from pilosa_tpu_torch.core.devcache import DeviceCache, new_owner_token
from pilosa_tpu_torch.core.fragment import DEFAULT_MAX_OP_N, Fragment
from pilosa_tpu_torch.hbm import residency
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

VIEW_STANDARD = "standard"
VIEW_BSI_PREFIX = "bsig_"


class View:
    def __init__(
        self,
        name: str,
        index: str,
        field: str,
        *,
        device: torch.device,
        dcache: DeviceCache,
        mutex: bool = False,
        cache_type: str = "ranked",
        cache_size: int = 50_000,
        path: Optional[str] = None,
    ):
        self.path = path  # the directory holding fragments/; None: in memory
        self.max_op_n = DEFAULT_MAX_OP_N  # passed to each new fragment
        self.name = name
        self.index = index
        self.field = field
        self.device = device
        self.dcache = dcache
        self.mutex = mutex
        self.cache_type = cache_type
        self.cache_size = cache_size
        self._mu = threading.RLock()
        self.fragments: Dict[int, Fragment] = {}
        # owner token for this view's stacks and TopN tally bundles
        self._stack_token = new_owner_token()

    def open(self) -> "View":
        """Open every fragment of the view's directory (a shard with a
        .snap or a .wal file)."""
        if self.path is not None:
            frag_dir = os.path.join(self.path, "fragments")
            if os.path.isdir(frag_dir):
                for fn in sorted(os.listdir(frag_dir)):
                    if fn.endswith((".snap", ".wal")):
                        shard_s = fn.rsplit(".", 1)[0]
                        if shard_s.isdigit():
                            self.fragment(int(shard_s))
        return self

    def fragment(self, shard: int) -> Fragment:
        """Get-or-create (and open) the fragment for a shard."""
        with self._mu:
            frag = self.fragments.get(shard)
            if frag is None:
                frag = Fragment(
                    self.index,
                    self.field,
                    self.name,
                    shard,
                    device=self.device,
                    dcache=self.dcache,
                    mutex=self.mutex,
                    cache_type=self.cache_type,
                    cache_size=self.cache_size,
                    path=None if self.path is None else os.path.join(self.path, "fragments", str(shard)),
                    max_op_n=self.max_op_n,
                ).open()
                frag.on_mutate = self._on_fragment_mutate
                self.fragments[shard] = frag
            return frag

    def _on_fragment_mutate(self) -> None:
        self.dcache.invalidate_owner(self._stack_token)

    def close(self) -> None:
        """Close every fragment (WAL, cache sidecar) and drop every device
        tensor this view cached: a deleted field's stacks must not wait
        for LRU pressure to leave."""
        with self._mu:
            for frag in self.fragments.values():
                frag.close()
            self.dcache.invalidate_owner(self._stack_token)

    def fragment_if_exists(self, shard: int) -> Optional[Fragment]:
        return self.fragments.get(shard)

    def available_shards(self) -> List[int]:
        with self._mu:
            return sorted(self.fragments)

    def _frags_for(self, shards: tuple) -> list:
        with self._mu:
            return [self.fragments.get(s) for s in shards]

    def _stack_key(self, kind: str, ident, shards: tuple) -> tuple:
        return (self._stack_token, kind, ident, shards)

    @staticmethod
    def _frag_versions(frags) -> tuple:
        return tuple(f.version if f is not None else -1 for f in frags)

    def sync_pending(self, shards=None, frags=None) -> None:
        """Read barrier: merge every listed (default: every) fragment's
        staged delta into its row store."""
        if frags is None:
            with self._mu:
                if shards is None:
                    frags = list(self.fragments.values())
                else:
                    frags = [self.fragments.get(s) for s in shards]
        for f in frags:
            if f is not None:
                f.sync_pending_now()

    def row_stack(self, row_id: int, shards) -> Optional[torch.Tensor]:
        """int32[S, W] device stack of one row over `shards`, or None when
        no listed shard has a fragment."""
        shards = tuple(shards)
        frags = self._frags_for(shards)
        if all(f is None for f in frags):
            return None
        self.sync_pending(frags=frags)
        zeros = np.zeros(WORDS_PER_ROW, np.uint32)

        def build() -> np.ndarray:
            return np.stack([f.row_words(row_id) if f is not None else zeros for f in frags])

        return residency.stage_row_stack(
            self.dcache,
            self._stack_key("row", row_id, shards),
            self._frag_versions(frags),
            build,
            self.device,
        )

    def plane_stack(self, row_ids, shards) -> Optional[torch.Tensor]:
        """int32[D, S, W] device stack (rows x shards), or None when no
        listed shard has a fragment. A row a fragment lacks reads as zero
        words (an int field's high plane that older shards never wrote
        after its bit depth grew)."""
        row_ids = tuple(row_ids)
        shards = tuple(shards)
        frags = self._frags_for(shards)
        if all(f is None for f in frags):
            return None
        self.sync_pending(frags=frags)
        def build() -> np.ndarray:
            out = np.zeros((len(row_ids), len(frags), WORDS_PER_ROW), np.uint32)
            for j, f in enumerate(frags):
                if f is not None:
                    f.rows_words_into(row_ids, out[:, j])
            return out

        return residency.stage_plane_stack(
            self.dcache,
            self._stack_key("planes", row_ids, shards),
            self._frag_versions(frags),
            build,
            self.device,
        )

    def stage_bulk(self, shards: np.ndarray, positions: np.ndarray) -> None:
        """Bulk-ingest router: one argsort splits the batch into per-shard
        chunks, each staged on its fragment; the device-cache invalidation
        every write owes runs once for the whole batch."""
        if not len(shards):
            return
        order = np.argsort(shards)
        sh = shards[order]
        pos = positions[order]
        bounds = np.flatnonzero(sh[1:] != sh[:-1]) + 1
        starts = np.concatenate(([0], bounds)).astype(np.int64)
        tokens = [self._stack_token]
        # one group commit for the whole batch, at the barrier's exit
        with walmod.GROUP_COMMIT.barrier():
            for shard, chunk in zip(sh[starts].tolist(), np.split(pos, bounds)):
                frag = self.fragment(int(shard))
                frag.stage_positions(chunk, notify=False)
                tokens.append(frag._token)
                tokens.append(frag._stack_token)
        self.dcache.invalidate_owners(tokens)

    def set_bit(self, row_id: int, col: int) -> bool:
        return self.fragment(col // SHARD_WIDTH).set_bit(row_id, col)

    def clear_bit(self, row_id: int, col: int) -> bool:
        frag = self.fragment_if_exists(col // SHARD_WIDTH)
        return frag.clear_bit(row_id, col) if frag is not None else False

    def set_value(self, col: int, bit_depth: int, value: int, clear: bool = False) -> bool:
        return self.fragment(col // SHARD_WIDTH).set_value(col, bit_depth, value, clear)

    def value(self, col: int, bit_depth: int):
        frag = self.fragment_if_exists(col // SHARD_WIDTH)
        if frag is None:
            return 0, False
        return frag.value(col, bit_depth)
