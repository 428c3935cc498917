"""Field: typed container of views.

The port of pilosa_tpu/core/field.py for set and mutex fields, in memory.
Int (BSI), time and bool fields come in later slices and raise at
creation.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Set

import numpy as np
import torch

from pilosa_tpu_torch.core.cache import (
    CACHE_TYPE_LRU,
    CACHE_TYPE_NONE,
    CACHE_TYPE_RANKED,
    DEFAULT_CACHE_SIZE,
)
from pilosa_tpu_torch.core.devcache import DeviceCache
from pilosa_tpu_torch.core.view import VIEW_STANDARD, View
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WIDTH_EXPONENT
from pilosa_tpu_torch.utils.arrays import group_slices

FIELD_TYPE_SET = "set"
FIELD_TYPE_INT = "int"
FIELD_TYPE_TIME = "time"
FIELD_TYPE_MUTEX = "mutex"
FIELD_TYPE_BOOL = "bool"

PORTED_TYPES = (FIELD_TYPE_SET, FIELD_TYPE_MUTEX)
FIELD_TYPES = (FIELD_TYPE_SET, FIELD_TYPE_INT, FIELD_TYPE_TIME, FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL)
CACHE_TYPES = (CACHE_TYPE_RANKED, CACHE_TYPE_LRU, CACHE_TYPE_NONE)

_NAME_RE = re.compile(r"^[a-z][a-z0-9_-]{0,63}$")


def validate_name(name: str) -> None:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid name {name!r}")


@dataclass
class FieldOptions:
    type: str = FIELD_TYPE_SET
    cache_type: str = CACHE_TYPE_RANKED
    cache_size: int = DEFAULT_CACHE_SIZE


class Field:
    def __init__(
        self,
        index: str,
        name: str,
        options: FieldOptions,
        *,
        device: torch.device,
        dcache: DeviceCache,
    ):
        # leading-underscore names are the index's internal fields (_exists)
        if not name.startswith("_"):
            validate_name(name)
        if options.type not in FIELD_TYPES:
            raise ValueError(f"invalid field type {options.type!r}")
        if options.type not in PORTED_TYPES:
            raise NotImplementedError(f"{options.type} fields are not ported yet")
        if options.cache_type not in CACHE_TYPES:
            raise ValueError(f"invalid cache type {options.cache_type!r}")
        self.index = index
        self.name = name
        self.options = options
        self.device = device
        self.dcache = dcache
        self._mu = threading.RLock()
        self.views: Dict[str, View] = {}

    def _view_create(self, name: str) -> View:
        with self._mu:
            v = self.views.get(name)
            if v is None:
                v = View(
                    name,
                    self.index,
                    self.name,
                    device=self.device,
                    dcache=self.dcache,
                    mutex=self.options.type == FIELD_TYPE_MUTEX,
                    cache_type=self.options.cache_type,
                    cache_size=self.options.cache_size,
                )
                self.views[name] = v
            return v

    def view(self, name: str = VIEW_STANDARD) -> Optional[View]:
        return self.views.get(name)

    def available_shards(self) -> Set[int]:
        with self._mu:
            shards: Set[int] = set()
            for v in self.views.values():
                shards.update(v.available_shards())
            return shards

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------

    def set_bit(self, row_id: int, col: int, ts=None) -> bool:
        if ts is not None:
            raise ValueError(f"field {self.name} is not a time field")
        return self._view_create(VIEW_STANDARD).set_bit(row_id, col)

    def clear_bit(self, row_id: int, col: int) -> bool:
        with self._mu:
            views = list(self.views.values())
        changed = False
        for v in views:
            changed |= v.clear_bit(row_id, col)
        return changed

    def import_bits(self, row_ids: np.ndarray, cols: np.ndarray, clear: bool = False) -> None:
        """Bulk import grouped by shard. Set-field SET imports take the
        staged path (View.stage_bulk: merge deferred to the next read
        barrier); clears and mutex fields take the exact per-fragment
        path (last-write-wins needs the merge at apply time)."""
        row_ids = np.asarray(row_ids, dtype=np.uint64)
        cols = np.asarray(cols, dtype=np.uint64)
        shards = cols >> np.uint64(SHARD_WIDTH_EXPONENT)
        std = self._view_create(VIEW_STANDARD)
        if not clear and self.options.type != FIELD_TYPE_MUTEX:
            positions = (row_ids << np.uint64(SHARD_WIDTH_EXPONENT)) | (
                cols & np.uint64(SHARD_WIDTH - 1)
            )
            std.stage_bulk(shards, positions)
            return
        for shard, sl in group_slices(shards):
            std.fragment(int(shard)).bulk_import(row_ids[sl], cols[sl], clear=clear)

    def import_row_words(self, row_id: int, shard: int, words: np.ndarray) -> int:
        """Word-level bulk union of one row of one shard (standard view).
        Returns the newly-set bit count."""
        if self.options.type != FIELD_TYPE_SET:
            raise ValueError(f"word-level import not supported on {self.options.type} fields")
        return self._view_create(VIEW_STANDARD).fragment(int(shard)).import_row_words(
            row_id, words
        )
