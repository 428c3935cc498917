"""Field: typed container of views.

The port of pilosa_tpu/core/field.py for set, mutex, bool, time and int
(BSI) fields. A bool field is a mutex field over rows 0 (false) and 1
(true). A time field writes its standard view (unless
`no_standard_view`) and, for a timestamped bit, one view per unit of its
quantum (`standard_2024`, `standard_202401`, `standard_20240102`,
`standard_2024010203`; core/timeq.py). A
durable field keeps its options in `<path>/.meta.json` (the reference's
`asdict(FieldOptions)`, rewritten when an int field's bit depth grows),
its views under `<path>/views/<view>` and, when keyed, its row keys in
`<path>/.keys.translate` (core/translate.py).

An int field stores `value - base` in sign + magnitude bit planes in its
BSI view (`bsig_<name>`): row 0 marks columns that hold a value, row 1
the sign, rows 2.. the magnitude bits (core/fragment.py BSI_*_BIT).
"""

from __future__ import annotations

import json
import os
import re
import threading
from dataclasses import asdict, dataclass
from datetime import datetime
from typing import Dict, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from pilosa_tpu_torch.core.cache import (
    CACHE_TYPE_LRU,
    CACHE_TYPE_NONE,
    CACHE_TYPE_RANKED,
    DEFAULT_CACHE_SIZE,
)
from pilosa_tpu_torch.core import timeq
from pilosa_tpu_torch.core import wal as walmod
from pilosa_tpu_torch.core.devcache import DeviceCache
from pilosa_tpu_torch.core.attrs import AttrStore
from pilosa_tpu_torch.core.translate import TranslateStore
from pilosa_tpu_torch.core.view import VIEW_BSI_PREFIX, VIEW_STANDARD, View, bump_shards_epoch
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WIDTH_EXPONENT
from pilosa_tpu_torch.utils.arrays import group_slices

FIELD_TYPE_SET = "set"
FIELD_TYPE_INT = "int"
FIELD_TYPE_TIME = "time"
FIELD_TYPE_MUTEX = "mutex"
FIELD_TYPE_BOOL = "bool"

FIELD_TYPES = (FIELD_TYPE_SET, FIELD_TYPE_INT, FIELD_TYPE_TIME, FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL)
CACHE_TYPES = (CACHE_TYPE_RANKED, CACHE_TYPE_LRU, CACHE_TYPE_NONE)

_NAME_RE = re.compile(r"^[a-z][a-z0-9_-]{0,63}$")


def validate_name(name: str) -> None:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid name {name!r}")


def bit_depth_of(uvalue: int) -> int:
    """Bits needed for a magnitude (at least 1)."""
    return max(1, int(uvalue).bit_length())


def bsi_base(min_v: int, max_v: int) -> int:
    """The default base: the range end nearest zero, or zero inside it."""
    if min_v > 0:
        return min_v
    if max_v < 0:
        return max_v
    return 0


@dataclass
class FieldOptions:
    type: str = FIELD_TYPE_SET
    cache_type: str = CACHE_TYPE_RANKED
    cache_size: int = DEFAULT_CACHE_SIZE
    # int fields: value range, base (derived from the range) and bit depth
    min: int = 0
    max: int = 0
    base: int = 0
    bit_depth: int = 0
    # keys: row keys translate through the field's TranslateStore
    time_quantum: str = ""
    keys: bool = False
    no_standard_view: bool = False


class Field:
    def __init__(
        self,
        index: str,
        name: str,
        options: FieldOptions,
        *,
        device: torch.device,
        dcache: DeviceCache,
        path: Optional[str] = None,
    ):
        # leading-underscore names are the index's internal fields (_exists)
        if not name.startswith("_"):
            validate_name(name)
        if options.type not in FIELD_TYPES:
            raise ValueError(f"invalid field type {options.type!r}")
        if options.cache_type not in CACHE_TYPES:
            raise ValueError(f"invalid cache type {options.cache_type!r}")
        if options.type == FIELD_TYPE_INT:
            _init_int_options(options)
        if options.type == FIELD_TYPE_TIME:
            timeq.validate_quantum(options.time_quantum)
        self.path = path  # None: in memory
        self.index = index
        self.name = name
        self.options = options
        self.device = device
        self.dcache = dcache
        self._mu = threading.RLock()
        self.views: Dict[str, View] = {}
        # shards a cluster peer announced: they exist cluster-wide even
        # where this node holds no fragment of them
        self.remote_available_shards: Set[int] = set()
        # row attributes: .row_attrs.json and its append log
        self.row_attr_store = AttrStore(None if path is None else os.path.join(path, ".row_attrs.json"))
        # row keys of a keyed field
        self.translate_store: Optional[TranslateStore] = None
        if options.keys:
            self.translate_store = TranslateStore(None if path is None else os.path.join(path, ".keys.translate"))

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    @property
    def meta_path(self) -> Optional[str]:
        return None if self.path is None else os.path.join(self.path, ".meta.json")

    @staticmethod
    def load_options(path: str) -> FieldOptions:
        """The options a field directory's .meta.json holds."""
        with open(os.path.join(path, ".meta.json")) as f:
            return FieldOptions(**json.load(f))

    def open(self) -> "Field":
        """Write .meta.json if it is missing, then open every view under
        views/ (time views included) and, for a keyed field, the row key
        store. The row attributes were read when the field was made."""
        if self.translate_store is not None:
            self.translate_store.open()
        if self.path is None:
            return self
        os.makedirs(self.path, exist_ok=True)
        if not os.path.exists(self.meta_path):
            self.save_meta()
        if os.path.exists(self._avail_path):
            with open(self._avail_path) as f:
                self.remote_available_shards.update(json.load(f))
        views_dir = os.path.join(self.path, "views")
        if os.path.isdir(views_dir):
            for vname in sorted(os.listdir(views_dir)):
                self._view_create(vname)
        return self

    def save_meta(self) -> None:
        if self.path is None:
            return
        walmod.write_durable(self.meta_path, json.dumps(asdict(self.options)))

    @property
    def _avail_path(self) -> Optional[str]:
        return None if self.path is None else os.path.join(self.path, ".available.shards.json")

    def add_remote_available(self, shards) -> None:
        """Merge cluster-announced shards into the availability set and
        persist it (`.available.shards.json`), so a restarted node still
        knows which shards exist cluster-wide."""
        with self._mu:
            new = {int(s) for s in shards} - self.remote_available_shards
            if not new:
                return
            self.remote_available_shards.update(new)
            self._persist_available()
        bump_shards_epoch()

    def remove_remote_available(self, shard: int) -> None:
        with self._mu:
            if shard not in self.remote_available_shards:
                return
            self.remote_available_shards.discard(int(shard))
            self._persist_available()
        bump_shards_epoch()

    def _persist_available(self) -> None:
        """Write the availability sidecar atomically; call under _mu."""
        p = self._avail_path
        if p is not None:
            walmod.write_durable(p, json.dumps(sorted(self.remote_available_shards)))

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
                    mutex=self.options.type in (FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL),
                    # BSI views hold bit planes, not rankable rows
                    cache_type=(
                        CACHE_TYPE_NONE
                        if name.startswith(VIEW_BSI_PREFIX)
                        else self.options.cache_type
                    ),
                    cache_size=self.options.cache_size,
                    path=None if self.path is None else os.path.join(self.path, "views", name),
                ).open()
                self.views[name] = v
            return v

    def view(self, name: str = VIEW_STANDARD) -> Optional[View]:
        return self.views.get(name)

    def close(self) -> None:
        """Close every view (WALs and cache sidecars, device tensors), the
        row key store and the row attribute log."""
        with self._mu:
            for v in self.views.values():
                v.close()
            if self.translate_store is not None:
                self.translate_store.close()
            self.row_attr_store.close()

    def bsi_view_name(self) -> str:
        return VIEW_BSI_PREFIX + self.name

    def available_shards(self) -> Set[int]:
        """The shards of local fragments and the cluster-announced ones."""
        with self._mu:
            shards: Set[int] = set(self.remote_available_shards)
            for v in self.views.values():
                shards.update(v.available_shards())
            return shards

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------

    def set_bit(self, row_id: int, col: int, ts: Optional[datetime] = None) -> bool:
        """Set a bit in the standard view (unless `no_standard_view`) and,
        when timestamped, in each unit view of the quantum."""
        changed = False
        if not self.options.no_standard_view:
            changed |= self._view_create(VIEW_STANDARD).set_bit(row_id, col)
        if ts is not None:
            if self.options.type != FIELD_TYPE_TIME:
                raise ValueError(f"field {self.name} is not a time field")
            for vname in timeq.views_by_time(VIEW_STANDARD, ts, self.options.time_quantum):
                changed |= self._view_create(vname).set_bit(row_id, col)
        return changed

    def clear_bit(self, row_id: int, col: int) -> bool:
        with self._mu:
            views = list(self.views.values())
        changed = False
        for v in views:
            if not v.name.startswith(VIEW_BSI_PREFIX):
                changed |= v.clear_bit(row_id, col)
        return changed

    def _check_value_range(self, lo: int, hi: int) -> None:
        """Values in [lo, hi] must fit the int field's [min, max]."""
        if self.options.type != FIELD_TYPE_INT:
            raise ValueError(f"field {self.name} is not an int field")
        if lo < self.options.min:
            raise ValueError(f"value {lo} below field minimum {self.options.min}")
        if hi > self.options.max:
            raise ValueError(f"value {hi} above field maximum {self.options.max}")

    def _grow_bit_depth(self, magnitude: int) -> None:
        """Widen the field to hold `magnitude`; planes older shards never
        wrote read as zero (View.plane_stack)."""
        required = bit_depth_of(magnitude)
        if required > self.options.bit_depth:
            with self._mu:
                self.options.bit_depth = max(self.options.bit_depth, required)
                self.save_meta()

    def set_value(self, col: int, value: int) -> bool:
        """Write one int value (the BSI view), growing the bit depth when
        the magnitude needs more planes."""
        self._check_value_range(value, value)
        base_value = value - self.options.base
        self._grow_bit_depth(abs(base_value))
        v = self._view_create(self.bsi_view_name())
        return v.set_value(col, self.options.bit_depth, base_value)

    def clear_value(self, col: int) -> bool:
        v = self.view(self.bsi_view_name())
        if v is None:
            return False
        val, exists = v.value(col, self.options.bit_depth)
        if not exists:
            return False
        return v.set_value(col, self.options.bit_depth, val, clear=True)

    def import_values(self, cols: np.ndarray, values: np.ndarray) -> None:
        """Bulk int import grouped by shard; the last write per column
        wins."""
        cols = np.asarray(cols, dtype=np.uint64)
        values = np.asarray(values, dtype=np.int64)
        if not len(values):
            return
        self._check_value_range(int(values.min()), int(values.max()))
        base_values = values - self.options.base
        self._grow_bit_depth(int(np.abs(base_values).max()))
        v = self._view_create(self.bsi_view_name())
        with walmod.GROUP_COMMIT.barrier():  # one group commit for every shard
            for shard, m in group_slices(cols // np.uint64(SHARD_WIDTH)):
                v.fragment(int(shard)).import_values(cols[m], base_values[m], self.options.bit_depth)

    def import_bits(
        self,
        row_ids: np.ndarray,
        cols: np.ndarray,
        timestamps: Optional[Union[Sequence[Optional[datetime]], np.ndarray]] = None,
        clear: bool = False,
    ) -> None:
        """Bulk import grouped by view and shard, under one group commit.
        SET imports into a view that is not mutex take the staged path
        (View.stage_bulk: merge deferred to the next read barrier); clears
        and mutex/bool fields take the exact per-fragment path
        (last-write-wins needs the merge at apply time). The timestamped
        bits of a time field also go to their unit views, grouped with
        numpy by hour: each hour of the batch names its views once. They
        are merged at apply time, as the reference's exact path merges
        them: staged, then one read barrier per unit view, which patches
        the view's resident extents in place."""
        row_ids = np.asarray(row_ids, dtype=np.uint64)
        cols = np.asarray(cols, dtype=np.uint64)
        shards = cols >> np.uint64(SHARD_WIDTH_EXPONENT)
        staged = not clear and self.options.type not in (FIELD_TYPE_MUTEX, FIELD_TYPE_BOOL)
        with walmod.GROUP_COMMIT.barrier():  # one group commit for every view and shard
            if not self.options.no_standard_view:
                self._import_view(VIEW_STANDARD, row_ids, cols, shards, staged, clear)
            if timestamps is not None and self.options.time_quantum:
                views = [
                    self._import_view(vname, row_ids[sel], cols[sel], shards[sel], staged, clear)
                    for vname, sel in self._time_view_groups(timestamps)
                ]
                if staged:
                    for v in views:
                        v.sync_pending()

    def _import_view(self, vname: str, row_ids, cols, shards, staged: bool, clear: bool) -> View:
        v = self._view_create(vname)
        if staged:
            positions = (row_ids << np.uint64(SHARD_WIDTH_EXPONENT)) | (cols & np.uint64(SHARD_WIDTH - 1))
            v.stage_bulk(shards, positions)
        else:
            for shard, sl in group_slices(shards):
                v.fragment(int(shard)).bulk_import(row_ids[sl], cols[sl], clear=clear)
        return v

    def _time_view_groups(self, timestamps):
        """(unit view name, indices of the bits that land in it) for every
        unit view a batch's timestamps reach: datetimes, or a numpy
        datetime64 array; None (NaT) reaches none."""
        hours = np.asarray(timestamps, dtype="datetime64[h]")
        idx = np.flatnonzero(~np.isnat(hours))
        if not len(idx):
            return
        uniq, inv = np.unique(hours[idx], return_inverse=True)
        names = [timeq.views_by_time(VIEW_STANDARD, h.item(), self.options.time_quantum) for h in uniq]
        for unit in range(len(names[0])):
            vnames, view_of = np.unique([n[unit] for n in names], return_inverse=True)
            for k, sel in group_slices(view_of[inv]):
                yield str(vnames[k]), idx[sel]

    def import_row_words(self, row_id: int, shard: int, words: np.ndarray) -> int:
        """Word-level bulk union of one row of one shard (standard view).
        Returns the newly-set bit count."""
        if self.options.type not in (FIELD_TYPE_SET, FIELD_TYPE_TIME, FIELD_TYPE_BOOL):
            raise ValueError(f"word-level import not supported on {self.options.type} fields")
        return self._view_create(VIEW_STANDARD).fragment(int(shard)).import_row_words(
            row_id, words
        )

    # ------------------------------------------------------------------
    # int reads and predicate bounds
    # ------------------------------------------------------------------

    def value(self, col: int) -> Tuple[int, bool]:
        """(value, exists) of one column."""
        v = self.view(self.bsi_view_name())
        if v is None:
            return 0, False
        val, exists = v.value(col, self.options.bit_depth)
        if not exists:
            return 0, False
        return val + self.options.base, True

    def _depth_bounds(self) -> Tuple[int, int]:
        o = self.options
        return o.base - (1 << o.bit_depth) + 1, o.base + (1 << o.bit_depth) - 1

    def base_value(self, op: str, value: int) -> Tuple[int, bool]:
        """A predicate value relative to the base, clamped to what the bit
        depth can hold: (base value, out of range)."""
        depth_min, depth_max = self._depth_bounds()
        base = self.options.base
        if op in ("gt", "gte"):
            if value > depth_max:
                return 0, True
            if value > depth_min:
                return value - base, False
            return 0, False
        if op in ("lt", "lte"):
            if value < depth_min:
                return 0, True
            if value > depth_max:
                return depth_max - base, False
            return value - base, False
        if op in ("eq", "neq"):
            if value < depth_min or value > depth_max:
                return 0, True
            return value - base, False
        raise ValueError(f"invalid op {op}")

    def base_value_between(self, lo: int, hi: int) -> Tuple[int, int, bool]:
        depth_min, depth_max = self._depth_bounds()
        if hi < depth_min or lo > depth_max:
            return 0, 0, True
        lo = max(lo, depth_min)
        hi = min(hi, depth_max)
        return lo - self.options.base, hi - self.options.base, False


def _init_int_options(options: FieldOptions) -> None:
    """Creation rules of an int field: the default range [0, 2^31 - 1],
    the base from the range, and the bit depth the range needs; at most
    32 magnitude bits (the kernels' words are 32 bits)."""
    if options.min == 0 and options.max == 0:
        options.max = 2**31 - 1
    options.base = bsi_base(options.min, options.max)
    required = max(
        bit_depth_of(abs(options.min - options.base)),
        bit_depth_of(abs(options.max - options.base)),
    )
    if options.bit_depth == 0:
        options.bit_depth = required
    if max(required, options.bit_depth) > 32:
        raise ValueError(
            f"int field range [{options.min}, {options.max}] needs "
            f"{max(required, options.bit_depth)}-bit magnitudes; device "
            "BSI supports at most 32 (narrow the range or shift it "
            "closer to the base)"
        )
