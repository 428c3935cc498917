"""Index: per-index namespace of fields plus existence tracking (the
`_exists` field whose row 0 marks every column ever set, which Not() and
All() read). The port of pilosa_tpu/core/index.py, in memory."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from pilosa_tpu_torch.core.devcache import DeviceCache
from pilosa_tpu_torch.core.field import FIELD_TYPE_SET, Field, FieldOptions, validate_name

EXISTENCE_FIELD_NAME = "_exists"


class Index:
    def __init__(
        self,
        name: str,
        *,
        device: torch.device,
        dcache: DeviceCache,
        keys: bool = False,
        track_existence: bool = True,
    ):
        validate_name(name)
        if keys:
            raise NotImplementedError("key translation is not ported yet")
        self.name = name
        self.keys = keys
        self.track_existence = track_existence
        self.device = device
        self.dcache = dcache
        self._mu = threading.RLock()
        self._fields: Dict[str, Field] = {}
        if track_existence:
            self._fields[EXISTENCE_FIELD_NAME] = self._new_field(
                EXISTENCE_FIELD_NAME,
                FieldOptions(type=FIELD_TYPE_SET, cache_type="none", cache_size=0),
            )

    def _new_field(self, name: str, options: FieldOptions) -> Field:
        return Field(self.name, name, options, device=self.device, dcache=self.dcache)

    def create_field(self, name: str, options: Optional[FieldOptions] = None) -> Field:
        with self._mu:
            validate_name(name)
            if name in self._fields:
                raise ValueError(f"field already exists: {name}")
            f = self._fields[name] = self._new_field(name, options or FieldOptions())
            return f

    def create_field_if_not_exists(self, name: str, options: Optional[FieldOptions] = None) -> Field:
        with self._mu:
            if name in self._fields:
                return self._fields[name]
            return self.create_field(name, options)

    def field(self, name: str) -> Optional[Field]:
        return self._fields.get(name)

    def fields(self, include_hidden: bool = False) -> List[Field]:
        """Fields sorted by name; `_`-prefixed internal fields only when
        include_hidden."""
        with self._mu:
            return [
                f
                for n, f in sorted(self._fields.items())
                if include_hidden or not n.startswith("_")
            ]

    def delete_field(self, name: str) -> None:
        with self._mu:
            f = self._fields.pop(name, None)
            if f is None:
                raise KeyError(f"field not found: {name}")
        f.close()

    def close(self) -> None:
        """Drop every device tensor the index's fields cached."""
        with self._mu:
            fields = list(self._fields.values())
        for f in fields:
            f.close()

    def existence_field(self) -> Optional[Field]:
        return self._fields.get(EXISTENCE_FIELD_NAME) if self.track_existence else None

    def track_columns(self, cols: np.ndarray) -> None:
        """Mark columns as existing (row 0 of `_exists`)."""
        ef = self.existence_field()
        if ef is not None and len(cols):
            ef.import_bits(np.zeros(len(cols), np.uint64), cols)

    def available_shards(self) -> Set[int]:
        with self._mu:
            shards: Set[int] = set()
            for f in self._fields.values():
                shards.update(f.available_shards())
            return shards
