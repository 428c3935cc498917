"""Index: per-index namespace of fields plus existence tracking (the
`_exists` field whose row 0 marks every column ever set, which Not() and
All() read). The port of pilosa_tpu/core/index.py. A durable index keeps
`{"keys", "track_existence"}` in `<path>/.meta.json`, one directory per
field (`_exists` included) and, when keyed, its column keys in
`<path>/.keys.translate` (core/translate.py)."""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from pilosa_tpu_torch.core.attrs import AttrStore
from pilosa_tpu_torch.core.devcache import DeviceCache
from pilosa_tpu_torch.core.field import FIELD_TYPE_SET, Field, FieldOptions, validate_name
from pilosa_tpu_torch.core.translate import TranslateStore

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
        path: Optional[str] = None,
    ):
        validate_name(name)
        self.path = path  # None: in memory
        self.name = name
        self.keys = keys
        self.track_existence = track_existence
        self.device = device
        self.dcache = dcache
        self._mu = threading.RLock()
        self._fields: Dict[str, Field] = {}
        # column attributes: .col_attrs.json and its append log
        self.column_attr_store = AttrStore(None if path is None else os.path.join(path, ".col_attrs.json"))
        # column keys of a keyed index
        self.translate_store: Optional[TranslateStore] = None
        if keys:
            self.translate_store = TranslateStore(None if path is None else os.path.join(path, ".keys.translate"))

    @property
    def meta_path(self) -> Optional[str]:
        return None if self.path is None else os.path.join(self.path, ".meta.json")

    def open(self) -> "Index":
        """Write .meta.json if it is missing, open every field directory
        (one holding a .meta.json), then create `_exists` if it is
        tracked and absent, and open the column key store of a keyed
        index. The column attributes were read when the index was made."""
        if self.path is not None:
            os.makedirs(self.path, exist_ok=True)
            if not os.path.exists(self.meta_path):
                self.save_meta()
            for fn in sorted(os.listdir(self.path)):
                fdir = os.path.join(self.path, fn)
                if os.path.isdir(fdir) and os.path.exists(os.path.join(fdir, ".meta.json")):
                    self._fields[fn] = self._new_field(fn, Field.load_options(fdir)).open()
        if self.track_existence and EXISTENCE_FIELD_NAME not in self._fields:
            self._fields[EXISTENCE_FIELD_NAME] = self._new_field(
                EXISTENCE_FIELD_NAME,
                FieldOptions(type=FIELD_TYPE_SET, cache_type="none", cache_size=0),
            ).open()
        if self.translate_store is not None:
            self.translate_store.open()
        return self

    def save_meta(self) -> None:
        if self.path is None:
            return
        tmp = self.meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"keys": self.keys, "track_existence": self.track_existence}, f)
        os.replace(tmp, self.meta_path)

    def _new_field(self, name: str, options: FieldOptions) -> Field:
        return Field(
            self.name,
            name,
            options,
            device=self.device,
            dcache=self.dcache,
            path=None if self.path is None else os.path.join(self.path, name),
        )

    def create_field(self, name: str, options: Optional[FieldOptions] = None) -> Field:
        with self._mu:
            validate_name(name)
            if name in self._fields:
                raise ValueError(f"field already exists: {name}")
            f = self._fields[name] = self._new_field(name, options or FieldOptions()).open()
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
        """Forget a field, close it and remove its directory."""
        with self._mu:
            f = self._fields.pop(name, None)
            if f is None:
                raise KeyError(f"field not found: {name}")
            f.close()
            if f.path is not None:
                shutil.rmtree(f.path, ignore_errors=True)

    def close(self) -> None:
        """Close every field (WALs and cache sidecars, device tensors), the
        column key store and the column attribute log."""
        with self._mu:
            fields = list(self._fields.values())
        for f in fields:
            f.close()
        if self.translate_store is not None:
            self.translate_store.close()
        self.column_attr_store.close()

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
