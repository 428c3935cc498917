"""Holder: the node-level root of the storage tree.

The port of pilosa_tpu/core/holder.py. `Holder(path=None, device=None)`
runs on the CUDA card (device None) and raises if there is none; pass
device="cpu" for the plain-PyTorch path. The holder owns the device cache
its fragments and views stage tensors in. With a `path` (a data
directory) it is durable, in the reference's on-disk format: one
directory per index holding a .meta.json, opened by `open()`, with its
fields, views, key stores and attribute files.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, List, Optional

from pilosa_tpu_torch.core.devcache import DeviceCache, default_budget
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.device import resolve


class Holder:
    def __init__(self, path: Optional[str] = None, device=None):
        self.path = path  # data directory; None: in memory
        self.device = resolve(device)
        self.dcache = DeviceCache(default_budget(self.device))
        self._mu = threading.RLock()
        self._indexes: Dict[str, Index] = {}

    def open(self) -> "Holder":
        if self.path is not None:
            os.makedirs(self.path, exist_ok=True)
            for name in sorted(os.listdir(self.path)):
                idx_dir = os.path.join(self.path, name)
                meta = os.path.join(idx_dir, ".meta.json")
                if not (os.path.isdir(idx_dir) and os.path.exists(meta)):
                    continue
                with open(meta) as f:
                    opts = json.load(f)
                self._indexes[name] = self._new_index(
                    name,
                    keys=opts.get("keys", False),
                    track_existence=opts.get("track_existence", True),
                ).open()
        return self

    def close(self) -> None:
        """Close every index (WALs synced and closed, cache sidecars
        written), then drop every device tensor."""
        with self._mu:
            for idx in self._indexes.values():
                idx.close()
            self._indexes.clear()
            self.dcache.clear()

    def flush_caches(self) -> None:
        """Write every fragment's rank-cache sidecar (the server's ticker)."""
        for frag in self.fragments():
            frag.flush_cache()

    def recalculate_caches(self) -> None:
        """Rebuild every fragment's rank cache from exact row counts."""
        for frag in self.fragments():
            frag.recalculate_cache()

    def fragments(self):
        for idx in self.indexes():
            for f in idx.fields(include_hidden=True):
                for v in list(f.views.values()):
                    yield from list(v.fragments.values())

    def _new_index(self, name: str, **kw) -> Index:
        return Index(
            name,
            device=self.device,
            dcache=self.dcache,
            path=None if self.path is None else os.path.join(self.path, name),
            **kw,
        )

    def create_index(self, name: str, *, keys: bool = False, track_existence: bool = True) -> Index:
        with self._mu:
            if name in self._indexes:
                raise ValueError(f"index already exists: {name}")
            idx = self._indexes[name] = self._new_index(
                name, keys=keys, track_existence=track_existence
            ).open()
            return idx

    def create_index_if_not_exists(self, name: str, **kw) -> Index:
        with self._mu:
            if name in self._indexes:
                return self._indexes[name]
            return self.create_index(name, **kw)

    def index(self, name: str) -> Optional[Index]:
        return self._indexes.get(name)

    def indexes(self) -> List[Index]:
        with self._mu:
            return [self._indexes[n] for n in sorted(self._indexes)]

    def delete_index(self, name: str) -> None:
        """Forget an index, drop its device tensors (a recreated index gets
        new owner tokens, so LRU pressure alone would be the only way the
        old stacks left) and remove its directory."""
        with self._mu:
            idx = self._indexes.pop(name, None)
            if idx is None:
                raise KeyError(f"index not found: {name}")
            idx.close()
            if idx.path is not None:
                shutil.rmtree(idx.path, ignore_errors=True)

    def pending_repair_count(self) -> int:
        """Replica writes awaiting repair: none on one node."""
        return 0

    def staged_position_count(self) -> int:
        """Staged SET positions not yet merged into row stores."""
        return sum(frag._pending_n for frag in self.fragments())

    def schema(self) -> List[dict]:
        """The schema description of `GET /schema` (the reference's
        holder.schema(), key for key)."""
        out = []
        for idx in self.indexes():
            fields = []
            for f in idx.fields():
                o = f.options
                fields.append(
                    {
                        "name": f.name,
                        "options": {
                            "type": o.type,
                            "cacheType": o.cache_type,
                            "cacheSize": o.cache_size,
                            "min": o.min,
                            "max": o.max,
                            "base": o.base,
                            "bitDepth": o.bit_depth,
                            "timeQuantum": o.time_quantum,
                            "keys": o.keys,
                            "noStandardView": o.no_standard_view,
                        },
                    }
                )
            out.append(
                {
                    "name": idx.name,
                    "options": {"keys": idx.keys, "trackExistence": idx.track_existence},
                    "fields": fields,
                }
            )
        return out
