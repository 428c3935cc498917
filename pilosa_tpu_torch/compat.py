"""Load a port Holder from another holder's state exported as numpy.

The state is plain data, so this module needs nothing of the exporting
package:

    {index_name: {
        "track_existence": bool,
        "keys": bool, "translate": (ids, keys),           # optional
        "fields": {field_name: {
            "type": "set" | "mutex" | "int",
            "cache_type": str, "cache_size": int,
            "min": int, "max": int, "base": int, "bit_depth": int,  # int only
            "keys": bool, "translate": (ids, keys),       # optional
            "views": {view_name: {shard: {row_id: (rep, array)}}},
        }},
    }}

`translate` carries a keyed index's column keys or a keyed field's row
keys as an integer id array and the list of their keys, in any order;
the port's stores then map the same keys to the same ids.

`rep` is "dense" (array = uint32[WORDS_PER_ROW] words) or "sparse"
(array = sorted uint32 in-shard positions), the row's host representation
in the exporter, which the import keeps: dense rows go through
import_row_words, sparse rows through exact position imports. Hidden
fields such as `_exists` are listed like any other field. An int field's
BSI view (`bsig_<name>`) lists its plane rows (core/fragment.py BSI_*_BIT)
like any other rows; its options keep the exporter's bit depth, which may
have grown past what the range needs, and must derive the same base.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from pilosa_tpu_torch.core.field import FIELD_TYPE_INT, FIELD_TYPE_MUTEX, FieldOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import EXISTENCE_FIELD_NAME
from pilosa_tpu_torch.ops.bitmap import unpack_positions
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


def holder_from_numpy(state: Dict[str, Dict[str, Any]], device=None) -> Holder:
    holder = Holder(None, device=device)
    for index_name, ispec in state.items():
        idx = holder.create_index(
            index_name,
            keys=ispec.get("keys", False),
            track_existence=ispec.get("track_existence", True),
        )
        _load_keys(idx.translate_store, ispec)
        for field_name, fspec in ispec["fields"].items():
            if field_name == EXISTENCE_FIELD_NAME:
                f = idx.existence_field()
                if f is None:
                    raise ValueError(f"{index_name}: {field_name} without existence tracking")
            else:
                opts = FieldOptions(
                    type=fspec.get("type", "set"),
                    cache_type=fspec.get("cache_type", "ranked"),
                    cache_size=fspec.get("cache_size", 50_000),
                    keys=fspec.get("keys", False),
                )
                if opts.type == FIELD_TYPE_INT:
                    opts.min, opts.max = int(fspec["min"]), int(fspec["max"])
                    opts.bit_depth = int(fspec.get("bit_depth", 0))
                f = idx.create_field(field_name, opts)
                if opts.type == FIELD_TYPE_INT and "base" in fspec and f.options.base != fspec["base"]:
                    raise ValueError(
                        f"{index_name}.{field_name}: base {fspec['base']} differs from the "
                        f"base {f.options.base} of range [{opts.min}, {opts.max}]"
                    )
                _load_keys(f.translate_store, fspec)
            for view_name, shards in fspec["views"].items():
                view = f._view_create(view_name)
                for shard, rows in shards.items():
                    frag = view.fragment(int(shard))
                    for row_id, (rep, arr) in rows.items():
                        if rep == "dense" and f.options.type != FIELD_TYPE_MUTEX:
                            frag.import_row_words(int(row_id), arr)
                            continue
                        pos = unpack_positions(arr) if rep == "dense" else arr
                        keys = np.uint64(row_id) * np.uint64(SHARD_WIDTH) + np.asarray(
                            pos, np.uint64
                        )
                        if f.options.type == FIELD_TYPE_MUTEX:
                            frag.bulk_import(np.full(len(keys), row_id, np.uint64), keys)
                        else:
                            frag.import_positions(keys, None)
    return holder


def _load_keys(store, spec: Dict[str, Any]) -> None:
    if "translate" in spec:
        if store is None:
            raise ValueError("translate entries without keys")
        ids, keys = spec["translate"]
        store.apply_entries(zip(np.asarray(ids, np.uint64).tolist(), keys))
