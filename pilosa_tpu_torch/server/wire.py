"""Public JSON form of query results (the `results` list of
`POST /index/{i}/query`).

The port's slice of pilosa_tpu/server/wire.py (`result_to_public_json`).
The internode encodings come with the cluster slice. Every number leaves
as a Python int or bool: `json.dumps` raises on numpy scalars and on 0-d
tensors, which a count read back from the card may be.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.exec.executor import GroupCount, Pair, ValCount


def _number(x: Any):
    if isinstance(x, torch.Tensor):
        x = x.item()
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    return int(x)


def result_to_public_json(r: Any) -> Any:
    """One call's result as the reference's handler writes it: a Row as
    {"attrs": {...}, "columns": [...]} plus "keys" on a keyed index, a
    Count or Set/Clear as a number or bool, Sum/Min/Max as {"value",
    "count"}, TopN as a list of {"id", "count"} plus "key" on a keyed
    field, GroupBy as a list of {"group": [{"field", "rowID" or
    "rowKey"}], "count"}, Rows as a list of row ids or row keys, MinRow
    and MaxRow as {"id", "count"}."""
    if isinstance(r, Row):
        out = {"attrs": r.attrs or {}, "columns": r.columns().tolist()}
        if r.keys is not None:
            out["keys"] = r.keys
        return out
    if isinstance(r, ValCount):
        return {"value": _number(r.value), "count": _number(r.count)}
    if isinstance(r, Pair):
        out = {"id": _number(r.id), "count": _number(r.count)}
        if r.key is not None:
            out["key"] = r.key
        return out
    if isinstance(r, GroupCount):
        return r.to_json()  # Python ints throughout (exec/executor.py)
    if isinstance(r, list):
        return [result_to_public_json(x) for x in r]
    if r is None or isinstance(r, (str, dict)):  # MinRow/MaxRow: Python ints
        return r
    return _number(r)
