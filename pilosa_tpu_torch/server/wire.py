"""Wire forms of query results: the internode encoding a coordinator
reduces, the binary array frames of the bulk internode imports, and the
public JSON of `POST /index/{i}/query`.

The port of pilosa_tpu/server/wire.py. The internode form is tagged
JSON, byte for byte the reference's: a Row travels as base64 uint32 bit
positions per shard, so a remote partial merges exactly into the
coordinator's Row; counts, Sum/Min/Max pairs (with their counts), TopN
pairs, GroupBy groups, Rows lists and MinRow/MaxRow's {"id", "count"}
travel as JSON numbers (the last under a tag the reference lacks: its
cluster cannot carry a MinRow leg). Every number
leaves as a Python int or bool: `json.dumps` raises on numpy scalars and
on 0-d tensors, which a count read back from the card may be.
"""

from __future__ import annotations

import base64
import struct
from typing import Any, Dict, List

import numpy as np
import torch

from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.exec.executor import FieldRow, GroupCount, Pair, ValCount
from pilosa_tpu_torch.ops import bitmap as ob

# -- binary array frames (bulk internode data) ---------------------------------

ARRAYS_MAGIC = b"PTA1"
ARRAYS_CTYPE = "application/octet-stream"
_MAX_ARRAY_BYTES = 1 << 31  # 2 GiB: a larger length prefix is rejected


def encode_arrays(*arrays) -> bytes:
    """magic | u32 n_arrays | per array: u32 length | raw little-endian
    uint64s. A sender never makes a frame the receiver must reject:
    an array over the bound raises, and callers chunk instead."""
    parts = [ARRAYS_MAGIC, struct.pack("<I", len(arrays))]
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
        if a.nbytes > _MAX_ARRAY_BYTES:
            raise ValueError(
                f"array of {a.nbytes} bytes exceeds the {_MAX_ARRAY_BYTES}-byte "
                "wire frame bound; chunk the transfer"
            )
        parts.append(struct.pack("<I", a.size))
        parts.append(a.astype("<u8", copy=False).tobytes())
    return b"".join(parts)


def decode_arrays(data: bytes, expect: int) -> List[np.ndarray]:
    """The strictly checked inverse of encode_arrays (untrusted input)."""
    if len(data) < 8 or data[:4] != ARRAYS_MAGIC:
        raise ValueError("bad array-stream magic")
    (n,) = struct.unpack_from("<I", data, 4)
    if n != expect:
        raise ValueError(f"array-stream has {n} arrays, expected {expect}")
    off = 8
    out: List[np.ndarray] = []
    for _ in range(n):
        if off + 4 > len(data):
            raise ValueError("truncated array-stream header")
        (ln,) = struct.unpack_from("<I", data, off)
        off += 4
        nbytes = ln * 8
        if nbytes > _MAX_ARRAY_BYTES or off + nbytes > len(data):
            raise ValueError("truncated array-stream payload")
        out.append(np.frombuffer(data, dtype="<u8", count=ln, offset=off).copy())
        off += nbytes
    if off != len(data):
        raise ValueError("trailing bytes in array-stream")
    return out


# -- internode results ---------------------------------------------------------


def _number(x: Any):
    if isinstance(x, torch.Tensor):
        x = x.item()
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    return int(x)


def _b64_positions(words: torch.Tensor) -> str:
    pos = ob.unpack_positions(ob.to_host(words)).astype(np.uint32)
    return base64.b64encode(pos.tobytes()).decode("ascii")


def encode_result(r: Any) -> Dict[str, Any]:
    """The tagged internode encoding of one call's result."""
    if isinstance(r, Row):
        return {
            "type": "row",
            "segments": {str(s): _b64_positions(w) for s, w in r.segments.items()},
            "attrs": r.attrs,
            "keys": r.keys,
        }
    if isinstance(r, (bool, np.bool_)):
        return {"type": "bool", "value": bool(r)}
    if isinstance(r, (int, np.integer)) or (isinstance(r, torch.Tensor) and r.dim() == 0):
        return {"type": "uint64", "value": _number(r)}
    if isinstance(r, ValCount):
        return {"type": "valcount", "value": _number(r.value), "count": _number(r.count)}
    if isinstance(r, Pair):
        return {"type": "pair", "id": _number(r.id), "count": _number(r.count), "key": r.key}
    if isinstance(r, dict) and set(r) == {"id", "count"}:  # MinRow / MaxRow
        return {"type": "idcount", "id": _number(r["id"]), "count": _number(r["count"])}
    if isinstance(r, list):
        if all(isinstance(p, Pair) for p in r):
            return {
                "type": "pairs",
                "pairs": [{"id": _number(p.id), "count": _number(p.count), "key": p.key} for p in r],
            }
        if all(isinstance(g, GroupCount) for g in r):
            return {
                "type": "groupcounts",
                "groups": [
                    {
                        "group": [
                            {"field": fr.field, "rowID": _number(fr.row_id), "rowKey": fr.row_key}
                            for fr in g.group
                        ],
                        "count": _number(g.count),
                    }
                    for g in r
                ],
            }
        if all(isinstance(x, str) for x in r):
            return {"type": "rowkeys", "keys": r}
        if all(isinstance(x, (int, np.integer)) for x in r):
            return {"type": "rowids", "rows": [_number(x) for x in r]}
    if r is None:
        return {"type": "none"}
    raise TypeError(f"cannot encode result of type {type(r)!r}")


def decode_result(d: Dict[str, Any], device=None) -> Any:
    """The inverse of encode_result; a Row's words land on `device` (the
    CPU when None)."""
    t = d.get("type")
    if t == "row":
        dev = torch.device("cpu") if device is None else device
        segments = {}
        for s, b in d.get("segments", {}).items():
            pos = np.frombuffer(base64.b64decode(b), dtype=np.uint32)
            segments[int(s)] = ob.from_host(ob.pack_positions(pos), dev)
        row = Row(segments)
        row.attrs = d.get("attrs")
        row.keys = d.get("keys")
        return row
    if t == "bool":
        return bool(d["value"])
    if t == "uint64":
        return int(d["value"])
    if t == "valcount":
        return ValCount(value=int(d["value"]), count=int(d["count"]))
    if t == "pair":
        return Pair(id=int(d["id"]), count=int(d["count"]), key=d.get("key"))
    if t == "idcount":
        return {"id": int(d["id"]), "count": int(d["count"])}
    if t == "pairs":
        return [Pair(id=int(p["id"]), count=int(p["count"]), key=p.get("key")) for p in d["pairs"]]
    if t == "groupcounts":
        return [
            GroupCount(
                group=[
                    FieldRow(field=fr["field"], row_id=int(fr.get("rowID") or 0), row_key=fr.get("rowKey"))
                    for fr in g["group"]
                ],
                count=int(g["count"]),
            )
            for g in d["groups"]
        ]
    if t == "rowkeys":
        return list(d["keys"])
    if t == "rowids":
        return [int(x) for x in d["rows"]]
    if t == "none":
        return None
    raise TypeError(f"cannot decode result type {t!r}")


# -- public JSON -----------------------------------------------------------------


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
