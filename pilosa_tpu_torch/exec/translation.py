"""Query key translation: string keys in calls <-> integer ids in results.

The port of pilosa_tpu/exec/translation.py. Before execution every string
key in the call tree is replaced by its id through the index's column
store or the field's row store; after execution ids in results are
mapped back to keys where the index or field is keyed. Translation
allocates ids on demand, for reads too: a read of a key never seen gets a
fresh id whose row or column is empty, so the answer does not change. It
runs on the host and never touches the card.
"""

from __future__ import annotations

from typing import Any, List

from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.pql.ast import Call, Query


class TranslationError(Exception):
    pass


def translate_call(idx: Index, c: Call) -> None:
    """In-place key -> id translation of one call tree."""
    # column keys: Set(col, ...), Clear(col, ...)
    col = c.args.get("_col")
    if isinstance(col, str):
        if not idx.keys:
            raise TranslationError(f"string column key {col!r} requires index keys=true")
        c.args["_col"] = idx.translate_store.translate_key(col)
    elif col is not None and idx.keys and not isinstance(col, bool):
        raise TranslationError("column value must be a string when index keys are on")

    # row keys via _row + _field (ClearRow/Store/SetRowAttrs forms)
    row = c.args.get("_row")
    if isinstance(row, str):
        fname = c.args.get("_field")
        f = idx.field(fname) if fname else None
        if f is None or not f.options.keys:
            raise TranslationError(f"string row key {row!r} requires field keys=true")
        c.args["_row"] = f.translate_store.translate_key(row)

    # row keys via field-named args: Row(f="key"), Set(c, f="key"), ...
    for k in list(c.args):
        if k.startswith("_") or k in ("from", "to"):
            continue
        v = c.args[k]
        if not isinstance(v, str):
            continue
        f = idx.field(k)
        if f is None:
            continue
        if not f.options.keys:
            raise TranslationError(f"string row key {v!r} requires field {k!r} keys=true")
        c.args[k] = f.translate_store.translate_key(v)

    # GroupBy(previous=[...]): one entry per child Rows call; string
    # entries translate through that child's field row keys
    if c.name == "GroupBy":
        gprev = c.args.get("previous")
        if gprev is not None:
            if not isinstance(gprev, list):
                raise TranslationError(
                    f"'previous' argument must be list, but got {type(gprev).__name__}"
                )
            if len(gprev) != len(c.children):
                raise TranslationError(
                    f"mismatched lengths for previous: {len(gprev)} and "
                    f"children: {len(c.children)}"
                )
            for i, pv in enumerate(gprev):
                child = c.children[i]
                fname = child.string_arg("field") or child.args.get("_field")
                f = idx.field(fname) if fname else None
                if f is not None and f.options.keys:
                    if not isinstance(pv, str):
                        raise TranslationError(
                            "prev value must be a string when field 'keys' option enabled"
                        )
                    gprev[i] = f.translate_store.translate_key(pv)
                elif isinstance(pv, str):
                    raise TranslationError(
                        f"got string row val {pv!r} in 'previous' for field "
                        f"{fname} which doesn't use string keys"
                    )

    # Rows(previous="key") cursor
    prev = c.args.get("previous")
    if isinstance(prev, str) and c.name != "GroupBy":
        fname = c.args.get("field") or c.args.get("_field")
        f = idx.field(fname) if fname else None
        if f is None or not f.options.keys:
            raise TranslationError("Rows(previous=<key>) requires field keys=true")
        c.args["previous"] = f.translate_store.translate_key(prev)

    # Rows(column="key")
    colarg = c.args.get("column")
    if isinstance(colarg, str):
        if not idx.keys:
            raise TranslationError("string column key requires index keys=true")
        c.args["column"] = idx.translate_store.translate_key(colarg)

    # nested calls in args (GroupBy filter=<call>) and children
    for v in c.args.values():
        if isinstance(v, Call):
            translate_call(idx, v)
    for child in c.children:
        translate_call(idx, child)


def translate_query(idx: Index, q: Query) -> None:
    for c in q.calls:
        translate_call(idx, c)


def translate_result(idx: Index, c: Call, result: Any) -> Any:
    """Id -> key translation of one call's result."""
    from pilosa_tpu_torch.exec.executor import GroupCount, Pair

    if isinstance(result, Row):
        if idx.keys:
            keys = idx.translate_store.keys_for_ids(result.columns())
            result.keys = [k or "" for k in keys]
        return result

    if isinstance(result, list) and result and isinstance(result[0], Pair):
        fname = c.args.get("_field") or c.string_arg("field")
        f = idx.field(fname) if fname else None
        if f is not None and f.options.keys:
            for p in result:
                p.key = f.translate_store.key_for_id(p.id)
        return result

    if isinstance(result, list) and result and isinstance(result[0], GroupCount):
        for gc in result:
            for fr in gc.group:
                f = idx.field(fr.field)
                if f is not None and f.options.keys:
                    fr.row_key = f.translate_store.key_for_id(fr.row_id)
        return result

    # Rows() -> list of row ids
    if c.name == "Rows" and isinstance(result, list) and (not result or isinstance(result[0], int)):
        fname = c.string_arg("field") or c.args.get("_field")
        f = idx.field(fname) if fname else None
        if f is not None and f.options.keys:
            return f.translate_store.keys_for_ids(result)
        return result

    return result


def translate_results(idx: Index, q: Query, results: List[Any]) -> List[Any]:
    return [translate_result(idx, c, r) for c, r in zip(q.calls, results)]
