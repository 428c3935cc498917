"""Shared data and helpers of the time-field differential tests
(tests/test_torch_time*.py): the same ingest through pilosa_tpu and the
port, the read, write and error query sets, and the comparison of both
executors' answers. A plain module, not a test file: pytest collects
nothing here.
"""

from datetime import datetime, timedelta

import numpy as np

from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.core.row import Row as JRow
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec.executor import GroupCount as JGroupCount
from pilosa_tpu.exec.executor import Pair as JPair
from pilosa_tpu_torch import Executor as TExecutor
from pilosa_tpu_torch import Holder as THolder
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.row import Row as TRow
from pilosa_tpu_torch.exec.executor import GroupCount as TGroupCount
from pilosa_tpu_torch.exec.executor import Pair as TPair
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

# hours of the test data: 2024-02-20T00:00 onwards over 12 days, across
# the leap day and the month end
T0 = datetime(2024, 2, 20)
HOURS = 12 * 24


# ---------------------------------------------------------------------------
# the same ingest through both packages
# ---------------------------------------------------------------------------


def ingest(holder, executor, fo, n_shards: int, seed: int, hour_shards=None) -> None:
    """Time field `t` (YMDH, rows 0-2), time field `tn` (YMD, no standard
    view), set fields `f` and `g`, mutex `m`, bool `b`, int `v`, through
    import_bits with and without timestamps, Set() with a timestamp and
    bool Sets; a keyed index `k` with a keyed time field. `hour_shards`
    limits each hour's bits to that many shards (sparse hour views)."""
    rng = np.random.default_rng(seed)
    idx = holder.create_index("i")
    t = idx.create_field("t", fo(type="time", time_quantum="YMDH"))
    tn = idx.create_field("tn", fo(type="time", time_quantum="YMD", no_standard_view=True))
    f = idx.create_field("f")
    g = idx.create_field("g")
    m = idx.create_field("m", fo(type="mutex"))
    b = idx.create_field("b", fo(type="bool"))
    idx.create_field("v", fo(type="int", min=0, max=100))
    width = n_shards * SHARD_WIDTH
    all_cols = []
    for r in range(3):
        n = 4000
        hours = rng.integers(0, HOURS, n)
        if hour_shards is None:
            cols = rng.integers(0, width, n)
        else:  # each hour's bits in a few shards
            home = (hours * 7919) % n_shards
            cols = (home + rng.integers(0, hour_shards, n)) % n_shards * SHARD_WIDTH + rng.integers(0, SHARD_WIDTH, n)
        cols = cols.astype(np.uint64)
        ts = [T0 + timedelta(hours=int(h), minutes=int(mi)) for h, mi in zip(hours, rng.integers(0, 60, n))]
        ts[::17] = [None] * len(ts[::17])  # bits without a timestamp: the standard view only
        t.import_bits(np.full(n, r, np.uint64), cols, timestamps=ts)
        tn.import_bits(np.full(n, r, np.uint64), cols[::2], timestamps=ts[::2])
        all_cols.append(cols)
    t.import_bits(np.full(50, 1, np.uint64), all_cols[1][:50], timestamps=[T0] * 50, clear=True)
    for r in range(4):
        cols = rng.integers(0, width, 3000).astype(np.uint64)
        f.import_bits(np.full(len(cols), r, np.uint64), cols)
        all_cols.append(cols)
    cols = rng.integers(0, width, 3000).astype(np.uint64)
    g.import_bits(rng.integers(0, 3, len(cols)).astype(np.uint64), cols)
    m.import_bits(rng.integers(0, 4, len(cols)).astype(np.uint64), cols)
    b.import_bits((rng.random(len(cols)) < 0.5).astype(np.uint64), cols)
    all_cols.append(cols)
    idx.track_columns(np.concatenate(all_cols))
    q = []
    for k, c in enumerate(rng.integers(0, width, 12)):
        when = (T0 + timedelta(hours=int(rng.integers(0, HOURS)))).strftime("%Y-%m-%dT%H:%M")
        q.append(f"Set({c}, t={k % 3}, {when})")
        q.append(f"Set({c}, b={'true' if k % 2 else 'false'})")
    q.append(f"Set({int(all_cols[0][0])}, v=42)")
    executor.execute("i", " ".join(q))
    k = holder.create_index("k", keys=True)
    k.create_field("kt", fo(type="time", time_quantum="YMD", keys=True))
    k.create_field("seg", fo(keys=True))
    q = []
    for j in range(60):
        when = (T0 + timedelta(hours=int(rng.integers(0, HOURS)))).strftime("%Y-%m-%dT%H:%M")
        q.append(f'Set("u{j}", kt="{["a", "b", "c"][j % 3]}", {when}) Set("u{j}", seg="s{j % 4}")')
    executor.execute("k", " ".join(q))


def both(n_shards: int, seed: int = 3, hour_shards=None):
    ref, port = JHolder(None).open(), THolder(device="cpu")
    ref_ex, port_ex = JExecutor(ref), TExecutor(port)
    ingest(ref, ref_ex, JFieldOptions, n_shards, seed, hour_shards)
    ingest(port, port_ex, TFieldOptions, n_shards, seed, hour_shards)
    return ref_ex, port_ex


def stored(holder) -> dict:
    """{(index, field, view, shard, row): positions} of a holder."""
    out = {}
    for idx in holder.indexes():
        for f in idx.fields(include_hidden=True):
            for vname, v in f.views.items():
                for shard, frag in v.fragments.items():
                    for r in frag.row_ids():
                        pos = np.asarray(frag.row_positions(r)).astype(np.uint64)
                        if len(pos):
                            out[(idx.name, f.name, vname, shard, r)] = pos.tolist()
    return out


# ---------------------------------------------------------------------------
# executor differentials
# ---------------------------------------------------------------------------

R1 = "from='2024-02-21T03:00', to='2024-02-29T21:00'"
R2 = "from='2024-02-28T13:00', to='2024-03-02T02:00'"
READS = [
    f"Count(Row(t=0, {R1}))",
    f"Row(t=0, {R1})",
    f"Count(Intersect(Row(t=0, {R1}), Row(f=0)))",
    "Row(t=0, from='2024-02-27T00:00')",
    "Count(Row(t=2, to='2024-02-23T05:00'))",
    "Count(Row(t=1, from='2024-01-01T00:00', to='2025-01-01T00:00'))",
    "Count(Row(t=1, from='2024-03-05T00:00', to='2024-02-01T00:00'))",
    f"Count(Row(t=7, {R1}))",
    "Count(Row(t=0))",
    f"Count(Row(tn=1, {R2}))",
    "Row(tn=2, from='2024-02-29T00:00')",
    "Count(Row(tn=0))",
    f"Count(Shift(Row(t=1, {R1}), n=1))",
    f"Shift(Row(t=1, {R1}), n=33)",
    f"Count(Shift(Union(Row(t=1, {R2}), Row(f=2)), n={SHARD_WIDTH - 1}))",
    f"Xor(Shift(Row(t=0, {R2}), n=32), Row(f=1))",
    f"Count(Difference(Row(t=2, {R1}), Row(t=2, {R2}), Row(g=1)))",
    f"Count(Row(t=0, {R1})) Count(Row(t=1, {R2})) Count(Shift(Row(t=2, {R1}), n=5))",
    f"TopN(f, Row(t=1, {R1}), n=5)",
    f"TopN(g, Row(t=0, {R2}))",
    f"Rows(t, {R1})",
    "Rows(t, from='2024-02-29T00:00')",
    "Rows(t)",
    "Rows(tn)",
    f"Rows(t, {R2}, previous=0, limit=1)",
    f"Rows(t, {R1}, column={SHARD_WIDTH - 1})",
    f"GroupBy(Rows(t, {R1}), Rows(g))",
    f"GroupBy(Rows(t, {R2}), Rows(m), filter=Row(f=0))",
    "GroupBy(Rows(tn), Rows(g))",
    "MinRow(field=f)",
    "MaxRow(field=f)",
    f"MinRow(Row(t=1, {R1}), field=f)",
    "MaxRow(Row(g=2), field=m)",
    f"MaxRow(Row(t=0, {R1}), field=t)",
    "MinRow(Row(f=99), field=f)",
    "MaxRow(field=v)",
    "MinRow(field=t)",
    "Count(Row(b=true))",
    "Count(Row(b=false))",
    "Row(b=1)",
    "Count(Intersect(Row(b=true), Row(m=1)))",
    "TopN(b)",
    "Rows(b)",
    "GroupBy(Rows(b), Rows(m))",
]
WRITES = [
    # Store, then the stored row; Store again over a smaller bitmap
    f"Store(Row(t=0, {R1}), f=100)",
    "Count(Row(f=100))",
    f"Store(Intersect(Row(t=0, {R1}), Row(g=0)), f=100) Count(Row(f=100))",
    "Store(Row(f=99), f=100) Count(Row(f=100))",
    f"Store(Shift(Row(t=2, {R2}), n=3), f=101) Row(f=101)",
    # ClearRow across every view of a time field, then the ranges
    "ClearRow(t=1)",
    f"Count(Row(t=1, {R1})) Count(Row(t=1)) Count(Row(t=0, {R1}))",
    "ClearRow(t=1)",
    "ClearRow(tn=2) Count(Row(tn=2, from='2024-02-01T00:00', to='2024-04-01T00:00'))",
    "ClearRow(m=2) Count(Row(m=2)) ClearRow(b=true) Count(Row(b=true)) Count(Row(b=false))",
    "ClearRow(f=0) Count(Row(f=0))",
    # bool mutex: a column moves between true and false
    "Set(5, b=true) Count(Row(b=true)) Set(5, b=false) Count(Row(b=true)) Count(Row(b=false))",
    "Clear(5, b=false) Count(Row(b=false))",
    # a timestamped Set lands in the standard view and its unit views
    "Set(77, t=5, 2024-02-29T23:00) Count(Row(t=5, from='2024-02-29T23:00', to='2024-03-01T00:00'))",
    "Count(Row(t=5, from='2024-03-01T00:00')) Count(Row(t=5))",
    "Rows(t, from='2024-02-29T00:00', to='2024-03-01T00:00')",
    "MaxRow(field=t) MinRow(Row(t=5), field=f)",
]
ERRORS = [
    "Row(f=1, from='2024-01-01T00:00', to='2024-02-01T00:00')",
    "Row(m=1, to='2024-02-01T00:00')",
    "Row(b=2)",
    "Row(f=true)",
    "Set(1, b=1)",
    "Set(1, f=1, 2024-01-01T00:00)",
    "Store(Row(f=1), m=1)",
    "Store(Row(f=1), t=1)",
    "Store(Row(f=1), Row(f=2), f=3)",
    "Store(Row(f=1))",
    "ClearRow(v=1)",
    "Row(t=0, from='2024-02-30T00:00', to='2024-03-01T00:00')",
    f"Shift(Row(t=0, {R1}), n={32 * SHARD_WIDTH + 1})",
]


def norm(result):
    if isinstance(result, (JRow, TRow)):
        return ("row", [int(c) for c in result.columns()])
    if isinstance(result, list) and result and isinstance(result[0], (JPair, TPair)):
        return [(p.id, p.count, p.key) for p in result]
    if isinstance(result, list) and result and isinstance(result[0], (JGroupCount, TGroupCount)):
        return [([(r.field, r.row_id, r.row_key) for r in g.group], g.count) for g in result]
    return result


def run_both(ref_ex, port_ex, pql, shards=None, index="i"):
    want = [norm(r) for r in ref_ex.execute(index, pql, shards=shards)]
    got = [norm(r) for r in port_ex.execute(index, pql, shards=shards)]
    assert got == want, f"{pql} shards={shards}"
    return got
