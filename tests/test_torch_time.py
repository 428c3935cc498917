"""Time and bool fields, Store, ClearRow, MinRow and MaxRow in the port,
against pilosa_tpu on the same inputs.

- timeq: the port's copy (pilosa_tpu_torch/core/timeq.py) against the
  reference's for every quantum, random instants (month ends and leap
  days among them) and open bounds.
- ingest: the same Set calls with a timestamp and the same
  import_bits(timestamps=) calls into both packages' holders give the
  same views and the same bits in each.
- executor: Count, Row, Rows, TopN, GroupBy, Store, ClearRow, MinRow
  and MaxRow on set, mutex, bool, time and keyed time fields over 1, 15
  and 20 shards, under a device budget that splits the shard axis, and
  over 64 shards whose hour views are sparse; answers and error texts
  must be identical.
- durable: a data dir with time and bool fields written by either
  package opens in the other with the same views, bits and answers.

The port runs on the CPU here (its kernels' plain twins).
"""

from datetime import datetime, timedelta

import numpy as np
import pytest

from pilosa_tpu.core import timeq as jtimeq
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.core.row import Row as JRow
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec.executor import ExecError as JExecError
from pilosa_tpu.exec.executor import GroupCount as JGroupCount
from pilosa_tpu.exec.executor import Pair as JPair
from pilosa_tpu_torch import ExecError as TExecError
from pilosa_tpu_torch import Executor as TExecutor
from pilosa_tpu_torch import Holder as THolder
from pilosa_tpu_torch.core import timeq as ttimeq
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.row import Row as TRow
from pilosa_tpu_torch.exec.executor import GroupCount as TGroupCount
from pilosa_tpu_torch.exec.executor import Pair as TPair
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.pql import parse as tparse
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

QUANTUMS = sorted(jtimeq.VALID_QUANTUMS)
# hours of the test data: 2024-02-20T00:00 onwards over 12 days, across
# the leap day and the month end
T0 = datetime(2024, 2, 20)
HOURS = 12 * 24


# ---------------------------------------------------------------------------
# timeq
# ---------------------------------------------------------------------------


def random_instants(rng, n):
    """Random instants plus month ends, leap days and year ends."""
    fixed = [
        datetime(2024, 2, 29, 23), datetime(2024, 2, 29), datetime(2023, 2, 28, 5), datetime(2024, 1, 31, 12),
        datetime(2024, 12, 31, 23), datetime(2025, 1, 1), datetime(2020, 2, 29, 1), datetime(2023, 3, 31, 22),
        datetime(2024, 4, 30), datetime(2024, 8, 31, 23, 59),
    ]
    base = datetime(2019, 1, 1)
    rand = [base + timedelta(minutes=int(m)) for m in rng.integers(0, 7 * 365 * 24 * 60, n)]
    return fixed + rand


@pytest.mark.parametrize("quantum", QUANTUMS)
def test_timeq_matches_reference(quantum):
    rng = np.random.default_rng(len(quantum) + 7 * QUANTUMS.index(quantum))
    ttimeq.validate_quantum(quantum)
    instants = random_instants(rng, 40)
    for t in instants:
        assert ttimeq.views_by_time("standard", t, quantum) == jtimeq.views_by_time("standard", t, quantum)
        s = t.strftime(jtimeq.TIME_FORMAT)
        assert ttimeq.parse_time(s) == jtimeq.parse_time(s)
    for _ in range(60):
        a, b = rng.choice(len(instants), 2)
        start = instants[a]
        # short, day-long, month-long and multi-year spans, and the empty one
        end = start + timedelta(hours=int(rng.choice([0, 1, 5, 30, 24 * 40, 24 * 800]))) if rng.random() < 0.5 else instants[b]
        want = jtimeq.views_by_time_range("standard", start, end, quantum)
        assert ttimeq.views_by_time_range("standard", start, end, quantum) == want, (start, end)
    names = [v for t in instants[:15] for v in jtimeq.views_by_time("standard", t, quantum)] + ["standard"]
    assert ttimeq.min_max_view_times(names, quantum) == jtimeq.min_max_view_times(names, quantum)
    assert ttimeq.min_max_view_times(["standard"], quantum) == (None, None)


def test_timeq_parse_and_validate_match_reference():
    for secs in (0, 1, 951782400, 1709251199, 1709251200, 2**31 + 5):
        assert ttimeq.parse_time(secs) == jtimeq.parse_time(secs)
    when = datetime(2024, 2, 29, 3)
    assert ttimeq.parse_time(when) is when
    for bad in ("2024-02-30T00:00", "yesterday", None):
        with pytest.raises(ValueError) as want:
            jtimeq.parse_time(bad)
        with pytest.raises(ValueError) as got:
            ttimeq.parse_time(bad)
        assert str(got.value) == str(want.value)
    for q in ("YX", "HY", "yMD"):
        with pytest.raises(ValueError) as want:
            jtimeq.validate_quantum(q)
        with pytest.raises(ValueError) as got:
            ttimeq.validate_quantum(q)
        assert str(got.value) == str(want.value)


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


def test_time_and_bool_ingest_matches_reference():
    """The same Set(…, ts) and import_bits(timestamps=) calls give the
    same view names and bits; the timestamped import's unit views are
    exactly the reference's."""
    ref_ex, port_ex = both(3)
    want, got = stored(ref_ex.holder), stored(port_ex.holder)
    assert got.keys() == want.keys()
    assert got == want
    views = {k[2] for k in got if k[1] == "t"}
    assert "standard" in views and any(len(v) == len("standard_2024022912") for v in views)
    assert {k[2] for k in got if k[1] == "tn"} == {k[2] for k in want if k[1] == "tn"}
    assert "standard" not in {k[2] for k in got if k[1] == "tn"}
    for name in ("t", "tn", "b"):
        jf, tf = ref_ex.holder.index("i").field(name), port_ex.holder.index("i").field(name)
        assert sorted(tf.views) == sorted(jf.views)
        assert tf.options.time_quantum == jf.options.time_quantum


def test_set_bit_with_timestamp_matches_reference():
    ref, port = JHolder(None).open(), THolder(device="cpu")
    for h, fo in ((ref, JFieldOptions), (port, TFieldOptions)):
        idx = h.create_index("i")
        idx.create_field("t", fo(type="time", time_quantum="MDH"))
        idx.create_field("s", fo())
    for when in (datetime(2024, 2, 29, 23), datetime(2024, 3, 1), datetime(2023, 12, 31, 23, 30)):
        for h in (ref, port):
            assert h.index("i").field("t").set_bit(4, SHARD_WIDTH + 3, when)
    assert stored(port) == stored(ref)
    with pytest.raises(ValueError) as want:
        ref.index("i").field("s").set_bit(1, 1, datetime(2024, 1, 1))
    with pytest.raises(ValueError) as got:
        port.index("i").field("s").set_bit(1, 1, datetime(2024, 1, 1))
    assert str(got.value) == str(want.value)


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


@pytest.fixture(scope="module", params=[1, 15, 20], ids=["1shard", "15shards", "20shards"])
def loaded(request):
    return both(request.param)


@pytest.mark.parametrize("subset", [None, "odd"], ids=["all", "odd"])
def test_time_reads_match_reference(loaded, subset):
    ref_ex, port_ex = loaded
    n = len(ref_ex.holder.index("i").available_shards())
    shards = None if subset is None else list(range(1, n, 2)) or [0]
    for pql in READS:
        run_both(ref_ex, port_ex, pql, shards)
    # the 47-view range of the time phase: a 47-leaf union
    views = ttimeq.views_by_time_range("standard", datetime(2024, 1, 2, 3), datetime(2024, 1, 8, 21), "YMDH")
    assert len(views) == 47


@pytest.mark.parametrize("pql", ERRORS)
def test_time_errors_match_reference(loaded, pql):
    ref_ex, port_ex = loaded
    with pytest.raises((JExecError, ValueError)) as want:
        ref_ex.execute("i", pql)
    with pytest.raises((TExecError, ValueError)) as got:
        port_ex.execute("i", pql)
    assert str(got.value) == str(want.value), pql
    assert isinstance(got.value, TExecError) == isinstance(want.value, JExecError)


def test_keyed_time_field_matches_reference(loaded):
    ref_ex, port_ex = loaded
    for pql in [
        "Count(Row(kt=\"a\", from='2024-02-22T00:00', to='2024-02-28T00:00'))",
        "Row(kt=\"b\", from='2024-02-25T00:00')",
        "Rows(kt, from='2024-02-22T00:00', to='2024-02-28T00:00')",
        "Rows(kt)",
        "GroupBy(Rows(kt, from='2024-02-20T00:00', to='2024-02-26T00:00'), Rows(seg))",
        "TopN(seg, Row(kt=\"c\", from='2024-02-21T00:00', to='2024-03-01T00:00'), n=3)",
        'MaxRow(Row(kt="a"), field=seg) MinRow(field=kt)',
    ]:
        run_both(ref_ex, port_ex, pql, index="k")


@pytest.mark.parametrize("n_shards", [1, 15, 20])
def test_time_writes_match_reference(n_shards):
    ref_ex, port_ex = both(n_shards, seed=5)
    for pql in WRITES:
        run_both(ref_ex, port_ex, pql)
    assert stored(port_ex.holder) == stored(ref_ex.holder)


def test_time_range_under_a_budget_that_splits_the_shards():
    """A tight device budget splits the 20 shards into chunks (and single
    shards); every range, Shift, Store and filtered MinRow/MaxRow (walked
    per chunk) still answers as the reference does. (A filtered TopN over
    16 or more shards whose filter stack exceeds the budget raises
    instead: ROADMAP Queue C.)"""
    ref_ex, port_ex = both(20, seed=9)
    reads = [q for q in READS if not q.startswith("TopN")]
    for budget, n_plans in ((8 << 20, 2), (4 << 20, 20)):
        port_ex.holder.dcache.budget_bytes = budget
        plans = port_ex._lower_plans(port_ex.holder.index("i"), tparse(f"Row(t=0, {R1})").calls[0], list(range(20)))
        for sp in plans:
            sp.release_extents()
        assert len(plans) == n_plans
        for pql in reads + [f"Store(Row(t=0, {R1}), f=50) Count(Row(f=50))"]:
            run_both(ref_ex, port_ex, pql)


def test_sparse_hour_views_match_reference():
    """64 shards whose hour views each hold bits in a few shards: the
    stacked lowering re-lowers over a compacted shard list."""
    ref_ex, port_ex = both(64, seed=11, hour_shards=2)
    for pql in [
        f"Count(Row(t=0, {R2}))",
        "Row(t=1, from='2024-02-29T05:00', to='2024-02-29T09:00')",
        "Count(Shift(Row(t=2, from='2024-03-01T00:00', to='2024-03-01T07:00'), n=1))",
        "Count(Intersect(Row(t=0, from='2024-02-25T00:00', to='2024-02-25T06:00'), Row(f=1)))",
        "TopN(f, Row(t=1, from='2024-02-26T04:00', to='2024-02-26T09:00'), n=3)",
    ]:
        run_both(ref_ex, port_ex, pql)


@pytest.mark.parametrize("k", [2, 9, 10, 20])
def test_sparse_row_result_holds_only_its_rows(k):
    """Row 0 of f holds bits in k of 20 shards while row 1 fills all 20,
    so Row(f=0) lowers over 20 shards. Its answers equal the reference's;
    with fewer than half the rows non-empty its segments share one
    [k, W] copy, else they are rows of the [20, W] result."""
    ref, port = JHolder(None).open(), THolder(device="cpu")
    rng = np.random.default_rng(40 + k)
    cols1 = rng.integers(0, 20 * SHARD_WIDTH, 4000).astype(np.uint64)
    cols0 = (rng.integers(0, SHARD_WIDTH, 300) + SHARD_WIDTH * rng.integers(0, k, 300)).astype(np.uint64)
    for h, fo in ((ref, JFieldOptions), (port, TFieldOptions)):
        idx = h.create_index("i")
        f = idx.create_field("f", fo())
        f.import_bits(np.r_[np.zeros(len(cols0)), np.ones(len(cols1))].astype(np.uint64), np.r_[cols0, cols1])
        idx.track_columns(np.r_[cols0, cols1])
    ref_ex, port_ex = JExecutor(ref), TExecutor(port)
    for pql in ["Row(f=0)", "Intersect(Row(f=0), Row(f=1))", "Count(Row(f=0))"]:
        run_both(ref_ex, port_ex, pql)
    (row,) = port_ex.execute("i", "Row(f=0)")
    assert len(row.segments) == k
    rows_held = k if 2 * k < 20 else 20
    for seg in row.segments.values():
        assert seg.untyped_storage().nbytes() == rows_held * seg.numel() * 4


def test_store_and_clear_row_drop_only_the_views_they_touch():
    """Stacks of the views a Store or ClearRow writes are dropped from the
    device cache; another field's stacks stay resident."""
    _, port_ex = both(3, seed=13)
    idx = port_ex.holder.index("i")
    port_ex.execute("i", f"Count(Row(t=1, {R1})) Count(Row(g=1)) Count(Row(f=2))")
    owners = lambda f: {k for k in idx.dcache._entries if k[0] == f.view("standard")._stack_token}
    g_before = owners(idx.field("g"))
    assert g_before
    before = port_ex.execute("i", f"Count(Row(t=1, {R1}))")
    port_ex.execute("i", "ClearRow(t=1)")
    assert port_ex.execute("i", f"Count(Row(t=1, {R1}))") == [0] != before
    port_ex.execute("i", "Store(Row(g=1), f=2)")
    assert port_ex.execute("i", "Count(Row(f=2))") == port_ex.execute("i", "Count(Row(g=1))")
    assert owners(idx.field("g")) >= g_before


# ---------------------------------------------------------------------------
# durable: both directions
# ---------------------------------------------------------------------------


def durable_ingest(holder, executor, fo):
    idx = holder.create_index("i")
    t = idx.create_field("t", fo(type="time", time_quantum="YMDH"))
    idx.create_field("b", fo(type="bool"))
    idx.create_field("f", fo())
    rng = np.random.default_rng(17)
    cols = rng.integers(0, 3 * SHARD_WIDTH, 2000).astype(np.uint64)
    ts = [T0 + timedelta(hours=int(h)) for h in rng.integers(0, 72, len(cols))]
    t.import_bits(rng.integers(0, 2, len(cols)).astype(np.uint64), cols, timestamps=ts)
    idx.track_columns(cols)
    executor.execute("i", "Set(3, b=true) Set(4, b=false) Set(9, t=3, 2024-02-21T05:00) Set(12, f=1)")


DURABLE_READS = [
    "Count(Row(t=0, from='2024-02-20T05:00', to='2024-02-22T01:00'))",
    "Row(t=1, from='2024-02-21T00:00')",
    "Rows(t, from='2024-02-21T00:00', to='2024-02-21T06:00')",
    "Count(Row(b=true)) Count(Row(b=false))",
    "MaxRow(field=t)",
]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_time_views_cross_open(tmp_path, writer):
    """A data dir with time and bool fields written by one package opens
    in the other: the same views, bits and answers."""
    d = str(tmp_path / "data")
    if writer == "reference":
        h = JHolder(d).open()
        durable_ingest(h, JExecutor(h), JFieldOptions)
    else:
        h = THolder(d, device="cpu").open()
        durable_ingest(h, TExecutor(h), TFieldOptions)
    want_bits = stored(h)
    want = [norm(r) for q in DURABLE_READS for r in (JExecutor(h) if writer == "reference" else TExecutor(h)).execute("i", q)]
    h.close()
    other = THolder(d, device="cpu").open() if writer == "reference" else JHolder(d).open()
    ex = TExecutor(other) if writer == "reference" else JExecutor(other)
    assert stored(other) == want_bits
    assert [norm(r) for q in DURABLE_READS for r in ex.execute("i", q)] == want
    assert sorted(other.index("i").field("t").views) == sorted({k[2] for k in want_bits if k[1] == "t"})
    other.close()


# ---------------------------------------------------------------------------
# the card's path never runs the twin
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_row_results_never_run_the_twin(monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")

    def refuse(*a, **k):
        raise AssertionError("plan_rows_plain ran on the card's path")

    monkeypatch.setattr(kernels, "plan_rows_plain", refuse)
    h = THolder(device="cuda")
    ex = TExecutor(h)
    idx = h.create_index("i")
    t = idx.create_field("t", TFieldOptions(type="time", time_quantum="YMDH"))
    t.import_bits(np.array([0, 0, 1], np.uint64), np.array([1, SHARD_WIDTH + 2, 5], np.uint64),
                  timestamps=[T0, T0 + timedelta(hours=30), T0])
    before = kernels.LAUNCHES["plan_rows"]
    got = ex.execute("i", f"Row(t=0, {R1}) Count(Shift(Row(t=0), n=1)) Shift(Row(t=0, {R1}), n=33)")
    assert [list(got[0].columns()), got[1]] == [[SHARD_WIDTH + 2], 2]
    assert kernels.LAUNCHES["plan_rows"] - before >= 3


# ---------------------------------------------------------------------------
# the CLI's import with a timestamp column
# ---------------------------------------------------------------------------


def test_cli_import_with_timestamps_matches_reference(tmp_path, capsys):
    """`import` of "row,col,timestamp" lines (some without a timestamp)
    into a time field prints what the reference CLI prints, and both
    servers then give the same time-range answers."""
    import json
    import urllib.request

    from pilosa_tpu.cli.main import main as jmain
    from pilosa_tpu.server.node import NodeServer as JNodeServer
    from pilosa_tpu_torch.cli.main import main as tmain
    from pilosa_tpu_torch.server import NodeServer as TNodeServer

    csv = tmp_path / "bits.csv"
    lines = ["# row,col,timestamp"]
    rng = np.random.default_rng(19)
    for k in range(300):
        when = (T0 + timedelta(hours=int(rng.integers(0, 60)))).strftime("%Y-%m-%dT%H:%M")
        lines.append(f"{k % 3},{int(rng.integers(0, 3 * SHARD_WIDTH))}" + ("" if k % 11 == 0 else f",{when}"))
    csv.write_text("\n".join(lines) + "\n")
    queries = (
        b"Count(Row(t=0, from='2024-02-20T05:00', to='2024-02-21T19:00')) Rows(t, from='2024-02-22T00:00') "
        b"Row(t=2, from='2024-02-21T00:00', to='2024-02-21T12:00') Count(Row(t=1))"
    )
    outs = []
    for main, server in ((jmain, JNodeServer(None, "n0", bind="localhost:0")), (tmain, TNodeServer(None, "n0", bind="localhost:0", device="cpu"))):
        server.start()
        try:
            for path, body in (("/index/i", {}), ("/index/i/field/t", {"options": {"type": "time", "timeQuantum": "YMDH"}})):
                urllib.request.urlopen(urllib.request.Request(server.node.uri + path, data=json.dumps(body).encode(), method="POST"))
            capsys.readouterr()
            rc = main(["import", "--host", server.node.uri, "-i", "i", "-f", "t", "--batch-size", "64", str(csv)])
            err = capsys.readouterr().err
            req = urllib.request.Request(server.node.uri + "/index/i/query", data=queries, method="POST")
            with urllib.request.urlopen(req) as r:
                outs.append((rc, err, json.loads(r.read())))
        finally:
            server.stop()
    assert outs[1] == outs[0] and outs[0][0] == 0 and "imported 300 records" in outs[0][1]
    assert outs[0][2]["results"][0] > 0
