"""The port's key translation against pilosa_tpu's.

- TranslateStore: the same key sequence gives the same ids and a
  byte-identical `.keys.translate` log in both packages; a torn tail is
  dropped and cut the same way; a reopened store keeps its ids.
- Keyed queries: seeded random workloads of keyed writes and reads (Set,
  Clear, Row, Count, TopN, Rows, GroupBy, Sum, with row and column keys,
  `previous` cursors in both forms) run through both executors with the
  same results, keys included (exact); keyed error cases (string keys on
  unkeyed fields and indexes, integer columns on keyed indexes, the
  shapes of `previous`) raise the same error type with the same message.
- compat carries a keyed holder's translate entries: the port holder
  loaded from it answers with the same keys and ids.
"""

import os

import numpy as np
import pytest

from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.core.translate import TranslateStore as JStore
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu_torch import Executor as TExecutor
from pilosa_tpu_torch import Holder as THolder
from pilosa_tpu_torch.compat import holder_from_numpy
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.translate import TranslateStore as TStore

# ---------------------------------------------------------------------------
# TranslateStore
# ---------------------------------------------------------------------------


def _key_batches(seed: int = 0):
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(20):
        n = int(rng.integers(1, 40))
        # repeats, within a batch and across batches, and non-ASCII keys
        batches.append([f"k{int(x)}" if x % 7 else f"ü-{int(x)}-ключ" for x in rng.integers(0, 300, n)])
    return batches


def test_store_ids_and_log_match_reference(tmp_path):
    jp, tp = str(tmp_path / "ref" / ".keys.translate"), str(tmp_path / "port" / ".keys.translate")
    js, ts = JStore(jp).open(), TStore(tp).open()
    for batch in _key_batches():
        assert ts.translate_keys(batch) == js.translate_keys(batch)
        k = batch[0]
        assert ts.translate_key(k) == js.translate_key(k)
    assert "nope" not in ts._by_key and js.find_key("nope") is None
    assert ts._next_id - 1 == js.max_id() and len(ts._by_key) == len(js)
    ids = list(range(0, js.max_id() + 3))
    assert ts.keys_for_ids(ids) == js.keys_for_ids(ids)
    assert [ts.key_for_id(i) for i in ids] == [js.key_for_id(i) for i in ids]
    js.close()
    ts.close()
    assert open(tp, "rb").read() == open(jp, "rb").read()
    # each package reopens its own log and the other's with the same ids
    for store_cls in (JStore, TStore):
        for path in (jp, tp):
            s = store_cls(path).open()
            assert s.keys_for_ids(ids) == ts.keys_for_ids(ids)
            assert s.translate_key("new-key") == ts._next_id
            s.close()
            with open(path, "r+b") as f:  # undo the append for the next reader
                f.truncate(os.path.getsize(path) - (12 + len("new-key")))


@pytest.mark.parametrize("cut", [1, 5, 11, 12, 13, 19])
def test_store_torn_tail_matches_reference(tmp_path, cut):
    """A log cut `cut` bytes into its last record (12-byte header + key):
    both packages drop that record, cut the file back to the last whole
    one and append after it identically."""
    src = tmp_path / "src"
    s = JStore(str(src)).open()
    s.translate_keys(["alpha", "beta", "gamma-ray"])
    s.close()
    data = src.read_bytes()
    last = 12 + len("gamma-ray")
    torn = data[: len(data) - last + cut]
    out = {}
    for name, cls in (("ref", JStore), ("port", TStore)):
        p = tmp_path / name
        p.write_bytes(torn)
        st = cls(str(p)).open()
        out[name] = (st.keys_for_ids([1, 2, 3, 4]), st.translate_keys(["delta", "alpha"]))
        st.close()
        out[name] += (p.read_bytes(),)
    assert out["port"] == out["ref"]
    assert out["port"][0] == ["alpha", "beta", None, None]


def test_store_in_memory_and_apply_entries():
    s = TStore().open()
    assert s.translate_keys(["a", "b", "a"]) == [1, 2, 1]
    s.apply_entries([(7, "z"), (2, "b")])
    assert s.keys_for_ids([1, 2, 3, 7]) == ["a", "b", None, "z"]
    assert s.translate_key("c") == 8
    with pytest.raises(Exception, match="id 7"):
        s.apply_entries([(7, "y")])


# ---------------------------------------------------------------------------
# keyed queries through both executors
# ---------------------------------------------------------------------------

SEGMENTS = [f"seg-{i:02d}" for i in range(6)]
COUNTRIES = ["US", "DE", "JP", "FR"]


def make_holders():
    holders = []
    for holder, fo in ((JHolder(None).open(), JFieldOptions), (THolder(device="cpu"), TFieldOptions)):
        k = holder.create_index("k", keys=True)
        k.create_field("segment", fo(keys=True))
        k.create_field("country", fo(type="mutex", keys=True))
        k.create_field("plan")
        k.create_field("spend", fo(type="int", min=0, max=1000))
        u = holder.create_index("u")
        u.create_field("f")
        u.create_field("kf", fo(keys=True))
        holders.append(holder)
    return holders


def keyed_writes(seed: int) -> list:
    """PQL writes for 400 column keys in a seeded random arrival order (so
    ids do not follow key order), each in one or two Zipf segments, one
    country, one plan and one spend value."""
    rng = np.random.default_rng(seed)
    users = [f"u{int(x):06d}" for x in rng.permutation(400)]
    pql = []
    for k, user in enumerate(users):
        calls = [f'Set("{user}", segment="{SEGMENTS[int(rng.zipf(1.6)) % len(SEGMENTS)]}")']
        if rng.random() < 0.5:
            calls.append(f'Set("{user}", segment="{SEGMENTS[int(rng.integers(len(SEGMENTS)))]}")')
        calls.append(f'Set("{user}", country="{COUNTRIES[int(rng.zipf(1.4)) % len(COUNTRIES)]}")')
        calls.append(f'Set("{user}", plan={int(rng.integers(0, 3))})')
        calls.append(f'Set("{user}", spend={int(rng.integers(0, 1001))})')
        if k % 17 == 0:
            calls.append(f'Clear("{user}", segment="{SEGMENTS[0]}")')
        pql.append(" ".join(calls))
    return pql


def keyed_reads(rng) -> list:
    seg = lambda: SEGMENTS[int(rng.integers(len(SEGMENTS)))]  # noqa: E731
    ctry = lambda: COUNTRIES[int(rng.integers(len(COUNTRIES)))]  # noqa: E731
    return [
        f'Count(Row(segment="{seg()}"))',
        f'Count(Intersect(Row(segment="{seg()}"), Row(country="{ctry()}")))',
        f'Row(country="{ctry()}")',
        f'Row(segment="{seg()}")',
        "TopN(segment, n=3)",
        f'TopN(segment, Row(country="{ctry()}"), n=4)',
        "TopN(country)",
        "Rows(segment)",
        "Rows(country)",
        f'Rows(country, previous="{ctry()}", limit=2)',
        f'Rows(segment, column="u{int(rng.integers(400)):06d}")',
        "Rows(plan)",
        "GroupBy(Rows(segment), Rows(country))",
        f'GroupBy(Rows(segment), Rows(country), Rows(plan), filter=Row(plan={int(rng.integers(3))}), limit=7)',
        f'GroupBy(Rows(segment), Rows(country), previous=["{seg()}", "{ctry()}"], limit=5)',
        f'GroupBy(Rows(segment, previous="{seg()}"), Rows(plan))',
        "GroupBy(Rows(plan), Rows(country), offset=2)",
        f'Sum(Row(segment="{seg()}"), field=spend)',
        'Count(Row(segment="never-seen"))',
        'Count(Not(Row(country="US")))',
    ]


def norm(r):
    if hasattr(r, "columns"):
        return ("row", [int(c) for c in r.columns()], r.keys)
    if isinstance(r, list):
        if r and hasattr(r[0], "group"):
            return [([(fr.field, fr.row_id, fr.row_key) for fr in g.group], g.count) for g in r]
        if r and hasattr(r[0], "key"):
            return [(p.id, p.count, p.key) for p in r]
        return list(r)
    if hasattr(r, "value"):
        return ("valcount", r.value, r.count)
    return r


def run_both(exs, index, pql):
    want, got = ([norm(r) for r in ex.execute(index, pql)] for ex in exs)
    assert got == want, pql
    return got


@pytest.mark.parametrize("seed", [0, 1])
def test_keyed_workload_matches_reference(seed):
    holders = make_holders()
    exs = [JExecutor(holders[0]), TExecutor(holders[1])]
    writes = keyed_writes(seed)
    rng = np.random.default_rng(100 + seed)
    keyed_rows = 0
    for k, pql in enumerate(writes):
        run_both(exs, "k", pql)
        if k % 100 == 99:
            for q in keyed_reads(rng):
                got = run_both(exs, "k", q)
                keyed_rows += bool(got and isinstance(got[0], tuple) and got[0][2])
    assert keyed_rows > 0
    # the id spaces agree key for key
    for name in ("segment", "country"):
        stores = [h.index("k").field(name).translate_store for h in holders]
        ids = list(range(stores[0].max_id() + 2))
        assert stores[1].keys_for_ids(ids) == stores[0].keys_for_ids(ids)
    stores = [h.index("k").translate_store for h in holders]
    ids = list(range(stores[0].max_id() + 2))
    assert stores[1].keys_for_ids(ids) == stores[0].keys_for_ids(ids)


KEY_ERRORS = [
    ("k", 'Set(5, segment="seg-00")'),
    ("k", "Set(5, plan=1)"),
    ("k", 'Row(plan="x")'),
    ("k", 'Rows(plan, previous="x")'),
    ("k", 'GroupBy(Rows(segment), previous="seg-00")'),
    ("k", 'GroupBy(Rows(segment), Rows(plan), previous=["seg-00"])'),
    ("k", "GroupBy(Rows(segment), previous=[1])"),
    ("k", 'GroupBy(Rows(plan), previous=["x"])'),
    ("u", 'Set("a", f=1)'),
    ("u", 'Row(f="a")'),
    ("u", 'Set(1, f="a")'),
    ("u", 'Rows(f, column="a")'),
    ("u", 'Rows(f, previous="a")'),
    ("u", 'Count(Row(kf="a")) Count(Row(f="b"))'),
    ("k", "Count(Row(nope=1))"),
]


@pytest.mark.parametrize("index,pql", KEY_ERRORS)
def test_key_errors_match_reference(index, pql):
    holders = make_holders()
    errs = []
    for ex in (JExecutor(holders[0]), TExecutor(holders[1])):
        with pytest.raises(Exception) as ei:
            ex.execute(index, pql)
        errs.append((type(ei.value).__name__, str(ei.value)))
    assert errs[1] == errs[0]


def test_unkeyed_index_takes_keyed_field():
    """A keyed field on an unkeyed index: row keys in, keys out in TopN,
    Rows and GroupBy; columns stay integers."""
    holders = make_holders()
    exs = [JExecutor(holders[0]), TExecutor(holders[1])]
    run_both(exs, "u", 'Set(3, kf="x") Set(4, kf="y") Set(4, kf="x") Set(3, f=1) Set(5, f=2)')
    for q in ('Row(kf="x")', "TopN(kf)", "Rows(kf)", "GroupBy(Rows(kf), Rows(f))", 'Rows(kf, previous="x")'):
        run_both(exs, "u", q)


def test_compat_carries_translate_entries():
    ref = make_holders()[0]
    jex = JExecutor(ref)
    for pql in keyed_writes(3)[:150]:
        jex.execute("k", pql)
    state = {}
    for idx in ref.indexes():
        fields = {}
        for f in idx.fields(include_hidden=True):
            views = {}
            for vname, v in f.views.items():
                views[vname] = {
                    shard: {rid: ("sparse", frag._rows[rid].to_positions().copy()) for rid in frag.row_ids()}
                    for shard, frag in v.fragments.items()
                }
            o = f.options
            spec = {"type": o.type, "cache_type": o.cache_type, "cache_size": o.cache_size, "views": views}
            if o.type == "int":
                spec.update(min=o.min, max=o.max, base=o.base, bit_depth=o.bit_depth)
            if o.keys:
                items = sorted(f.translate_store._by_id.items())
                spec.update(keys=True, translate=(np.array([i for i, _ in items], np.uint64), [k for _, k in items]))
            fields[f.name] = spec
        ispec = {"track_existence": idx.track_existence, "fields": fields}
        if idx.keys:
            items = sorted(idx.translate_store._by_id.items())
            ispec.update(keys=True, translate=(np.array([i for i, _ in items], np.uint64), [k for _, k in items]))
        state[idx.name] = ispec
    port = holder_from_numpy(state, device="cpu")
    exs = [jex, TExecutor(port)]
    rng = np.random.default_rng(9)
    for q in keyed_reads(rng):
        run_both(exs, "k", q)
    for name in ("segment", "country"):
        stores = [h.index("k").field(name).translate_store for h in (ref, port)]
        assert stores[1].keys_for_ids(range(60)) == stores[0].keys_for_ids(range(60))
    # a key new to both gets the same next id in both
    run_both(exs, "k", 'Set("fresh", segment="seg-new") Row(segment="seg-new")')


def test_keyed_ids_are_arrival_order():
    """Column ids follow the order keys arrive, not their sort order: the
    shard of a column key is fixed by its first write."""
    h = THolder(device="cpu")
    h.create_index("k", keys=True).create_field("f")
    ex = TExecutor(h)
    ex.execute("k", 'Set("zz", f=1) Set("aa", f=1)')
    row = ex.execute("k", "Row(f=1)")[0]
    assert row.columns().tolist() == [1, 2] and row.keys == ["zz", "aa"]
    assert h.index("k").translate_store._by_key["aa"] == 2
