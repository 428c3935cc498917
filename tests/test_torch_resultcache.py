"""The port's versioned result cache (pilosa_tpu_torch/core/resultcache.py)
and the executor's cache surface against pilosa_tpu's.

One seeded sequence of reads (Counts over plain Rows, Intersect/Union
trees within one view and across views, Not, a BSI condition, mutex and
bool rows, a run of adjacent Counts, TopN with and without a filter,
GroupBy, and ineligible shapes) and writes (PQL Set and Clear, staged
/import bursts to watched and unwatched rows, an exact import-roaring,
Store, ClearRow, a bool flip, a timestamped Set and a mutex write) runs
through the reference executor and the port's (on the CPU), each with
its process-global result cache on (64 MB, count repair on). After every
step the answers must be identical and the two caches' counters (hits,
misses, revalidations, repairs, tree repairs, re-keys, stores,
evictions) equal: the port revalidates, repairs, re-keys and recomputes
exactly where the reference does. Every burst stays below the merge
barrier's device threshold, so the reference merges on the host
(merge_keys_host). Unit checks of the store follow: LRU budget, tenant
quotas, drop_index, interest rows and the barrier's old-word capture.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import numpy as np
import pytest

from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.core.resultcache import RESULT_CACHE as JRC
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu_torch.core import merge as tmerge
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.core.resultcache import RESULT_CACHE as TRC
from pilosa_tpu_torch.core.resultcache import ResultCache
from pilosa_tpu_torch.exec import plan as tplan
from pilosa_tpu_torch.exec.executor import Executor as TExecutor
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

N_SHARDS = 3
COUNTERS = ("hits", "misses", "revalidations", "repairs", "tree_repairs", "rekeys", "stores", "evictions")

READS = [
    "Count(Row(f=1))",
    "Count(Row(f=2))",
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Union(Row(f=1), Row(f=3), Row(f=4)))",
    "Count(Intersect(Row(f=1), Row(g=0)))",
    "Count(Union(Row(g=1), Row(f=2)))",
    "Count(Difference(Row(f=1), Row(f=2)))",
    "Count(Not(Row(f=1)))",
    "Count(Row(v > 50))",
    "Count(Row(m=2))",
    "Count(Row(b=true))",
    "Count(Row(f=1)) Count(Row(f=2)) Count(Intersect(Row(f=1), Row(g=0)))",
    "TopN(f, n=3)",
    "TopN(f, Row(g=0), n=3)",
    "GroupBy(Rows(f), Rows(g))",
    "Count(Row(t=1, from='2024-01-01T00:00', to='2024-02-01T00:00'))",
    "TopN(f, n=2, attrName=color, attrValues=[\"red\"])",
]


def canon(r):
    """A result in a form both packages share."""
    if isinstance(r, list):
        return [canon(x) for x in r]
    if hasattr(r, "group"):  # GroupCount
        return ([(fr.field, fr.row_id) for fr in r.group], r.count)
    if hasattr(r, "id") and hasattr(r, "count") and not hasattr(r, "columns"):  # Pair
        return (r.id, r.count)
    return r


class Pair2:
    """Both holders and executors, written identically."""

    def __init__(self):
        rng = np.random.default_rng(1200)
        self.j = JHolder().open()
        self.t = THolder(device="cpu").open()
        for h, FO in ((self.j, JFieldOptions), (self.t, TFieldOptions)):
            idx = h.create_index("i")
            idx.create_field("f")
            idx.create_field("g")
            idx.create_field("v", FO(type="int", min=0, max=1000))
            idx.create_field("m", FO(type="mutex"))
            idx.create_field("b", FO(type="bool"))
            idx.create_field("t", FO(type="time", time_quantum="YMD"))
        self.jex, self.tex = JExecutor(self.j), TExecutor(self.t)
        for row in range(5):
            self.bits("f", row, rng.integers(0, N_SHARDS * SHARD_WIDTH, 400 * (row + 1)))
        for row in range(2):
            self.bits("g", row, rng.integers(0, N_SHARDS * SHARD_WIDTH, 700))
        cols = rng.choice(N_SHARDS * SHARD_WIDTH, 300, replace=False).astype(np.uint64)
        vals = rng.integers(0, 100, len(cols))
        for h in (self.j, self.t):
            h.index("i").field("v").import_values(cols, vals)
            h.index("i").track_columns(cols)
        self.both("Set(10, m=2) Set(11, m=1) Set(12, b=true) Set(13, b=false) SetRowAttrs(f, 1, color=\"red\")")

    def bits(self, field, row, cols):
        cols = np.asarray(cols, np.uint64)
        rows = np.full(len(cols), row, np.uint64)
        for h in (self.j, self.t):
            h.index("i").field(field).import_bits(rows, cols)
            h.index("i").track_columns(cols)

    def roaring(self, field, row, shard, cols):
        pos = np.uint64(row) * np.uint64(SHARD_WIDTH) + np.asarray(cols, np.uint64)
        for h in (self.j, self.t):
            h.index("i").field(field).view("standard").fragment(shard).import_positions(pos, None)

    def both(self, pql):
        jr = canon(self.jex.execute("i", pql))
        tr = canon(self.tex.execute("i", pql))
        return jr, tr

    def close(self):
        self.t.close()


@pytest.fixture
def caches():
    saved = (JRC.budget_bytes, JRC.repair_enabled, TRC.budget_bytes, TRC.repair_enabled)
    for rc in (JRC, TRC):
        rc.reset()
        rc.configure(budget_bytes=64 << 20, repair=True)
    yield
    JRC.reset()
    TRC.reset()
    JRC.configure(budget_bytes=saved[0], repair=saved[1])
    TRC.configure(budget_bytes=saved[2], repair=saved[3])


def counters(rc):
    s = rc.stats_snapshot()
    return {k: s[k] for k in COUNTERS}


def test_answers_and_counters_match_reference(caches):
    rng = np.random.default_rng(1300)
    p = Pair2()
    try:
        steps = []

        def read_all(tag):
            for q in READS:
                jr, tr = p.both(q)
                assert tr == jr, (tag, q)
                steps.append((tag, q))
                assert counters(TRC) == counters(JRC), (tag, q)

        read_all("cold")
        read_all("warm")  # every eligible read hits
        writes = [
            ("set", lambda: p.both("Set(5, f=1)")),
            ("clear", lambda: p.both("Clear(5, f=1)")),
            # staged bursts: a watched row (repair), an unwatched one
            # (re-key), a watched row of another view (tree patch)
            ("import f1", lambda: p.bits("f", 1, rng.integers(0, N_SHARDS * SHARD_WIDTH, 500))),
            ("import f0", lambda: p.bits("f", 0, rng.integers(0, N_SHARDS * SHARD_WIDTH, 500))),
            ("import g0", lambda: p.bits("g", 0, rng.integers(0, N_SHARDS * SHARD_WIDTH, 300))),
            ("two bursts", lambda: (p.bits("f", 2, rng.integers(0, SHARD_WIDTH, 200)),
                                    p.bits("f", 2, rng.integers(0, SHARD_WIDTH, 200)))),
            ("roaring", lambda: p.roaring("f", 1, 1, rng.integers(0, SHARD_WIDTH, 100))),
            ("store", lambda: p.both("Store(Row(f=0), f=3)")),
            ("clearrow", lambda: p.both("ClearRow(f=4)")),
            ("bool flip", lambda: p.both("Set(12, b=false)")),
            ("time set", lambda: p.both("Set(14, t=1, 2024-01-05T03:00)")),
            ("mutex", lambda: p.both("Set(10, m=1)")),
        ]
        for tag, write in writes:
            write()
            read_all(tag)
        s = TRC.stats_snapshot()
        assert s["repairs"] > 0 and s["tree_repairs"] > 0 and s["rekeys"] > 0 and s["hits"] > 0
    finally:
        p.close()


def test_repaired_count_needs_no_dispatch(caches):
    """A repeat after a staged burst to its row is repaired from the word
    delta: no plan dispatch, and the count is the recomputed one."""
    p = Pair2()
    try:
        q = "Count(Intersect(Row(f=1), Row(f=2)))"
        p.both(q)
        p.bits("f", 1, np.arange(0, 3000, 3))
        tplan.reset_stats()
        before = TRC.stats_snapshot()["repairs"]
        jr, tr = p.both(q)
        assert tr == jr
        assert TRC.stats_snapshot()["repairs"] > before
        assert tplan.STATS == {"evals": 0, "host_reads": 0}
    finally:
        p.close()


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def vec(token, shards=(0, 1), versions=(0, 0)):
    return (("v", "", "f", "standard", token, tuple(shards), tuple(versions)),)


def test_lru_budget_quota_and_drop_index():
    rc = ResultCache(budget_bytes=1 << 20)
    for k in range(3):
        rc.put(("s", f"Count(Row(f={k}))", (0, 1), False), "count", "i", f"Count(Row(f={k}))", k, vec(7))
    assert rc.get(("s", "Count(Row(f=0))", (0, 1), False), vec(7)) == (True, 0)
    assert rc.get(("s", "Count(Row(f=0))", (0, 1), False), vec(7, versions=(1, 0))) == (False, None)
    nb = rc.stats_snapshot()["resident_bytes"] // 3
    rc.configure(budget_bytes=2 * nb)  # the least recently used goes
    assert rc.stats_snapshot()["entries"] == 2
    assert rc.get(("s", "Count(Row(f=1))", (0, 1), False), vec(7)) == (False, None)
    rc.configure(budget_bytes=1 << 20, tenant_overrides={"j": nb})
    for k in range(3):
        rc.put(("s", f"x{k}", (0, 1), False), "count", "j", f"x{k}", k, vec(8))
    snap = rc.stats_snapshot()
    assert snap["by_index"]["j"] <= nb and snap["quota_evictions_by_index"]["j"] == 2
    rc.drop_index("i")
    assert "i" not in rc.stats_snapshot()["by_index"]
    rc.drop_view(8)
    assert rc.stats_snapshot()["entries"] == 0


def test_barrier_captures_old_words_of_watched_rows_only(caches):
    """With a repairable Count cached on f row 1, the barrier captures the
    row's base words; with none, it reads nothing."""
    h = THolder(device="cpu").open()
    try:
        f = h.create_index("i").create_field("f")
        f.import_bits(np.array([1, 2], np.uint64), np.array([3, 4], np.uint64))
        ex = TExecutor(h)
        assert ex.execute("i", "Count(Row(f=1))") == [1]
        assert TRC.interest_rows("i", "f", "standard") == {1}
        v = f.view("standard")
        f.import_bits(np.array([1, 2], np.uint64), np.array([40, 50], np.uint64))
        merges = tmerge.merge_barrier(list(v.fragments.values()))
        (m,) = merges
        assert set(m.old_words) == {1} and m.rows == [1, 2]
        assert m.old_words[1][0] == 1 << 3
        widx, wv = m.word_delta(1)
        assert widx.tolist() == [1] and wv.tolist() == [1 << 8]
        TRC.reset()
        f.import_bits(np.array([1], np.uint64), np.array([41], np.uint64))
        (m,) = tmerge.merge_barrier(list(v.fragments.values()))
        assert m.old_words == {}
    finally:
        h.close()
