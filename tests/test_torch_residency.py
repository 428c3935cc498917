"""The port's extent residency, pins and in-place patches against
pilosa_tpu's, on the CPU.

Mirrors tests/test_hbm.py::TestExtentPaging at 16 shards and extent_rows
4 (4 extents a row stack): the same seeded writes and queries go through
a pilosa_tpu holder and a port holder, each with the same device budget
(the reference's process-wide DEVICE_CACHE, set and restored by the
fixture; its result cache is off so every query stages), and every
answer and every query's re-staged bytes (extents x extent bytes) must
be equal:

- a budget short of the working set re-stages exactly the deficit;
- a budget holding the working set re-stages nothing;
- extents and monolithic staging give the same answers;
- a one-shard write drops only the extent covering that shard; a staged
  import into another row patches (re-keys) the covering extents and
  re-stages nothing; a staged import into the operand's own row is
  patched into the resident extent, which then holds the words a fresh
  staging builds;
- a barrier over a subset of shards leaves the other dirty shards
  patchable;
- both barrier routes of the port (merge-device-threshold 0: the merged
  keys stay on the device, here the CPU, and or_bits runs its twin; -1:
  the host merge) against the reference's host route: the same answers,
  re-staged bytes and patched entries over several bursts into the
  operand rows, every merged key applied once, and patched row and
  planes entries equal to a fresh staging;
- copy-on-write: a pinned entry keeps its words while the barrier
  patches a clone; an unpinned one is patched in place;
- under a budget below one shard's stack the port answers shard by
  shard, as the reference's per-shard loop does, instead of raising.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import numpy as np
import pytest
import torch

from pilosa_tpu.core import merge as jmerge
from pilosa_tpu.core.devcache import DEVICE_CACHE
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.core.resultcache import RESULT_CACHE
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec.executor import ValCount as JValCount
from pilosa_tpu.hbm import residency as jres
from pilosa_tpu.parallel import mesh as pmesh
from pilosa_tpu_torch import Executor as TExecutor
from pilosa_tpu_torch import Holder as THolder
from pilosa_tpu_torch.core import merge as tmerge
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.row import Row as TRow
from pilosa_tpu_torch.exec.executor import ValCount as TValCount
from pilosa_tpu_torch.hbm import residency as tres
from pilosa_tpu_torch.hbm.residency import ExtentTable
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

S = 16
EXT = 4
ROW_BYTES = WORDS_PER_ROW * 4
EXT_BYTES = EXT * ROW_BYTES


class Both:
    """A reference and a port holder with the same data, and their
    executors."""

    def __init__(self, track_existence: bool = True):
        self.jh = JHolder().open()
        self.th = THolder(device="cpu").open()
        self.jidx = self.jh.create_index("i", track_existence=track_existence)
        self.tidx = self.th.create_index("i", track_existence=track_existence)
        self.jex = JExecutor(self.jh)
        self.tex = TExecutor(self.th)

    def field(self, name: str, **opts):
        return (
            self.jidx.create_field(name, JFieldOptions(**opts)),
            self.tidx.create_field(name, TFieldOptions(**opts)),
        )

    def each(self, name: str):
        return self.jidx.field(name), self.tidx.field(name)

    def budget(self, nbytes: int) -> None:
        DEVICE_CACHE.budget_bytes = nbytes
        self.th.dcache.budget_bytes = nbytes

    def extent_rows(self, rows: int) -> None:
        jres.configure(extent_rows=rows)
        tres.configure(extent_rows=rows)

    def clear(self) -> None:
        DEVICE_CACHE.clear()
        self.th.dcache.clear()

    def query(self, pql: str):
        """Both answers (asserted equal) and both restaged byte counts."""
        j0, t0 = jres.stats_snapshot()["restage_bytes"], tres.stats_snapshot()["restage_bytes"]
        want = [_norm(r) for r in self.jex.execute("i", pql)]
        got = [_norm(r) for r in self.tex.execute("i", pql)]
        assert got == want, pql
        j1, t1 = jres.stats_snapshot()["restage_bytes"], tres.stats_snapshot()["restage_bytes"]
        return got, j1 - j0, t1 - t0

    def patches(self):
        return jres.stats_snapshot()["extent_patches"], tres.stats_snapshot()["extent_patches"]


def _norm(r):
    if isinstance(r, TRow) or hasattr(r, "columns"):
        return ("row", [int(c) for c in r.columns()])
    if isinstance(r, (JValCount, TValCount)):
        return ("vc", r.value, r.count)
    if isinstance(r, list):
        return [(tuple(g.row_id for g in p.group), p.count) if hasattr(p, "group") else (p.id, p.count) for p in r]
    return r


@pytest.fixture
def env():
    """One device, no result cache, clean counters; the budget and
    extent rows of both packages restored afterwards."""
    old_mesh = pmesh.active_mesh()
    pmesh.set_active_mesh(None)
    old_budget, old_rows = DEVICE_CACHE.budget_bytes, jres.extent_rows()
    old_trows = tres.extent_rows()
    DEVICE_CACHE.clear()
    RESULT_CACHE.configure(budget_bytes=0)
    jres.reset_stats()
    tres.reset_stats()
    both = Both()
    both.extent_rows(EXT)
    both.budget(1 << 30)
    yield both
    jres.configure(extent_rows=old_rows)
    tres.configure(extent_rows=old_trows)
    DEVICE_CACHE.budget_bytes = old_budget
    DEVICE_CACHE.clear()
    jres.reset_stats()
    tres.reset_stats()
    pmesh.set_active_mesh(old_mesh)


def populate(both: Both, n_rows: int, seed: int = 5) -> None:
    """Field f: n_rows random dense rows in every shard, by words."""
    jf, tf = both.field("f")
    rng = np.random.default_rng(seed)
    for r in range(n_rows):
        for s in range(S):
            w = rng.integers(0, 2**32, WORDS_PER_ROW).astype(np.uint32)
            jf.import_row_words(r, s, w)
            tf.import_row_words(r, s, w)


def import_bits(both: Both, name: str, rows, cols) -> None:
    for f in both.each(name):
        f.import_bits(np.asarray(rows, np.uint64), np.asarray(cols, np.uint64))


def test_partial_restage_under_budget_pressure(env):
    n_rows = 8
    populate(env, n_rows)
    ws = n_rows * S * ROW_BYTES  # 32 extents
    budget = 24 * EXT_BYTES
    assert S * ROW_BYTES <= budget // 4  # one stack stays under the guard
    env.budget(budget)
    q = "Count(Union(" + ", ".join(f"Row(f={r})" for r in range(n_rows)) + "))"
    jev0 = jres.stats_snapshot()["evicted_extent_bytes"]
    tev0 = env.th.dcache.evicted_extent_bytes
    _, jr, tr = env.query(q)
    assert jr == tr == ws
    assert jres.stats_snapshot()["evicted_extent_bytes"] - jev0 == env.th.dcache.evicted_extent_bytes - tev0
    assert env.th.dcache.evicted_extent_bytes - tev0 == ws - budget
    assert env.th.dcache.bytes_used <= budget and DEVICE_CACHE.bytes_used <= budget
    assert env.th.dcache.pinned_bytes == 0 == DEVICE_CACHE.pinned_bytes
    _, jr, tr = env.query(q)
    assert jr == tr == ws - budget  # the deficit, not the working set


def test_resident_budget_means_zero_restage(env):
    populate(env, 4)
    q = "Count(Union(Row(f=0), Row(f=1), Row(f=2), Row(f=3)))"
    _, jr, tr = env.query(q)
    assert jr == tr == 4 * S * ROW_BYTES
    _, jr, tr = env.query(q)
    assert jr == tr == 0


def test_extent_and_monolithic_answers_agree(env):
    populate(env, 3)
    q = "Count(Intersect(Row(f=0), Row(f=1)))Count(Xor(Row(f=1), Row(f=2)))Row(f=2)"
    env.extent_rows(0)
    env.clear()
    want, _, _ = env.query(q)
    for rows in (1, 3, 4, 16, 17):
        env.extent_rows(rows)
        env.clear()
        assert env.query(q)[0] == want, rows


def test_single_shard_write_drops_only_its_extent(env):
    populate(env, 1)
    q = "Count(Row(f=0))"
    env.query(q)
    assert env.query(q)[1:] == (0, 0)
    for f in env.each("f"):
        f.set_bit(5, 2 * SHARD_WIDTH + 7)  # another row: its shard's extent drops
    _, jr, tr = env.query(q)
    assert jr == tr == EXT_BYTES
    for f in env.each("f"):
        f.set_bit(0, 9 * SHARD_WIDTH + 11)  # the operand's row, shard 9
    _, jr, tr = env.query(q)
    assert jr == tr == EXT_BYTES
    env.clear()
    env.query(q)


def test_staged_import_into_other_row_patches_without_restage(env):
    populate(env, 1)
    q = "Count(Row(f=0))"
    env.query(q)
    p0 = env.patches()
    import_bits(env, "f", [9, 9], [2 * SHARD_WIDTH + 1, 9 * SHARD_WIDTH + 1])
    _, jr, tr = env.query(q)
    assert jr == tr == 0  # re-keyed in place: nothing re-staged
    p1 = env.patches()
    assert p1[0] - p0[0] == p1[1] - p0[1] == 2  # one per covering extent
    assert tres.stats_snapshot()["patch_upload_bytes"] == 0  # row 9 is not in the entry
    env.clear()
    env.query(q)


def test_staged_import_into_operand_row_is_patched(env):
    populate(env, 2)
    jf, tf = env.each("f")
    q = "Count(Row(f=0))Count(Intersect(Row(f=0), Row(f=1)))"
    env.query(q)
    rng = np.random.default_rng(8)
    cols = rng.integers(0, S * SHARD_WIDTH, 3000).astype(np.uint64)
    import_bits(env, "f", np.zeros(len(cols)), cols)
    p0 = env.patches()
    _, jr, tr = env.query(q)
    assert jr == tr == 0
    p1 = env.patches()
    assert p1[0] - p0[0] == p1[1] - p0[1] == 8  # both rows' 4 extents
    st = tres.stats_snapshot()
    # the port ORs the merged keys themselves, where the reference uploads
    # a dense 128 KiB block per dirty shard: each distinct column once,
    # and on a CPU holder nothing crosses to a card
    assert st["patch_keys"] == len(np.unique(cols))
    assert st["patch_upload_bytes"] == 0
    assert st["extent_patch_batches"] == 4  # one or_bits launch per row-0 extent
    v = tf.view("standard")
    patched = v.row_stack(0, tuple(range(S))).clone()
    env.th.dcache.clear()
    assert torch.equal(patched, v.row_stack(0, tuple(range(S))))
    env.clear()
    env.query(q)


def test_subset_barrier_keeps_other_shards_patchable(env):
    populate(env, 1)
    q = "Count(Row(f=0))"
    env.query(q)
    p0 = env.patches()
    import_bits(env, "f", [9, 9], [1 * SHARD_WIDTH + 1, 13 * SHARD_WIDTH + 1])
    for f in env.each("f"):
        v = f.view("standard")
        v.sync_pending(frags=[v.fragments[1]])
        assert 13 in v._dirty_staged
        v.sync_pending(frags=[v.fragments[13]])
    _, jr, tr = env.query(q)
    assert jr == tr == 0
    p1 = env.patches()
    assert p1[0] - p0[0] == p1[1] - p0[1] == 2


@pytest.fixture
def route(request):
    """The port's barrier route (threshold 0 or -1) against the
    reference's host route; both packages' thresholds restored."""
    jold, told = jmerge._device_threshold, tmerge._device_threshold
    jmerge.configure(device_threshold=-1)
    tmerge.configure(device_threshold=request.param)
    yield request.param
    jmerge.configure(device_threshold=jold)
    tmerge.configure(device_threshold=told)


@pytest.mark.parametrize("route", [0, -1], ids=["device-route", "host-route"], indirect=True)
def test_patch_routes_match_reference(env, route):
    populate(env, 2)
    q = "Count(Row(f=0))Count(Intersect(Row(f=0), Row(f=1)))Count(Union(Row(f=0), Row(f=1)))"
    env.query(q)
    rng = np.random.default_rng(31)
    applied = 0
    for burst in range(3):
        rows = rng.integers(0, 3, 4000)  # row 2 is in no resident entry
        cols = rng.integers(0, S * SHARD_WIDTH, 4000)
        # bit 31 of a word, the first and the last column, duplicates
        edge = np.array([31, 0, S * SHARD_WIDTH - 1, 5 * SHARD_WIDTH + 63, 31])
        rows = np.concatenate([rows, np.full(len(edge), burst % 2)])
        cols = np.concatenate([cols, edge])
        import_bits(env, "f", rows, cols)
        p0, k0 = env.patches(), tres.stats_snapshot()["patch_keys"]
        _, jr, tr = env.query(q)
        assert jr == tr == 0, burst
        p1 = env.patches()
        assert p1[0] - p0[0] == p1[1] - p0[1] == 8, burst  # both rows' 4 extents
        keys = tres.stats_snapshot()["patch_keys"] - k0
        assert keys == len({(r, c) for r, c in zip(rows.tolist(), cols.tolist()) if r < 2}), burst
        applied += keys
    st = tres.stats_snapshot()
    assert st["patch_keys"] == applied and st["patch_upload_bytes"] == 0
    tf = env.tidx.field("f")
    v = tf.view("standard")
    shards = tuple(range(S))
    patched = [v.row_stack(r, shards).clone() for r in (0, 1)]
    env.th.dcache.clear()
    for r in (0, 1):
        assert torch.equal(patched[r], v.row_stack(r, shards)), r
    # a planes entry of rows 0 and 1 beside the two row stacks: one
    # or_bits launch per extent of each, both planes patched
    planes = v.plane_stack((0, 1), shards)
    before = tres.stats_snapshot()
    cols = rng.integers(0, S * SHARD_WIDTH, 3000)
    import_bits(env, "f", rng.integers(0, 2, len(cols)), cols)
    patched = v.plane_stack((0, 1), shards)
    after = tres.stats_snapshot()
    assert after["restage_bytes"] == before["restage_bytes"]
    launches = after["extent_patch_batches"] - before["extent_patch_batches"]
    assert after["extent_patches"] - before["extent_patches"] == launches == 3 * S // EXT
    assert not torch.equal(planes, patched)
    env.th.dcache.clear()
    assert torch.equal(patched, v.plane_stack((0, 1), shards))
    env.clear()
    env.query(q)


@pytest.mark.parametrize("pinned", [False, True])
def test_copy_on_write_of_pinned_entry(env, pinned):
    """A one-extent stack is the cached entry itself. Unpinned, the
    barrier ORs the delta into it in place; pinned (a plan holds it, not
    yet launched), the entry keeps its words and a patched clone takes
    its place. Port only: the reference's patch is always a new array."""
    populate(env, 1)
    tf = env.tidx.field("f")
    v = tf.view("standard")
    shards = tuple(range(EXT))  # one extent: the mono entry
    table = ExtentTable(env.th.dcache)
    held = v.row_stack(0, shards, extents=table)
    if not pinned:
        table.release()
    before = held.clone()
    tf.import_bits(np.zeros(4, np.uint64), np.array([0, 33, SHARD_WIDTH + 2, 3 * SHARD_WIDTH + 64], np.uint64))
    fresh = v.row_stack(0, shards)
    st = tres.stats_snapshot()
    assert st["extent_patches"] == 1 and st["restage_bytes"] == EXT * ROW_BYTES  # the first staging only
    assert (fresh is held) != pinned
    assert torch.equal(held, before) == pinned
    if pinned:
        assert env.th.dcache.pinned_bytes == held.numel() * 4  # zombie bytes until the plan lets go
        table.release()
    assert env.th.dcache.pinned_bytes == 0
    want = np.stack([v.fragments[s].row_words(0) for s in shards]).view(np.int32)
    assert np.array_equal(fresh.numpy(), want)


@pytest.mark.parametrize(
    "pql",
    [
        "Count(Intersect(Row(f=0), Row(g=0)))",
        "Count(Union(Row(f=0), Row(f=1), Row(g=1)))",
        "Count(Not(Row(f=1)))",
        "TopN(f, Row(g=0), n=3)",
        "Row(g=1)",
        "Sum(Row(g=0), field=v)",
        "Count(Row(v > 3))",
        "GroupBy(Rows(f), Rows(g))",
    ],
)
def test_budget_below_one_shard_answers_per_shard(env, pql):
    """Stacks over a quarter of the budget halve the shard list; below 16
    shards the port lowers each shard alone, admitted over the budget,
    and answers as the reference's per-shard loop does (restaged bytes
    differ by design: the reference's loop stages per-fragment rows)."""
    n = 8
    jf, tf = env.field("f")
    jg, tg = env.field("g")
    jv, tv = env.field("v", type="int", min=-10, max=10)
    rng = np.random.default_rng(9)
    for r in range(2):
        cols = rng.integers(0, n * SHARD_WIDTH, 4000).astype(np.uint64)
        for f, idx in ((jf, env.jidx), (tf, env.tidx)):
            f.import_bits(np.full(len(cols), r, np.uint64), cols)
            idx.track_columns(cols)
        cols = rng.integers(0, n * SHARD_WIDTH, 3000).astype(np.uint64)
        for f, idx in ((jg, env.jidx), (tg, env.tidx)):
            f.import_bits(np.full(len(cols), r, np.uint64), cols)
            idx.track_columns(cols)
    cols = np.unique(rng.integers(0, n * SHARD_WIDTH, 2000)).astype(np.uint64)
    vals = rng.integers(-10, 11, len(cols))
    for v, idx in ((jv, env.jidx), (tv, env.tidx)):
        v.import_values(cols, vals)
        idx.track_columns(cols)
    env.budget(ROW_BYTES // 2)  # a quarter of it is 1/8 of one shard's row
    env.query(pql)
    assert env.th.dcache.pinned_bytes == 0


def test_filter_outlives_its_pins_under_a_concurrent_barrier(env, monkeypatch):
    """A bare Row filter over one extent is the cached entry itself. The
    filtered TopN launches its tally kernels on it after the filter plan
    has released its pins; a barrier from another thread in that gap
    patches the unpinned entry in place. The TopN must still count
    against the filter as it was lowered: the reference's answer before
    the write. The next query sees the write."""
    import threading

    shards = EXT  # one extent: Row(g=0) is the mono entry itself
    rng = np.random.default_rng(12)
    jf, tf = env.field("f")
    jg, tg = env.field("g")
    for r in range(3):
        for s in range(shards):
            w = rng.integers(0, 2**32, WORDS_PER_ROW).astype(np.uint32)
            jf.import_row_words(r, s, w)
            tf.import_row_words(r, s, w)
    cols = rng.integers(0, shards * SHARD_WIDTH, 2000).astype(np.uint64)
    import_bits(env, "g", np.zeros(len(cols)), cols)
    q = "TopN(f, Row(g=0), n=3)"
    want_before, _, _ = env.query(q)
    burst = rng.integers(0, shards * SHARD_WIDTH, 4000).astype(np.uint64)
    tview = tg.view("standard")
    orig = TExecutor._topn_icounts_raw
    seen = {}

    def barrier_in_the_gap(self, view, cand, present, src_stack):
        if not seen:
            seen["patches"] = tres.stats_snapshot()["extent_patches"]
            tg.import_bits(np.zeros(len(burst), np.uint64), burst)
            t = threading.Thread(target=tview.sync_pending)
            t.start()
            t.join(30)
            assert not t.is_alive()
            seen["patches"] = tres.stats_snapshot()["extent_patches"] - seen["patches"]
        return orig(self, view, cand, present, src_stack)

    monkeypatch.setattr(TExecutor, "_topn_icounts_raw", barrier_in_the_gap)
    got = [_norm(r) for r in env.tex.execute("i", q)]
    assert seen["patches"] == 1  # the filter's entry was patched, not dropped
    assert got == want_before
    assert env.th.dcache.pinned_bytes == 0
    jg.import_bits(np.zeros(len(burst), np.uint64), burst)
    after, _, tr = env.query(q)
    assert tr == 0 and after != want_before  # the patched entry serves the write
