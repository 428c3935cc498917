"""Multi-Count batching in the port: N adjacent Count calls evaluate as
one MultiCountPlan, whose roots run in one plan_count_multi launch over
their shared leaves (pilosa_tpu_torch/ops/kernels.py), held exactly to
the reference's multi-root program `_eval_multi_jit` and to per-root
plan_count_plain on the same seeded numpy words, and, through both
executors, to the reference's answers (mirrors tests/test_multicount.py).

On CPU tensors plan_count_multi runs its twin; the `cuda` test holds the
kernel to the twin on the card and skips without one.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pilosa_tpu.exec.plan as jplan
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.resultcache import RESULT_CACHE
from pilosa_tpu_torch.exec import executor as exmod
from pilosa_tpu_torch.exec import plan as tplan
from pilosa_tpu_torch.exec.executor import Executor
from pilosa_tpu_torch.ops import kernels as K
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

W = 256
OPS = ["and", "or", "xor", "andnot"]


def words(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def build(spec, mod):
    if spec[0] == "leaf":
        return mod.PLeaf(spec[1])
    if spec[0] == "zero":
        return mod.PZero()
    return mod.PNary(spec[0], tuple(build(c, mod) for c in spec[1]))


def shared_roots(rng, n_roots, n_leaves):
    """Random roots over `n_leaves` leaves that share subtrees: each root
    combines two or three picks from a pool of small trees and leaves."""
    pool = [("leaf", i) for i in range(n_leaves)] + [("zero",)]
    for _ in range(6):
        kids = tuple(pool[int(rng.integers(len(pool)))] for _ in range(int(rng.integers(2, 4))))
        pool.append((OPS[int(rng.integers(4))], kids))
    roots = []
    for _ in range(n_roots):
        kids = tuple(pool[int(rng.integers(len(pool)))] for _ in range(int(rng.integers(1, 4))))
        roots.append(kids[0] if len(kids) == 1 else (OPS[int(rng.integers(4))], kids))
    return roots


@pytest.mark.parametrize("n_roots", [1, 2, 5, 16, 64])
def test_multi_counts_match_eval_multi_jit(n_roots):
    """_multi_counts (plan_count_multi's twin on the CPU) equals the
    reference's one-program evaluation and per-root plan_count_plain,
    exactly, on the full shard axis and on a prefix of it."""
    rng = np.random.default_rng(700 + n_roots)
    s, n_leaves = 5, 6
    ops = [words(rng, s, W) for _ in range(n_leaves)]
    tops = [t(o) for o in ops]
    specs = shared_roots(rng, n_roots, n_leaves)
    want = np.asarray(
        jplan._eval_multi_jit(tuple(build(sp, jplan) for sp in specs), "count", tuple(jnp.asarray(o) for o in ops), ())
    ).astype(np.int64)
    roots = [build(sp, tplan) for sp in specs]
    got = tplan._multi_counts(roots, tops, s)
    np.testing.assert_array_equal(got.numpy(), want)
    for r, root in enumerate(roots):
        np.testing.assert_array_equal(tplan._root_counts(root, tops, s).numpy(), want[r])
    np.testing.assert_array_equal(tplan._multi_counts(roots, tops, s - 2).numpy(), want[:, : s - 2])


def chain_programs(rng, n_roots, n_leaves, length):
    """Postfix programs of n-ary and/or/xor/andnot chains of `length`
    distinct leaves (`length` 1: a Row), root r starting at leaf r."""
    progs = []
    for r in range(n_roots):
        ids = [r % n_leaves] + [int(i) for i in rng.permutation(n_leaves) if i != r % n_leaves][: length - 1]
        progs.append([ids[0]] + [x for i in ids[1:] for x in (i, K.BINOPS[OPS[int(rng.integers(4))]])])
    return progs


# the batches whose launch tables take the kernel's rarer branches: more
# roots than one launch holds, more distinct leaves than its shared memory
# holds, and a table past the 2048 entries kept in shared memory
MULTI_SPLITS = {
    "roots": lambda rng: chain_programs(rng, 100, 32, 3),
    "leaves": lambda rng: chain_programs(rng, 100, 120, 3),
    "long table": lambda rng: chain_programs(rng, 64, 48, 40),
}


def decode_table32(words, n_root, n_code):
    """A launch's packed 32-bit table read back: each root's output row,
    first code and end, and the codes, in the kernel's (warp) order;
    checks the warp ranges cover the roots in order and the padding."""
    t = words.view(np.int32)
    w = K.MULTI_WARPS
    firsts = t[: w + 1].tolist()
    assert firsts[0] == 0 and firsts[-1] == n_root and firsts == sorted(firsts)
    rows = t[w + 1 : w + 1 + n_root].tolist()
    assert sorted(r & 255 for r in rows) == list(range(n_root))
    starts = t[w + 1 + n_root : w + 2 + 2 * n_root].tolist()
    assert starts[0] == 0 and starts[-1] == n_code
    codes = t[w + 2 + 2 * n_root : w + 2 + 2 * n_root + n_code].tolist()
    assert len(t) >= K.multi_table_entries(n_root, n_code) and t[w + 2 + 2 * n_root + n_code] == 0
    # the flat roots' op: a leaf push, then leaf_ops of that op, nothing else
    for k, row in enumerate(rows):
        seg = codes[starts[k] : starts[k + 1]]
        flat = [(c >> 3) & 7 for c in seg] == [K.MICRO_KINDS["push"]] + [K.MICRO_KINDS["leaf_op"]] * (len(seg) - 1)
        flat = flat and len({c & 7 for c in seg[1:]}) <= 1
        assert (row >> 8) == ((1 + (seg[1] & 7 if len(seg) > 1 else 0)) if flat else 0)
    return [r & 255 for r in rows], starts, codes


def run_multi_tables(leaves, progs, shards):
    """The plan_count_multi kernel's loop in numpy over the host tables
    the wrapper hands each launch (plan_count_multi_tables, its root
    starts and codes read back from the packed 32-bit table): every
    root's codes read the group's leaf slots and its own stack."""
    binop = [np.bitwise_and, np.bitwise_or, np.bitwise_xor, lambda a, b: a & ~b, lambda a, b: ~a & b]
    out = np.zeros((len(progs), shards), np.int64)
    for group, slot_leaves, starts, codes, stack in K.plan_count_multi_tables(progs):
        rows, starts, codes = decode_table32(K.plan_count_multi_table32(starts, codes), len(group), len(codes))
        slots = [leaves[i][:shards] for i in slot_leaves]
        for k, r in ((k, group[row]) for k, row in enumerate(rows)):
            zero = np.zeros_like(leaves[0][:shards])
            top, below = zero, []
            for pc in range(starts[k], starts[k + 1]):
                c = codes[pc]
                kind, op = (c >> 3) & 7, c & 7
                if kind == K.MICRO_KINDS["stack_op"]:
                    top = binop[op](below.pop(), top)
                    continue
                v = slots[c >> 6] if kind in (K.MICRO_KINDS["push"], K.MICRO_KINDS["leaf_op"]) else zero
                if kind in (K.MICRO_KINDS["leaf_op"], K.MICRO_KINDS["zero_op"]):
                    top = binop[op](top, v)
                else:
                    if pc > starts[k]:
                        below.append(top)
                    top = v
                assert len(below) <= stack
            out[r] = np.bitwise_count(top).sum(axis=1, dtype=np.int64)
    return out


@pytest.mark.parametrize("split", sorted(MULTI_SPLITS))
def test_plan_count_multi_launch_tables(split):
    """The host side of plan_count_multi: the roots split into launches
    that each fit (at most 64 roots; slots for the distinct leaves and the
    deepest stack within the shared memory), and the launch tables run as
    the kernel runs them equal the twin exactly."""
    rng = np.random.default_rng(900 + sorted(MULTI_SPLITS).index(split))
    progs = MULTI_SPLITS[split](rng)
    n_leaves = 1 + max(i for p in progs for i in p)
    s = 3
    leaves = [words(rng, s, 8) for _ in range(n_leaves)]
    tables = K.plan_count_multi_tables(progs)
    assert [tb[0] for tb in tables] == K.plan_count_multi_groups(progs)
    assert [r for tb in tables for r in tb[0]] == list(range(len(progs)))
    for group, slot_leaves, starts, codes, stack in tables:
        assert len(group) <= K.MULTI_MAX_ROOTS
        assert len(slot_leaves) + stack <= K.MULTI_CAP
        assert len(starts) == len(group) + 1 and starts[-1] == len(codes)
    if split == "long table":  # its table is read from device memory
        ((group, slot_leaves, starts, codes, stack),) = tables
        assert len(starts) + 1 + len(codes) > K.MULTI_TABLE_SMEM_ENTRIES
        assert not K.plan_count_multi_layout(len(group), len(slot_leaves), len(codes), stack)[3]
    else:
        assert len(tables) > 1
    want = K.plan_count_multi_plain([t(x) for x in leaves], progs, s).numpy()
    np.testing.assert_array_equal(run_multi_tables(leaves, progs, s), want)
    np.testing.assert_array_equal(run_multi_tables(leaves, progs, s - 1), want[:, : s - 1])


@pytest.mark.parametrize("seed", range(3))
def test_plan_count_multi_twin_is_per_root_plan_count(seed):
    rng = np.random.default_rng(800 + seed)
    s, n_leaves = 4, 9
    leaves = [t(words(rng, s, W)) for _ in range(n_leaves)]
    progs = []
    for sp in shared_roots(rng, 20, n_leaves):
        own, _, prog = tplan._compile(build(sp, tplan), leaves, {})
        # the root's own leaf list back to indices of the shared list
        idx = [next(i for i, x in enumerate(leaves) if x is o) for o in own]
        progs.append([idx[i] if i >= 0 else i for i in prog])
    got = K.plan_count_multi(leaves, progs, s)
    assert got.shape == (20, s) and got.dtype == torch.int64
    for r, prog in enumerate(progs):
        assert torch.equal(got[r], K.plan_count_plain(leaves, prog, s))


def test_plan_count_multi_groups_fit_one_launch():
    """Roots share one launch until their distinct leaves and deepest
    stack outgrow its shared memory, or 64 roots: as few launches as fit,
    decided from the micro programs."""
    cap = K.MULTI_CAP
    union = lambda ids: [ids[0]] + [x for i in ids[1:] for x in (i, K.BINOPS["or"])]  # noqa: E731
    # 64 roots over 32 shared leaves: one launch
    progs = [union([(r + k) % 32 for k in range(4)]) for r in range(64)]
    assert K.plan_count_multi_groups(progs) == [list(range(64))]
    # 65 roots: a second launch for the last
    assert K.plan_count_multi_groups(progs + progs[:1]) == [list(range(64)), [64]]
    # each root its own 10 leaves: cap // 10 roots a launch
    progs = [union(list(range(10 * r, 10 * r + 10))) for r in range(30)]
    groups = K.plan_count_multi_groups(progs)
    assert [len(g) for g in groups[:-1]] == [cap // 10] * (len(groups) - 1)
    assert sum(groups, []) == list(range(30))
    assert len(groups) == -(-30 // (cap // 10))
    with pytest.raises(ValueError, match="more than one launch holds"):
        K.plan_count_multi_groups([union(list(range(cap + 1)))])


def nested_programs(rng, n_roots, n_leaves, depth):
    """Postfix programs that push `depth` distinct leaves before their
    first operator, so each needs depth - 1 stack entries."""
    return [
        [int(i) for i in rng.choice(n_leaves, size=depth, replace=False)]
        + [K.BINOPS[OPS[int(rng.integers(4))]] for _ in range(depth - 1)]
        for _ in range(n_roots)
    ]


def random_batch(rng):
    """2-64 roots over 1-120 leaves: chains, nested programs or both."""
    n_roots, n_leaves = int(rng.integers(2, 65)), int(rng.integers(1, 121))
    chains = chain_programs(rng, n_roots, n_leaves, int(rng.integers(1, min(n_leaves, 40) + 1)))
    nested = nested_programs(rng, n_roots, n_leaves, int(rng.integers(1, min(n_leaves, 20) + 1)))
    pick = int(rng.integers(3))
    return chains if pick == 0 else nested if pick == 1 else chains[: n_roots // 2] + nested[n_roots // 2 :]


LAYOUT_BATCHES = {f"split {k}": (lambda rng, k=k: MULTI_SPLITS[k](rng)) for k in MULTI_SPLITS}
LAYOUT_BATCHES.update({f"random {i}": random_batch for i in range(12)})


def layouts(n, n_leaf, n_code, stack):
    """Every (VEC, nbuf, L, table in shared memory) of one or two ring
    buffers the kernel takes for a launch of this shape, with its
    resident blocks x L."""
    entries = K.multi_table_entries(n, n_code)
    out = {}
    for vec in K.MULTI_VECS:
        for nbuf in (1, 2):
            for lanes in K.MULTI_LANES:
                for tab in (True, False):
                    if K.multi_launch_ok(n, n_leaf, n_code, stack, vec, nbuf, lanes, tab):
                        smem = K.multi_smem_bytes(n, n_leaf, stack, vec, nbuf, lanes, entries if tab else 0)
                        out[vec, nbuf, lanes, tab] = K.multi_resident_blocks(smem, lanes) * lanes
    return out


@pytest.mark.parametrize("batch", sorted(LAYOUT_BATCHES))
def test_plan_count_multi_layout_fits(batch):
    """The (VEC, nbuf, L, table) the launcher picks for every launch of a
    batch fits the shared memory and passes the kernel's argument check,
    and keeps the most uint4 loads in flight an SM (resident blocks x L)
    of every layout of one or two ring buffers the kernel takes, two
    buffers where a layout with as many loads does, and the table in
    shared memory only when it is short enough."""
    rng = np.random.default_rng(1200 + sorted(LAYOUT_BATCHES).index(batch))
    progs = LAYOUT_BATCHES[batch](rng)
    for group, slot_leaves, starts, codes, stack in K.plan_count_multi_tables(progs):
        n, n_leaf, n_code = len(group), len(slot_leaves), len(codes)
        vec, nbuf, lanes, tab = K.plan_count_multi_layout(n, n_leaf, n_code, stack)
        assert K.multi_launch_ok(n, n_leaf, n_code, stack, vec, nbuf, lanes, tab)
        entries = K.multi_table_entries(n, n_code)
        smem = K.multi_smem_bytes(n, n_leaf, stack, vec, nbuf, lanes, entries if tab else 0)
        assert smem <= K.MULTI_SMEM_BYTES and K.multi_resident_blocks(smem, lanes) >= 1
        assert not tab or entries <= K.MULTI_TABLE_SMEM_ENTRIES
        options = layouts(n, n_leaf, n_code, stack)
        best = max(options.values())
        assert options[vec, nbuf, lanes, tab] == best
        if any(score == best and lay[1] >= 2 for lay, score in options.items()):
            assert nbuf >= 2


# seeded batches and the launches (roots a group, in order) that the
# grouping rule gave them before the kernel's redesign; its groups stay
PINNED_GROUPS = {
    "roots": (1300, lambda rng: chain_programs(rng, 130, 40, 3), [64, 64, 2]),
    "leaves": (1301, lambda rng: chain_programs(rng, 64, 120, 4), [52, 12]),
    "chains": (1302, lambda rng: chain_programs(rng, 64, 105, 30), [64]),
    "stacks": (1303, lambda rng: nested_programs(rng, 64, 100, 12), [29, 21, 14]),
    "mixed": (1304, lambda rng: chain_programs(rng, 20, 90, 20) + nested_programs(rng, 30, 60, 8), [50]),
}


@pytest.mark.parametrize("name", sorted(PINNED_GROUPS))
def test_plan_count_multi_groups_pinned(name):
    seed, make, sizes = PINNED_GROUPS[name]
    progs = make(np.random.default_rng(seed))
    groups = K.plan_count_multi_groups(progs)
    assert [len(g) for g in groups] == sizes
    assert sum(groups, []) == list(range(len(progs)))


@pytest.mark.parametrize("batch", sorted(LAYOUT_BATCHES))
def test_plan_count_multi_table32_decodes(batch):
    """The packed 32-bit table of each launch decodes back to its roots'
    micro programs: every root once, in the warps the host balanced, with
    the same kinds and ops, each push reading its leaf through the
    group's slot list, and the padding entry the kernel reads one code
    ahead."""
    rng = np.random.default_rng(1200 + sorted(LAYOUT_BATCHES).index(batch))
    progs = LAYOUT_BATCHES[batch](rng)
    reads = (K.MICRO_KINDS["push"], K.MICRO_KINDS["leaf_op"])
    for group, slot_leaves, starts, codes, stack in K.plan_count_multi_tables(progs):
        words = K.plan_count_multi_table32(starts, codes)
        assert words.dtype == np.int64
        rows, got_starts, got_codes = decode_table32(words, len(group), len(codes))
        for k, row in enumerate(rows):
            micro, pushes, slots = K.plan_micro_program(progs[group[row]])
            seg = got_codes[got_starts[k] : got_starts[k + 1]]
            assert [c & 63 for c in seg] == micro
            assert [slot_leaves[c >> 6] for c in seg if (c >> 3) & 7 in reads] == pushes
            assert slots <= stack
        # the warps' codes: no warp more than the longest root above the least loaded
        cost = [starts[k + 1] - starts[k] + 1 for k in range(len(group))]
        loads = [sum(cost[k] for k in ks) for ks in K.plan_count_multi_warps(starts)]
        assert max(loads) - min(loads) <= max(cost)


def test_multi_launch_check_at_the_cap():
    """The host's view of pt_plan_count_multi's argument check: a group
    whose leaves (or leaves and stack) take every VEC-1 slot beside the
    counters launches, at VEC 1 with one buffer (L 1 with a stack), also with 64
    roots; one slot more is refused, and plan_count_multi_groups never
    makes such a group."""
    cap = K.MULTI_CAP
    union = lambda ids: [ids[0]] + [x for i in ids[1:] for x in (i, K.BINOPS["or"])]  # noqa: E731
    ((group, slots, starts, codes, stack),) = K.plan_count_multi_tables([union(list(range(cap)))])
    assert len(slots) + stack == cap
    assert K.plan_count_multi_layout(1, len(slots), len(codes), stack)[:2] == (1, 1)
    assert K.multi_launch_ok(1, cap, len(codes), 0, 1, 1, 1, True)
    assert K.multi_launch_ok(64, cap, 64, 0, 1, 1, 1, False)
    assert K.multi_launch_ok(1, cap - 9, 1, 9, 1, 1, 1, False)
    assert not K.multi_launch_ok(1, cap - 9, 1, 9, 1, 1, 2, False)  # the stack at L 2 does not fit
    # one slot over: a leaf, or a stack entry
    assert not K.multi_launch_ok(1, cap + 1, len(codes) + 1, 0, 1, 1, 1, False)
    assert not K.multi_launch_ok(1, cap - 8, 1, 9, 1, 1, 1, False)
    with pytest.raises(ValueError, match="more than one launch holds"):
        K.plan_count_multi_groups([union(list(range(cap + 1)))])
    # the kernel's other limits: roots, VEC, L, buffers, the table's length
    assert not K.multi_launch_ok(65, 4, 65, 0, 1, 1, 1, False)
    assert not K.multi_launch_ok(1, 4, 1, 0, 3, 1, 1, False)
    assert not K.multi_launch_ok(1, 4, 1, 0, 4, 1, 1, False)
    assert not K.multi_launch_ok(1, 4, 1, 0, 1, 1, 8, False)  # L above 4 * VEC
    assert not K.multi_launch_ok(1, 4, 1, 0, 1, 0, 1, False)
    assert not K.multi_launch_ok(1, 4, 1, 0, 1, K.MULTI_MAX_BUF + 1, 1, False)
    long = K.MULTI_TABLE_SMEM_ENTRIES - K.multi_table_entries(1, 0) + 1
    assert not K.multi_launch_ok(1, 4, long, 0, 1, 1, 1, True)
    assert K.multi_launch_ok(1, 4, long, 0, 1, 1, 1, False)
    assert K.multi_launch_ok(1, 4, long - 1, 0, 1, 1, 1, True)
    assert not K.multi_launch_ok(1, 27, 1, 0, 2, K.MULTI_MAX_BUF, 1, False)  # 4 buffers of 27 VEC-2 slots: 432 KiB


# ---------------------------------------------------------------------------
# through the executors
# ---------------------------------------------------------------------------

SINGLES = (
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Union(Row(f=1), Row(f=2)))",
    "Count(Xor(Row(f=2), Row(f=3)))",
    "Count(Difference(Row(f=3), Row(f=1)))",
)
MULTI = "".join(SINGLES)


@pytest.fixture
def pair():
    """The same seeded bits in a reference holder and a port holder on the
    CPU; the port's result cache off (these probes count dispatches)."""
    rng = np.random.default_rng(900)
    jh = JHolder().open()
    th = Holder(device="cpu").open()
    for h in (jh, th):
        h.create_index("i").create_field("f")
    n_shards = 5
    for row in (1, 2, 3):
        cols = rng.integers(0, n_shards * SHARD_WIDTH, 500 * row).astype(np.uint64)
        rows = np.full(len(cols), row, np.uint64)
        for h in (jh, th):
            h.index("i").field("f").import_bits(rows, cols)
    budget = RESULT_CACHE.budget_bytes
    RESULT_CACHE.configure(budget_bytes=0)
    yield JExecutor(jh), Executor(th), th
    RESULT_CACHE.configure(budget_bytes=budget)
    th.close()


@pytest.fixture
def counted(monkeypatch):
    """Calls of plan_count and plan_count_multi (the CPU route launches
    nothing, so the wrappers are counted here)."""
    calls = {"plan_count": 0, "plan_count_multi": 0}
    for name in calls:
        fn = getattr(K, name)

        def wrap(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(K, name, wrap)
    return calls


def test_multicount_one_launch_matches_serial_and_reference(pair, counted):
    jex, ex, _ = pair
    singles = [ex.execute("i", q)[0] for q in SINGLES]
    assert singles == [jex.execute("i", q)[0] for q in SINGLES]
    tplan.reset_stats()
    counted.update(plan_count=0, plan_count_multi=0)
    got = ex.execute("i", MULTI)
    assert got == singles == jex.execute("i", MULTI)
    assert tplan.STATS == {"evals": 1, "host_reads": 1}  # four counts, one dispatch
    assert counted == {"plan_count": 0, "plan_count_multi": 1}


def test_multicount_mixed_query_batches_runs(pair, counted):
    """Only adjacent Count runs batch; other calls execute in order."""
    jex, ex, _ = pair
    q = "Count(Row(f=1)) Count(Row(f=2)) Row(f=3) Count(Row(f=3)) Count(Row(f=1))"
    got = ex.execute("i", q)
    want = jex.execute("i", q)
    assert [got[k] for k in (0, 1, 3, 4)] == [want[k] for k in (0, 1, 3, 4)]
    assert got[2].columns().tolist() == want[2].columns().tolist()
    assert counted["plan_count_multi"] == 2


def test_multicount_shift_root_and_shared_range(pair):
    """A Shift root rides beside the others (its own plan_rows launch);
    the results equal the reference's."""
    jex, ex, _ = pair
    q = "Count(Shift(Row(f=1), n=3)) Count(Row(f=1)) Count(Intersect(Row(f=2), Shift(Row(f=1), n=3)))"
    assert ex.execute("i", q) == jex.execute("i", q)


def test_multicount_sparse_compaction(pair):
    jex, ex, th = pair
    for h in (jex.holder, th):
        g = h.index("i").create_field("g")  # sparse: 6 of 200 shards
        for s in range(0, 200, 33):
            g.import_bits(np.full(4, 1, np.uint64), np.arange(4, dtype=np.uint64) + np.uint64(s * SHARD_WIDTH))
    q = "Count(Row(g=1)) Count(Intersect(Row(g=1), Row(g=1)))"
    tplan.reset_stats()
    expect = 4 * len(range(0, 200, 33))
    assert ex.execute("i", q) == [expect, expect] == jex.execute("i", q)
    assert tplan.STATS["evals"] == 1


def test_multicount_root_wider_than_a_launch(pair, counted):
    """A root reading more distinct leaves than one plan_count_multi
    launch holds runs on plan_count beside the batch; answers equal the
    reference's."""
    jex, ex, th = pair
    wide = K.MULTI_CAP + 5
    for h in (jex.holder, th):
        w = h.index("i").create_field("w")
        w.import_bits(np.arange(wide, dtype=np.uint64), np.arange(wide, dtype=np.uint64) * np.uint64(7))
    q = "Count(Row(f=1)) Count(Union({})) Count(Intersect(Row(f=1), Row(f=2)))".format(
        ", ".join(f"Row(w={r})" for r in range(wide))
    )
    counted.update(plan_count=0, plan_count_multi=0)
    assert ex.execute("i", q) == jex.execute("i", q)
    assert counted == {"plan_count": 1, "plan_count_multi": 1}


def test_multicount_error_propagates(pair):
    _, ex, _ = pair
    with pytest.raises(exmod.ExecError, match="single bitmap input"):
        ex.execute("i", "Count(Row(f=1)) Count(Row(f=1), Row(f=2))")


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_plan_count_multi_matches_twin():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        K._nvcc()
    except RuntimeError:
        pytest.skip("no nvcc")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1000)
    # ... and W on the tile edges of each VEC the launcher picks (a tile
    # is 512 * VEC words), S = 1, and 300 one-word shards (block runs
    # crossing shards)
    shapes = [(3, 4100, 2, 4), (7, 32768, 16, 16), (2, 512, 64, 32), (1, 4, 5, 60)]
    shapes += [(s, w, 16, n) for n in (4, 12, 30) for s, w in ((2, 516), (3, 1028), (1, 1004), (3, 32772))]
    shapes += [(300, 4, 1, 3), (300, 4, 64, 8)]
    for s, w, n_roots, n_leaves in shapes:
        leaves = [t(words(rng, s, w)) for _ in range(n_leaves)]
        progs = []
        for sp in shared_roots(rng, n_roots, n_leaves):
            own, _, prog = tplan._compile(build(sp, tplan), leaves, {})
            idx = [next(i for i, x in enumerate(leaves) if x is o) for o in own]
            progs.append([idx[i] if i >= 0 else i for i in prog] if own else [K.PUSH_ZERO])
        want = K.plan_count_multi(leaves, progs, s)
        before = K.LAUNCHES["plan_count_multi"]
        got = K.plan_count_multi([x.to(dev) for x in leaves], progs, s).cpu()
        assert torch.equal(got, want)
        assert K.LAUNCHES["plan_count_multi"] - before == len(K.plan_count_multi_groups(progs))
    # more than one launch a batch, and the table read from device memory
    for split, make in sorted(MULTI_SPLITS.items()):
        progs = make(rng)
        leaves = [t(words(rng, 2, 4100)) for _ in range(1 + max(i for p in progs for i in p))]
        want = K.plan_count_multi_plain(leaves, progs, 2)
        before = K.LAUNCHES["plan_count_multi"]
        got = K.plan_count_multi([x.to(dev) for x in leaves], progs, 2).cpu()
        assert torch.equal(got, want), split
        assert K.LAUNCHES["plan_count_multi"] - before == len(K.plan_count_multi_groups(progs))
