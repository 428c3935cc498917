"""The port's Rows and GroupBy against pilosa_tpu's, and the GroupBy
kernels' twins against the reference's XLA programs.

Both packages take the same ingest calls (dense rows by words, sparse
rows through import_bits, a mutex field, a field with fragments in two
shards only, an empty field); then randomized Rows and GroupBy calls of
depth 1-3, with filters (Shift among them), limit, offset, per-child
previous, the list form previous=[...], child limits and columns, run
through both executors at the default prefix tile (the one-shot path) and
at a one-MiB tile (the pruned descent). Every result must be identical
(exact: group counts are integers). The port runs on the CPU, through the
kernels' plain twins; the `cuda`-marked test holds the two kernels to
their twins on a card and skips without one.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec import groupby as jgb
from pilosa_tpu.exec.executor import ExecError as JExecError
from pilosa_tpu_torch import ExecError as TExecError
from pilosa_tpu_torch import Executor as TExecutor
from pilosa_tpu_torch import Holder as THolder
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.exec import groupby as tgb
from pilosa_tpu_torch.ops import bitmap as ob
from pilosa_tpu_torch.ops import kernels as K
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

N_SHARDS = 4
W = WORDS_PER_ROW


def ingest(holder, field_options, seed: int = 5) -> None:
    """The same calls for either package. `a`: 3 dense and 3 sparse rows;
    `b`: 4 sparse rows, row 3 in shard 0 only; `m`: a mutex field; `c`:
    fragments in shards 1 and 2 only; `e`: no bits at all."""
    rng = np.random.default_rng(seed)
    idx = holder.create_index("i", track_existence=True)
    a = idx.create_field("a")
    b = idx.create_field("b")
    m = idx.create_field("m", field_options(type="mutex"))
    c = idx.create_field("c")
    idx.create_field("e")
    ef = idx.existence_field()
    all_cols = []
    for r in range(3):
        for s in range(N_SHARDS):
            w = rng.integers(0, 2**32, W, dtype=np.uint32)
            for _ in range(r + 1):
                w &= rng.integers(0, 2**32, W, dtype=np.uint32)
            a.import_row_words(r, s, w)
            ef.import_row_words(0, s, w)
    for r in range(3, 6):
        cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, 20000).astype(np.uint64)
        a.import_bits(np.full(len(cols), r, np.uint64), cols)
        all_cols.append(cols)
    for r in range(4):
        hi = SHARD_WIDTH if r == 3 else N_SHARDS * SHARD_WIDTH
        cols = rng.integers(0, hi, 30000).astype(np.uint64)
        b.import_bits(np.full(len(cols), r, np.uint64), cols)
        all_cols.append(cols)
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, 40000).astype(np.uint64)
    m.import_bits(rng.integers(0, 3, len(cols)).astype(np.uint64), cols)
    all_cols.append(cols)
    cols = rng.integers(SHARD_WIDTH, 3 * SHARD_WIDTH, 30000).astype(np.uint64)
    c.import_bits(rng.integers(0, 3, len(cols)).astype(np.uint64), cols)
    all_cols.append(cols)
    idx.track_columns(np.concatenate(all_cols))


@pytest.fixture(scope="module")
def both():
    ref, port = JHolder(None).open(), THolder(device="cpu")
    ingest(ref, JFieldOptions)
    ingest(port, TFieldOptions)
    return JExecutor(ref), TExecutor(port)


def norm(r):
    if isinstance(r, list):
        if r and hasattr(r[0], "group"):
            return [([(fr.field, fr.row_id, fr.row_key) for fr in g.group], g.count) for g in r]
        return list(r)
    return r


def run_both(ref_ex, port_ex, pql, shards=None):
    want = [norm(r) for r in ref_ex.execute("i", pql, shards=shards)]
    got = [norm(r) for r in port_ex.execute("i", pql, shards=shards)]
    assert got == want, f"{pql} shards={shards}"
    return got


FIELDS = ["a", "b", "m", "c"]
FILTERS = [
    "Row(a=0)",
    "Row(b=3)",
    "Union(Row(a=4), Row(m=1))",
    "Not(Row(a=1))",
    "Shift(Row(a=2), n=1)",
    "Intersect(Shift(Row(b=0), n=3), Row(a=0))",
    "Row(a=99)",
    "Row(c=1)",
]


def random_group_by(rng) -> str:
    depth = int(rng.integers(1, 4))
    fields = [FIELDS[i] for i in rng.choice(len(FIELDS), depth, replace=False)]
    children = []
    for fname in fields:
        extra = []
        u = rng.random()
        if u < 0.15:
            extra.append(f"previous={int(rng.integers(0, 4))}")
        elif u < 0.25:
            extra.append(f"limit={int(rng.integers(1, 4))}")
        elif u < 0.3:
            extra.append(f"column={int(rng.integers(0, N_SHARDS * SHARD_WIDTH))}")
        children.append(f"Rows({', '.join([fname] + extra)})")
    args = list(children)
    if rng.random() < 0.5:
        args.append(f"filter={FILTERS[int(rng.integers(len(FILTERS)))]}")
    if rng.random() < 0.3:
        args.append(f"limit={int(rng.integers(1, 12))}")
    if rng.random() < 0.3:
        args.append(f"offset={int(rng.integers(0, 6))}")
    if rng.random() < 0.2 and not any("previous" in ch for ch in children):
        args.append("previous=[{}]".format(", ".join(str(int(rng.integers(0, 4))) for _ in fields)))
    return f"GroupBy({', '.join(args)})"


GROUP_BYS = [random_group_by(np.random.default_rng(1000 + k)) for k in range(24)] + [
    "GroupBy(Rows(a))",
    "GroupBy(Rows(a), Rows(b), Rows(m))",
    "GroupBy(Rows(a), Rows(c))",
    "GroupBy(Rows(c), Rows(a), filter=Shift(Row(b=3), n=1))",
    "GroupBy(Rows(a), Rows(e))",
    "GroupBy(Rows(a), Rows(b), previous=[2, 1], limit=5)",
    "GroupBy(Rows(a, previous=3), Rows(b, previous=0))",
    "GroupBy(Rows(b), Rows(a), filter=Row(a=99))",
]


@pytest.mark.parametrize("tile_mb", [256, 1], ids=["oneshot", "descent"])
def test_group_by_matches_reference(both, tile_mb, monkeypatch):
    ref_ex, port_ex = both
    monkeypatch.setenv("PILOSA_TPU_GROUPBY_TILE_MB", str(tile_mb))
    monkeypatch.setattr(tgb, "TILE_BYTES", tile_mb << 20)
    nonempty = 0
    for pql in GROUP_BYS:
        got = run_both(ref_ex, port_ex, pql)
        nonempty += bool(got[0])
    assert nonempty > len(GROUP_BYS) // 2
    for shards in ([1, 3], [3]):
        for pql in GROUP_BYS[-8:-4]:
            run_both(ref_ex, port_ex, pql, shards)


def test_group_by_paths(monkeypatch):
    """The one-shot path and the descent give the same groups, and each
    is taken where the tile rule says: 12 prefixes of [4, 64] words fit
    the default tile; a tile of 2 prefixes makes them descend."""
    rng = np.random.default_rng(3)
    planes = [torch.from_numpy(rng.integers(0, 2**32, (n, 4, 64), dtype=np.uint32).view(np.int32)) for n in (3, 4, 2)]
    rows = [[1, 5, 9], [0, 1, 2, 3], [7, 8]]
    filt = torch.from_numpy(rng.integers(0, 2**32, (4, 64), dtype=np.uint32).view(np.int32))
    calls = []
    real = tgb._descend
    monkeypatch.setattr(tgb, "_descend", lambda *a: calls.append(a[0]) or real(*a))
    for f in (None, filt):
        calls.clear()
        want = {}
        for i, x in enumerate(rows[0]):
            for j, y in enumerate(rows[1]):
                for k, z in enumerate(rows[2]):
                    w = planes[0][i] & planes[1][j] & planes[2][k]
                    if f is not None:
                        w = w & f
                    n = int(ob.popcount_words(w).sum())
                    if n:
                        want[(x, y, z)] = n
        assert tgb.group_by_device(planes, rows, f) == want
        assert calls == []
        monkeypatch.setattr(tgb, "TILE_BYTES", 64 * 4 * 4 * 2)
        assert tgb.group_by_device(planes, rows, f) == want
        assert calls and set(calls) == {1, 2}
        monkeypatch.setattr(tgb, "TILE_BYTES", 256 << 20)


ROWS = [
    "Rows(a)",
    "Rows(b)",
    "Rows(m)",
    "Rows(c)",
    "Rows(e)",
    "Rows(a, previous=2)",
    "Rows(a, limit=2)",
    "Rows(a, previous=1, limit=3)",
    f"Rows(b, column={SHARD_WIDTH + 17})",
    "Rows(b, column=5)",
    f"Rows(c, column={3 * SHARD_WIDTH + 1})",
    "Rows(field=m, limit=1)",
]


@pytest.mark.parametrize("shards", [None, [0], [2, 3]], ids=["all", "0", "2,3"])
def test_rows_match_reference(both, shards):
    ref_ex, port_ex = both
    for pql in ROWS:
        run_both(ref_ex, port_ex, pql, shards)


GB_ERRORS = [
    "GroupBy()",
    "GroupBy(Row(a=1))",
    "GroupBy(Rows(a), filter=3)",
    "GroupBy(Rows(nope))",
    "Rows()",
    "Rows(nope)",
]


@pytest.mark.parametrize("pql", GB_ERRORS)
def test_group_by_errors_match_reference(both, pql):
    ref_ex, port_ex = both
    with pytest.raises(Exception) as want:
        ref_ex.execute("i", pql)
    with pytest.raises(Exception) as got:
        port_ex.execute("i", pql)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, TExecError) == isinstance(want.value, JExecError)


def test_group_by_chunks_shards_over_budget(both, monkeypatch):
    """Plane stacks over the device budget split the shard list; the
    groups add across the pieces."""
    ref_ex, port_ex = both
    dcache = port_ex.holder.dcache
    monkeypatch.setattr(dcache, "budget_bytes", 4 * 6 * W * 4 * 2)
    for pql in ("GroupBy(Rows(a), Rows(b))", "GroupBy(Rows(a), Rows(m), filter=Shift(Row(a=0), n=1))"):
        run_both(ref_ex, port_ex, pql)


# ---------------------------------------------------------------------------
# the kernels' twins against the reference's XLA programs
# ---------------------------------------------------------------------------


def _words(rng, *shape):
    w = rng.integers(0, 2**32, shape, dtype=np.uint32)
    return w & rng.integers(0, 2**32, shape, dtype=np.uint32)


@pytest.mark.parametrize("g,r,s,w", [(1, 3, 2, 64), (2, 5, 3, 1000), (16, 8, 2, 32), (17, 1, 1, 7)])
def test_counts_cross_twin_matches_reference(g, r, s, w):
    rng = np.random.default_rng(g * 100 + r)
    acc, planes = _words(rng, g, s, w), _words(rng, r, s, w)
    want = np.asarray(jgb._counts_cross(jnp.asarray(acc), jnp.asarray(planes))).astype(np.int32)
    got = K.counts_cross(torch.from_numpy(acc.view(np.int32)), torch.from_numpy(planes.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the twin itself (K.counts_cross sends one prefix to rows_counts)
    got = K.counts_cross_plain(torch.from_numpy(acc.view(np.int32)), torch.from_numpy(planes.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_and_twin_matches_reference():
    rng = np.random.default_rng(21)
    acc, planes, filt = _words(rng, 3, 2, 96), _words(rng, 4, 2, 96), _words(rng, 2, 96)
    t = lambda x: torch.from_numpy(x.view(np.int32))  # noqa: E731
    gi, ri = np.array([0, 2, 2, 1]), np.array([3, 0, 1, 3])
    want = np.asarray(jgb._select_pairs(jnp.asarray(acc), jnp.asarray(planes), gi, ri))
    np.testing.assert_array_equal(K.gather_and(t(acc), gi, t(planes), ri).numpy().view(np.uint32), want)
    want = np.asarray(jgb._cross_expand(jnp.asarray(acc), jnp.asarray(planes)))
    got = K.gather_and(t(acc), np.repeat(np.arange(3), 4), t(planes), np.tile(np.arange(4), 3))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    idx = np.array([3, 1])
    want = np.asarray(jgb._select_rows_filtered(jnp.asarray(planes), idx, jnp.asarray(filt)))
    got = K.gather_and(t(planes), idx, t(filt)[None], np.zeros(2, np.int64))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    with pytest.raises(IndexError):
        K.gather_and(t(planes), [4], t(filt)[None], [0])
    with pytest.raises(ValueError):
        K.gather_and(t(planes), [0, 1], t(filt)[None], [0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        K._nvcc()
    except RuntimeError:
        pytest.skip("no nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_group_by_kernels_match_twins(cuda_device):
    """counts_cross at every chunk size (G = 2, 3, 8, 16, 17, 40; G = 1
    on rows_counts), rows past one 64-row block round, W not a multiple of
    4 or of a tile; gather_and on aligned and unaligned slabs, repeated
    indices and runs of outputs past one 16-output chunk."""
    rng = np.random.default_rng(77)
    dev = cuda_device
    t = lambda x: torch.from_numpy(x.view(np.int32))  # noqa: E731
    for g, r, s, w in [(1, 3, 5, 32768), (2, 70, 3, 4100), (3, 4, 2, 1001), (8, 5, 4, 32768),
                       (16, 8, 2, 32768), (17, 2, 3, 4096), (40, 3, 1, 33)]:
        acc, planes = t(_words(rng, g, s, w)), t(_words(rng, r, s, w))
        name = "counts_cross" if g > 1 else "rows_counts"
        before = K.LAUNCHES[name]
        got = K.counts_cross(acc.to(dev), planes.to(dev)).cpu()
        assert K.LAUNCHES[name] == before + 1
        assert torch.equal(got, K.counts_cross_plain(acc, planes))
    a, b = t(_words(rng, 5, 3, 4096)), t(_words(rng, 2, 3, 4096))
    ia, ib = [4, 0, 2, 2], [1, 1, 0, 1]
    got = K.gather_and(a.to(dev), ia, b.to(dev), ib).cpu()
    assert torch.equal(got, K.gather_and(a, ia, b, ib))
    a, b = t(_words(rng, 3, 1, 1003)), t(_words(rng, 3, 1, 1003))
    got = K.gather_and(a.to(dev), [2, 0], b.to(dev), [1, 1]).cpu()
    assert torch.equal(got, K.gather_and(a, [2, 0], b, [1, 1]))
    # a cross expansion over two 16-output chunks and a filter broadcast
    a, b = t(_words(rng, 5, 2, 2048)), t(_words(rng, 7, 2, 2048))
    for ia, ib in ((np.repeat(np.arange(5), 7), np.tile(np.arange(7), 5)), (np.arange(5)[::-1], np.zeros(5, int))):
        got = K.gather_and(a.to(dev), ia, b.to(dev), ib).cpu()
        assert torch.equal(got, K.gather_and(a, ia, b, ib))
