"""The port's executor against pilosa_tpu's on the same data: every count,
result row and TopN list (in order) must be identical.

Data is made with numpy from a seed and loaded into a pilosa_tpu holder;
the port's holder is built from that holder's exported state through
pilosa_tpu_torch.compat.holder_from_numpy, so both answer over identical
bits (and identical sparse/dense row representations). A second test
drives the same ingest calls through both packages' APIs (staged
import_bits, word imports, mutex imports, PQL Set/Clear) and compares
again. The port runs on the CPU here (its kernels' plain twins).
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.core.row import Row as JRow
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec.executor import ExecError as JExecError
from pilosa_tpu.exec.translation import TranslationError
from pilosa_tpu_torch import ExecError as TExecError
from pilosa_tpu_torch import Executor as TExecutor
from pilosa_tpu_torch import Holder as THolder
from pilosa_tpu_torch.compat import holder_from_numpy
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.row import Row as TRow
from pilosa_tpu_torch.exec.translation import TranslationError as TTranslationError
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

REPO = pathlib.Path(__file__).resolve().parent.parent
N_SHARDS = 4


def export_state(h) -> dict:
    """A pilosa_tpu holder's rows as holder_from_numpy's plain state."""
    state = {}
    for idx in h.indexes():
        fields = {}
        for f in idx.fields(include_hidden=True):
            views = {}
            for vname, v in f.views.items():
                shards = {}
                for shard, frag in v.fragments.items():
                    rows = {}
                    for rid in frag.row_ids():
                        rb = frag._rows[rid]
                        if rb.dense is not None:
                            rows[rid] = ("dense", rb.to_words().copy())
                        elif len(rb.positions):
                            rows[rid] = ("sparse", rb.positions.copy())
                    shards[shard] = rows
                views[vname] = shards
            o = f.options
            fields[f.name] = {
                "type": o.type,
                "cache_type": o.cache_type,
                "cache_size": o.cache_size,
                "views": views,
            }
            if o.type == "int":
                fields[f.name].update(min=o.min, max=o.max, base=o.base, bit_depth=o.bit_depth)
        state[idx.name] = {"track_existence": idx.track_existence, "fields": fields}
    return state


def ingest(holder, field_options, seed: int, n_shards: int = N_SHARDS) -> None:
    """The same ingest calls for either package: dense rows by words,
    sparse rows through the staged import_bits, a mutex field, and an
    index without existence tracking."""
    rng = np.random.default_rng(seed)
    idx = holder.create_index("i", track_existence=True)
    f = idx.create_field("f")
    g = idx.create_field("g")
    m = idx.create_field("m", field_options(type="mutex"))
    ef = idx.existence_field()
    for r in range(4):  # dense rows, density 2^-(1 + r); row 3 absent from shard 2
        for s in range(n_shards):
            if r == 3 and s == 2:
                continue
            w = rng.integers(0, 2**32, WORDS_PER_ROW, dtype=np.uint32)
            for _ in range(r):
                w &= rng.integers(0, 2**32, WORDS_PER_ROW, dtype=np.uint32)
            f.import_row_words(r, s, w)
            ef.import_row_words(0, s, w)
    all_cols = []
    for r in range(4, 12):  # sparse rows, some only in a few shards
        shards = rng.choice(n_shards, size=int(rng.integers(1, n_shards + 1)), replace=False)
        cols = np.concatenate(
            [
                rng.integers(0, SHARD_WIDTH, int(rng.integers(50, 400))).astype(np.uint64)
                + np.uint64(s) * np.uint64(SHARD_WIDTH)
                for s in shards
            ]
        )
        f.import_bits(np.full(len(cols), r, np.uint64), cols)
        all_cols.append(cols)
    for r in range(3):
        cols = rng.integers(0, n_shards * SHARD_WIDTH, 30000).astype(np.uint64)
        g.import_bits(np.full(len(cols), r, np.uint64), cols)
        all_cols.append(cols)
    cols = rng.integers(0, n_shards * SHARD_WIDTH, 4000).astype(np.uint64)
    cols = np.concatenate([cols, cols[:500]])  # re-set columns: last write wins
    m.import_bits(rng.integers(0, 4, len(cols)).astype(np.uint64), cols)
    all_cols.append(cols)
    idx.track_columns(np.concatenate(all_cols))
    plain = holder.create_index("plain", track_existence=False)
    pf = plain.create_field("f")
    cols = rng.integers(0, 2 * SHARD_WIDTH, 2000).astype(np.uint64)
    pf.import_bits(rng.integers(0, 3, len(cols)).astype(np.uint64), cols)


def norm(result):
    if isinstance(result, (JRow, TRow)):
        return ("row", [int(c) for c in result.columns()])
    if isinstance(result, list):
        return [(p.id, p.count) for p in result]
    return result


def run_both(ref_ex, port_ex, pql, shards=None, index="i"):
    want = [norm(r) for r in ref_ex.execute(index, pql, shards=shards)]
    got = [norm(r) for r in port_ex.execute(index, pql, shards=shards)]
    assert got == want, f"{pql} shards={shards}"
    return got


@pytest.fixture(scope="module")
def loaded():
    ref = JHolder(None).open()
    ingest(ref, JFieldOptions, seed=7)
    port = holder_from_numpy(export_state(ref), device="cpu")
    return JExecutor(ref), TExecutor(port)


READS = [
    "Count(Row(f=0))",
    "Count(Row(f=99))",
    "Count(Intersect(Row(f=1), Row(g=0)))",
    "Count(Union(Row(f=0), Row(f=5), Row(g=1)))",
    "Count(Difference(Row(f=2), Row(g=0), Row(f=6)))",
    "Count(Xor(Row(f=3), Row(f=7)))",
    "Count(Not(Row(f=1)))",
    "Count(Not(Union(Row(f=4), Row(m=1))))",
    "Count(All())",
    "Count(Shift(Row(f=4), n=1))",
    "Count(Shift(Row(f=0), n=33))",
    "Count(Shift(Shift(Row(f=5), n=2), n=31))",
    "Count(Intersect(Union(Row(f=0), Row(f=4)), Not(Difference(Row(g=0), Row(f=9)))))",
    "Count(Intersect(Row(f=1), Row(f=99)))",
    "Count(Difference(Row(f=99), Row(f=1)))",
    "Count(Union(Row(f=98), Row(f=99)))",
    "Count(Row(m=2))",
    "Row(f=4)",
    "Row(f=99)",
    "Intersect(Row(f=0), Row(g=1))",
    "Xor(Row(f=6), Shift(Row(f=6), n=7))",
    "Shift(Row(f=4), n=1)",
    "Not(Row(m=1))",
    "Count(Row(f=0)) Count(Row(g=1)) Count(Not(Row(f=2)))",
    "Count(Row(f=1)) Count(Shift(Row(f=1), n=1))",
    "Count(Row(f=77)) Count(Row(f=78))",
    "TopN(f)",
    "TopN(f, n=3)",
    "TopN(f, n=3, threshold=40000)",
    "TopN(f, ids=[0, 4, 5, 99])",
    "TopN(f, Row(g=0), n=5)",
    "TopN(f, Row(g=0))",
    "TopN(f, Intersect(Row(g=0), Row(g=1)), n=4, threshold=2)",
    "TopN(f, Row(g=1), ids=[1, 4, 6])",
    "TopN(f, Row(g=0), n=3, tanimotoThreshold=10)",
    "TopN(f, Row(f=99), n=3)",
    "TopN(f, Shift(Row(g=0), n=1), n=4)",
    "TopN(m, n=2)",
    "TopN(m, Row(f=0), n=2)",
]


@pytest.mark.parametrize("shards", [None, [1, 3], [0, 2], [3]], ids=["all", "1,3", "0,2", "3"])
def test_reads_match_reference(loaded, shards):
    ref_ex, port_ex = loaded
    for pql in READS:
        run_both(ref_ex, port_ex, pql, shards)


def test_reads_without_existence(loaded):
    ref_ex, port_ex = loaded
    for pql in ["Count(Row(f=1))", "Row(f=2)", "TopN(f, n=2)", "TopN(f, Row(f=0), n=2)"]:
        run_both(ref_ex, port_ex, pql, index="plain")
    with pytest.raises(JExecError):
        ref_ex.execute("plain", "Count(Not(Row(f=1)))")
    with pytest.raises(TExecError):
        port_ex.execute("plain", "Count(Not(Row(f=1)))")


ERRORS = [
    "Count(Row(nope=1))",
    "Count(Intersect())",
    "Count(Row(f=1), Row(f=2))",
    "TopN(f, Row(g=0), Row(g=1))",
    "TopN(nope)",
    "Row(f=1, from='2019-01-01T00:00', to='2020-01-01T00:00')",
    "Row(f > 5)",
    "Shift(Row(f=1), Row(f=2))",
    "Not(Row(f=1), Row(f=2))",
    "Row(f='a')",
    "Set(1, f='a')",
]


@pytest.mark.parametrize("pql", ERRORS)
def test_errors_match_reference(loaded, pql):
    ref_ex, port_ex = loaded
    # string keys on unkeyed fields fail translation in both packages,
    # with the same error type and message
    with pytest.raises((JExecError, TranslationError)) as want:
        ref_ex.execute("i", pql)
    with pytest.raises((TExecError, TTranslationError)) as got:
        port_ex.execute("i", pql)
    if isinstance(want.value, TranslationError):
        assert isinstance(got.value, TTranslationError) and str(got.value) == str(want.value)


def test_unported_calls_raise(loaded):
    """The attribute calls and Options, MinRow, MaxRow and ClearRow (on a
    row that holds no bit, so the shared holder's bits stay as they are),
    Rows and GroupBy, all ported since, give the reference's answers: the
    same results, the same row attrs and column attr sets in the JSON."""
    from pilosa_tpu.server import wire as jwire
    from pilosa_tpu_torch.server import wire as twire

    ref_ex, port_ex = loaded
    for pql in ["SetRowAttrs(f, 1, a=1)", "SetColumnAttrs(1, a=1)", "Options(Row(f=1), shards=[0])"]:
        want = ref_ex.execute_response("i", pql)
        got = port_ex.execute_response("i", pql)
        assert [twire.result_to_public_json(r) for r in got.results] == [
            jwire.result_to_public_json(r) for r in want.results
        ], pql
        assert got.column_attr_sets == want.column_attr_sets is None
    for pql in ["MinRow(field=f)", "MaxRow(field=f)", "MaxRow(Row(g=0), field=f)", "ClearRow(f=99)"]:
        assert port_ex.execute("i", pql) == ref_ex.execute("i", pql), pql
    for pql in ["GroupBy(Rows(f))", "Rows(f)"]:
        want = ref_ex.execute("i", pql)[0]
        got = port_ex.execute("i", pql)[0]
        if pql.startswith("GroupBy"):
            want = [([(fr.field, fr.row_id) for fr in g.group], g.count) for g in want]
            got = [([(fr.field, fr.row_id) for fr in g.group], g.count) for g in got]
        assert got == want and len(got) > 5, pql


WRITES = [
    "Set(5, f=1)",
    "Set(5, f=1)",
    f"Set({SHARD_WIDTH + 9}, g=0) Set({3 * SHARD_WIDTH + 1}, f=300)",
    "Clear(5, f=1)",
    "Clear(6, f=1)",
    "Set(7, m=1) Set(7, m=2)",
    f"Set({5 * SHARD_WIDTH + 3}, f=4)",
    "Clear(7, m=2)",
]


def test_same_ingest_and_writes_match_reference():
    """Both packages take the same ingest calls and PQL writes; every
    write result and every read after them must agree."""
    ref, port = JHolder(None).open(), THolder(device="cpu")
    ingest(ref, JFieldOptions, seed=11)
    ingest(port, TFieldOptions, seed=11)
    ref_ex, port_ex = JExecutor(ref), TExecutor(port)
    for pql in READS[:12] + READS[26:]:
        run_both(ref_ex, port_ex, pql)
    for pql in WRITES:
        run_both(ref_ex, port_ex, pql)
    for pql in READS:
        run_both(ref_ex, port_ex, pql)


def test_sparse_view_compaction_matches_reference():
    """70 shards with f present in three of them: the stacked lowering
    compacts the shard axis (SparseView) on both sides."""
    ref, port = JHolder(None).open(), THolder(device="cpu")
    rng = np.random.default_rng(3)
    g_cols = rng.integers(0, 70 * SHARD_WIDTH, 20000).astype(np.uint64)
    f_cols = np.concatenate(
        [rng.integers(0, SHARD_WIDTH, 300).astype(np.uint64) + np.uint64(s * SHARD_WIDTH) for s in (0, 30, 69)]
    )
    f_rows = rng.integers(0, 3, len(f_cols)).astype(np.uint64)
    for h in (ref, port):
        idx = h.create_index("i")
        idx.create_field("g").import_bits(np.zeros(len(g_cols), np.uint64), g_cols)
        idx.create_field("f").import_bits(f_rows, f_cols)
        idx.track_columns(np.concatenate([g_cols, f_cols]))
    ref_ex, port_ex = JExecutor(ref), TExecutor(port)
    for pql in [
        "Count(Row(f=1))",
        "Count(Intersect(Row(f=1), Row(g=0)))",
        "Count(Shift(Row(f=2), n=5))",
        "Row(f=0)",
        "TopN(f, Row(g=0), n=2)",
        "Count(Row(f=0)) Count(Row(f=2))",
    ]:
        run_both(ref_ex, port_ex, pql)


def test_wide_and_deep_trees_match_reference():
    """Counts over 40 distinct rows, and a tree nested 40 deep, run as one
    plan_count program on the port and equal the reference."""
    ref, port = JHolder(None).open(), THolder(device="cpu")
    rng = np.random.default_rng(5)
    cols = rng.integers(0, 3 * SHARD_WIDTH, 40 * 600).astype(np.uint64)
    rows = np.repeat(np.arange(40, dtype=np.uint64), 600)
    for h in (ref, port):
        idx = h.create_index("i", track_existence=True)
        idx.create_field("w").import_bits(rows, cols)
        idx.track_columns(cols)
    ref_ex, port_ex = JExecutor(ref), TExecutor(port)
    w = [f"Row(w={r})" for r in range(40)]
    deep = w[0]
    for d in range(1, 40):
        call = ("Intersect", "Union", "Xor", "Difference")[d % 4]
        deep = f"{call}({deep}, {w[d]})" if d % 3 else f"{call}({w[d]}, {deep})"
    for pql in [
        f"Count(Union({', '.join(w)}))",
        f"Count(Xor({', '.join(w)}))",
        f"Count(Difference(Row(w=39), Union({', '.join(w[:35])})))",
        f"Count(Not(Union({', '.join(w[:36])})))",
        f"Count({deep})",
        f"Count(Union({', '.join(w)})) Count({deep})",
        f"TopN(w, Union({', '.join(w[:34])}), n=5)",
    ]:
        run_both(ref_ex, port_ex, pql)


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------


def test_import_leaves_jax_out():
    code = (
        "import sys, pilosa_tpu_torch, pilosa_tpu_torch.compat, pilosa_tpu_torch.server, "
        "pilosa_tpu_torch.cli, pilosa_tpu_torch.sched, pilosa_tpu_torch.exec.batcher, "
        "pilosa_tpu_torch.core.resultcache, pilosa_tpu_torch.hbm.prefetch; print('jax' in sys.modules)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True
    )
    assert out.stdout.strip() == "False"


def test_no_reference_imports():
    pattern = re.compile(r"(import|from)\s+pilosa_tpu(?!_torch)\b")
    files = list((REPO / "pilosa_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        assert not pattern.search(text), path
        assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path


def test_holder_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        THolder()
    assert THolder(device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# the kernel-backed layers one by one, on the same loaded data
# ---------------------------------------------------------------------------


PLAN_CALLS = [
    "Intersect(Row(f=1), Row(g=0))",
    "Union(Row(f=0), Row(f=5), Row(g=1))",
    "Not(Row(f=1))",
    "Shift(Row(f=4), n=1)",
]


@pytest.mark.parametrize("pql", PLAN_CALLS)
def test_plan_modes_match_reference(loaded, pql):
    """StackedPlan count/total/shard_counts/rows over the plan_count kernel
    (twin here) against the reference StackedPlan on the same call."""
    from pilosa_tpu_torch.pql import parse as tparse
    from pilosa_tpu.pql import parse as jparse

    ref_ex, port_ex = loaded
    jidx, tidx = ref_ex.holder.index("i"), port_ex.holder.index("i")
    shards = ref_ex._shards_for(jidx, None, jparse(pql).calls[0])
    assert shards == port_ex._shards_for(tidx, None, tparse(pql).calls[0])

    def both():
        jp = ref_ex._lower_stacked(jidx, jparse(pql).calls[0], shards)
        (tp,) = port_ex._lower_plans(tidx, tparse(pql).calls[0], shards)
        return jp, tp

    jp, tp = both()
    assert tp.count() == jp.count()
    jp, tp = both()
    assert tp.total() == jp.total()
    jp, tp = both()
    np.testing.assert_array_equal(tp.shard_counts(), np.asarray(jp.shard_counts()).astype(np.int64))
    jp, tp = both()
    np.testing.assert_array_equal(tp.rows().numpy().view(np.uint32), np.asarray(jp.rows()))


def test_multicount_plan_matches_reference(loaded):
    from pilosa_tpu.exec.plan import MultiCountPlan as JMulti
    from pilosa_tpu.pql import parse as jparse
    from pilosa_tpu_torch.exec.plan import MultiCountPlan as TMulti
    from pilosa_tpu_torch.pql import parse as tparse

    ref_ex, port_ex = loaded
    jidx, tidx = ref_ex.holder.index("i"), port_ex.holder.index("i")
    calls = " ".join(PLAN_CALLS[:3])
    shards = list(range(N_SHARDS))
    for method in ("counts", "totals"):
        roots, low, n, out = ref_ex._lower_roots(jidx, jparse(calls).calls, shards)
        want = getattr(JMulti(roots, low.operands, low.scalars, n, out, extents=low.extents), method)()
        roots, low, n, out = port_ex._lower_roots(tidx, tparse(calls).calls, shards)
        assert getattr(TMulti(roots, low.operands, n, out), method)() == want


def test_row_count_and_fragment_row_counts_match_reference(loaded):
    """Row.count() (popcount kernel) and Fragment.row_counts (rows_counts
    kernel, with and without a filter row) against the reference."""
    ref_ex, port_ex = loaded
    for pql in ["Row(f=0)", "Union(Row(f=4), Row(g=2))", "Row(f=99)"]:
        (jr,) = ref_ex.execute("i", pql)
        (tr,) = port_ex.execute("i", pql)
        assert tr.count() == jr.count()
    jv = ref_ex.holder.index("i").field("f").view()
    tv = port_ex.holder.index("i").field("f").view()
    ids = list(range(13))
    for shard in range(N_SHARDS):
        jf, tf = jv.fragment_if_exists(shard), tv.fragment_if_exists(shard)
        np.testing.assert_array_equal(tf.row_counts(ids), jf.row_counts(ids))
        filt = jf.row_words(1)
        np.testing.assert_array_equal(
            tf.row_counts(ids, torch.from_numpy(filt.view(np.int32).copy())),
            jf.row_counts(ids, filt),
        )
        assert [tf.row_count(r) for r in ids] == [jf.row_count(r) for r in ids]
        jc, jl = jf.rows_sparse_concat(ids)
        tc, tl = tf.rows_sparse_concat(ids)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize(
    "pql",
    ["Row(f=1)", "Intersect(Row(f=0), Row(g=1))", "Shift(Row(f=4), n=1)", "Shift(Row(f=0), n=33)", "Row(f=99)"],
)
@pytest.mark.parametrize("shards", [None, [1, 3]], ids=["all", "1,3"])
def test_row_count_matches_reference(loaded, pql, shards, monkeypatch):
    """Row.count() after Row()/Intersect()/Shift() equals pilosa_tpu's
    Row.count() on the same data, counting every segment in one
    count2_segments call (one launch on the card)."""
    from pilosa_tpu_torch.ops import kernels

    ref_ex, port_ex = loaded
    (jr,) = ref_ex.execute("i", pql, shards=shards)
    (tr,) = port_ex.execute("i", pql, shards=shards)
    calls = []
    real = kernels.count2_segments
    monkeypatch.setattr(kernels, "count2_segments", lambda *a: calls.append(len(a[0])) or real(*a))
    assert tr.count() == jr.count()
    assert calls == ([len(tr.segments)] if tr.segments else [])


def test_counts_cross_matches_reference(loaded):
    """The filtered-TopN dense tally (kernels.counts_cross with one
    prefix, the rows_counts kernel) against the reference _counts_cross
    on the same stacks."""
    import jax.numpy as jnp

    from pilosa_tpu.exec import groupby as jgb
    from pilosa_tpu_torch.ops import kernels

    ref_ex, port_ex = loaded
    shards = tuple(range(N_SHARDS))
    jv = ref_ex.holder.index("i").field("f").view()
    tv = port_ex.holder.index("i").field("f").view()
    src = port_ex.holder.index("i").field("g").view().row_stack(0, shards)
    want = jgb._counts_cross(
        jnp.asarray(src.numpy().view(np.uint32))[None], jv.plane_stack((0, 2, 5), shards)
    )[0]
    got = kernels.counts_cross(src[None], tv.plane_stack((0, 2, 5), shards))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))


def test_topn_tally_shard_major_matches_row_major_reference(loaded):
    """The filtered-TopN sparse tally: the port's shard-major bundle
    (segment j * n_sparse + k for shard j, sparse row k) through
    gather_tally and the [n_present, n_sparse] -> [n_sparse, n_present]
    transpose gives the reference's tallies, which gather_tally_sorted
    computes over its row-major bundle (segment k * s_pow2 + j); so does
    the whole tally, dense rows included."""
    import jax.numpy as jnp

    from pilosa_tpu.ops import bitmap as jb
    from pilosa_tpu_torch.ops import kernels

    ref_ex, port_ex = loaded
    shards = tuple(range(N_SHARDS))
    jv = ref_ex.holder.index("i").field("f").view()
    tv = port_ex.holder.index("i").field("f").view()
    src = port_ex.holder.index("i").field("g").view().row_stack(0, shards)
    jsrc = jnp.asarray(src.numpy().view(np.uint32))
    jpresent = [(s, jv.fragment_if_exists(s)) for s in shards]
    tpresent = [(s, tv.fragment_if_exists(s)) for s in shards]
    cand = list(range(12))
    jbundle = ref_ex._topn_tally_build(cand, jpresent, WORDS_PER_ROW)
    tbundle = TExecutor._topn_tally_build(cand, tpresent, WORDS_PER_ROW, src.device)
    assert (tbundle.dense_rows, tbundle.sparse_rows) == (jbundle.dense_rows, jbundle.sparse_rows)
    n_sparse, n_present = len(tbundle.sparse_rows), len(shards)
    assert n_sparse >= 4 and tbundle.dense_rows
    idx, mask, starts, ends = (x.numpy() for x in tbundle.dev)
    assert starts.size == n_present * n_sparse and np.all(starts[1:] == ends[:-1])
    for seg in range(starts.size):  # shard-major: segment seg holds shard seg // n_sparse
        assert np.all(idx[starts[seg] : ends[seg]] // WORDS_PER_ROW == seg // n_sparse)
    got = kernels.gather_tally(src, *tbundle.dev).reshape(n_present, n_sparse).T
    j_idx, j_mask, j_starts, j_ends, r_pad, s_pow2 = jbundle.dev
    want = np.asarray(jb.gather_tally_sorted(jsrc, j_idx, j_mask, j_starts, j_ends))
    want = want.reshape(r_pad, s_pow2)[:n_sparse, :n_present]
    assert want.any()
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    order, fused = port_ex._topn_icounts_raw(tv, cand, tpresent, src)
    j_order, j_fused, _ = ref_ex._topn_icounts_raw(jv, cand, jpresent, jsrc)
    assert order == j_order
    np.testing.assert_array_equal(fused, j_fused)
