"""Durable holders of the port against pilosa_tpu's, on the CPU.

One seeded write sequence (staged imports, row words, PQL Set/Clear
interleaved with staged sets, int values with bit-depth growth, a mutex
field, deletes) goes through a pilosa_tpu holder and a port holder, each
on its own data dir. After close and reopen both hold the same rows,
values, rank caches and schema, their .snap, .cache, .meta.json and .wal
files are byte-identical, and each package opens the other's dir with
the same answers. max_op_n is small (snapshots) or huge (everything
replays from the WAL). Keyed indexes and fields likewise: the same keyed
writes leave identical files, `.keys.translate` logs included, and each
package opens the other's keyed dir with the same keyed answers.

The kill matrix runs this file as a worker (`python
tests/test_torch_durable.py --worker DIR POINT NTH SYNC_INTERVAL`): the
port's holder takes a seeded stream of writes, records each
acknowledgement, and SIGKILLs itself at the NTH time it reaches a fault
point. Both packages must then reopen the dir with every acknowledged
write in it.
"""

import os
import shutil
import signal
import sys
import time

import numpy as np

N_SHARDS = 3
KILL_SEED = 11


def tune(holder, max_op_n: int) -> None:
    """Set max_op_n on every view and fragment of a holder (either
    package)."""
    for idx in holder.indexes():
        for f in idx.fields(include_hidden=True):
            for v in f.views.values():
                v.max_op_n = max_op_n
                for frag in v.fragments.values():
                    frag.max_op_n = max_op_n


def kill_ops(seed: int = KILL_SEED) -> list:
    """A seeded stream of writes to index i: staged bit imports, PQL
    Set/Clear of bits, int value imports and PQL value writes."""
    rng = np.random.default_rng(seed)
    ops, set_bits = [], []
    for k in range(200):  # more than any kill point needs, on a fast host too
        kind = ("bits", "set", "clear", "values", "setv")[k % 5]
        if kind == "bits":
            cols = rng.integers(0, N_SHARDS * (1 << 20), 300)
            rows = rng.integers(0, 4, 300)
            ops.append(("bits", rows.tolist(), cols.tolist()))
            set_bits += list(zip(rows.tolist(), cols.tolist()))
        elif kind == "set":
            r, c = int(rng.integers(0, 4)), int(rng.integers(0, N_SHARDS * (1 << 20)))
            ops.append(("set", r, c))
            set_bits.append((r, c))
        elif kind == "clear":
            r, c = set_bits[int(rng.integers(0, len(set_bits)))]
            ops.append(("clear", r, c))
        elif kind == "values":
            cols = np.unique(rng.integers(0, N_SHARDS * (1 << 20), 200))
            ops.append(("values", cols.tolist(), rng.integers(-1000, 1001, len(cols)).tolist()))
        else:
            ops.append(("setv", int(rng.integers(0, N_SHARDS * (1 << 20))), int(rng.integers(-1000, 1001))))
    return ops


def _apply(holder, executor, op) -> None:
    idx = holder.index("i")
    kind = op[0]
    if kind == "bits":
        cols = np.array(op[2], np.uint64)
        idx.field("f").import_bits(np.array(op[1], np.uint64), cols)
        idx.track_columns(cols)
    elif kind == "set":
        executor.execute("i", f"Set({op[2]}, f={op[1]})")
    elif kind == "clear":
        executor.execute("i", f"Clear({op[2]}, f={op[1]})")
    elif kind == "values":
        cols = np.array(op[1], np.uint64)
        idx.field("v").import_values(cols, np.array(op[2], np.int64))
        idx.track_columns(cols)
    else:
        executor.execute("i", f"Set({op[1]}, v={op[2]})")


def _worker(data_dir: str, point: str, nth: int, sync_interval: float) -> int:
    """Write kill_ops() through the port on data_dir, appending each
    acknowledged op's index to data_dir/acked, until the fault hook kills
    the process at the nth visit of `point`."""
    from pilosa_tpu_torch import Executor, Holder
    from pilosa_tpu_torch.core import wal
    from pilosa_tpu_torch.core.field import FieldOptions

    hits = [0]

    def hook(p, path):
        if p == point:
            hits[0] += 1
            if hits[0] == nth:
                os.kill(os.getpid(), signal.SIGKILL)

    wal.GROUP_COMMIT.configure(sync_interval=sync_interval)
    holder = Holder(os.path.join(data_dir, "db"), device="cpu").open()
    idx = holder.create_index("i")
    idx.create_field("f")
    idx.create_field("v", FieldOptions(type="int", min=-1000, max=1000, bit_depth=2))
    ex = Executor(holder)
    wal.set_fault_hook(hook)
    with open(os.path.join(data_dir, "acked"), "a") as ack:
        for k, op in enumerate(kill_ops()):
            tune(holder, 400)
            _apply(holder, ex, op)
            ack.write(f"{k}\n")
            ack.flush()
            os.fsync(ack.fileno())
    time.sleep(10)  # interval mode: the syncer reaches the point later
    return 3  # never killed


# The worker runs the port alone: JAX and the reference load only below.
if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    d, pt, n, si = sys.argv[2:6]
    sys.exit(_worker(d, pt, int(n), float(si)))

import subprocess  # noqa: E402

import pytest  # noqa: E402

from pilosa_tpu.core.field import FieldOptions as JFieldOptions  # noqa: E402
from pilosa_tpu.core.holder import Holder as JHolder  # noqa: E402
from pilosa_tpu.exec import Executor as JExecutor  # noqa: E402
from pilosa_tpu_torch import Executor as TExecutor  # noqa: E402
from pilosa_tpu_torch import Holder as THolder  # noqa: E402
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions  # noqa: E402
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW  # noqa: E402

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))


def jholder(path):
    return JHolder(str(path)).open()


def tholder(path):
    return THolder(str(path), device="cpu").open()


def write_sequence(holder, executor, fo, max_op_n: int, seed: int = 3) -> None:
    """The same writes through either package (fo: its FieldOptions)."""
    rng = np.random.default_rng(seed)
    idx = holder.create_index("i")
    f = idx.create_field("f")
    m = idx.create_field("m", fo(type="mutex"))
    v = idx.create_field("v", fo(type="int", min=-1000, max=1000, bit_depth=3))
    u = idx.create_field("u", fo(type="int", min=0, max=1 << 20, bit_depth=1))
    g = idx.create_field("g", fo(cache_type="lru", cache_size=20))
    j = holder.create_index("j", track_existence=False)
    j.create_field("x").import_bits(np.arange(10, dtype=np.uint64), np.arange(10, dtype=np.uint64))
    ef = idx.existence_field()
    tune(holder, max_op_n)
    for r in range(2):  # dense rows by words
        for s in range(N_SHARDS):
            w = rng.integers(0, 2**32, WORDS_PER_ROW, dtype=np.uint32)
            if r:
                w &= rng.integers(0, 2**32, WORDS_PER_ROW, dtype=np.uint32)
            f.import_row_words(r, s, w)
            ef.import_row_words(0, s, w)
            tune(holder, max_op_n)
    high = (N_SHARDS - 1) * SHARD_WIDTH
    for k in range(4):  # staged sets interleaved with PQL Set/Clear
        cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, 3000).astype(np.uint64)
        rows = rng.integers(2, 8, len(cols)).astype(np.uint64)
        f.import_bits(rows, cols)
        idx.track_columns(cols)
        c0, c1 = int(cols[0]), int(cols[1])
        executor.execute(
            "i", f"Set({high + k}, f=2) Clear({c0}, f={int(rows[0])}) Set({c1}, f=9) Clear({k * 7}, f=0)"
        )
        g.import_bits(rng.integers(0, 40, 200).astype(np.uint64), rng.integers(0, SHARD_WIDTH, 200).astype(np.uint64))
        tune(holder, max_op_n)
    f.import_bits(np.array([3, 3], np.uint64), np.array([5, 6], np.uint64), clear=True)
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, 2000).astype(np.uint64)
    m.import_bits(rng.integers(0, 4, len(cols)).astype(np.uint64), np.concatenate([cols[:1500], cols[:500]]))
    executor.execute("i", f"Set({int(cols[0])}, m=3) Set(17, m=1)")
    tune(holder, max_op_n)
    for step, hi in enumerate((5, 1000)):  # v grows from 3 to 10 bits
        vc = np.unique(rng.integers(0, N_SHARDS * SHARD_WIDTH, 5000)).astype(np.uint64)
        v.import_values(vc, rng.integers(-hi, hi + 1, len(vc)))
        idx.track_columns(vc)
        tune(holder, max_op_n)
    uc = np.arange(0, SHARD_WIDTH, 3, dtype=np.uint64)
    u.import_values(uc, rng.integers(0, 1 << 20, len(uc)))  # dense planes
    u.import_values(uc[:100], np.full(100, 7))
    idx.track_columns(uc)
    executor.execute("i", f"Set({high + 5}, v=-999) Set(11, u=1048576) Clear({int(uc[1])}, u=0)")
    tune(holder, max_op_n)
    idx.delete_field("g")
    holder.delete_index("j")


READS = [
    "Count(Row(f=0))",
    "Count(Intersect(Row(f=1), Row(f=5)))",
    "Count(Not(Row(f=2)))",
    "Count(Union(Row(f=9), Row(m=3), Row(v > 900)))",
    "TopN(f, n=5)",
    "TopN(f, Row(f=0), n=4)",
    "TopN(m, n=3)",
    "Sum(field=v) Min(field=v) Max(field=v)",
    "Sum(Row(f=0), field=u) Max(field=u)",
    "Count(Row(v < -500)) Count(Row(u == 7))",
    "Row(f=9)",
]


def norm(result):
    if hasattr(result, "columns"):
        return ("row", [int(c) for c in result.columns()])
    if isinstance(result, list):
        return [(p.id, p.count) for p in result]
    if hasattr(result, "value") and hasattr(result, "count"):
        return ("valcount", result.value, result.count)
    return result


def answers(executor_cls, holder):
    ex = executor_cls(holder)
    return [[norm(r) for r in ex.execute("i", q)] for q in READS]


def state(holder) -> dict:
    """Every row's words, every fragment's rank-cache top, sampled int
    values and the schema."""
    out = {"schema": holder.schema()}
    for idx in holder.indexes():
        for f in idx.fields(include_hidden=True):
            for vname, v in sorted(f.views.items()):
                for shard in sorted(v.fragments):
                    frag = v.fragments[shard]
                    rows = {r: frag.row_words(r).tobytes() for r in frag.row_ids()}
                    out[(idx.name, f.name, vname, shard)] = (rows, frag.cache_top())
            if f.options.type == "int":
                cols = list(range(0, N_SHARDS * SHARD_WIDTH, SHARD_WIDTH // 16 + 1)) + [11, 2 * SHARD_WIDTH + 5]
                out[(idx.name, f.name, "values")] = [f.value(c) for c in cols]
    return out


def files(root) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("max_op_n", [50, 10**9])
def test_durable_matches_reference(tmp_path, max_op_n):
    jd, td = tmp_path / "ref", tmp_path / "port"
    ref, port = jholder(jd), tholder(td)
    write_sequence(ref, JExecutor(ref), JFieldOptions, max_op_n)
    write_sequence(port, TExecutor(port), TFieldOptions, max_op_n)
    want = state(ref)
    assert state(port) == want
    want_answers = answers(JExecutor, ref)
    assert answers(TExecutor, port) == want_answers
    ref.close()
    port.close()
    jf, tf = files(jd), files(td)
    assert sorted(tf) == sorted(jf)
    assert any(p.endswith(".wal") and b for p, b in tf.items())
    if max_op_n == 50:
        assert sum(p.endswith(".snap") for p in tf) >= 8
    assert not any(p.startswith(("j/", "i/g/")) for p in tf)  # deletes removed the files
    for p in tf:
        assert tf[p] == jf[p], p
    # each package reopens its own dir, then the other's
    for holder_of, ex_cls, d in (
        (jholder, JExecutor, jd),
        (tholder, TExecutor, td),
        (tholder, TExecutor, jd),
        (jholder, JExecutor, td),
    ):
        h = holder_of(d)
        try:
            assert state(h) == want, (holder_of.__name__, d.name)
            assert answers(ex_cls, h) == want_answers, (holder_of.__name__, d.name)
        finally:
            h.close()


def test_reopen_serves_staged_and_lazy_rows(tmp_path):
    """A reopened fragment reads snapshot rows on demand without keeping
    them, replays staged sets after the snapshot, and keeps writing."""
    h = tholder(tmp_path)
    f = h.create_index("i").create_field("f")
    rng = np.random.default_rng(0)
    cols = rng.integers(0, SHARD_WIDTH, 20000).astype(np.uint64)
    f.import_bits(np.zeros(len(cols), np.uint64), cols)  # past max_op_n: snapshot
    f.import_bits(np.ones(5, np.uint64), np.arange(5, dtype=np.uint64))  # WAL only
    h.close()
    h = tholder(tmp_path)
    frag = h.index("i").field("f").view().fragment(0)
    assert type(frag._rows).__name__ == "_LazyRows"
    assert set(frag._rows._mat) == {1}  # the replay wrote row 1
    np.testing.assert_array_equal(frag.row_positions(0), np.unique(cols).astype(np.uint32))
    assert frag.row_count(0) == len(np.unique(cols))
    assert frag.rows_device([0, 1]).shape == (2, WORDS_PER_ROW)
    assert set(frag._rows._mat) == {1}  # row 0 was only read
    assert frag.cache_top() == [(0, len(np.unique(cols))), (1, 5)]
    frag.set_bit(0, 7)
    assert 0 in frag._rows._mat
    h.close()
    h = tholder(tmp_path)
    assert h.index("i").field("f").view().fragment(0).row_count(0) == len(np.unique(np.append(cols, 7)))
    h.close()


@pytest.mark.parametrize(
    "make,named",
    [
        (lambda h: h.create_index("i").create_field("b", JFieldOptions(type="bool")), "bool"),
        (lambda h: h.create_index("i").create_field("t", JFieldOptions(type="time", time_quantum="YMD")), "time"),
        (lambda h: h.create_index("i").column_attr_store.set_attrs(1, {"a": 1}), ".col_attrs"),
        (lambda h: h.create_index("i").create_field("f").row_attr_store.set_attrs(1, {"a": 1}), ".row_attrs"),
    ],
)
def test_unported_contents_raise_by_name(tmp_path, make, named):
    """Attribute files raise naming the file; bool and time fields,
    ported since, open with the reference's options."""
    ref = jholder(tmp_path)
    make(ref)
    ref.close()
    if named in ("bool", "time"):
        h = tholder(tmp_path)
        o = h.index("i").field(named[0]).options
        assert (o.type, o.time_quantum) == (named, "YMD" if named == "time" else "")
        h.close()
        return
    with pytest.raises(NotImplementedError, match=named) as ei:
        tholder(tmp_path)
    assert str(tmp_path) in str(ei.value)


def keyed_sequence(holder, executor, fo) -> None:
    """The same keyed writes through either package: a keyed index with a
    keyed set field, a keyed mutex field and an int field, written through
    row and column keys (PQL and key-translated imports); a keyed field on
    an unkeyed index."""
    rng = np.random.default_rng(4)
    k = holder.create_index("k", keys=True)
    seg = k.create_field("seg", fo(keys=True))
    k.create_field("cty", fo(type="mutex", keys=True))
    k.create_field("spend", fo(type="int", min=0, max=1000))
    users = [f"user-{int(x)}" for x in rng.permutation(3000)]
    cols = np.asarray(k.translate_store.translate_keys(users), np.uint64)
    rows = np.asarray(seg.translate_store.translate_keys([f"s{int(x) % 5}" for x in rng.zipf(1.5, len(users))]), np.uint64)
    seg.import_bits(rows, cols)
    k.track_columns(cols)
    for j, u in enumerate(users[:40]):
        executor.execute("k", f'Set("{u}", cty="{["US", "DE", "JP"][j % 3]}") Set("{u}", spend={j * 7})')
    executor.execute("k", 'Clear("user-5", seg="s0") Set("late", seg="s9")')
    plain = holder.create_index("p")
    plain.create_field("kf", fo(keys=True))
    executor.execute("p", 'Set(3, kf="x") Set(1048580, kf="y")')


KEYED_READS = [
    ("k", 'Row(seg="s1")'),
    ("k", "TopN(seg, n=3)"),
    ("k", 'TopN(seg, Row(cty="US"))'),
    ("k", "Rows(seg)"),
    ("k", 'Rows(cty, previous="DE")'),
    ("k", "GroupBy(Rows(seg), Rows(cty))"),
    ("k", 'Sum(Row(seg="s2"), field=spend)'),
    ("p", "Rows(kf)"),
    ("p", 'Row(kf="y")'),
]


def keyed_answers(executor_cls, holder):
    ex = executor_cls(holder)
    out = []
    for index, q in KEYED_READS:
        for r in ex.execute(index, q):
            if hasattr(r, "columns"):
                out.append(([int(c) for c in r.columns()], r.keys))
            elif isinstance(r, list) and r and hasattr(r[0], "group"):
                out.append([([(fr.field, fr.row_id, fr.row_key) for fr in g.group], g.count) for g in r])
            elif isinstance(r, list) and r and hasattr(r[0], "key"):
                out.append([(p.id, p.count, p.key) for p in r])
            elif isinstance(r, list):
                out.append(list(r))
            else:
                out.append(norm(r))
    return out


def test_keyed_dirs_match_and_cross_open(tmp_path):
    """The same keyed writes through both packages leave byte-identical
    files (.keys.translate logs included), and each package opens its own
    keyed dir and the other's with the same keyed answers; a key written
    after the reopen gets the same next id in both."""
    jd, td = tmp_path / "ref", tmp_path / "port"
    ref, port = jholder(jd), tholder(td)
    keyed_sequence(ref, JExecutor(ref), JFieldOptions)
    keyed_sequence(port, TExecutor(port), TFieldOptions)
    want = keyed_answers(JExecutor, ref)
    assert keyed_answers(TExecutor, port) == want
    assert want[0][1] and want[5]  # keyed columns and groups
    ref.close()
    port.close()
    jf, tf = files(jd), files(td)
    assert sorted(tf) == sorted(jf)
    logs = [p for p in tf if p.endswith(".keys.translate")]
    assert sorted(logs) == ["k/.keys.translate", "k/cty/.keys.translate", "k/seg/.keys.translate", "p/kf/.keys.translate"]
    for p in tf:
        assert tf[p] == jf[p], p
    for k, (holder_of, ex_cls, src) in enumerate(
        ((tholder, TExecutor, jd), (jholder, JExecutor, td), (tholder, TExecutor, td))
    ):
        d = tmp_path / f"open{k}"  # each reopen writes: a copy each
        shutil.copytree(src, d)
        h = holder_of(d)
        try:
            assert keyed_answers(ex_cls, h) == want, (holder_of.__name__, src.name)
            assert ex_cls(h).execute("k", 'Set("after", seg="s1")') == [True]
            assert h.index("k").translate_store._by_key.get("after") == 3002
        finally:
            h.close()


# ---------------------------------------------------------------------------
# the kill matrix
# ---------------------------------------------------------------------------


def _expected(ops, n_acked):
    """(bits {(row, col)}, values {col: v}, columns that exist) after the
    acknowledged ops, and the bits and columns the op in flight touched
    (not checked: it may or may not have landed)."""
    bits, values, cols = set(), {}, set()
    for op in ops[:n_acked]:
        if op[0] == "bits":
            bits |= set(zip(op[1], op[2]))
            cols |= set(op[2])
        elif op[0] == "set":
            bits.add((op[1], op[2]))
            cols.add(op[2])
        elif op[0] == "clear":
            bits.discard((op[1], op[2]))
        elif op[0] == "values":
            values.update(zip(op[1], op[2]))
            cols |= set(op[1])
        else:
            values[op[1]] = op[2]
            cols.add(op[1])
    fuzzy_bits, fuzzy_cols = set(), set()
    if n_acked < len(ops):
        op = ops[n_acked]
        if op[0] == "bits":
            fuzzy_bits = set(zip(op[1], op[2]))
            fuzzy_cols = set(op[2])
        elif op[0] in ("set", "clear"):
            fuzzy_bits = {(op[1], op[2])}
            fuzzy_cols = {op[2]}
        elif op[0] == "values":
            fuzzy_cols = set(op[1])
        else:
            fuzzy_cols = {op[1]}
    return bits, values, cols, fuzzy_bits, fuzzy_cols


def _check_acked(h, ops, n_acked):
    bits, values, cols, fuzzy_bits, fuzzy_cols = _expected(ops, n_acked)
    idx = h.index("i")
    view = idx.field("f").view()
    got = set()
    for shard in view.available_shards():
        frag = view.fragment(shard)
        for r in range(4):
            got |= {(r, int(c) + shard * SHARD_WIDTH) for c in frag.row_positions(r)}
    assert got - fuzzy_bits == bits - fuzzy_bits
    v = idx.field("v")
    for c, val in values.items():
        if c not in fuzzy_cols:
            assert v.value(c) == (val, True), c
    ev = idx.existence_field().view()
    exists = set()
    for shard in ev.available_shards():
        exists |= {int(c) + shard * SHARD_WIDTH for c in ev.fragment(shard).row_positions(0)}
    assert cols - fuzzy_cols <= exists


@pytest.mark.parametrize(
    "point,nth,sync_interval",
    [
        ("wal.write", 40, 0.0),
        ("wal.write", 40, 0.05),
        ("wal.commit.post_fsync", 12, 0.0),
        # in interval mode the background syncer reaches the point
        ("wal.commit.post_fsync", 4, 0.05),
        ("snapshot.pre_truncate", 6, 0.0),
        ("snapshot.pre_truncate", 6, 0.05),
    ],
)
def test_kill_keeps_acknowledged_writes(tmp_path, point, nth, sync_interval):
    p = subprocess.run(
        [sys.executable, HERE, "--worker", str(tmp_path), point, str(nth), str(sync_interval)],
        cwd=REPO, capture_output=True, text=True, timeout=240,
    )
    assert p.returncode == -signal.SIGKILL, (p.returncode, p.stderr[-2000:])
    with open(tmp_path / "acked") as f:
        n_acked = sum(1 for line in f.read().split("\n")[:-1] if line)
    ops = kill_ops()
    assert 0 < n_acked < len(ops) or point == "wal.commit.post_fsync", n_acked
    db = tmp_path / "db"
    assert any(n.endswith(".wal") and os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(db) for n in ns)
    snapshot = None
    for holder_of in (tholder, jholder):
        h = holder_of(db)
        try:
            _check_acked(h, ops, n_acked)
            s = state(h)
            assert snapshot is None or s == snapshot, "the two packages read the dir differently"
            snapshot = s
        finally:
            h.close()
