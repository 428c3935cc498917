"""Row and column attributes and Options in the port, against pilosa_tpu
on the same inputs.

- AttrStore (pilosa_tpu_torch/core/attrs.py) against the reference's:
  set, merge and None delete, bulk imports, replay of each other's
  files, a torn last log line truncated at the same offset, compaction,
  blocks and checksums; the files are byte-identical.
- executor: randomized SetRowAttrs, SetColumnAttrs, Options, Row,
  TopN(attrName=, attrValues=) and the query options over several seeds,
  on an unkeyed and a keyed index; results, row attrs, column attr sets
  and error texts must be identical.
- HTTP: the same session against both servers gives byte-identical
  bodies.

The port runs on the CPU here (its kernels' plain twins).
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import http.client
import json
import os

import numpy as np
import pytest

from pilosa_tpu.core import attrs as jattrs
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.exec.executor import ExecOptions as JExecOptions
from pilosa_tpu.server import wire as jwire
from pilosa_tpu.server.node import NodeServer as JNodeServer
from pilosa_tpu_torch import Executor as TExecutor
from pilosa_tpu_torch import Holder as THolder
from pilosa_tpu_torch.core import attrs as tattrs
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.exec.executor import ExecOptions as TExecOptions
from pilosa_tpu_torch.server import NodeServer as TNodeServer
from pilosa_tpu_torch.server import wire as twire
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

SEEDS = [0, 1, 2, 3, 4]
N_SHARDS = 3


# ---------------------------------------------------------------------------
# AttrStore
# ---------------------------------------------------------------------------


def random_attrs(rng, allow_none: bool = True) -> dict:
    out = {}
    for _ in range(int(rng.integers(1, 4))):
        key = f"k{int(rng.integers(0, 6))}"
        kind = int(rng.integers(0, 5 if allow_none else 4))
        out[key] = [
            lambda: f"s{int(rng.integers(0, 9))}",
            lambda: int(rng.integers(-(2**40), 2**40)),
            lambda: float(rng.integers(0, 1000)) / 8,
            lambda: bool(rng.integers(0, 2)),
            lambda: None,
        ][kind]()
    return out


def store_ops(rng, n: int) -> list:
    """A random sequence of ("set", id, attrs) and ("bulk", {id: attrs})."""
    ops = []
    for _ in range(n):
        if rng.random() < 0.15:
            ops.append(("bulk", {int(rng.integers(0, 450)): random_attrs(rng) for _ in range(int(rng.integers(1, 6)))}))
        else:
            ops.append(("set", int(rng.integers(0, 450)), random_attrs(rng)))
    return ops


def apply(store, ops) -> None:
    for op in ops:
        if op[0] == "set":
            store.set_attrs(op[1], op[2])
        else:
            store.set_bulk_attrs(op[1])


def state(store) -> tuple:
    blocks = store.blocks()
    return (
        {i: store.attrs(i) for i in store.ids()},
        blocks,
        [store.block_data(b["id"]) for b in blocks],
        [store.block_checksum(b["id"]) for b in blocks] + [store.block_checksum(99)],
    )


def files(d) -> dict:
    return {fn: open(os.path.join(d, fn), "rb").read() for fn in sorted(os.listdir(d))}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("threshold", [jattrs.COMPACT_THRESHOLD, 7], ids=["log", "compacting"])
def test_attr_store_matches_reference(tmp_path, monkeypatch, seed, threshold):
    """The same writes through both stores give the same attrs, blocks,
    checksums and files (compacting every 7 lines, or never); each
    package reopens the other's files with the same state and keeps
    writing to them."""
    monkeypatch.setattr(jattrs, "COMPACT_THRESHOLD", threshold)
    monkeypatch.setattr(tattrs, "COMPACT_THRESHOLD", threshold)
    rng = np.random.default_rng(seed)
    ops = store_ops(rng, 60)
    dj, dt = tmp_path / "ref", tmp_path / "port"
    js, ts = jattrs.AttrStore(str(dj / "a.json")), tattrs.AttrStore(str(dt / "a.json"))
    assert tattrs.AttrStore(None).attrs(3) == {} and tattrs.AttrStore(None).ids() == []
    apply(js, ops)
    apply(ts, ops)
    assert state(ts) == state(js)
    assert files(dt) == files(dj)
    assert ts.ids_array().tolist() == js.ids()
    js.close()
    ts.close()
    # cross replay, then more writes on the other's files
    more = store_ops(rng, 20)
    t2, j2 = tattrs.AttrStore(str(dj / "a.json")), jattrs.AttrStore(str(dt / "a.json"))
    assert state(t2) == state(j2) == state(js)
    apply(t2, more)
    apply(j2, more)
    assert files(dj) == files(dt)
    t2.close()
    j2.close()
    assert state(jattrs.AttrStore(str(dj / "a.json"))) == state(tattrs.AttrStore(str(dt / "a.json")))


@pytest.mark.parametrize("cut", [1, 5, 17, -1])
def test_torn_attr_log_truncated_like_reference(tmp_path, cut):
    """A log whose last line lost its tail (or its newline) opens in both
    packages with the same state, truncated at the same offset; the next
    append starts a fresh line."""
    rng = np.random.default_rng(cut + 10)
    src = tmp_path / "src"
    s = jattrs.AttrStore(str(src / "a.json"))
    apply(s, store_ops(rng, 12))
    s.close()
    log = (src / "a.json.log").read_bytes()
    last = log[: -1].rfind(b"\n") + 1
    torn = log[: len(log) + cut] if cut < 0 else log[: last + cut]
    assert torn != log and not torn.endswith(b"\n")
    results = []
    for pkg in (jattrs, tattrs):
        d = tmp_path / pkg.__name__.split(".")[0]
        d.mkdir()
        (d / "a.json.log").write_bytes(torn)
        st = pkg.AttrStore(str(d / "a.json"))
        size = (d / "a.json.log").stat().st_size
        st.set_attrs(999, {"z": 1})
        st.close()
        results.append((state(st), size, (d / "a.json.log").read_bytes()))
    assert results[0] == results[1]
    assert results[0][1] == last
    assert state(tattrs.AttrStore(str(tmp_path / "pilosa_tpu" / "a.json")))[0][999] == {"z": 1}


# ---------------------------------------------------------------------------
# executor differential
# ---------------------------------------------------------------------------


def ingest(holder, executor, fo, keyed: bool, seed: int):
    """Set field f (rows 0-7, some dense), g, a mutex m and an int v over
    N_SHARDS shards; keyed: column keys c<N> and row keys r<N> on f."""
    rng = np.random.default_rng(seed)
    idx = holder.create_index("i", keys=keyed)
    f = idx.create_field("f", fo(keys=keyed))
    g = idx.create_field("g")
    idx.create_field("m", fo(type="mutex"))
    idx.create_field("v", fo(type="int", min=-100, max=100))
    width = N_SHARDS * SHARD_WIDTH
    if keyed:
        q = []
        for k in range(400):
            q.append(f'Set("c{int(rng.integers(0, 300))}", f="r{int(rng.integers(0, 6))}")')
            if k % 3 == 0:
                q.append(f'Set("c{int(rng.integers(0, 300))}", g={int(rng.integers(0, 3))})')
        executor.execute("i", " ".join(q))
        return idx
    for r in range(8):
        cols = rng.integers(0, width, 5000 if r < 2 else 300).astype(np.uint64)
        f.import_bits(np.full(len(cols), r, np.uint64), cols)
        idx.track_columns(cols)
    cols = rng.integers(0, width, 2000).astype(np.uint64)
    g.import_bits(rng.integers(0, 3, len(cols)).astype(np.uint64), cols)
    idx.field("m").import_bits(rng.integers(0, 4, len(cols)).astype(np.uint64), cols)
    idx.field("v").import_values(cols[:500], rng.integers(-100, 101, 500))
    idx.track_columns(cols)
    return idx


def both(keyed: bool, seed: int):
    ref, port = JHolder(None).open(), THolder(device="cpu")
    ref_ex, port_ex = JExecutor(ref), TExecutor(port)
    ingest(ref, ref_ex, JFieldOptions, keyed, seed)
    ingest(port, port_ex, TFieldOptions, keyed, seed)
    return ref_ex, port_ex


def pql_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, str):
        return json.dumps(v)
    return repr(v)


def random_query(rng, keyed: bool, cols: list) -> str:
    """One random call of the attribute plane."""
    row = (lambda: f'"r{int(rng.integers(0, 7))}"') if keyed else (lambda: str(int(rng.integers(0, 9))))
    col = (lambda: f'"c{int(rng.integers(0, 300))}"') if keyed else (lambda: str(int(rng.choice(cols))))
    attrs = lambda: ", ".join(f"{k}={pql_value(v)}" for k, v in random_attrs(rng).items())  # noqa: E731
    flag = lambda: "true" if rng.random() < 0.5 else "false"  # noqa: E731
    k = int(rng.integers(0, 11))
    if k == 0:
        return f"SetRowAttrs(f, {row()}, {attrs()})"
    if k == 1:
        return " ".join(f"SetColumnAttrs({col()}, {attrs()})" for _ in range(int(rng.integers(1, 6))))
    if k == 2:
        return f"Row(f={row()})"
    if k == 3:
        return f"Options(Row(f={row()}), columnAttrs={flag()}, excludeRowAttrs={flag()}, excludeColumns={flag()})"
    if k == 4:
        shards = [[0], [1, 2], [0, 3]][int(rng.integers(0, 3))]
        return f"Options(Union(Row(f={row()}), Row(g=1)), shards={shards})"
    if k == 5:
        vals = ", ".join(pql_value(v) for v in random_attrs(rng, allow_none=False).values())
        key = f"k{int(rng.integers(0, 6))}"
        n = int(rng.integers(0, 5))
        filt = "" if rng.random() < 0.5 else "Row(g=0), "
        return f"TopN(f, {filt}n={n}, attrName={key}, attrValues=[{vals}])"
    if k == 6:
        return f"Options(Count(Row(f={row()})), shards=[{int(rng.integers(0, N_SHARDS))}])"
    if k == 7:
        return f"Row(f={row()}) Intersect(Row(f={row()}), Row(g=2))"
    if k == 8:
        return f"Options(Row(f={row()}), excludeRowAttrs=true) Row(f={row()})"
    if k == 9:
        rows = '"r0"), Row(f="r1"' if keyed else "0), Row(f=1"
        return f"Options(Union(Row(f={rows})), columnAttrs=true) Row(m=1)"
    return f"SetRowAttrs(f, {row()}, {attrs()}) TopN(f, Row(m=2), n=3, attrName=k1, attrValues=[1, true, \"s3\"])"


ERRORS = [
    "SetRowAttrs(nofield, 1, a=1)",
    "Options(Row(f=1), Row(f=2))",
    "Options(Row(f=1), shards=3)",
    "Options()",
    "Count(Options(Row(f=1)))",
    "Union(SetColumnAttrs(1, a=1))",
]


def response(ex, wire, pql, opt):
    try:
        resp = ex.execute_response("i", pql, opt=opt)
    except Exception as e:  # the error's type name and text must agree
        return ("error", type(e).__name__, str(e))
    return (
        json.dumps([wire.result_to_public_json(r) for r in resp.results]),
        None if resp.column_attr_sets is None else json.dumps([c.to_json() for c in resp.column_attr_sets]),
    )


@pytest.mark.parametrize("keyed", [False, True], ids=["ids", "keys"])
@pytest.mark.parametrize("seed", SEEDS)
def test_attr_queries_match_reference(seed, keyed):
    """Random attribute writes and reads, with random query options, give
    byte-identical results and column attr sets in both executors; so do
    the errors. The answers are not trivial: rows carry attrs and column
    attr sets come back."""
    ref_ex, port_ex = both(keyed, seed)
    rng = np.random.default_rng(100 + seed)
    cols = [int(c) for c in ref_ex.execute("i", "Union(Row(f=0), Row(f=1))")[0].columns()[:200]] if not keyed else []
    seen_cas = seen_attrs = 0
    for step in range(50):
        pql = random_query(rng, keyed, cols)
        flags = [bool(x) for x in rng.integers(0, 2, 3)] if step % 3 == 0 else [False] * 3
        jopt = JExecOptions(column_attrs=flags[0], exclude_row_attrs=flags[1], exclude_columns=flags[2])
        topt = TExecOptions(column_attrs=flags[0], exclude_row_attrs=flags[1], exclude_columns=flags[2])
        want = response(ref_ex, jwire, pql, jopt)
        got = response(port_ex, twire, pql, topt)
        assert got == want, pql
        seen_cas += bool(want[1] and want[1] != "[]")
        seen_attrs += '"attrs": {"' in want[0]
    assert seen_cas and seen_attrs
    for pql in ERRORS:
        assert response(port_ex, twire, pql, TExecOptions()) == response(ref_ex, jwire, pql, JExecOptions()), pql


def test_column_attrs_come_from_the_store_side():
    """columnAttrs looks the store's ids up in the Row's words: a Row of
    every column of three shards is not listed column by column."""
    h = THolder(device="cpu")
    idx = h.create_index("i")
    f = idx.create_field("f")
    cols = np.arange(0, N_SHARDS * SHARD_WIDTH, 3, dtype=np.uint64)
    f.import_bits(np.zeros(len(cols), np.uint64), cols)
    ex = TExecutor(h)
    ex.execute("i", "SetColumnAttrs(3, a=1) SetColumnAttrs(4, a=2) SetColumnAttrs(3145725, b=true)")
    from pilosa_tpu_torch.core import row as trow

    calls = []
    real = trow.Row.columns
    trow.Row.columns = lambda self: calls.append(1) or real(self)
    try:
        resp = ex.execute_response("i", "Row(f=0)", opt=TExecOptions(column_attrs=True))
    finally:
        trow.Row.columns = real
    assert not calls
    assert [c.to_json() for c in resp.column_attr_sets] == [{"attrs": {"a": 1}, "id": 3}, {"attrs": {"b": True}, "id": 3145725}]


def test_column_attrs_of_shards_far_apart_match_reference():
    """A Row with columns in shard 0 and in shard 2^40: its column attr
    sets are looked up per shard present, not over the span of shard
    ids, and equal the reference's."""
    big = 1 << 60
    pql = f"Set(3, f=0) Set({big}, f=0) Set({big + 5}, f=0) SetColumnAttrs(3, a=1) SetColumnAttrs({big}, b=true) SetColumnAttrs({big + 9}, c=2)"
    got = []
    for holder, ex_cls, opt, wire in (
        (JHolder(None).open(), JExecutor, JExecOptions, jwire),
        (THolder(device="cpu"), TExecutor, TExecOptions, twire),
    ):
        holder.create_index("i").create_field("f")
        ex = ex_cls(holder)
        ex.execute("i", pql)
        got.append(response(ex, wire, "Row(f=0)", opt(column_attrs=True)))
    assert got[1] == got[0]
    assert json.loads(got[0][1]) == [{"attrs": {"a": 1}, "id": 3}, {"attrs": {"b": True}, "id": big}]


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


def http_steps(seed: int) -> list:
    rng = np.random.default_rng(seed)
    steps = [
        ("POST", "/index/i", {}),
        ("POST", "/index/i/field/f", {}),
        ("POST", "/index/i/field/g", {}),
    ]
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, 400)
    steps.append(("POST", "/index/i/field/f/import", {"rows": (cols % 4).tolist(), "cols": cols.tolist()}))
    steps.append(("POST", "/index/i/field/g/import", {"rows": (cols % 2).tolist()[:200], "cols": cols.tolist()[:200]}))
    sets = " ".join(f"SetColumnAttrs({int(c)}, n={k}, s=\"x{k}\")" for k, c in enumerate(cols[:60]))
    steps.append(("POST", "/index/i/query", {"query": sets + ' SetRowAttrs(f, 1, color="red", w=0.5) SetRowAttrs(f, 2, color="blue")'}))
    for q, extra in [
        ("Row(f=1) Row(f=2)", {}),
        ("Row(f=1)", {"columnAttrs": True}),
        ("Row(f=1)", {"excludeRowAttrs": True, "columnAttrs": True}),
        ("Row(f=2)", {"excludeColumns": True}),
        ('TopN(f, attrName=color, attrValues=["red", "blue"]) TopN(f, Row(g=0), n=1, attrName=color, attrValues=["blue"])', {}),
        ("Options(Row(f=3), columnAttrs=true, shards=[0, 2])", {}),
    ]:
        steps.append(("POST", "/index/i/query", {"query": q, **extra}))
    return steps


@pytest.mark.parametrize("seed", SEEDS)
def test_attr_http_bodies_match_reference(seed):
    """The same requests against both servers: identical status codes and
    byte-identical bodies."""
    outs = []
    for srv in (JNodeServer(None, "n0", bind="localhost:0"), TNodeServer(None, "n0", bind="localhost:0", device="cpu")):
        srv.start()
        host, port = srv.node.uri.removeprefix("http://").rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        got = []
        try:
            for method, path, body in http_steps(seed):
                conn.request(method, path, body=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                got.append((r.status, r.read()))
        finally:
            conn.close()
            srv.stop()
        outs.append(got)
    assert outs[1] == outs[0]
    bodies = [json.loads(b) for _, b in outs[0][-6:]]
    assert bodies[1]["columnAttrs"] and bodies[0]["results"][0]["attrs"] == {"color": "red", "w": 0.5}
