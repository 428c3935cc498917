"""The port's cluster held to the single nodes on the shapes where the JAX
cluster is no oracle, on the CPU.

A Shift carries each shard's top bits into the next shard, so a
cluster's aggregate over a Shift must count every shard once, with the
carry in from its predecessor, which may live on another node. MinRow
and MaxRow legs must cross the wire, and GroupBy's offset must page the
merged groups once. The JAX cluster gets these shapes wrong, so the
oracle here is two single nodes, the port's and the reference's, which
agree with each other.

A port `ClusterHarness(3, replica_n=1)` and a `replica_n=2` one (in
memory, on the CPU), a port single node and a reference single node get
the same seeded data through their first node's public routes: 6 shards
of set fields, a mutex field and a signed int field, each with a third of
its bits at the top of a shard (where a Shift's carry leaves it) and a
third at the bottom (where it lands), and a keyed index.
Every query of QUERIES, through every node of both clusters, must give
the single nodes' body exactly. The module also holds the wire to every
result type the executor returns, a run of MinRows to closed breakers,
and the metadata files to their fsyncs.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import http.client
import json
import os

import numpy as np
import pytest
import torch

from pilosa_tpu.server.node import NodeServer as JNodeServer
from pilosa_tpu_torch.core import wal as twal
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.exec.executor import FieldRow, GroupCount, Pair, ValCount
from pilosa_tpu_torch.server import NodeServer as TNodeServer
from pilosa_tpu_torch.server import faults as tfaults
from pilosa_tpu_torch.server import wire as twire
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW
from pilosa_tpu_torch.testing import ClusterHarness as TClusterHarness

N_SHARDS = 6
SEED = 20261019


def request(uri: str, method: str, path: str, body=b"", ctype="application/json"):
    host, port = uri.removeprefix("http://").rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        conn.request(method, path, body=body, headers={"Content-Type": ctype} if body else {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def query(uri: str, index: str, pql: str):
    return request(uri, "POST", f"/index/{index}/query", pql.encode(), "text/plain")


def load(uri: str) -> None:
    """Schema and seeded data through one node's public routes."""
    rng = np.random.default_rng(SEED)

    def cols(n: int, unique: bool = False) -> np.ndarray:
        # a third in the top 3000 columns of a shard, where a Shift's carry
        # leaves it, a third in the bottom 3000, where the carry lands
        shard = rng.integers(0, N_SHARDS, n)
        off = rng.integers(0, SHARD_WIDTH, n)
        pick = rng.integers(0, 3, n)
        off = np.where(pick == 0, rng.integers(SHARD_WIDTH - 3000, SHARD_WIDTH, n), off)
        off = np.where(pick == 1, rng.integers(0, 3000, n), off)
        c = shard * SHARD_WIDTH + off
        return np.unique(c)[rng.permutation(len(np.unique(c)))] if unique else c

    f_cols = cols(2500)
    f_rows = rng.integers(0, 6, len(f_cols))
    h_cols = cols(900)
    h_rows = rng.integers(0, 3, len(h_cols))
    m_cols = cols(700, unique=True)
    m_rows = rng.integers(0, 4, len(m_cols))
    v_cols = cols(900, unique=True)
    v_vals = rng.integers(-500, 501, len(v_cols))
    k_cols = [f"c{i}" for i in range(80)]
    k_rows = [["a", "b"][i % 2] for i in range(80)]

    def call(method, path, body=b"", ctype="application/json"):
        status, got = request(uri, method, path, body, ctype)
        assert status == 200, (path, got)

    call("POST", "/index/i", {})
    for f in ("f", "h"):
        call("POST", f"/index/i/field/{f}", {})
    call("POST", "/index/i/field/m", {"options": {"type": "mutex"}})
    call("POST", "/index/i/field/v", {"options": {"type": "int", "min": -500, "max": 500}})
    call("POST", "/index/i/field/f/import", {"rows": f_rows.tolist(), "cols": f_cols.tolist()})
    call("POST", "/index/i/field/h/import", {"rows": h_rows.tolist(), "cols": h_cols.tolist()})
    call("POST", "/index/i/field/m/import", {"rows": m_rows.tolist(), "cols": m_cols.tolist()})
    call("POST", "/index/i/field/v/import-value", {"cols": v_cols.tolist(), "values": v_vals.tolist()})
    call("POST", "/index/k", {"options": {"keys": True}})
    call("POST", "/index/k/field/kf", {"options": {"keys": True}})
    call("POST", "/index/k/field/kf/import", {"rowKeys": k_rows, "colKeys": k_cols})


QUERIES = [
    # C1: aggregates over a Shift
    "Count(Shift(Row(h=0), n=2000))",
    "Count(Shift(Shift(Row(h=0), n=1), n=1))",
    "Count(Intersect(Shift(Row(f=1), n=1), Row(f=2)))",
    "Count(Shift(Row(m=1), n=3))",
    "Count(Shift(Row(v > 0), n=1))",
    "Count(Not(Shift(Row(f=1), n=1)))",
    "Count(Row(f=1))Count(Shift(Row(h=1), n=5))Count(Row(f=2))",
    "Count(Shift(Row(h=0), n=1))Count(Shift(Row(h=2), n=700))",
    "Count(Intersect(Shift(Row(h=0), n=2000), Row(f=2)))",
    "Sum(Shift(Row(f=1), n=1), field=v)",
    "Sum(Shift(Row(h=0), n=2000), field=v)",
    "Min(Shift(Row(h=0), n=2000), field=v)",
    "Max(Shift(Row(h=1), n=1), field=v)",
    "TopN(f, Shift(Row(h=0), n=1), n=2)",
    "TopN(f, Shift(Row(h=1), n=2000), n=3)",
    "GroupBy(Rows(h), Rows(f), filter=Shift(Row(h=0), n=2000))",
    "Options(Count(Shift(Row(h=0), n=2000)), shards=[1, 3])",
    "Shift(Row(h=0), n=2000)",
    # C2: MinRow / MaxRow legs
    "MinRow(field=h)",
    "MaxRow(field=f)",
    "MaxRow(Row(h=1), field=f)",
    # C3: GroupBy's offset, paged once over the merged groups
    "GroupBy(Rows(h), Rows(f), offset=3)",
    "GroupBy(Rows(h), Rows(f), offset=3, limit=4)",
    "GroupBy(Rows(m), Rows(f), offset=5, limit=20)",
    # a keyed index
    "Count(Shift(Row(kf=\"a\"), n=1))",
]


def _index_of(q: str) -> str:
    return "k" if "kf" in q else "i"


class Servers:
    def __init__(self):
        self.c1 = TClusterHarness(3, replica_n=1, in_memory=True, device="cpu")
        self.c2 = TClusterHarness(3, replica_n=2, in_memory=True, device="cpu")
        self.single = TNodeServer(None, "solo", device="cpu").start()
        self.ref = JNodeServer(None, "ref").start()
        for uri in (self.c1[0].node.uri, self.c2[0].node.uri, self.single.node.uri, self.ref.node.uri):
            load(uri)

    def close(self) -> None:
        # the last started first: each port node puts back the result-cache
        # budget it found
        self.ref.stop()
        self.single.stop()
        self.c2.close()
        self.c1.close()


@pytest.fixture(scope="module")
def sv():
    s = Servers()
    try:
        yield s
    finally:
        s.close()


def test_a_shard_and_its_predecessor_live_apart(sv):
    """At replica 1 some shard's predecessor is on another node (so its
    carry crosses the wire), the last shard's successor included."""
    cluster = sv.c1[0].cluster
    apart = [
        s
        for s in range(1, N_SHARDS + 1)
        if cluster.shard_nodes("i", s)[0].id != cluster.shard_nodes("i", s - 1)[0].id
    ]
    assert apart, "every shard shares its predecessor's node: pick another seed"


@pytest.mark.parametrize("q", QUERIES)
def test_clusters_answer_as_the_single_nodes(sv, q):
    index = _index_of(q)
    want = query(sv.single.node.uri, index, q)
    assert want[0] == 200, want
    assert query(sv.ref.node.uri, index, q) == want, "the two single nodes disagree"
    for h in (sv.c1, sv.c2):
        for n in range(len(h)):
            got = query(h[n].node.uri, index, q)
            assert got == want, (q, h[0].cluster.replica_n, n, got, want)


def test_minrow_leaves_breakers_closed(sv):
    """Ten MinRows in a row answer on every call, no peer's breaker opens,
    and a write through the coordinator still reaches its owners."""
    want = query(sv.single.node.uri, "i", "MinRow(field=h) MaxRow(field=h)")
    for i in range(10):
        assert query(sv.c1[i % 3].node.uri, "i", "MinRow(field=h) MaxRow(field=h)") == want
    for srv in sv.c1.nodes:
        assert all(state == tfaults.CLOSED for state in srv.breakers.snapshot().values()), srv.breakers.snapshot()
    col = 5 * SHARD_WIDTH + 17
    status, got = query(sv.c1[0].node.uri, "i", f"Set({col}, f=9)")
    assert status == 200 and got["results"] == [True], got
    assert query(sv.c1[1].node.uri, "i", "Count(Row(f=9))") == (200, {"results": [1]})


def _words(*pairs) -> torch.Tensor:
    w = torch.zeros(WORDS_PER_ROW, dtype=torch.int32)
    for i, v in pairs:
        w[i] = v
    return w


WIRE_RESULTS = [
    Row({0: _words((0, 5), (2, -1)), 2: _words((1, 1), (WORDS_PER_ROW - 1, -(2**31)))}),
    True,
    False,
    7,
    torch.tensor(9),
    ValCount(-12, 3),
    Pair(id=4, count=2, key="x"),
    [Pair(id=4, count=2), Pair(id=1, count=1)],
    [GroupCount(group=[FieldRow(field="h", row_id=1), FieldRow(field="f", row_id=2)], count=3)],
    ["a", "b"],
    [3, 5],
    {"id": 2, "count": 11},
    None,
]


@pytest.mark.parametrize("r", WIRE_RESULTS, ids=lambda r: type(r).__name__)
def test_wire_round_trips_every_result_type(r):
    """Every result type a leg returns crosses the internode wire as it
    left: one without an encoding would 500 the leg."""
    got = twire.decode_result(json.loads(json.dumps(twire.encode_result(r))))
    if isinstance(r, Row):
        assert sorted(got.segments) == sorted(r.segments)
        for s, w in r.segments.items():
            assert torch.equal(got.segments[s], w)
    elif isinstance(r, torch.Tensor):
        assert got == int(r)
    else:
        assert got == r


def _fsynced(monkeypatch) -> list:
    """Patch os.fsync to record the path of every fd it syncs."""
    seen = []
    real = os.fsync

    def spy(fd):
        seen.append(os.path.realpath(os.readlink(f"/proc/self/fd/{fd}")))
        return real(fd)

    monkeypatch.setattr(os, "fsync", spy)
    return seen


def test_metadata_files_fsync_file_and_directory(tmp_path, monkeypatch):
    """Each metadata write fsyncs its temp file, renames it into place and
    fsyncs the directory: the node's .id and .topology, an index's and a
    field's .meta.json and a field's .available.shards.json."""
    from pilosa_tpu_torch.cluster.topology import Node

    seen = _fsynced(monkeypatch)
    d = os.path.realpath(tmp_path)
    srv = TNodeServer(str(tmp_path), "n0", device="cpu").start()
    try:
        assert request(srv.node.uri, "POST", "/index/i", {})[0] == 200
        assert request(srv.node.uri, "POST", "/index/i/field/f", {})[0] == 200
        idx = srv.holder.index("i")
        f = idx.field("f")
        f.add_remote_available([7])
        srv.set_topology([Node(id="n0", uri=srv.node.uri, is_coordinator=True), Node(id="n1", uri="http://127.0.0.1:9")])
        files = [os.path.join(d, ".id"), os.path.join(d, ".topology"), idx.meta_path, f.meta_path, f._avail_path]
    finally:
        srv.stop()
    for p in files:
        p = os.path.realpath(p)
        assert os.path.exists(p), p
        assert p + ".tmp" in seen, (p, seen)
        assert os.path.dirname(p) in seen[seen.index(p + ".tmp") :], (p, seen)


@pytest.mark.parametrize("interval", [0.0, 3600.0])
def test_key_log_follows_the_wal_sync_setting(tmp_path, monkeypatch, interval):
    """Under the strict WAL a keyed Set's new keys are fsynced before the
    answer; under a cadence they wait for the next commit round."""
    srv = TNodeServer(str(tmp_path), "n0", device="cpu", wal_sync_interval=interval).start()
    try:
        assert request(srv.node.uri, "POST", "/index/k", {"options": {"keys": True}})[0] == 200
        assert request(srv.node.uri, "POST", "/index/k/field/kf", {"options": {"keys": True}})[0] == 200
        seen = _fsynced(monkeypatch)
        status, got = query(srv.node.uri, "k", 'Set("c1", kf="a")')
        assert status == 200 and got["results"] == [True], got
        logs = [p for p in seen if p.endswith(".keys.translate")]
        if interval == 0:
            assert len(logs) == 2, seen  # the index's column keys and the field's row keys
        else:
            assert logs == [], seen
            twal.GROUP_COMMIT.flush()
            assert len([p for p in seen if p.endswith(".keys.translate")]) == 2, seen
    finally:
        srv.stop()
        twal.GROUP_COMMIT.configure(sync_interval=0.0)
