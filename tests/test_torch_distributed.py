"""The port's 3-node, replica-2 cluster against pilosa_tpu's, on the CPU.

A port `ClusterHarness(3, replica_n=2, in_memory=True, device="cpu")`, a
`pilosa_tpu.testing.ClusterHarness` of the same shape and a port single
node get the same seeded data through their first node's public routes:
`/import` (set fields, and column keys on a keyed index),
`/import-value` (a signed int field) and `/import-roaring` (one frame a
shard), over 6 shards at the default shard width (sparse rows: the
shard width is read once at import, so no test changes it). Then every
query of QUERIES, asked through every node of each cluster, must give
a response body equal to the JAX cluster's and to the single node's,
exactly:

- with the cluster whole;
- with node1 partitioned from node0's client (a FaultInjector rule on
  both coordinators: node1's legs fail over to its replicas);
- with node2 stopped and one probe pass run on node0: /status says
  DEGRADED on both clusters and the answers stay the same.

A keyed Set through a non-coordinator node (its key stores forward new
keys to the coordinator's) and the replica imports are checked on the
way. The module's setup starts seven servers; the whole file runs in
well under a minute on one worker.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import http.client
import json

import numpy as np
import pytest

from pilosa_tpu.core import roaring_io as jroaring
from pilosa_tpu.server import faults as jfaults
from pilosa_tpu.testing import ClusterHarness as JClusterHarness
from pilosa_tpu_torch.server import NodeServer as TNodeServer
from pilosa_tpu_torch.server import faults as tfaults
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.testing import ClusterHarness as TClusterHarness

N_SHARDS = 6
SEED = 20261018


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


def _data():
    rng = np.random.default_rng(SEED)
    n = 3000
    cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, n)
    f_rows = rng.integers(0, 8, n)
    h_cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, 600)
    h_rows = rng.integers(0, 3, 600)
    v_cols = rng.choice(N_SHARDS * SHARD_WIDTH, 800, replace=False)
    v_vals = rng.integers(-1000, 1001, 800)
    g = {}
    for s in range(N_SHARDS):
        rows = rng.integers(0, 4, 400).astype(np.uint64)
        cols_in = rng.integers(0, SHARD_WIDTH, 400).astype(np.uint64)
        g[s] = np.unique(rows * np.uint64(SHARD_WIDTH) + cols_in)
    k_cols = [f"c{i}" for i in rng.permutation(60)]
    k_rows = [["a", "b", "c"][i % 3] for i in range(60)]
    return cols, f_rows, h_cols, h_rows, v_cols, v_vals, g, k_cols, k_rows


def load(uri: str) -> list:
    """Schema and data through one node's public routes; returns every
    response body."""
    cols, f_rows, h_cols, h_rows, v_cols, v_vals, g, k_cols, k_rows = _data()
    out = []

    def call(method, path, body=b"", ctype="application/json"):
        status, got = request(uri, method, path, body, ctype)
        assert status == 200, (path, got)
        out.append(got)

    call("POST", "/index/i", {})
    for f in ("f", "g", "h"):
        call("POST", f"/index/i/field/{f}", {})
    call("POST", "/index/i/field/v", {"options": {"type": "int", "min": -1000, "max": 1000}})
    call("POST", "/index/i/field/f/import", {"rows": f_rows.tolist(), "cols": cols.tolist()})
    call("POST", "/index/i/field/h/import", {"rows": h_rows.tolist(), "cols": h_cols.tolist()})
    call("POST", "/index/i/field/v/import-value", {"cols": v_cols.tolist(), "values": v_vals.tolist()})
    for s in range(N_SHARDS):
        call("POST", f"/index/i/field/g/import-roaring/{s}", jroaring.encode(g[s]), "application/octet-stream")
    call("POST", "/index/k", {"options": {"keys": True}})
    call("POST", "/index/k/field/kf", {"options": {"keys": True}})
    call("POST", "/index/k/field/kf/import", {"rowKeys": k_rows, "colKeys": k_cols})
    return out


QUERIES = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Count(Union(Row(f=1), Row(f=2), Row(g=0)))",
    "Count(Difference(Row(f=1), Row(g=1)))",
    "Count(Xor(Row(f=0), Row(g=0)))",
    "Count(Not(Row(f=3)))",
    "Count(Row(f=1))Count(Row(f=2))Count(Intersect(Row(f=5), Row(g=3)))",
    "Row(f=2)",
    "Intersect(Row(f=1), Row(g=1))",
    "Union(Row(h=1), Row(h=2))",
    "Shift(Row(f=4), n=1)",
    "TopN(f, n=3)",
    "TopN(f, Row(g=1), n=4)",
    "Rows(f)",
    "GroupBy(Rows(h), Rows(g))",
    "GroupBy(Rows(h), Rows(g), Rows(f), limit=20)",
    "Sum(field=v)",
    "Sum(Row(f=1), field=v)",
    "Min(field=v)",
    "Max(Row(g=2), field=v)",
    "Count(Row(v > 0))",
    "Count(Row(-100 < v < 500))",
    "Row(kf=\"a\")",
    "Count(Row(kf=\"b\"))",
]


def _index_of(q: str) -> str:
    return "k" if "kf" in q else "i"


def answers(servers) -> dict:
    """(query, node) -> body for every query through every server."""
    out = {}
    for q in QUERIES:
        for n, uri in enumerate(servers):
            status, got = request(uri, "POST", f"/index/{_index_of(q)}/query", q.encode(), "text/plain")
            out[(q, n)] = (status, got)
    return out


class Phases:
    """The three clusters and the phase they are in; phases only advance."""

    ORDER = ("whole", "partitioned", "degraded")

    def __init__(self):
        self.t = TClusterHarness(3, replica_n=2, in_memory=True, device="cpu")
        self.j = JClusterHarness(3, replica_n=2, in_memory=True)
        self.single = TNodeServer(None, "solo", device="cpu").start()
        self.phase = "whole"
        self.loaded = [load(self.t[0].node.uri), load(self.j[0].node.uri), load(self.single.node.uri)]
        # a keyed Set through a non-coordinator node: its key stores
        # forward the new keys to node0's
        self.keyed_set = []
        for uri in (self.t[1].node.uri, self.j[1].node.uri, self.single.node.uri):
            self.keyed_set.append(request(uri, "POST", "/index/k/query", b'Set("c99", kf="d") Row(kf="d")', "text/plain"))
        self.single_answers = answers([self.single.node.uri])

    def advance(self, phase: str) -> None:
        while self.ORDER.index(self.phase) < self.ORDER.index(phase):
            if self.phase == "whole":
                tinj = tfaults.FaultInjector(seed=1).partition(self.t[1].node.uri)
                jinj = jfaults.FaultInjector(seed=1).partition(self.j[1].node.uri)
                self.t[0].client.fault_injector = tinj
                self.j[0].client.fault_injector = jinj
                self.phase = "partitioned"
            else:
                self.t[0].client.fault_injector = None
                self.j[0].client.fault_injector = None
                self.t.stop_node(2)
                self.j.stop_node(2)
                self.t[0].run_probe_pass(timeout=1.0)
                self.j[0].run_probe_pass(timeout=1.0)
                self.phase = "degraded"

    def live(self, h) -> list:
        n = 2 if self.phase == "degraded" else 3
        return [h[i].node.uri for i in range(n)]

    def close(self) -> None:
        # the last started first: each port node puts back the result-cache
        # budget it found
        self.single.stop()
        self.j.close()
        self.t.close()


@pytest.fixture(scope="module")
def cl():
    p = Phases()
    try:
        yield p
    finally:
        p.close()


def test_loads_and_keyed_set_match(cl):
    """Every DDL and import answer, and the keyed Set through node1, are
    the JAX cluster's (the import summaries count the replica owners:
    equal on the two clusters)."""
    assert cl.loaded[0] == cl.loaded[1]
    assert cl.keyed_set[0] == cl.keyed_set[1] == cl.keyed_set[2]
    assert cl.keyed_set[0][0] == 200 and cl.keyed_set[0][1]["results"][0] is True


def _check(cl, phase: str, q: str) -> None:
    cl.advance(phase)
    want = cl.single_answers[(q, 0)]
    assert want[0] == 200, want
    for n, (tu, ju) in enumerate(zip(cl.live(cl.t), cl.live(cl.j))):
        tgot = request(tu, "POST", f"/index/{_index_of(q)}/query", q.encode(), "text/plain")
        jgot = request(ju, "POST", f"/index/{_index_of(q)}/query", q.encode(), "text/plain")
        assert tgot == jgot, (q, n, tgot, jgot)
        assert tgot == want, (q, n, tgot, want)


@pytest.mark.parametrize("q", QUERIES)
def test_whole_cluster_matches(cl, q):
    _check(cl, "whole", q)


@pytest.mark.parametrize("q", QUERIES)
def test_partitioned_node_fails_over(cl, q):
    _check(cl, "partitioned", q)
    assert cl.t[0].client.fault_injector.count("partition") > 0


def test_stopped_node_degrades_after_one_probe(cl):
    cl.advance("degraded")
    for h in (cl.t, cl.j):
        for i in (0, 1):
            status, st = request(h[i].node.uri, "GET", "/status")
            assert status == 200 and st["state"] == "DEGRADED", (i, st)
            assert {n["id"]: n["state"] for n in st["nodes"]}["node2"] == "DOWN"


@pytest.mark.parametrize("q", QUERIES)
def test_degraded_cluster_matches(cl, q):
    _check(cl, "degraded", q)
