"""The port's anti-entropy against pilosa_tpu's, on the CPU.

The reference's cases, on the port: block digests find a difference and
skip empty blocks, the majority-vote merge (the union at 2 replicas, the
majority at 3, pairs outside the block ignored, every replica
converging), a fragment-level sync round trip, drift repaired by a pass,
the attribute stores' pull-merge, mutated fragments synced first, a
replica write dropped by a partition becoming pending-repair debt that a
pass resolves, and `POST /internal/sync` over HTTP on durable nodes
after one of them was down.

Differential cases, inputs made by numpy from a seed: the port's block
digests byte-equal to the reference's (the functions and whole
fragments), the merge's deltas equal at 2 and 3 replicas, the attribute
stores' block checksums equal, and a port ClusterHarness(3, replica 2)
beside a JAX one put through the same partition, writes (a Clear among
them), heal and passes: equal ledgers and `reached` sets, equal
per-node counts (the Clear node2 missed comes back in both), equal
digests, and a Count cached at the coordinator before the repair that
answers the repaired count after it. Then the interval loop drains the
debt on its own.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from pilosa_tpu.cluster import antientropy as jae
from pilosa_tpu.core.attrs import AttrStore as JAttrStore
from pilosa_tpu.core.fragment import Fragment as JFragment
from pilosa_tpu.server import faults as jfaults
from pilosa_tpu.testing import ClusterHarness as JClusterHarness
from pilosa_tpu_torch.cluster import antientropy as tae
from pilosa_tpu_torch.cluster.antientropy import block_checksums, diff_blocks, merge_block
from pilosa_tpu_torch.core import blocks as tblocks
from pilosa_tpu_torch.core.attrs import AttrStore as TAttrStore
from pilosa_tpu_torch.core.devcache import DeviceCache
from pilosa_tpu_torch.core.fragment import Fragment as TFragment
from pilosa_tpu_torch.core.resultcache import RESULT_CACHE
from pilosa_tpu_torch.server import faults as tfaults
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.testing import ClusterHarness as TClusterHarness

CPU = torch.device("cpu")
SEED = 20261018
# fast failure handling, as the reference's fault tests set it
FAST = dict(retry_max_attempts=2, retry_base_backoff=0.01, breaker_threshold=2, breaker_cooldown=60.0, query_deadline=5.0)


def P(pairs):
    if not pairs:
        return np.empty(0, np.uint64), np.empty(0, np.uint64)
    r, c = zip(*pairs)
    return np.array(r, np.uint64), np.array(c, np.uint64)


def as_set(rows_cols):
    return {(int(r), int(c)) for r, c in zip(*rows_cols)}


def tfragment(shard: int = 0) -> TFragment:
    return TFragment("i", "f", "standard", shard, device=CPU, dcache=DeviceCache(1 << 30)).open()


def jfragment(shard: int = 0) -> JFragment:
    return JFragment(None, "i", "f", "standard", shard).open()


# ---------------------------------------------------------------------------
# the reference's block and merge cases (tests/test_cluster.py)
# ---------------------------------------------------------------------------


def test_block_checksums_detect_difference():
    a = block_checksums(P([(0, 1), (0, 5), (150, 7)]))
    b = block_checksums(P([(0, 1), (0, 5), (150, 8)]))
    assert set(a) == {0, 1}
    assert a[0] == b[0]
    assert a[1] != b[1]
    assert diff_blocks(a, b) == [1]


def test_block_checksums_empty():
    assert block_checksums(P([])) == {}
    assert tfragment().block_checksums() == {}


def test_merge_block_two_replicas_union():
    """An even split sets: two replicas converge to their union."""
    sets, clears = merge_block(0, [P([(0, 1), (0, 2)]), P([(0, 2), (0, 3)])])
    assert as_set(sets[0]) == {(0, 3)} and as_set(sets[1]) == {(0, 1)}
    assert all(len(r) == 0 for r, _ in clears)


def test_merge_block_three_replicas_majority():
    sets, clears = merge_block(0, [P([(0, 1), (0, 9)]), P([(0, 1)]), P([(0, 2)])])
    assert (0, 1) in as_set(sets[2])  # 2 of 3 votes: kept
    assert (0, 9) in as_set(clears[0]) and (0, 2) in as_set(clears[2])  # 1 of 3: cleared
    assert len(clears[1][0]) == 0


def test_merge_block_ignores_out_of_block_pairs():
    sets, _ = merge_block(0, [P([(0, 1), (250, 2)]), P([])])  # row 250 is block 2's
    assert as_set(sets[1]) == {(0, 1)}


def test_merge_convergence_end_to_end():
    rng = np.random.default_rng(3)
    replicas = []
    for _ in range(3):
        n = rng.integers(50, 150)
        replicas.append((rng.integers(0, 100, n).astype(np.uint64), rng.integers(0, 1000, n).astype(np.uint64)))
    sets, clears = merge_block(0, replicas)
    states = [(as_set(rep) | as_set(s)) - as_set(cl) for rep, s, cl in zip(replicas, sets, clears)]
    assert states[0] == states[1] == states[2]


def test_fragment_block_sync_roundtrip():
    fa, fb = tfragment(), tfragment()
    fa.bulk_import(np.array([0, 0, 1, 205]), np.array([3, 4, 9, 11]))
    fb.bulk_import(np.array([0, 1, 205]), np.array([3, 9, 12]))
    diffs = diff_blocks(fa.block_checksums(), fb.block_checksums())
    assert diffs == [0, 2]
    for bid in diffs:
        sets, clears = merge_block(bid, [fa.block_pairs(bid), fb.block_pairs(bid)])
        fa.apply_deltas(sets[0], clears[0])
        fb.apply_deltas(sets[1], clears[1])
    assert diff_blocks(fa.block_checksums(), fb.block_checksums()) == []
    assert fa.pairs()[1].tolist() == fb.pairs()[1].tolist()


def test_fragment_pairs_row_range_and_apply_deltas_clear():
    """`pairs(lo, hi)` keeps rows in [lo, hi); a clear delta clears and
    bumps the version like any exact write."""
    f = tfragment()
    f.bulk_import(np.array([0, 99, 100, 199, 200]), np.array([1, 2, 3, 4, 5]))
    assert as_set(f.pairs(100, 200)) == {(100, 3), (199, 4)}
    assert as_set(f.block_pairs(0)) == {(0, 1), (99, 2)}
    v = f.version
    assert f.apply_deltas(P([(7, 7)]), P([(99, 2), (100, 9)])) == (1, 1)
    assert f.version > v
    assert as_set(f.pairs()) == {(0, 1), (7, 7), (100, 3), (199, 4), (200, 5)}


# ---------------------------------------------------------------------------
# differential: the port's digests and merges are the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_block_checksums_byte_equal_functions(seed):
    """Random unsorted pairs with duplicates over many blocks."""
    rng = np.random.default_rng([SEED, seed])
    n = int(rng.integers(1, 5000))
    rows = rng.integers(0, 1000 if seed % 2 else 120, n).astype(np.uint64)
    cols = rng.integers(0, SHARD_WIDTH, n).astype(np.uint64)
    got = tblocks.block_checksums((rows, cols))
    assert got == jae.block_checksums((rows, cols)) and len(got) > 0
    assert all(isinstance(v, bytes) and len(v) == 16 for v in got.values())
    assert tblocks.HASH_BLOCK_SIZE == jae.HASH_BLOCK_SIZE and tblocks.block_id_of(250) == 2


@pytest.mark.parametrize("seed", range(4))
def test_block_checksums_byte_equal_fragments(seed):
    """A port and a reference fragment with the same bits (sparse rows
    and dense ones, a clear among the writes): the same digests, pairs
    and block pairs."""
    rng = np.random.default_rng([SEED, 100 + seed])
    tf, jf = tfragment(3), jfragment(3)
    n = 6000
    rows = rng.integers(0, 400, n)
    cols = rng.integers(0, SHARD_WIDTH, n)
    dense_cols = rng.choice(SHARD_WIDTH, 20000, replace=False)
    for f in (tf, jf):
        f.bulk_import(rows, cols)
        f.bulk_import(np.full(len(dense_cols), 7), dense_cols)
        f.bulk_import(rows[:500], cols[:500], clear=True)
    got = tf.block_checksums()
    assert got == jf.block_checksums() and set(got) == {0, 1, 2, 3}
    for a, b in zip(tf.pairs(), jf.pairs()):
        assert a.tolist() == b.tolist()
    for bid in (0, 3, 9):
        for a, b in zip(tf.block_pairs(bid), jf.block_pairs(bid)):
            assert a.tolist() == b.tolist()


@pytest.mark.parametrize("n_replicas", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", range(3))
def test_merge_block_deltas_equal(n_replicas, seed):
    """Replicas sharing most pairs, each with pairs of its own, in and
    out of the block, duplicates among them; seed 2 draws columns over
    the whole uint64 range."""
    rng = np.random.default_rng([SEED, 200 + seed, n_replicas])
    col_hi = 2**64 - 1 if seed == 2 else 5000
    common = (rng.integers(300, 400, 300).astype(np.uint64), rng.integers(0, col_hi, 300, dtype=np.uint64))
    replicas = []
    for i in range(n_replicas):
        k = int(rng.integers(0, 200))
        rows = np.concatenate([common[0][: 250 + 10 * i], rng.integers(250, 450, k).astype(np.uint64)])
        cols = np.concatenate([common[1][: 250 + 10 * i], rng.integers(0, col_hi, k, dtype=np.uint64)])
        dup = rng.integers(0, len(rows), 20)
        replicas.append((np.concatenate([rows, rows[dup]]), np.concatenate([cols, cols[dup]])))
    t_sets, t_clears = tae.merge_block(3, replicas)
    j_sets, j_clears = jae.merge_block(3, replicas)
    for got, want in ((t_sets, j_sets), (t_clears, j_clears)):
        assert len(got) == len(want) == n_replicas
        for (gr, gc), (wr, wc) in zip(got, want):
            assert gr.dtype == wr.dtype and gr.tolist() == wr.tolist() and gc.tolist() == wc.tolist()
    assert n_replicas == 1 or any(len(r) for r, _ in t_sets)
    assert tae.diff_blocks({1: b"a", 2: b"b"}, {2: b"c", 5: b"d"}) == jae.diff_blocks({1: b"a", 2: b"b"}, {2: b"c", 5: b"d"})


def test_attr_store_checksums_equal():
    """The port's attribute stores give the reference's block checksums
    and block data for the same attributes."""
    rng = np.random.default_rng([SEED, 300])
    t, j = TAttrStore(None), JAttrStore(None)
    ids = rng.choice(5000, 300, replace=False)
    for i in ids.tolist():
        attrs = {"k": int(rng.integers(0, 9)), "s": f"v{i % 7}", "b": bool(i % 2)}
        t.set_attrs(i, attrs)
        j.set_attrs(i, attrs)
    bulk = {int(i): {"x": 1.5, "gone": None} for i in ids[:40]}
    t.set_bulk_attrs(bulk)
    j.set_bulk_attrs(bulk)
    assert t.blocks() == j.blocks() and len(t.blocks()) > 3
    for b in t.blocks():
        assert t.block_checksum(b["id"]) == j.block_checksum(b["id"]) == b["checksum"]
        assert t.block_data(b["id"]) == j.block_data(b["id"])
    assert t.block_checksum(10**6) is None and j.block_checksum(10**6) is None


# ---------------------------------------------------------------------------
# the reference's node cases (tests/test_server.py, tests/test_faults.py)
# ---------------------------------------------------------------------------


def _harness(n, **kw):
    return TClusterHarness(n, in_memory=True, device="cpu", **kw)


def _count(node, index, q, remote=False):
    return node.api.query_response(index, q, remote=remote).results[0]


def test_anti_entropy_repairs_drift():
    with _harness(2, replica_n=2) as c:
        api = c[0].api
        api.create_index("ae")
        api.create_field("ae", "f", {"type": "set"})
        api.import_bits("ae", "f", [0, 0, 1], [1, 2, 3])
        # drift: a bit on node1 only
        c[1].api.import_bits("ae", "f", [0], [999], local_only=True)
        assert [_count(c[i], "ae", "Count(Row(f=0))", remote=True) for i in (0, 1)] == [2, 3]
        c[0].sync_holder()
        c[1].sync_holder()
        # a majority of 2 is 1 vote: both converge to the union
        assert [_count(c[i], "ae", "Count(Row(f=0))", remote=True) for i in (0, 1)] == [3, 3]
        last = c[1].ae_last
        # the bit of f and its column's existence bit went to node0
        assert last["blocks"] == 2 and last["bits_sent"] == 2 and last["synced"] == 2


def test_anti_entropy_syncs_attrs():
    """Attribute drift repairs by the block-diff pull-merge; bilateral
    drift on disjoint ids converges too."""
    with _harness(2) as c:
        api = c[0].api
        api.create_index("at")
        api.create_field("at", "f", {"type": "set"})
        idx0 = c[0].holder.index("at")
        idx0.field("f").row_attr_store.set_attrs(3, {"label": "three"})
        idx0.column_attr_store.set_attrs(700, {"city": "x"})
        idx1 = c[1].holder.index("at")
        assert idx1.field("f").row_attr_store.attrs(3) == {}
        c[1].sync_holder()  # node1 pulls the drifted blocks
        assert idx1.field("f").row_attr_store.attrs(3) == {"label": "three"}
        assert idx1.column_attr_store.attrs(700) == {"city": "x"}
        idx1.field("f").row_attr_store.set_attrs(9, {"label": "nine"})
        c[0].sync_holder()
        assert idx0.field("f").row_attr_store.attrs(9) == {"label": "nine"}


def test_ae_prioritizes_mutated_fragments():
    """Fragments mutated since their last pass sort first."""
    with _harness(2, replica_n=2) as c:
        api = c[0].api
        api.create_index("pr")
        api.create_field("pr", "f", {"type": "set"})
        cols = [s * SHARD_WIDTH + 1 for s in range(6)]
        api.import_bits("pr", "f", [0] * len(cols), cols)
        c[0].sync_holder()
        tasks = c[0]._ae_tasks()
        assert tasks, "node0 primary-owns nothing"
        target = tasks[-1][3]
        api.import_bits("pr", "f", [1], [target * SHARD_WIDTH + 9])
        assert c[0]._ae_tasks()[0][3] == target


def _seed_data(api, index="ft", field="f", n_shards=12):
    api.create_index(index)
    api.create_field(index, field, {"type": "set"})
    rows, cols = [], []
    for s in range(n_shards):
        for r in range(3):
            rows.append(r)
            cols.append(s * SHARD_WIDTH + 7 * r + s)
    api.import_bits(index, field, rows, cols)


def test_write_replica_drop_is_visible():
    """A write that misses a replica is pending-repair debt (/status
    pendingRepairs), not silent drift, and a pass resolves it."""
    with _harness(3, replica_n=2, **FAST) as c:
        api = c[0].api
        _seed_data(api)
        _seed_data(api, index="st")
        assert c[0].holder.pending_repair_count() == 0
        inj = tfaults.FaultInjector(seed=3).partition(c[2].node.uri)
        c[0].client.fault_injector = inj
        cols = [s * SHARD_WIDTH + 99 for s in range(12)]
        summary = api.import_bits("ft", "f", [5] * len(cols), cols)
        assert summary["errors"], "node2's replicas should have failed"
        assert c[0].holder.pending_repair_count() > 0
        assert all(n == "node2" for _, _, n in c[0].holder.pending_repairs())
        # the row-wide write path records drops too
        api.query_response("st", "Store(Row(f=0), f=6)")
        st_entries = [e for e in c[0].holder.pending_repairs() if e[0] == "st"]
        assert st_entries and all(n == "node2" for _, _, n in st_entries)
        with urllib.request.urlopen(f"{c[0].node.uri}/status") as r:
            st = json.loads(r.read())
        assert st["pendingRepairs"] == c[0].holder.pending_repair_count()
        assert st["breakers"].get(c[2].node.uri) == tfaults.OPEN
        inj.heal(c[2].node.uri)
        c[0].probe_peers()
        before = c[0].holder.pending_repair_count()
        c[0].sync_holder()
        assert c[0].holder.pending_repair_count() < before
        # every node's pass (and the nudges) drains the rest
        for s in c.nodes:
            s.sync_holder()
        assert [s.holder.pending_repair_count() for s in c.nodes] == [0, 0, 0]
        for s in c.nodes:
            assert _count(s, "ft", "Count(Row(f=5))") == 12
            assert _count(s, "st", "Count(Row(f=6))") == 12


# ---------------------------------------------------------------------------
# POST /internal/sync over HTTP on durable nodes (tests/test_lifecycle.py)
# ---------------------------------------------------------------------------


def _http(method, uri, path, body=None, timeout=300):
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(uri + path, data=data, method=method)
    if isinstance(body, dict):
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
    return json.loads(raw) if raw else None


def test_internal_sync_over_http_after_a_node_was_down(tmp_path):
    """Node2 stops; writes, row and column attributes go in through node0
    (node2's share is debt); node2 restarts on its data dir; one `POST
    /internal/sync` a node repairs it: every node answers the writes and
    the attributes, block digests agree, no debt is left."""
    with TClusterHarness(3, replica_n=2, base_dir=str(tmp_path), device="cpu", **FAST) as c:
        u0 = c[0].node.uri
        _http("POST", u0, "/index/e2e", {})
        _http("POST", u0, "/index/e2e/field/f", {})
        first = [s * SHARD_WIDTH + 11 for s in range(9)]
        _http("POST", u0, "/index/e2e/field/f/import", {"rows": [0] * 9, "cols": first})
        c.stop_node(2)
        later = [s * SHARD_WIDTH + 500 + s for s in range(9)]
        out = _http("POST", u0, "/index/e2e/field/f/import", {"rows": [0] * 9, "cols": later})
        assert out["errors"]
        _http("POST", u0, "/index/e2e/query", b'SetRowAttrs(f, 0, label="alpha", rank=7)')
        _http("POST", u0, "/index/e2e/query", b"SetColumnAttrs(11, city=\"x\")")
        assert _http("GET", u0, "/status")["pendingRepairs"] > 0
        c.restart_node(2)
        c[0].run_probe_pass()
        assert _http("GET", u0, "/status")["state"] == "NORMAL"
        replies = [_http("POST", n.node.uri, "/internal/sync") for n in c.nodes]
        assert all(r["ran"] and isinstance(r["synced"], int) for r in replies), replies
        assert sum(r["synced"] for r in replies) > 0
        assert all(isinstance(t, list) and len(t) == 3 for r in replies for t in r["reached"])
        for n in c.nodes:
            uri = n.node.uri
            assert _http("GET", uri, "/status")["pendingRepairs"] == 0
            assert _http("POST", uri, "/index/e2e/query", b"Count(Row(f=0))")["results"] == [18]
            row = _http("POST", uri, "/index/e2e/query", {"query": "Row(f=0)", "columnAttrs": True})
            assert row["results"][0]["attrs"] == {"label": "alpha", "rank": 7}, uri
            assert row["columnAttrs"] == [{"id": 11, "attrs": {"city": "x"}}], uri
        for s in range(9):
            owners = c[0].cluster.shard_nodes("e2e", s)
            sums = [
                _http("GET", c.nodes[int(o.id[4:])].node.uri,
                      f"/internal/fragment/blocks?index=e2e&field=f&view=standard&shard={s}")["blocks"]
                for o in owners
            ]
            assert sums[0] == sums[1] and sums[0], s
        # block data, binary and JSON, and deltas posted as JSON
        q = "index=e2e&field=f&view=standard&shard=0&block=0"
        assert _http("GET", u0, f"/internal/fragment/block/data?{q}") == {"rows": [0, 0], "cols": [11, 500]}
        missing = "index=e2e&field=f&view=standard&shard=99&block=0"
        assert _http("GET", u0, f"/internal/fragment/block/data?{missing}") == {"rows": [], "cols": []}
        _http("POST", u0, "/internal/fragment/block/deltas",
              {"index": "e2e", "field": "f", "view": "standard", "shard": 0,
               "sets": {"rows": [3], "cols": [4]}, "clears": {"rows": [0], "cols": [11]}})
        assert _http("GET", u0, f"/internal/fragment/block/data?{q}") == {"rows": [0, 3], "cols": [500, 4]}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _http("GET", u0, "/internal/fragment/blocks?index=nope&field=f&shard=0")
        assert ei.value.code == 404


# ---------------------------------------------------------------------------
# differential: a port cluster and a JAX cluster through the same faults
# ---------------------------------------------------------------------------

N_SHARDS = 8


def _diff_writes():
    rng = np.random.default_rng([SEED, 400])
    base_cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, 1500)
    base_rows = rng.integers(0, 4, 1500)
    new_cols = np.unique(rng.integers(0, N_SHARDS * SHARD_WIDTH, 400))
    set_cols = rng.integers(0, N_SHARDS * SHARD_WIDTH, 6)
    return base_rows, base_cols, new_cols, set_cols


def _run_cluster(c, faults_mod, query):
    """Drive one cluster through the scenario; returns what it observed."""
    base_rows, base_cols, new_cols, set_cols = _diff_writes()
    api = c[0].api
    api.create_index("d")
    api.create_field("d", "f", {"type": "set"})
    api.import_bits("d", "f", base_rows.tolist(), base_cols.tolist())
    out = {}
    inj = faults_mod.FaultInjector(seed=1).partition(c[2].node.uri)
    c[0].client.fault_injector = inj
    api.import_bits("d", "f", [9] * len(new_cols), new_cols.tolist())
    for col in set_cols.tolist():
        query(c[0], f"Set({col}, f=9)")
    # a Clear node2 misses: the union at replica 2 brings it back
    cleared = int(base_cols[base_rows == 0][0])
    query(c[0], f"Clear({cleared}, f=0)")
    out["debt"] = c[0].holder.pending_repairs()
    inj.heal(c[2].node.uri)
    c[0].probe_peers()
    # cached at the coordinator with node2 still stale
    out["before"] = [query(c[0], "Count(Row(f=9))") for _ in range(2)]
    out["passes"] = []
    for s in c.nodes:
        synced, reached = s.try_sync_holder(wait_nudge=True)
        out["passes"].append((synced, sorted(reached)))
    out["pending"] = [s.holder.pending_repair_count() for s in c.nodes]
    out["after"] = query(c[0], "Count(Row(f=9))")
    out["remote"] = [
        [query(s, f"Count(Row(f={r}))", remote=True) for r in (0, 9)] for s in c.nodes
    ]
    out["digests"] = {
        (s.node.id, shard): s.holder.index("d").field("f").view("standard").fragment(shard).block_checksums()
        for s in c.nodes
        for shard in range(N_SHARDS)
        if c[0].cluster.owns_shard(s.node.id, "d", shard)
    }
    out["cleared"] = cleared
    return out


def test_port_cluster_converges_as_the_reference():
    base_rows, base_cols, new_cols, set_cols = _diff_writes()
    want_9 = len(set(new_cols.tolist()) | set(set_cols.tolist()))
    want_0 = len(set(base_cols[base_rows == 0].tolist()))
    hits0 = RESULT_CACHE.stats_snapshot()["hits"]
    with TClusterHarness(3, replica_n=2, in_memory=True, device="cpu", **FAST) as tc:
        got = _run_cluster(tc, tfaults, lambda n, q, remote=False: n.api.query_response("d", q, remote=remote).results[0])
        hits = RESULT_CACHE.stats_snapshot()["hits"] - hits0
    with JClusterHarness(3, replica_n=2, in_memory=True, **FAST) as jc:
        want = _run_cluster(jc, jfaults, lambda n, q, remote=False: n.api.query("d", q, remote=remote)[0])
    assert got["debt"] == want["debt"] and got["debt"]
    assert got["before"] == want["before"]
    assert got["before"][0] < want_9  # node2's stale copies answered some legs
    assert hits >= 1  # the second Count was served from the result cache
    assert got["passes"] == want["passes"]
    assert got["pending"] == want["pending"] == [0, 0, 0]
    assert got["after"] == want["after"] == want_9
    # the missed Clear came back on every owner: the union at replica 2
    assert got["remote"] == want["remote"]
    assert sum(r[0] for r in got["remote"]) == 2 * want_0
    assert got["digests"] == want["digests"] and len(got["digests"]) == 2 * N_SHARDS


def test_interval_loop_drains_the_debt():
    with _harness(3, replica_n=2, anti_entropy_interval=0.2, **FAST) as c:
        api = c[0].api
        _seed_data(api)
        inj = tfaults.FaultInjector(seed=5).partition(c[2].node.uri)
        c[0].client.fault_injector = inj
        cols = [s * SHARD_WIDTH + 77 for s in range(12)]
        api.import_bits("ft", "f", [4] * len(cols), cols)
        assert c[0].holder.pending_repair_count() > 0
        inj.heal(c[2].node.uri)
        c[0].probe_peers()
        deadline = time.time() + 30
        while time.time() < deadline and any(s.holder.pending_repair_count() for s in c.nodes):
            time.sleep(0.1)
        assert [s.holder.pending_repair_count() for s in c.nodes] == [0, 0, 0]
        for s in c.nodes:
            assert _count(s, "ft", "Count(Row(f=4))", remote=True) == sum(
                1 for x in range(12) if c[0].cluster.owns_shard(s.node.id, "ft", x)
            )
        assert all(s.ae_last is not None for s in c.nodes)


# ---------------------------------------------------------------------------
# the device side: a clean pass stages and evicts nothing; a repair drops
# the extents it makes stale
# ---------------------------------------------------------------------------


def _stage_answers(c, queries):
    return [c[0].api.query_response("ft", q).results[0] for q in queries]


def test_clean_pass_stages_and_evicts_nothing():
    from pilosa_tpu_torch.hbm import residency

    queries = ["Count(Row(f=0))", "Count(Intersect(Row(f=1), Row(f=2)))", "TopN(f, n=2)"]
    with _harness(3, replica_n=2) as c:
        _seed_data(c[0].api)
        for s in c.nodes:
            s.sync_holder()  # nothing drifted: merges nothing
        want = _stage_answers(c, queries)
        resident = [set(s.holder.dcache._entries) for s in c.nodes]
        assert sum(map(len, resident)) > 0, "the queries staged nothing"
        before = (residency.stats_snapshot()["restage_bytes"], [s.holder.dcache.stats_snapshot()["built_bytes"] for s in c.nodes])
        for s in c.nodes:
            assert s.sync_holder() == 0
            assert s.ae_last["blocks"] == 0 and s.ae_last["restage_bytes_after"] == s.ae_last["restage_bytes_before"]
        after = (residency.stats_snapshot()["restage_bytes"], [s.holder.dcache.stats_snapshot()["built_bytes"] for s in c.nodes])
        assert after == before
        assert [set(s.holder.dcache._entries) for s in c.nodes] == resident
        assert _stage_answers(c, queries) == want


def test_repair_delta_drops_the_stale_extent():
    """A set-and-clear delta to a fragment whose row is resident: the
    covering entries are dropped (never patched in place), and the next
    query re-stages them and answers the repaired bits."""
    from pilosa_tpu_torch.hbm import residency

    with _harness(1) as c:
        _seed_data(c[0].api)
        q = "Count(Row(f=0))"
        assert _count(c[0], "ft", q) == 12
        patches = residency.stats_snapshot()["extent_patches"]
        restaged = residency.stats_snapshot()["restage_bytes"]
        col = 3 * SHARD_WIDTH + 3  # row 0's bit in shard 3 (7*0 + 3)
        _http("POST", c[0].node.uri, "/internal/fragment/block/deltas",
              {"index": "ft", "field": "f", "view": "standard", "shard": 3,
               "sets": {"rows": [0, 0], "cols": [40, 41]}, "clears": {"rows": [0], "cols": [col % SHARD_WIDTH]}})
        assert _count(c[0], "ft", q) == 13
        stats = residency.stats_snapshot()
        assert stats["extent_patches"] == patches and stats["restage_bytes"] > restaged
        (row,) = c[0].api.query_response("ft", "Row(f=0)").results
        cols = row.columns().tolist()
        assert col not in cols and {3 * SHARD_WIDTH + 40, 3 * SHARD_WIDTH + 41} <= set(cols)
