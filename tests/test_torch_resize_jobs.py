"""The port's resize jobs against pilosa_tpu's, on the CPU.

A port `ClusterHarness(3, replica_n=2)` and a JAX one of the same shape
get the same seeded data over 16 shards (set, mutex and int fields, and
a keyed index); a fourth node joins each, then node1 is removed from
each. After each job every node of both clusters, and a port and a JAX
single node holding the same data, give identical bodies for a seeded
query set; the job records agree (state, action, the phase sequence,
`moved` and the fragments each node fetched), and so do the bits a Set
took inside the cutover.

Then the reference's lifecycle cases on the port (tests/test_cluster.py,
test_lifecycle.py, test_cluster_r3.py, test_liveness.py,
test_server.py): a join under writes with no freeze and no lost write,
the kill matrix (source, destination, coordinator), abort mid-stream,
after the joiner streamed and after the commit, the 400s of malformed
resize bodies (their status and error text held to the reference's),
the holder cleaner after a join and after a remove, a dead node's
removal, an unreachable member, the coordinator's role, a resized
cluster restarting from disk and the manual checkpoint resize. Hazard
(a) on a cluster: a node answers, gains the shard by a resize, answers
again. Every wait polls with a deadline.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import http.client
import json
import time

import numpy as np
import pytest

from pilosa_tpu.server.node import NodeServer as JNodeServer
from pilosa_tpu.testing import ClusterHarness as JClusterHarness
from pilosa_tpu_torch.cluster.topology import Node
from pilosa_tpu_torch.server import NodeServer
from pilosa_tpu_torch.server import faults as tfaults
from pilosa_tpu_torch.server import resize as tresize
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.testing import ClusterHarness

SHARDS = 16
SEED = 20261019
FAST = dict(retry_max_attempts=2, retry_base_backoff=0.01, breaker_threshold=2, breaker_cooldown=60.0, query_deadline=10.0)
T = dict(device="cpu")


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


def post(uri, path, body):
    status, got = request(uri, "POST", path, body)
    assert status == 200, (path, got)
    return got


def wait_job(uri: str, want: str = "DONE", timeout: float = 60.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        _, job = request(uri, "GET", "/cluster/resize/job")
        if job["state"] != "RUNNING":
            assert job["state"] == want, job
            return job
        time.sleep(0.02)
    raise AssertionError(f"resize job did not finish in {timeout} s")


def q(s, index: str, pql: str):
    return s.api.query_response(index, pql).results


def local_shards(s, index: str) -> set:
    idx = s.holder.index(index)
    return {sh for f in idx.fields(include_hidden=True) for v in f.views.values() for sh in v.fragments}


def only_owned(s, index: str) -> bool:
    return all(s.cluster.owns_shard(s.node.id, index, sh) for sh in local_shards(s, index))


def transfer_state_clean(*servers):
    for s in servers:
        assert s._transfer_captures == {}, s.node.id
        assert s._resize_ledger == {}, s.node.id


def load_rows(api, index: str, n_shards: int, offset: int) -> list:
    api.create_index(index)
    api.create_field(index, "f", {"type": "set"})
    cols = [s * SHARD_WIDTH + offset for s in range(n_shards)]
    api.import_bits(index, "f", [0] * len(cols), cols)
    return cols


# ---------------------------------------------------------------------------
# the port's jobs against the reference's
# ---------------------------------------------------------------------------


def _data():
    rng = np.random.default_rng(SEED)
    n = 4000
    cols = rng.integers(0, SHARDS * SHARD_WIDTH, n)
    f_rows = rng.integers(0, 6, n)
    m_cols = rng.choice(SHARDS * SHARD_WIDTH, 1500, replace=False)
    m_rows = rng.integers(0, 4, 1500)
    v_cols = rng.choice(SHARDS * SHARD_WIDTH, 1200, replace=False)
    v_vals = rng.integers(-1000, 1001, 1200)
    k_cols = [f"c{i}" for i in rng.permutation(80)]
    k_rows = [["a", "b", "c"][i % 3] for i in range(80)]
    return cols, f_rows, m_cols, m_rows, v_cols, v_vals, k_cols, k_rows


def load(uri: str) -> None:
    cols, f_rows, m_cols, m_rows, v_cols, v_vals, k_cols, k_rows = _data()
    post(uri, "/index/i", {})
    post(uri, "/index/i/field/f", {})
    post(uri, "/index/i/field/m", {"options": {"type": "mutex"}})
    post(uri, "/index/i/field/v", {"options": {"type": "int", "min": -1000, "max": 1000}})
    post(uri, "/index/i/field/f/import", {"rows": f_rows.tolist(), "cols": cols.tolist()})
    post(uri, "/index/i/field/m/import", {"rows": m_rows.tolist(), "cols": m_cols.tolist()})
    post(uri, "/index/i/field/v/import-value", {"cols": v_cols.tolist(), "values": v_vals.tolist()})
    post(uri, "/index/k", {"options": {"keys": True}})
    post(uri, "/index/k/field/kf", {"options": {"keys": True}})
    post(uri, "/index/k/field/kf/import", {"rowKeys": k_rows, "colKeys": k_cols})


QUERIES = [
    "Count(Row(f=1))",
    "Row(f=2)",
    "Count(Union(Row(f=0), Row(m=1)))",
    "Count(Intersect(Row(f=3), Row(m=2)))",
    "Count(Not(Row(f=4)))",
    "Shift(Row(f=5), n=1)",
    "TopN(f, n=4)",
    "TopN(m, Row(f=1), n=3)",
    "Rows(m)",
    "GroupBy(Rows(m), Rows(f), limit=12)",
    "Sum(field=v)",
    "Min(Row(f=2), field=v)",
    "Max(field=v)",
    "Count(Row(v > 100))",
    'Row(kf="a")',
    'Count(Row(kf="c"))',
    "TopN(kf, n=2)",
]
# writes every cluster takes inside its cutover (and the singles too)
CUTOVER_WRITES = [("i", f"Set({s * SHARD_WIDTH + 77}, f=9)") for s in range(SHARDS)] + [
    ("i", f"Set({3 * SHARD_WIDTH + 5}, m=3)"),
    ("k", 'Set("c900", kf="b")'),
]


def answers(uris) -> dict:
    out = {}
    for pql in QUERIES + ["Row(f=9)", "Count(Row(m=3))"]:
        index = "k" if "kf" in pql else "i"
        for uri in uris:
            status, got = request(uri, "POST", f"/index/{index}/query", pql.encode(), "text/plain")
            assert status == 200, (uri, pql, got)
            assert out.setdefault(pql, got) == got, (uri, pql, got, out[pql])
    return out


def run_job(coord, uri_path: str, body: dict) -> tuple:
    """One job through the coordinator's route with the cutover writes in
    its cutover phase: (job record, phase labels)."""
    phases = []

    def hook(label):
        phases.append(label)
        if label == "cutover":
            for index, pql in CUTOVER_WRITES:
                assert coord.api.query_response(index, pql).results[0] in (True, False)

    coord.resize_phase_hook = hook
    try:
        post(coord.node.uri, uri_path, body)
        job = wait_job(coord.node.uri, timeout=120)
    finally:
        coord.resize_phase_hook = None
    return job, phases


def _summary(job: dict) -> dict:
    return {
        "state": job["state"],
        "action": job["action"],
        "committed": job["committed"],
        "moved": sorted(tuple(m) for m in job["moved"]),
        "fetched": {k: v["fetched"] for k, v in job["transfers"].items()},
        "nodes": [(n["id"], n["isCoordinator"]) for n in job["nodes"]],
    }


def test_join_and_remove_answer_as_the_reference():
    with ClusterHarness(3, replica_n=2, in_memory=True, **T) as tc, JClusterHarness(3, replica_n=2, in_memory=True) as jc:
        t3 = NodeServer(None, "node3", replica_n=2, **T).start()
        j3 = JNodeServer(None, "node3", replica_n=2).start()
        t1 = NodeServer(None, "single", **T).start()
        j1 = JNodeServer(None, "single").start()
        try:
            for uri in (tc[0].node.uri, jc[0].node.uri, t1.node.uri, j1.node.uri):
                load(uri)
            for index, pql in CUTOVER_WRITES:
                q(t1, index, pql)
                j1.api.query(index, pql)
            singles = answers([t1.node.uri, j1.node.uri])
            # the join
            tj, tp = run_job(tc[0], "/cluster/join", {"id": "node3", "uri": t3.node.uri})
            jj, jp = run_job(jc[0], "/cluster/join", {"id": "node3", "uri": j3.node.uri})
            assert tp == jp == ["probe", "stream", "stream:node0", "stream:node1", "stream:node2", "stream:node3", "cutover", "committed"]
            assert _summary(tj) == _summary(jj)
            assert tj["transfers"]["node3"]["fetched"] > 0 and tj["moved"]
            ports = [s.node.uri for s in list(tc) + [t3]]
            refs = [s.node.uri for s in list(jc) + [j3]]
            assert answers(ports + refs) == singles
            # (e) the joiner's key stores forward a new key to the coordinator
            for uri in (t3.node.uri, j3.node.uri, t1.node.uri, j1.node.uri):
                status, got = request(uri, "POST", "/index/k/query", b'Set("c901", kf="a")', "text/plain")
                assert (status, got) == (200, {"results": [True]}), (uri, got)
            singles = answers([t1.node.uri, j1.node.uri])
            assert answers(ports + refs) == singles
            for s in list(tc) + [t3]:
                assert len(s.cluster.nodes) == 4 and s.state == "NORMAL" and only_owned(s, "i")
                assert s.holder.pending_repair_count() == 0
            transfer_state_clean(*tc, t3)
            # node1 leaves
            tr, tp = run_job(tc[0], "/cluster/resize/remove-node", {"id": "node1"})
            jr, jp = run_job(jc[0], "/cluster/resize/remove-node", {"id": "node1"})
            assert tp == jp == ["probe", "stream", "stream:node0", "stream:node2", "stream:node3", "cutover", "committed"]
            assert _summary(tr) == _summary(jr)
            live = [tc[0], tc[2], t3]
            assert answers([s.node.uri for s in live] + [jc[0].node.uri, jc[2].node.uri, j3.node.uri]) == singles
            for s in live:
                assert [n.id for n in s.cluster.nodes] == ["node0", "node2", "node3"] and only_owned(s, "i")
            assert all(n.id != "node1" for n in tc[1].cluster.nodes) and tc[1].state == "NORMAL"
            transfer_state_clean(*live)
        finally:
            for s in (t3, j3, t1, j1):
                s.stop()


# ---------------------------------------------------------------------------
# the reference's lifecycle cases
# ---------------------------------------------------------------------------


def test_join_via_coordinator_and_cleaner():
    """The joiner serves, and every node keeps only its own fragments."""
    with ClusterHarness(2, in_memory=True, **T) as c:
        cols = load_rows(c[0].api, "j", 24, 7)
        joiner = NodeServer(None, "node2", **T).start()
        try:
            job = post(c[0].node.uri, "/cluster/join", {"id": joiner.node.id, "uri": joiner.node.uri})
            assert job["state"] in ("RUNNING", "DONE")
            job = wait_job(c[0].node.uri)
            assert job["stats"]["legs"] > 0 and job["stats"]["bytes_streamed"] > 0
            assert local_shards(joiner, "j")
            for s in (c[0], c[1], joiner):
                assert len(s.cluster.nodes) == 3 and s.state == "NORMAL"
                assert q(s, "j", "Count(Row(f=0))") == [len(cols)]
                assert only_owned(s, "j"), s.node.id
            assert any(n.id == joiner.node.id for sh in range(24) for n in c[0].cluster.shard_nodes("j", sh))
        finally:
            joiner.stop()


def test_join_idempotent_and_gated():
    with ClusterHarness(2, in_memory=True, **T) as c:
        job = post(c[0].node.uri, "/cluster/join", {"id": c[1].node.id, "uri": c[1].node.uri})
        assert job["action"] == "noop"
        status, _ = request(c[1].node.uri, "POST", "/cluster/join", {"id": "x", "uri": "http://localhost:1"})
        assert status == 400  # not the coordinator


@pytest.mark.parametrize("removed", [2, 0], ids=["member", "coordinator"])
def test_remove_node_rebalances(removed):
    with ClusterHarness(3, replica_n=2, in_memory=True, **T) as c:
        cols = load_rows(c[0].api, "rm", 16, 3)
        post(c[0].node.uri, "/cluster/resize/remove-node", {"id": c[removed].node.id})
        wait_job(c[0].node.uri)
        rest = [s for i, s in enumerate(c) if i != removed]
        for s in rest:
            assert len(s.cluster.nodes) == 2 and only_owned(s, "rm")
            assert q(s, "rm", "Count(Row(f=0))") == [len(cols)]
        gone = c[removed]
        assert gone.state == "NORMAL" and all(n.id != gone.node.id for n in gone.cluster.nodes)
        coords = [n for n in rest[0].cluster.nodes if n.is_coordinator]
        assert len(coords) == 1
        new_coord = next(s for s in rest if s.node.id == coords[0].id)
        assert new_coord.node.is_coordinator and new_coord.api.resize_job()["state"] in ("NONE", "DONE")


def test_joiner_does_not_become_coordinator():
    with ClusterHarness(2, in_memory=True, **T) as c:
        joiner = NodeServer(None, "aaa-joiner", **T).start()  # its id sorts first
        try:
            post(c[0].node.uri, "/cluster/join", {"id": joiner.node.id, "uri": joiner.node.uri, "isCoordinator": True})
            wait_job(c[0].node.uri)
            assert [n.id for n in c[0].cluster.nodes if n.is_coordinator] == [c[0].node.id]
            assert not joiner.node.is_coordinator
        finally:
            joiner.stop()


def test_join_unreachable_member_aborts_and_rolls_back():
    with ClusterHarness(3, in_memory=True, **T, **FAST) as c:
        old_ids = {n.id for n in c[0].cluster.nodes}
        c[2].stop()
        joiner = NodeServer(None, "joiner2", **T).start()
        try:
            post(c[0].node.uri, "/cluster/join", {"id": joiner.node.id, "uri": joiner.node.uri})
            job = wait_job(c[0].node.uri, want="ABORTED")
            assert job["error"]
            for s in (c[0], c[1]):
                assert {n.id for n in s.cluster.nodes} == old_ids and s.state == "NORMAL"
            assert [n.id for n in joiner.cluster.nodes] == [joiner.node.id] and joiner.state == "NORMAL"
        finally:
            joiner.stop()


def test_abort_with_no_job_and_probe_defers():
    with ClusterHarness(2, in_memory=True, **T) as c:
        _, out = request(c[0].node.uri, "POST", "/cluster/resize/abort")
        assert out["state"] == "NONE"
        assert request(c[0].node.uri, "GET", "/cluster/resize/job")[1] == {"state": "NONE"}
        c[0].state = "RESIZING"  # the liveness tick leaves the status flow to the job
        assert c[0].run_probe_pass() is False
        status, out = request(c[0].node.uri, "POST", "/index/x", {})
        assert status == 503 and "RESIZING" in out["error"]
        c[0].state = "NORMAL"


def test_streaming_join_no_freeze_and_no_lost_writes():
    """Inside the cutover the cluster still takes writes and answers in
    state NORMAL; those writes are on every node after the commit."""
    with ClusterHarness(2, in_memory=True, **T) as c:
        api = c[0].api
        cols = load_rows(api, "lj", 16, 0)
        extra = [s * SHARD_WIDTH + 100 for s in range(16)]
        joiner = NodeServer(None, "stream-joiner", **T).start()
        during = {}

        def hook(phase):
            if phase == "cutover":
                during["state"] = c[0].state
                during["job"] = c[0].resize_job["state"]
                api.import_bits("lj", "f", [0] * len(extra), extra)
                (during["count"],) = q(c[0], "lj", "Count(Row(f=0))")

        c[0].resize_phase_hook = hook
        try:
            post(c[0].node.uri, "/cluster/join", {"id": joiner.node.id, "uri": joiner.node.uri})
            job = wait_job(c[0].node.uri)
            assert (during["state"], during["job"], during["count"]) == ("NORMAL", "RUNNING", len(cols) + len(extra))
            assert job["committed"] is True and job["transfers"]
            model = sorted(set(cols + extra))
            for s in (c[0], c[1], joiner):
                assert q(s, "lj", "Row(f=0)")[0].columns().tolist() == model, s.node.id
            transfer_state_clean(c[0], c[1], joiner)
        finally:
            c[0].resize_phase_hook = None
            joiner.stop()


def test_writes_during_the_stream_reach_the_joiner():
    """Writes between the joiner's snapshot and the cutover ride the
    captures: the job's catch-up drains apply them there."""
    with ClusterHarness(2, in_memory=True, **T) as c:
        api = c[0].api
        cols = load_rows(api, "ws", 16, 1)
        joiner = NodeServer(None, "zz-joiner", **T).start()
        extra = [s * SHARD_WIDTH + 200 for s in range(16)]

        def hook(phase):
            if phase == f"stream:{joiner.node.id}":
                c[0].resize_phase_hook = None
                # after the members streamed, before the joiner: its legs' captures
                api.import_bits("ws", "f", [0] * len(extra), extra)

        c[0].resize_phase_hook = hook
        before = tresize.stats_snapshot()
        try:
            post(c[0].node.uri, "/cluster/join", {"id": joiner.node.id, "uri": joiner.node.uri})
            job = wait_job(c[0].node.uri)
            model = sorted(set(cols + extra))
            for s in (c[0], c[1], joiner):
                assert q(s, "ws", "Row(f=0)")[0].columns().tolist() == model, s.node.id
            after = tresize.stats_snapshot()
            assert after["fragments_streamed"] > before["fragments_streamed"]
            assert after["catchup_rounds"] > before["catchup_rounds"] and job["stats"]["catchup_rounds"] > 0
        finally:
            joiner.stop()


def test_resize_kill_source_aborts_cleanly():
    with ClusterHarness(2, in_memory=True, **T, **FAST) as c:
        cols = load_rows(c[0].api, "ks", 16, 3)
        old_ids = {n.id for n in c[0].cluster.nodes}
        joiner = NodeServer(None, "ks-joiner", **T, **FAST).start()
        inj = tfaults.FaultInjector(seed=7)
        inj.add_rule("refuse", path="/internal/fragment/data")
        tfaults.install_injector(inj)
        try:
            post(c[0].node.uri, "/cluster/join", {"id": joiner.node.id, "uri": joiner.node.uri})
            job = wait_job(c[0].node.uri, want="ABORTED", timeout=120)
            assert job["error"] and inj.count("refuse") > 0
            for s in (c[0], c[1]):
                assert {n.id for n in s.cluster.nodes} == old_ids and s.state == "NORMAL"
                assert s.holder.pending_repair_count() == 0
            assert [n.id for n in joiner.cluster.nodes] == [joiner.node.id]
            assert joiner.holder.index("ks") is None or not local_shards(joiner, "ks")
            transfer_state_clean(c[0], c[1], joiner)
            tfaults.uninstall_injector()
            for s in c:
                s.breakers.reset()
            joiner.breakers.reset()
            assert q(c[0], "ks", "Count(Row(f=0))") == [len(cols)]
            post(c[0].node.uri, "/cluster/join", {"id": joiner.node.id, "uri": joiner.node.uri})
            wait_job(c[0].node.uri, timeout=120)
            for s in (c[0], c[1], joiner):
                assert q(s, "ks", "Count(Row(f=0))") == [len(cols)], s.node.id
        finally:
            tfaults.uninstall_injector()
            joiner.stop()


def test_resize_kill_destination_aborts_cleanly():
    # the default breaker: the rollback's messages must still reach node1
    with ClusterHarness(3, replica_n=2, in_memory=True, **T) as c:
        cols = load_rows(c[0].api, "kd", 24, 5)
        old_ids = {n.id for n in c[0].cluster.nodes}
        captured_mid = {}

        def hook(phase):
            if phase == f"stream:{c[1].node.id}":
                captured_mid["n"] = sum(len(s._transfer_captures) for s in c.nodes)

        c[0].resize_phase_hook = hook
        inj = tfaults.FaultInjector(seed=11)
        inj.add_rule("refuse", uri=c[1].node.uri, path="/internal/resize/stream")
        tfaults.install_injector(inj)
        try:
            post(c[0].node.uri, "/cluster/resize/remove-node", {"id": c[2].node.id})
            job = wait_job(c[0].node.uri, want="ABORTED", timeout=120)
            assert job["error"] and captured_mid.get("n", 0) > 0
            for s in c.nodes:
                assert {n.id for n in s.cluster.nodes} == old_ids and s.state == "NORMAL"
                assert s.holder.pending_repair_count() == 0 and only_owned(s, "kd")
            transfer_state_clean(*c.nodes)
            tfaults.uninstall_injector()
            for s in c.nodes:
                s.breakers.reset()
                assert q(s, "kd", "Count(Row(f=0))") == [len(cols)], s.node.id
        finally:
            c[0].resize_phase_hook = None
            tfaults.uninstall_injector()


def test_resize_kill_coordinator_mid_job_cluster_survives():
    with ClusterHarness(2, in_memory=True, **T, **FAST) as c:
        cols = load_rows(c[0].api, "kc", 16, 8)
        old_ids = {n.id for n in c[0].cluster.nodes}
        joiner = NodeServer(None, "kc-joiner", **T).start()
        inj = tfaults.FaultInjector(seed=13)
        c[0].client.fault_injector = inj

        def hook(phase):
            if phase == f"stream:{joiner.node.id}":
                inj.add_rule("partition")  # the coordinator is cut off

        c[0].resize_phase_hook = hook
        try:
            post(c[0].node.uri, "/cluster/join", {"id": joiner.node.id, "uri": joiner.node.uri})
            job = wait_job(c[0].node.uri, want="ABORTED", timeout=120)
            assert job["error"]
            assert {n.id for n in c[1].cluster.nodes} == old_ids and c[1].state == "NORMAL"
            assert q(c[1], "kc", "Count(Row(f=0))") == [len(cols)]
            assert [n.id for n in joiner.cluster.nodes] == [joiner.node.id]
            inj.heal()
            c[0].resize_phase_hook = None
            c[0].breakers.reset()
            c[0].probe_peers()
            post(c[0].node.uri, "/cluster/join", {"id": joiner.node.id, "uri": joiner.node.uri})
            wait_job(c[0].node.uri, timeout=120)
            for s in (c[0], c[1], joiner):
                assert q(s, "kc", "Count(Row(f=0))") == [len(cols)], s.node.id
            transfer_state_clean(c[0], c[1], joiner)
        finally:
            c[0].resize_phase_hook = None
            c[0].client.fault_injector = None
            joiner.stop()


def test_abort_mid_stream_restores_pre_resize_state():
    with ClusterHarness(3, replica_n=2, in_memory=True, **T) as c:
        load_rows(c[0].api, "ab", 24, 2)
        model = q(c[0], "ab", "Row(f=0)")[0].columns().tolist()
        for s in c:  # every node stages its fragments on its device cache
            q(s, "ab", "Count(Row(f=0))")
        pre_bytes = [s.holder.dcache.stats_snapshot()["resident_bytes"] for s in c]
        old_ids = {n.id for n in c[0].cluster.nodes}
        pre = {s.node.id: sorted(local_shards(s, "ab")) for s in c}

        def hook(phase):
            if phase == f"stream:{c[1].node.id}":
                c[0].abort_resize()

        c[0].resize_phase_hook = hook
        try:
            post(c[0].node.uri, "/cluster/resize/remove-node", {"id": c[2].node.id})
            job = wait_job(c[0].node.uri, want="ABORTED")
            assert job["error"] == "aborted"
            for s, b in zip(c, pre_bytes):
                assert {n.id for n in s.cluster.nodes} == old_ids and s.state == "NORMAL"
                assert s.holder.pending_repair_count() == 0
                assert sorted(local_shards(s, "ab")) == pre[s.node.id], s.node.id
                assert s.holder.dcache.stats_snapshot()["resident_bytes"] <= b
            transfer_state_clean(*c.nodes)
            assert q(c[0], "ab", "Row(f=0)")[0].columns().tolist() == model
            c[0].resize_phase_hook = None
            post(c[0].node.uri, "/cluster/resize/remove-node", {"id": c[2].node.id})
            wait_job(c[0].node.uri)
            for s in (c[0], c[1]):
                assert q(s, "ab", "Row(f=0)")[0].columns().tolist() == model, s.node.id
        finally:
            c[0].resize_phase_hook = None


def test_abort_after_joiner_streamed_deletes_joiner_fragments():
    with ClusterHarness(2, in_memory=True, **T) as c:
        cols = load_rows(c[0].api, "aj", 16, 11)
        old_ids = {n.id for n in c[0].cluster.nodes}
        joiner = NodeServer(None, "zz-joiner", **T).start()
        joiner.api.create_index("aj")
        joiner.api.create_field("aj", "f", {"type": "set"})
        streamed = {}

        def hook(phase):
            if phase == "cutover":
                streamed["frags"] = len(local_shards(joiner, "aj"))
                c[0].abort_resize()

        c[0].resize_phase_hook = hook
        try:
            post(c[0].node.uri, "/cluster/join", {"id": joiner.node.id, "uri": joiner.node.uri})
            job = wait_job(c[0].node.uri, want="ABORTED")
            assert job["error"] == "aborted" and streamed["frags"] > 0
            assert [n.id for n in joiner.cluster.nodes] == [joiner.node.id]
            assert not local_shards(joiner, "aj"), "the joiner kept fetched fragments"
            for s in (c[0], c[1]):
                assert {n.id for n in s.cluster.nodes} == old_ids and s.state == "NORMAL"
            transfer_state_clean(c[0], c[1], joiner)
            c[0].resize_phase_hook = None
            post(c[0].node.uri, "/cluster/join", {"id": joiner.node.id, "uri": joiner.node.uri})
            wait_job(c[0].node.uri)
            for s in (c[0], c[1], joiner):
                assert q(s, "aj", "Row(f=0)")[0].columns().tolist() == sorted(cols), s.node.id
        finally:
            c[0].resize_phase_hook = None
            joiner.stop()


def test_abort_after_commit_is_noop():
    with ClusterHarness(2, in_memory=True, **T) as c:
        cols = load_rows(c[0].api, "cm", 12, 4)
        joiner = NodeServer(None, "cm-joiner", **T).start()
        seen = {}

        def hook(phase):
            if phase == "committed":
                seen["state"] = c[0].abort_resize()["state"]

        c[0].resize_phase_hook = hook
        try:
            post(c[0].node.uri, "/cluster/join", {"id": joiner.node.id, "uri": joiner.node.uri})
            job = wait_job(c[0].node.uri)
            assert seen["state"] == "RUNNING" and job["committed"] is True
            for s in (c[0], c[1], joiner):
                assert len(s.cluster.nodes) == 3 and s.state == "NORMAL"
                assert q(s, "cm", "Count(Row(f=0))") == [len(cols)], s.node.id
        finally:
            c[0].resize_phase_hook = None
            joiner.stop()


COERCION = [
    ("POST", "/internal/resize/stream", {}),
    ("POST", "/internal/resize/stream", {"job": "j", "nodes": "nope"}),
    ("POST", "/internal/resize/stream", {"job": "j", "nodes": [{"uri": "u"}]}),
    ("POST", "/internal/resize/stream", {"job": "j", "nodes": [{"id": "a"}], "postCommit": "yes"}),
    ("POST", "/internal/resize", {"nodes": [{"id": "a"}], "replicaN": "two"}),
    ("POST", "/internal/resize", [1, 2]),
    ("POST", "/internal/resize/catchup", {"job": ""}),
    ("POST", "/cluster/resize/remove-node", {}),
    ("POST", "/cluster/join", {"id": "x"}),
    ("GET", "/internal/fragment/delta?index=cx&field=f&shard=0", None),
    ("GET", "/internal/fragment/delta?index=cx&field=f&shard=0&job=j1", None),
    ("GET", "/internal/fragment/data?index=cx&field=f&shard=9", None),
    ("GET", "/internal/index/nope/fragments", None),
]


def test_resize_surface_errors_as_the_reference():
    """Malformed resize bodies are 400s naming the field, a delta with no
    capture a 410, a missing fragment or index a 404: the status and the
    error text of the reference's."""
    t = NodeServer(None, "node0", **T).start()
    j = JNodeServer(None, "node0").start()
    try:
        for s in (t, j):
            s.api.create_index("cx")
            s.api.create_field("cx", "f", {"type": "set"})
        for method, path, body in COERCION:
            got = request(t.node.uri, method, path, b"" if body is None else body)
            want = request(j.node.uri, method, path, b"" if body is None else body)
            assert got == want, (path, got, want)
            assert got[0] in (400, 404, 410), got
    finally:
        t.stop()
        j.stop()


def test_remove_dead_node_succeeds():
    with ClusterHarness(3, replica_n=2, in_memory=True, **T, **FAST) as c:
        cols = load_rows(c[0].api, "dd", 16, 4)
        c[2].stop()
        post(c[0].node.uri, "/cluster/resize/remove-node", {"id": c[2].node.id})
        wait_job(c[0].node.uri)
        for s in (c[0], c[1]):
            assert len(s.cluster.nodes) == 2 and only_owned(s, "dd")
            assert q(s, "dd", "Count(Row(f=0))") == [len(cols)], s.node.id


def test_stale_extent_on_a_node_that_gains_a_shard():
    """(a) Every node answers first (staging its extents, node0-2 with no
    copy of some shards node3's removal hands them), then gains those
    shards: the same queries through each equal numpy."""
    with ClusterHarness(4, replica_n=2, in_memory=True, **T) as c:
        rng = np.random.default_rng(SEED)
        c[0].api.create_index("st")
        c[0].api.create_field("st", "f", {"type": "set"})
        cols = np.unique(rng.integers(0, 16 * SHARD_WIDTH, 3000)).astype(np.uint64)
        c[0].api.import_bits("st", "f", np.ones(len(cols), np.uint64), cols)
        owned = {s.node.id: local_shards(s, "st") for s in c.nodes[:3]}
        for s in c:
            assert q(s, "st", "Count(Row(f=1))") == [len(cols)]
            assert q(s, "st", "Row(f=1)")[0].columns().tolist() == cols.tolist()
        post(c[0].node.uri, "/cluster/resize/remove-node", {"id": "node3"})
        wait_job(c[0].node.uri)
        gained = {s.node.id: local_shards(s, "st") - owned[s.node.id] for s in c.nodes[:3]}
        assert any(gained.values()), gained
        for s in c.nodes[:3]:
            assert q(s, "st", "Count(Row(f=1))") == [len(cols)], s.node.id
            assert q(s, "st", "Row(f=1)")[0].columns().tolist() == cols.tolist(), s.node.id
            for shard in gained[s.node.id]:  # this node's own copy, on its own
                got = s.api.query_response("st", "Row(f=1)", shards=[shard]).results[0].columns()
                want = cols[(cols >= shard * SHARD_WIDTH) & (cols < (shard + 1) * SHARD_WIDTH)]
                assert got.tolist() == want.tolist(), (s.node.id, shard)


def test_resized_cluster_restarts_from_disk(tmp_path):
    c = ClusterHarness(3, replica_n=2, base_dir=str(tmp_path), **T)
    joiner = NodeServer(str(tmp_path / "node3"), "node3", replica_n=2, **T).start()
    try:
        cols = load_rows(c[0].api, "pt", 24, 9)
        post(c[0].node.uri, "/cluster/join", {"id": joiner.node.id, "uri": joiner.node.uri})
        wait_job(c[0].node.uri)
        ports = {s.node.id: int(s.node.uri.rsplit(":", 1)[1]) for s in [c[0], c[1], c[2], joiner]}
    finally:
        joiner.stop()
        c.close()
    revived = []
    try:
        for nid in sorted(ports):
            revived.append(NodeServer(str(tmp_path / nid), f"wrong-{nid}", bind=f"localhost:{ports[nid]}", **T).start())
        for s in revived:
            assert s.topology_restored and {n.id for n in s.cluster.nodes} == set(ports) and s.cluster.replica_n == 2
        assert [s.node.id for s in revived if s.node.is_coordinator] == ["node0"]
        for s in revived:
            assert q(s, "pt", "Count(Row(f=0))") == [len(cols)], s.node.id
            assert only_owned(s, "pt")
    finally:
        # the last started first: each node puts back the result-cache
        # budget it found, so node0 stopping last leaves the process's
        for s in reversed(revived):
            s.stop()


def test_resize_add_node_by_checkpoint():
    """The manual resize: the new node fetches with the old membership,
    then every member installs the new one."""
    with ClusterHarness(2, in_memory=True, **T) as c:
        c[0].api.create_index("grow")
        c[0].api.create_field("grow", "f", {"type": "set"})
        cols = [(i % 16) * SHARD_WIDTH + i for i in range(160)]
        c[0].api.import_bits("grow", "f", [0] * len(cols), cols)
        n2 = NodeServer(None, "node2", **T).start()
        try:
            members = [Node(id=s.node.id, uri=s.node.uri) for s in (c[0], c[1], n2)]
            n2.api.apply_schema(c[0].api.schema())
            assert n2.resize_to(members, old_nodes=[Node(id=s.node.id, uri=s.node.uri) for s in (c[0], c[1])]) > 0
            c[0].resize_to(members)
            c[1].resize_to(members)
            for s in (c[0], c[1], n2):
                assert q(s, "grow", "Count(Row(f=0))") == [160], s.node.id
        finally:
            n2.stop()


def test_set_coordinator_moves_the_role():
    with ClusterHarness(3, in_memory=True, **T) as c:
        out = post(c[0].node.uri, "/cluster/resize/set-coordinator", {"id": "node2"})
        assert out == {"coordinator": "node2"}
        for s in c:
            assert [n.id for n in s.cluster.nodes if n.is_coordinator] == ["node2"]
        status, _ = request(c[0].node.uri, "POST", "/cluster/resize/set-coordinator", {"id": "nope"})
        assert status == 404


def test_writes_routed_by_a_replaced_placement_go_again():
    """A peer refuses a frame or a Set leg for a shard it does not own
    under its installed placement (503, retryable), and a router whose
    placement a resize replaced during an import or a Set routes it again,
    so the new owners hold the writes and no node gets back a fragment of
    a shard it gave up."""
    with ClusterHarness(3, replica_n=2, in_memory=True, **T, **FAST) as c:
        api = c[0].api
        api.create_index("rr")
        api.create_field("rr", "f", {"type": "set"})
        s = next(sh for sh in range(16) if not c[2].cluster.owns_shard("node2", "rr", sh))
        status, out = request(c[2].node.uri, "POST", "/internal/index/rr/field/f/import",
                              {"rows": [1], "cols": [s * SHARD_WIDTH + 1]})
        assert status == 503 and "placement" in out["error"], out
        status, out = request(c[2].node.uri, "POST", "/internal/index/rr/query",
                              {"query": f"Set({s * SHARD_WIDTH + 1}, f=1)", "shards": [s], "remote": True})
        assert status == 503 and "placement" in out["error"], out
        assert local_shards(c[2], "rr") == set()
        # node2 leaves while an import and a Set are being routed by node0
        two = [Node(id=n.node.id, uri=n.node.uri, is_coordinator=(n is c[0])) for n in c.nodes[:2]]
        orig_import, orig_write = type(api)._import_once, type(c[0].executor)._write_by_column_once
        calls = []

        def import_once(self, cl, *a, **kw):
            calls.append("import")
            if len(calls) == 1:
                for n in c:
                    n.set_topology(two, replica_n=2)
            return orig_import(self, cl, *a, **kw)

        def write_once(self, idx, call, cl):
            calls.append("set")
            if calls.count("set") == 1:
                for n in c:
                    n.set_topology([Node(id=x.node.id, uri=x.node.uri, is_coordinator=(x is c[0])) for x in c.nodes], replica_n=2)
            return orig_write(self, idx, call, cl)

        cols = [sh * SHARD_WIDTH + 5 for sh in range(16)]
        type(api)._import_once = import_once
        try:
            out = api.import_bits("rr", "f", [1] * len(cols), cols)
        finally:
            type(api)._import_once = orig_import
        assert calls == ["import", "import"] and out["applied"] == out["expected"] == 32, out
        for n in c.nodes[:2]:
            assert q(n, "rr", "Count(Row(f=1))") == [16]
        assert local_shards(c[2], "rr") == set() and c[2].holder.pending_repair_count() == 0
        # and back to three while a Set is routed by the two-node placement
        type(c[0].executor)._write_by_column_once = write_once
        try:
            for n in c.nodes[:2]:
                n.set_topology(two, replica_n=2)
            assert q(c[0], "rr", f"Set({s * SHARD_WIDTH + 9}, f=2)") == [True]
        finally:
            type(c[0].executor)._write_by_column_once = orig_write
        assert calls.count("set") == 2
        owners = [n for n in c if c[0].cluster.owns_shard(n.node.id, "rr", s)]
        for n in owners:
            assert q(n, "rr", "Row(f=2)")[0].columns().tolist() == [s * SHARD_WIDTH + 9], n.node.id
