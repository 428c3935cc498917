"""The port's placement, transport policy, wire forms and internode client
against pilosa_tpu's own modules, on the same inputs.

- Placement (`cluster/topology.py`): fnv1a64 vectors, jump hashing,
  and 1,000 random (index, shard) pairs at n = 1..5 nodes and ReplicaN
  = 1..3 give the same partitions and owners; `shards_by_node` and
  `shards_by_all_owners` with down nodes, `contains_shards`,
  `determine_state`, `diff`, `frag_sources` and the JSON forms agree.
- Transport policy (`server/faults.py`): RetryPolicy backoffs under one
  seed, DeadlineBudget and CircuitBreaker transitions under an injected
  clock, BreakerRegistry snapshots and FaultInjector rule firing, step
  by step against the reference's.
- Wire (`server/wire.py`): encode_result of every result type gives
  byte-identical JSON, and decode_result inverts it; the binary array
  frames are byte-identical and keep the reference's decode bound.
- The InternalClient against a live port node on the CPU: retries
  through injected 500s, no retry of a 4xx, an open breaker failing
  fast, a probe passing it, key translation forwarded to the primary.
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import json
import random
import time
import urllib.error

import numpy as np
import pytest
import torch

from pilosa_tpu.cluster import topology as jtopo
from pilosa_tpu.core.row import Row as JRow
from pilosa_tpu.exec.executor import FieldRow as JFieldRow
from pilosa_tpu.exec.executor import GroupCount as JGroupCount
from pilosa_tpu.exec.executor import Pair as JPair
from pilosa_tpu.exec.executor import ValCount as JValCount
from pilosa_tpu.ops import bitmap as job
from pilosa_tpu.server import faults as jfaults
from pilosa_tpu.server import wire as jwire
from pilosa_tpu_torch.cluster import topology as ttopo
from pilosa_tpu_torch.core.row import Row as TRow
from pilosa_tpu_torch.exec.executor import FieldRow as TFieldRow
from pilosa_tpu_torch.exec.executor import GroupCount as TGroupCount
from pilosa_tpu_torch.exec.executor import Pair as TPair
from pilosa_tpu_torch.exec.executor import ValCount as TValCount
from pilosa_tpu_torch.ops import bitmap as tob
from pilosa_tpu_torch.server import NodeServer as TNodeServer
from pilosa_tpu_torch.server import faults as tfaults
from pilosa_tpu_torch.server import wire as twire
from pilosa_tpu_torch.server.client import BreakerOpenError, ClientError, InternalClient
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _clusters(n: int, replica_n: int, down=()):
    ids = [f"node{i}" for i in random.Random(n).sample(range(10), n)]
    j = jtopo.Cluster(
        nodes=[jtopo.Node(id=i, uri=f"http://h{i}:1", state="DOWN" if i in down else "READY") for i in ids],
        replica_n=replica_n,
    )
    t = ttopo.Cluster(
        nodes=[ttopo.Node(id=i, uri=f"http://h{i}:1", state="DOWN" if i in down else "READY") for i in ids],
        replica_n=replica_n,
    )
    return j, t


@pytest.mark.parametrize("data", [b"", b"a", b"foobar", b"i" + (7).to_bytes(8, "big"), bytes(range(256))])
def test_fnv1a64_vectors(data):
    assert ttopo.fnv1a64(data) == jtopo.fnv1a64(data)
    if data == b"a":
        assert ttopo.fnv1a64(data) == 0xAF63DC4C8601EC8C  # the published FNV-1a vector


def test_jump_and_mod_hashers():
    rng = random.Random(7)
    for _ in range(2000):
        key, n = rng.getrandbits(64), rng.randint(0, 40)
        assert ttopo.JumpHasher().hash(key, n) == jtopo.JumpHasher().hash(key, n)
        assert ttopo.ModHasher().hash(key, n) == jtopo.ModHasher().hash(key, n)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("replica_n", [1, 2, 3])
def test_placement_identical(n, replica_n):
    j, t = _clusters(n, replica_n)
    rng = np.random.default_rng(n * 10 + replica_n)
    for _ in range(1000):
        index = "".join(rng.choice(list("abcxyz"), rng.integers(1, 6)))
        shard = int(rng.integers(0, 1 << 20))
        assert t.partition(index, shard) == j.partition(index, shard)
        assert [x.id for x in t.shard_nodes(index, shard)] == [x.id for x in j.shard_nodes(index, shard)]
        assert t.primary_node(index, shard).id == j.primary_node(index, shard).id
        assert t.owns_shard(t.nodes[0].id, index, shard) == j.owns_shard(j.nodes[0].id, index, shard)
    shards = list(range(300))
    for node in t.nodes:
        assert t.contains_shards("i", shards, node.id) == j.contains_shards("i", shards, node.id)


@pytest.mark.parametrize("n,replica_n,n_down", [(3, 2, 0), (3, 2, 1), (4, 3, 2), (5, 2, 1), (5, 1, 2)])
def test_shards_by_node_with_down_nodes(n, replica_n, n_down):
    j0, _ = _clusters(n, replica_n)
    down = [x.id for x in j0.nodes[:n_down]]
    j, t = _clusters(n, replica_n, down=down)
    shards = list(range(512))
    assert t.shards_by_node("c", shards) == j.shards_by_node("c", shards)
    assert t.shards_by_all_owners("c", shards) == j.shards_by_all_owners("c", shards)
    for ids in ([], down, [x.id for x in t.nodes]):
        assert t.determine_state(set(ids)) == j.determine_state(set(ids))


def test_diff_frag_sources_and_json():
    for n, replica_n in ((3, 1), (3, 2), (4, 2)):
        j, t = _clusters(n, replica_n)
        frags_j = [jtopo.Frag("f", "standard", s) for s in range(64)]
        frags_t = [ttopo.Frag("f", "standard", s) for s in range(64)]
        for jto, tto in (
            (j.with_added_node(jtopo.Node(id="zz", uri="http://z:1")), t.with_added_node(ttopo.Node(id="zz", uri="http://z:1"))),
            (j.with_removed_node(j.nodes[1].id), t.with_removed_node(t.nodes[1].id)),
        ):
            assert t.diff(tto) == j.diff(jto)
            try:
                want = {k: [s.to_json() for s in v] for k, v in j.frag_sources(jto, "i", frags_j).items()}
            except jtopo.ClusterError as e:
                with pytest.raises(ttopo.ClusterError, match=str(e)[:20]):
                    t.frag_sources(tto, "i", frags_t)
                continue
            got = {k: [s.to_json() for s in v] for k, v in t.frag_sources(tto, "i", frags_t).items()}
            assert got == want
        with pytest.raises(ttopo.ClusterError):
            t.diff(t.with_removed_node(t.nodes[0].id).with_added_node(ttopo.Node(id="q")))
        assert json.dumps(t.to_json()) == json.dumps(j.to_json())
        back = ttopo.Cluster.from_json(t.to_json())
        assert back.to_json() == t.to_json()
        assert t.mesh_peers(t.nodes[0].id) == [] and t.mesh_group_of("nope") == ""


# ---------------------------------------------------------------------------
# transport policy
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.mark.parametrize("code", [200, 400, 404, 408, 409, 429, 500, 502, 503])
def test_retryable_status(code):
    assert tfaults.retryable_status(code) == jfaults.retryable_status(code)


def test_retry_policy_and_budget():
    for jitter in (0.0, 0.5):
        jp = jfaults.RetryPolicy(max_attempts=4, base_backoff=0.05, max_backoff=0.3, jitter=jitter, seed=3)
        tp = tfaults.RetryPolicy(max_attempts=4, base_backoff=0.05, max_backoff=0.3, jitter=jitter, seed=3)
        assert [tp.backoff(a) for a in range(1, 9)] == [jp.backoff(a) for a in range(1, 9)]
    with pytest.raises(ValueError):
        tfaults.RetryPolicy(max_attempts=0)
    jclk, tclk = FakeClock(), FakeClock()
    jb, tb = jfaults.DeadlineBudget(1.5, clock=jclk), tfaults.DeadlineBudget(1.5, clock=tclk)
    for dt in (0.0, 0.5, 0.9, 0.2):
        jclk.advance(dt)
        tclk.advance(dt)
        assert (tb.remaining(), tb.expired(), tb.elapsed()) == (jb.remaining(), jb.expired(), jb.elapsed())


# (operation, argument): the same script drives both breakers
_BREAKER_SCRIPT = [
    ("fail", None), ("allow", None), ("fail", None), ("succeed", None), ("fail", None), ("fail", None),
    ("fail", None), ("allow", None), ("tick", 1.0), ("allow", None), ("tick", 1.5), ("allow", None),
    ("allow", None), ("neutral", None), ("allow", None), ("fail", None), ("allow", None), ("tick", 2.5),
    ("allow", None), ("succeed", None), ("allow", None), ("allow", None),
]


@pytest.mark.parametrize("threshold,cooldown", [(1, 2.0), (3, 2.0), (2, 0.5)])
def test_circuit_breaker_transitions(threshold, cooldown):
    jclk, tclk = FakeClock(), FakeClock()
    jt, tt = [], []
    jb = jfaults.CircuitBreaker(threshold, cooldown, clock=jclk, on_transition=lambda a, b: jt.append((a, b)))
    tb = tfaults.CircuitBreaker(threshold, cooldown, clock=tclk, on_transition=lambda a, b: tt.append((a, b)))
    for op, arg in _BREAKER_SCRIPT:
        outs = []
        for br, clk in ((jb, jclk), (tb, tclk)):
            if op == "tick":
                clk.advance(arg)
                outs.append(None)
            elif op == "allow":
                outs.append(br.allow())
            elif op == "fail":
                outs.append(br.record_failure())
            elif op == "succeed":
                outs.append(br.record_success())
            else:
                outs.append(br.record_neutral())
        assert outs[0] == outs[1] and tb.state == jb.state, (op, tb.state, jb.state)
    assert tt == jt


def test_breaker_registry():
    jclk, tclk = FakeClock(), FakeClock()
    jr = jfaults.BreakerRegistry(threshold=1, cooldown=2.0, clock=jclk)
    tr = tfaults.BreakerRegistry(threshold=1, cooldown=2.0, clock=tclk)
    for uri, ok, dt in (("http://a:1/", False, 0.0), ("http://b:1", True, 0.0), ("http://a:1", None, 2.5), ("http://a:1", True, 0.0)):
        for r, clk in ((jr, jclk), (tr, tclk)):
            clk.advance(dt)
            if ok is None:
                r.allow(uri)
            else:
                r.record(uri, ok)
        assert tr.snapshot() == jr.snapshot()
        assert tr.state(uri) == jr.state(uri) and tr.allow("http://c:1") == jr.allow("http://c:1")
    tr.reset()
    assert tr.snapshot() == {}


def _fire(inj, mod, uri, path):
    try:
        inj.before_request("GET", uri, path, uri + path)
        return "ok"
    except mod.InjectedTimeout:
        return "timeout"
    except urllib.error.HTTPError as e:
        return f"http{e.code}"
    except urllib.error.URLError:
        return "refused"


def test_fault_injector_rules_replay():
    def run(mod, seed):
        inj = mod.FaultInjector(seed=seed, sleep=lambda s: None)
        inj.add_rule("http500", uri="http://p:1", times=2)
        inj.add_rule("timeout", path="/internal", prob=0.5)
        inj.add_rule("refuse", uri="http://q:2", skip=1, times=1)
        inj.add_rule("slow", delay=0.01)
        inj.partition("http://r:3/")
        out = []
        for i in range(30):
            uri = ("http://p:1", "http://q:2", "http://r:3", "http://s:4")[i % 4]
            out.append(_fire(inj, mod, uri, "/internal/x" if i % 3 else "/status"))
            if i == 20:
                inj.heal("http://r:3")
        return out, {k: inj.count(k) for k in ("http500", "timeout", "refuse", "slow", "partition")}

    for seed in (1, 2, 11):
        assert run(tfaults, seed) == run(jfaults, seed)
    with pytest.raises(ValueError):
        tfaults.FaultInjector().add_rule("meteor")
    inj = tfaults.FaultInjector()
    tfaults.install_injector(inj)
    try:
        assert tfaults.global_injector() is inj
    finally:
        tfaults.uninstall_injector()
    assert tfaults.global_injector() is None


# ---------------------------------------------------------------------------
# wire
# ---------------------------------------------------------------------------


def _row_pair(positions_by_shard):
    j = JRow({s: job.pack_positions(p) for s, p in positions_by_shard.items()})
    t = TRow({s: tob.from_host(tob.pack_positions(p), torch.device("cpu")) for s, p in positions_by_shard.items()})
    return j, t


def _results():
    rng = np.random.default_rng(5)
    row_j, row_t = _row_pair({s: np.unique(rng.integers(0, SHARD_WIDTH, 300)) for s in (0, 3, 7)})
    keyed_j, keyed_t = _row_pair({1: np.array([5, 9], np.uint64)})
    keyed_j.keys = keyed_t.keys = ["a", "b"]
    keyed_j.attrs = keyed_t.attrs = {"x": 1}
    return [
        (row_j, row_t),
        (keyed_j, keyed_t),
        (JRow(), TRow()),
        (True, True),
        (False, np.bool_(False)),
        (12345678901, torch.tensor(12345678901)),
        (0, np.int64(0)),
        (JValCount(-17, 4), TValCount(-17, 4)),
        (JPair(3, 9, key="k"), TPair(3, 9, key="k")),
        ([JPair(1, 5), JPair(2, 4, key="z")], [TPair(1, 5), TPair(2, 4, key="z")]),
        (
            [JGroupCount([JFieldRow("f", 1), JFieldRow("g", 2, row_key="b")], 7)],
            [TGroupCount([TFieldRow("f", 1), TFieldRow("g", 2, row_key="b")], 7)],
        ),
        (["a", "b"], ["a", "b"]),
        ([1, 5, 9], [1, np.int64(5), 9]),
        (None, None),
    ]


@pytest.mark.parametrize("i", range(14))
def test_encode_result_byte_identical(i):
    jr, tr = _results()[i]
    want = json.dumps(jwire.encode_result(jr))
    got = json.dumps(twire.encode_result(tr))
    assert got == want
    back = twire.decode_result(json.loads(got))
    assert json.dumps(twire.encode_result(back)) == want
    assert json.dumps(twire.result_to_public_json(back)) == json.dumps(jwire.result_to_public_json(jwire.decode_result(json.loads(want))))


def test_array_frames_identical_and_bounded(monkeypatch):
    a = np.arange(1000, dtype=np.uint64) * np.uint64(7)
    b = np.array([2**64 - 1, 0, 5], np.uint64)
    assert twire.encode_arrays(a, b) == jwire.encode_arrays(a, b)
    got = twire.decode_arrays(jwire.encode_arrays(a, b), 2)
    assert got[0].tolist() == a.tolist() and got[1].tolist() == b.tolist()
    for bad, expect in ((b"XXXX\x00\x00\x00\x00", 0), (jwire.encode_arrays(a), 2), (jwire.encode_arrays(a)[:-3], 1), (jwire.encode_arrays(a) + b"!", 1)):
        with pytest.raises(ValueError):
            twire.decode_arrays(bad, expect)
    monkeypatch.setattr(twire, "_MAX_ARRAY_BYTES", 64)
    ok = twire.encode_arrays(np.arange(8, dtype=np.uint64))
    assert twire.decode_arrays(ok, 1)[0].tolist() == list(range(8))
    with pytest.raises(ValueError, match="chunk the transfer"):
        twire.encode_arrays(np.arange(9, dtype=np.uint64))


# ---------------------------------------------------------------------------
# the internode client against a live port node
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def solo():
    srv = TNodeServer(None, "solo", device="cpu").start()
    srv.api.create_index("i")
    srv.api.create_field("i", "f")
    srv.api.import_bits("i", "f", [1, 1, 2], [3, SHARD_WIDTH + 4, 5])
    srv.api.create_index("k", keys=True)
    try:
        yield srv
    finally:
        srv.stop()


def _client(**kw):
    return InternalClient(retry_policy=tfaults.RetryPolicy(max_attempts=3, base_backoff=0.001, seed=1), **kw)


def test_client_retries_through_injected_500s(solo):
    c = _client()
    c.fault_injector = tfaults.FaultInjector().add_rule("http500", times=2)
    res = c.query_node(solo.node.uri, "i", "Count(Row(f=1))", shards=[0, 1], remote=True)
    assert res == [2] and c.fault_injector.count("http500") == 2
    c.fault_injector = tfaults.FaultInjector().add_rule("http500", times=5)
    with pytest.raises(ClientError) as ei:
        c.query_node(solo.node.uri, "i", "Count(Row(f=1))")
    assert ei.value.status == 500 and ei.value.retryable


def test_client_does_not_retry_4xx_or_payload_errors(solo):
    c = _client()
    with pytest.raises(ClientError) as ei:
        c.fragment_versions(solo.node.uri, "i", "Count(Row(f=1))", ["a"])
    assert ei.value.status == 400 and not ei.value.retryable
    with pytest.raises(ClientError) as ei:
        c.query_node(solo.node.uri, "i", "Count(Row(f=1)", remote=True)  # a parse error
    assert ei.value.status == 400 and not ei.value.retryable
    # an execution error answers 200 with {"error"}: the peer ran the leg
    with pytest.raises(ClientError) as ei:
        c.query_node(solo.node.uri, "i", "Count(Row(zz=1))", remote=True)
    assert ei.value.status is None and not ei.value.retryable
    with pytest.raises(ClientError, match="index not found"):
        c.query_node(solo.node.uri, "nope", "Count(Row(f=1))")


def test_client_breaker_fast_fail_and_probe(solo):
    reg = tfaults.BreakerRegistry(threshold=1, cooldown=60.0)
    c = _client(breakers=reg)
    c.fault_injector = tfaults.FaultInjector().partition(solo.node.uri)
    with pytest.raises(ClientError):
        c.status(solo.node.uri)
    assert reg.state(solo.node.uri) == tfaults.OPEN
    c.fault_injector = None
    t0 = time.perf_counter()
    with pytest.raises(BreakerOpenError):
        c.status(solo.node.uri)
    assert time.perf_counter() - t0 < 0.05
    assert c.status(solo.node.uri, probe=True)["state"] == "NORMAL"
    assert reg.state(solo.node.uri) == tfaults.CLOSED


def test_client_replication_calls(solo):
    c = _client()
    assert c.available_shards(solo.node.uri, "i")["f"] == [0, 1]
    assert [ix["name"] for ix in c.schema(solo.node.uri)] == ["i", "k"]
    assert c.translate_keys_remote(solo.node.uri, "k", None, ["x", "y", "x"]) == [1, 2, 1]
    entries, off = c.translate_entries(solo.node.uri, "k", None, 0)
    assert entries == [(1, "x"), (2, "y")] and off == 2
    assert c.translate_entries(solo.node.uri, "k", None, 1) == ([(2, "y")], 2)
    assert c.send_message(solo.node.uri, {"type": "available-shards", "index": "i", "field": "f", "shards": [9]}) == {"ok": True}
    assert c.available_shards(solo.node.uri, "i")["f"] == [0, 1, 9]
    c.import_bits(solo.node.uri, "i", "f", 0, [4], [6])
    vers = c.fragment_versions(solo.node.uri, "i", "Count(Row(f=4))", [0])
    assert vers["shards"] == [0] and vers["views"][0][:3] == ["v", "f", "standard"]
    assert c.query_node(solo.node.uri, "i", "Row(f=4)", remote=True)[0].columns().tolist() == [6]


def test_cluster_modules_leave_jax_out():
    import pathlib
    import subprocess
    import sys

    code = (
        "import sys, pilosa_tpu_torch.exec.distributed, pilosa_tpu_torch.testing, "
        "pilosa_tpu_torch.server.client, pilosa_tpu_torch.server.faults, pilosa_tpu_torch.cluster.topology; "
        "print('jax' in sys.modules, any(m == 'pilosa_tpu' or m.startswith('pilosa_tpu.') for m in sys.modules))"
    )
    repo = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False False"
