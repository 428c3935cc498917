"""The port's fragment transfer against pilosa_tpu's, on the CPU.

The serialization and the live-transfer captures of one fragment:
`to_bytes` byte-equal to the reference's on the same seeded rows (set,
mutex, int and word-imported rows), a drained capture byte-equal to the
reference's for the same write sequence, and the reference's fragment
cases (snapshot plus drained capture equals the source, overflow, one
capture a destination, a wholesale replace losing the capture, the
cutover barrier and a mutex retry through it, the strict record decode,
a durable round trip, a stream for the wrong shard).

Then the hazards of a fragment replaced or deleted under a view: a stack
staged while the view had no fragment of a shard answers afresh once a
transferred fragment lands there (a), a fragment made again after a
delete starts above every version its predecessor reached, so a Count
cached at the coordinator over a peer's copy is not served stale (b),
the view's staged tally loses what a replace or a delete voids (c), and
a write inside the cutover barrier is a 503 with Retry-After that the
write fan-out retries, while a mutex fragment refuses the sweep's merge
(d).
"""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pilosa_tpu.core import wal as jwal
from pilosa_tpu.core.fragment import Fragment as JFragment
from pilosa_tpu_torch import Executor as TExecutor
from pilosa_tpu_torch import Holder as THolder
from pilosa_tpu_torch.core import fragment as tfragment_mod
from pilosa_tpu_torch.core import wal as twal
from pilosa_tpu_torch.core.devcache import DeviceCache
from pilosa_tpu_torch.core.fragment import Fragment as TFragment
from pilosa_tpu_torch.core.fragment import TransferCaptureLost, TransferCutover
from pilosa_tpu_torch.core.resultcache import RESULT_CACHE
from pilosa_tpu_torch.server import NodeServer
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW
from pilosa_tpu_torch.testing import ClusterHarness as TClusterHarness

CPU = torch.device("cpu")
SEED = 20261019
SHARDS = 16
BIT_DEPTH = 12


def tfrag(shard: int = 0, mutex: bool = False, path=None) -> TFragment:
    return TFragment("i", "f", "standard", shard, device=CPU, dcache=DeviceCache(1 << 30), mutex=mutex, path=path).open()


def jfrag(shard: int = 0, mutex: bool = False, path=None) -> JFragment:
    return JFragment(path, "i", "f", "standard", shard, mutex=mutex).open()


def pairs(f):
    r, c = f.pairs()
    return list(zip(r.tolist(), c.tolist()))


def seeded_writes(kind: str, seed: int):
    """(name, args) write calls of one kind of fragment, from a seed."""
    rng = np.random.default_rng([seed, SEED])
    n = 3000
    if kind == "set":
        rows = rng.integers(0, 40, n).astype(np.uint64)
        cols = rng.integers(0, SHARD_WIDTH, n).astype(np.uint64)
        return [("bulk_import", (rows, cols)), ("bulk_import", (rows[:200], cols[:200], True))]
    if kind == "mutex":
        rows = rng.integers(0, 8, n).astype(np.uint64)
        cols = rng.integers(0, 5000, n).astype(np.uint64)
        return [("bulk_import", (rows, cols))]
    if kind == "int":
        cols = np.unique(rng.integers(0, SHARD_WIDTH, n)).astype(np.uint64)
        vals = rng.integers(-(1 << BIT_DEPTH) + 1, 1 << BIT_DEPTH, len(cols))
        return [("import_values", (cols, vals, BIT_DEPTH))]
    words = rng.integers(0, 2**32, (3, WORDS_PER_ROW), dtype=np.uint64).astype(np.uint32)
    words[1] &= rng.integers(0, 2**32, WORDS_PER_ROW, dtype=np.uint64).astype(np.uint32)
    return [("import_row_words", (r * 7 + 1, w)) for r, w in enumerate(words)]


def apply(f, calls):
    for name, args in calls:
        getattr(f, name)(*args)


# ---------------------------------------------------------------------------
# bytes equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["set", "mutex", "int", "row_words"])
@pytest.mark.parametrize("seed", [0, 1])
def test_to_bytes_byte_equal(kind, seed):
    calls = seeded_writes(kind, seed)
    mutex = kind == "mutex"
    t, j = tfrag(3, mutex), jfrag(3, mutex)
    apply(t, calls)
    apply(j, calls)
    blob = t.to_bytes()
    assert blob == j.to_bytes()
    # each package reads the other's stream
    t2, j2 = tfrag(3, mutex), jfrag(3, mutex)
    t2.from_bytes(j.to_bytes())
    j2.from_bytes(blob)
    assert pairs(t2) == pairs(j2) == pairs(j)


@pytest.mark.parametrize("kind", ["set", "mutex", "int", "row_words"])
def test_drained_capture_byte_equal(kind):
    """The same writes after begin_streaming drain to the same bytes."""
    before, during = seeded_writes(kind, 2), seeded_writes(kind, 3)
    mutex = kind == "mutex"
    t, j = tfrag(0, mutex), jfrag(0, mutex)
    apply(t, before)
    apply(j, before)
    assert t.begin_streaming("job:n3") == j.begin_streaming("job:n3")
    apply(t, during)
    apply(j, during)
    if kind == "set":
        for f in (t, j):
            f.stage_positions(np.array([5 * SHARD_WIDTH + 9, 6 * SHARD_WIDTH + 1], np.uint64))
            f.clear_bit(5, 9)
            f.set_bit(7, 123)
    data = t.drain_capture("job:n3")
    assert data and data == j.drain_capture("job:n3")
    # the port replays the reference's delta onto the reference's snapshot
    dst = tfrag(0, mutex)
    dst.from_bytes(j2_snapshot(before, mutex))
    dst.apply_transfer_records(data)
    assert pairs(dst) == pairs(t) == pairs(j)


def j2_snapshot(calls, mutex):
    j = jfrag(0, mutex)
    apply(j, calls)
    return j.to_bytes()


# ---------------------------------------------------------------------------
# the reference's fragment cases (tests/test_cluster.py)
# ---------------------------------------------------------------------------


def test_capture_roundtrip_streams_and_replays():
    src = tfrag()
    src.bulk_import(np.array([0, 1]), np.array([3, 9]))
    blob = src.begin_streaming()
    src.bulk_import(np.array([0]), np.array([7]))
    src.stage_positions(np.array([2 * SHARD_WIDTH + 5], np.uint64))
    src.clear_bit(1, 9)
    words = np.zeros(WORDS_PER_ROW, np.uint32)
    words[0] = 0b1000
    src.import_row_words(5, words)
    dst = tfrag()
    dst.from_bytes(blob)
    assert pairs(dst) != pairs(src)  # the snapshot lags
    assert dst.apply_transfer_records(src.drain_capture()) > 0
    assert pairs(dst) == pairs(src)
    # a drain pops: the second one is empty
    assert dst.apply_transfer_records(src.drain_capture()) == 0
    src.end_capture()
    with pytest.raises(TransferCaptureLost):
        src.drain_capture()


def test_capture_overflow_forces_refetch(monkeypatch):
    monkeypatch.setattr(tfragment_mod, "CAPTURE_MAX_POSITIONS", 4)
    f = tfrag()
    f.begin_streaming()
    f.bulk_import(np.zeros(10, np.uint64), np.arange(10, dtype=np.uint64))
    with pytest.raises(TransferCaptureLost):
        f.drain_capture()
    f.begin_streaming()
    assert f.drain_capture() == b""
    f.end_capture()


def test_capture_per_destination_independence():
    src = tfrag()
    src.bulk_import(np.array([0]), np.array([1]))
    blob_a = src.begin_streaming("j:a")
    src.bulk_import(np.array([0]), np.array([2]))
    blob_b = src.begin_streaming("j:b")  # must not reset j:a
    src.bulk_import(np.array([0]), np.array([3]))
    da, db = tfrag(), tfrag()
    da.from_bytes(blob_a)
    db.from_bytes(blob_b)
    da.apply_transfer_records(src.drain_capture("j:a"))
    db.apply_transfer_records(src.drain_capture("j:b"))
    assert pairs(da) == pairs(db) == pairs(src)
    src.end_capture("j:a")
    with pytest.raises(TransferCaptureLost):
        src.drain_capture("j:a")
    assert src.drain_capture("j:b") == b""
    src.end_capture()


def test_wholesale_replace_invalidates_capture():
    other = tfrag()
    other.bulk_import(np.array([9]), np.array([1]))
    f = tfrag()
    f.begin_streaming()
    f.from_bytes(other.to_bytes())
    with pytest.raises(TransferCaptureLost):
        f.drain_capture()


def test_begin_capture_if_version():
    f = tfrag()
    f.bulk_import(np.array([1]), np.array([1]))
    v = f.version
    f.bulk_import(np.array([1]), np.array([2]))
    assert not f.begin_capture_if_version("t", v)
    assert f.begin_capture_if_version("t", f.version)
    f.set_bit(2, 2)
    assert f.drain_capture("t") == twal.encode_records([(twal.OP_SET, np.array([2 * SHARD_WIDTH + 2], np.uint64))])


def test_mutex_import_retry_after_cutover_barrier():
    f = tfrag(mutex=True)
    f.bulk_import(np.array([1]), np.array([7]))
    f.block_writes(30.0)
    with pytest.raises(TransferCutover):
        f.bulk_import(np.array([2]), np.array([7]))
    f.unblock_writes()
    assert f.bulk_import(np.array([2]), np.array([7])) == 1
    assert pairs(f) == [(2, 7)]
    assert f._mutex_map == {7: 2}


@pytest.mark.parametrize("funnel", ["set_bit", "clear_bit", "bulk_import", "stage_positions", "import_row_words", "import_values", "apply_deltas"])
def test_cutover_barrier_blocks_every_write_funnel(funnel):
    """Every write funnel raises inside the barrier and nothing lands;
    the barrier lifts with the last capture or at its deadline."""
    f = tfrag()
    f.bulk_import(np.array([1]), np.array([1]))
    before = pairs(f)
    calls = {
        "set_bit": lambda: f.set_bit(2, 3),
        "clear_bit": lambda: f.clear_bit(1, 1),
        "bulk_import": lambda: f.bulk_import(np.array([4]), np.array([4])),
        "stage_positions": lambda: f.stage_positions(np.array([9], np.uint64)),
        "import_row_words": lambda: f.import_row_words(3, np.ones(WORDS_PER_ROW, np.uint32)),
        "import_values": lambda: f.import_values(np.array([5], np.uint64), np.array([3]), 4),
        "apply_deltas": lambda: f.apply_deltas(
            (np.array([6], np.uint64), np.array([6], np.uint64)), (np.empty(0, np.uint64), np.empty(0, np.uint64))
        ),
    }
    f.begin_streaming("t")
    f.block_writes(30.0)
    with pytest.raises(TransferCutover):
        calls[funnel]()
    assert pairs(f) == before and f.drain_capture("t") == b""
    f.end_capture("t")  # the last capture lifts the barrier
    calls[funnel]()
    f.block_writes(0.0)  # an expired barrier heals itself
    f.set_bit(8, 8)


def test_decode_records_strict_on_torn_stream():
    data = twal.encode_records([(twal.OP_SET, np.array([1, 2, 3], np.uint64))])
    assert data == jwal.encode_records([(jwal.OP_SET, np.array([1, 2, 3], np.uint64))])
    got = list(twal.decode_records(data))
    assert len(got) == 1 and got[0][1].tolist() == [1, 2, 3]
    with pytest.raises(ValueError):
        list(twal.decode_records(data[:-3]))
    bad = bytearray(data)
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError):
        list(twal.decode_records(bytes(bad)))
    # a torn delta applies nothing
    f = tfrag()
    with pytest.raises(ValueError):
        f.apply_transfer_records(data + data[:-3])
    assert pairs(f) == []


def test_fragment_stream_roundtrip(tmp_path):
    src = tfrag(3)
    src.bulk_import(np.array([0, 5, 7]), np.array([10, 20, 30]))
    dst = tfrag(3, path=str(tmp_path / "frag"))
    dst.from_bytes(src.to_bytes())
    assert pairs(dst) == pairs(src)
    dst.close()
    # the replace snapshotted at once: the reference reads the file too
    assert pairs(tfrag(3, path=str(tmp_path / "frag"))) == pairs(src)
    assert pairs(jfrag(3, path=str(tmp_path / "frag"))) == pairs(src)


def test_fragment_stream_rejects_wrong_shard():
    src = tfrag(3)
    src.bulk_import(np.array([0]), np.array([10]))
    with pytest.raises(ValueError):
        tfrag(5).from_bytes(src.to_bytes())


def test_merge_from_bytes_unions_and_mutex_refuses():
    a, b = tfrag(), tfrag()
    a.bulk_import(np.array([1, 2]), np.array([1, 2]))
    b.bulk_import(np.array([2, 3]), np.array([2, 3]))
    assert b.merge_from_bytes(a.to_bytes()) == 1
    assert pairs(b) == [(1, 1), (2, 2), (3, 3)]
    m = tfrag(mutex=True)
    with pytest.raises(ValueError):
        m.merge_from_bytes(a.to_bytes())


def test_mutex_replay_keeps_the_mutex_vector():
    """A drained capture replayed on a mutex fragment leaves its column ->
    row vector equal to the source's, so a later write clears the right
    row."""
    src, dst = tfrag(mutex=True), tfrag(mutex=True)
    src.bulk_import(np.array([1, 1]), np.array([4, 5]))
    dst.from_bytes(src.begin_streaming())
    src.bulk_import(np.array([2]), np.array([4]))
    dst.apply_transfer_records(src.drain_capture())
    assert dst._mutex_map == src._mutex_map == {4: 2, 5: 1}
    dst.bulk_import(np.array([3]), np.array([4]))
    assert pairs(dst) == [(1, 5), (3, 4)]


# ---------------------------------------------------------------------------
# hazards of a fragment replaced or deleted under a view
# ---------------------------------------------------------------------------


def _holder_with_rows(seed: int, absent=()):
    rng = np.random.default_rng([seed, SEED])
    h = THolder(None, device="cpu").open()
    idx = h.create_index("i")
    f = idx.create_field("f")
    want = {}
    for s in range(SHARDS):
        if s in absent:
            continue
        cols = np.unique(rng.integers(0, SHARD_WIDTH, 500)).astype(np.uint64) + np.uint64(s * SHARD_WIDTH)
        f.import_bits(np.ones(len(cols), np.uint64), cols)
        want[s] = cols
    return h, f, want, rng


def test_stale_extent_after_a_transferred_fragment_lands():
    """(a) A stack staged while shard 5 had no fragment here, then a
    fragment for shard 5 arrives by transfer (from_bytes), then by replay
    (apply_transfer_records): each Count and Row equals numpy."""
    h, f, want, rng = _holder_with_rows(4, absent=(5,))
    ex = TExecutor(h)

    def check():
        cols = np.sort(np.concatenate(list(want.values())))
        (cnt,) = ex.execute("i", "Count(Row(f=1))")
        (row,) = ex.execute("i", "Row(f=1)")
        assert cnt == len(cols)
        assert row.columns().tolist() == cols.tolist()

    check()  # stages the extent covering every shard, 5 absent
    src = tfrag(5)
    cols5 = np.unique(rng.integers(0, SHARD_WIDTH, 700)).astype(np.uint64)
    src.bulk_import(np.ones(len(cols5), np.uint64), cols5)
    blob = src.begin_streaming("t")
    f._view_create("standard").fragment(5).from_bytes(blob)
    want[5] = cols5 + np.uint64(5 * SHARD_WIDTH)
    check()
    more = np.array([11, 12], np.uint64)
    src.bulk_import(np.ones(2, np.uint64), more)
    f.view("standard").fragment(5).apply_transfer_records(src.drain_capture("t"))
    want[5] = np.union1d(want[5], more + np.uint64(5 * SHARD_WIDTH))
    check()
    h.close()


def test_recreated_fragment_starts_above_the_deleted_version():
    h, f, want, _ = _holder_with_rows(5)
    v = f.view("standard")
    old = v.fragment(3).version
    assert v.delete_fragment(3) and not v.delete_fragment(3)
    assert v.fragment(3).version > old
    h.close()


def test_recreated_fragment_is_not_served_from_a_stale_cache():
    """(b) The coordinator caches a Count over a peer's shard; the peer
    deletes that fragment and makes it again with other bits and as many
    version bumps. The coordinator's revalidation must not take the new
    fragment's versions for the old one's."""
    with TClusterHarness(2, in_memory=True, device="cpu", cache_result_mb=64) as c:
        api = c[0].api
        api.create_index("i")
        api.create_field("i", "f", {"type": "set"})
        s = next(sh for sh in range(SHARDS) if c[0].cluster.shard_nodes("i", sh)[0].id == "node1")
        api.import_bits("i", "f", [1, 1, 1], [s * SHARD_WIDTH + 1, s * SHARD_WIDTH + 2, 3])
        q = "Count(Row(f=1))"
        assert c[0].api.query_response("i", q).results == [3]
        hits0 = RESULT_CACHE.stats_snapshot()["hits"]
        assert c[0].api.query_response("i", q).results == [3]
        assert RESULT_CACHE.stats_snapshot()["hits"] > hits0  # served from the cache
        peer = c[1].holder.index("i").field("f").view("standard")
        n_bumps = peer.fragment(s).version
        peer.delete_fragment(s)
        frag = peer.fragment(s)
        for k in range(n_bumps):  # as many bumps as the deleted one took
            frag.set_bit(1, 100 + k)
        assert c[0].api.query_response("i", q).results == [1 + n_bumps]


def test_staged_tally_follows_replace_and_delete():
    """(c) Staged positions a replace or a delete voids leave the view's
    staged tally and the holder's count."""
    h, f, _, _ = _holder_with_rows(6)
    v = f.view("standard")
    v.sync_pending()  # the import's staged writes merge first
    assert h.staged_position_count() == 0
    v.fragment(2).stage_positions(np.array([SHARD_WIDTH + 4, SHARD_WIDTH + 5], np.uint64))
    v.fragment(4).stage_positions(np.array([SHARD_WIDTH + 6], np.uint64))
    assert h.staged_position_count() == 3
    other = tfrag(2)
    other.bulk_import(np.array([9]), np.array([9]))
    v.fragment(2).from_bytes(other.to_bytes())
    assert h.staged_position_count() == 1
    v.delete_fragment(4)
    assert h.staged_position_count() == 0
    v.fragment(4).stage_positions(np.array([7], np.uint64))
    assert h.staged_position_count() == 1
    h.close()


def _http(method, url, body=None):
    data = body if isinstance(body, bytes) or body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def test_write_inside_the_cutover_barrier_is_a_retryable_503():
    """(d) A direct client sees 503 with Retry-After for a Set and an
    import into a fragment inside the barrier, and 200 once it lifts."""
    srv = NodeServer(None, "n0", device="cpu").start()
    try:
        srv.api.create_index("i")
        srv.api.create_field("i", "f", {"type": "set"})
        srv.api.import_bits("i", "f", [1], [2])
        frag = srv.holder.index("i").field("f").view("standard").fragment(0)
        frag.begin_streaming("t")
        frag.block_writes(30.0)
        for path, body in (("/index/i/query", b"Set(3, f=1)"), ("/index/i/field/f/import", {"rows": [1], "cols": [4]})):
            code, hdrs, out = _http("POST", srv.node.uri + path, body)
            assert code == 503 and hdrs.get("Retry-After") == "1", (code, hdrs, out)
            assert "cutover" in out["error"]
        code, _, out = _http("POST", srv.node.uri + "/index/i/query", b"Count(Row(f=1))")
        assert (code, out) == (200, {"results": [1]})  # reads go on
        frag.end_capture("t")
        code, _, out = _http("POST", srv.node.uri + "/index/i/query", b"Set(3, f=1) Count(Row(f=1))")
        assert (code, out) == (200, {"results": [True, 2]})
    finally:
        srv.stop()


def test_write_fan_out_retries_a_peers_cutover_503():
    """(d) At replica 2 a Set and an import through node0 meet node1's
    barrier: node0's client retries the 503 until the barrier lifts, so
    both copies take the writes and no debt is left; with both copies in
    the barrier the client gets the 503."""
    fast = dict(retry_max_attempts=8, retry_base_backoff=0.01)
    with TClusterHarness(2, replica_n=2, in_memory=True, device="cpu", **fast) as c:
        api = c[0].api
        api.create_index("i")
        api.create_field("i", "f", {"type": "set"})
        api.import_bits("i", "f", [1], [2])
        f1 = c[1].holder.index("i").field("f").view("standard").fragment(0)
        f1.block_writes(30.0)
        threading.Timer(0.3, f1.unblock_writes).start()
        code, _, out = _http("POST", c[0].node.uri + "/index/i/query", b"Set(3, f=1)")
        assert (code, out) == (200, {"results": [True]})
        f1.block_writes(30.0)
        threading.Timer(0.3, f1.unblock_writes).start()
        code, _, out = _http("POST", c[0].node.uri + "/index/i/field/f/import", {"rows": [1], "cols": [4]})
        assert code == 200 and out["errors"] == [], out
        for s in c:
            assert s.api.query_response("i", "Row(f=1)").results[0].columns().tolist() == [2, 3, 4]
            assert s.holder.pending_repair_count() == 0
        f0 = c[0].holder.index("i").field("f").view("standard").fragment(0)
        for f in (f0, f1):
            f.block_writes(30.0)
        code, hdrs, _ = _http("POST", c[0].node.uri + "/index/i/query", b"Set(5, f=1)")
        assert code == 503 and hdrs.get("Retry-After") == "1"
        code, hdrs, out = _http("POST", c[0].node.uri + "/index/i/field/f/import", {"rows": [1], "cols": [6]})
        assert code == 503 and hdrs.get("Retry-After") == "1" and "cutover" in out["error"], out
        # the barred peer's 503s proved it alive: its breaker stays closed
        assert set(c[0].breakers.snapshot().values()) <= {"closed"}
        for f in (f0, f1):
            f.unblock_writes()
        code, _, out = _http("POST", c[0].node.uri + "/index/i/query", b"Set(5, f=1) Count(Row(f=1))")
        assert (code, out) == (200, {"results": [True, 4]})
