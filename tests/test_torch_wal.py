"""The port's WAL, snapshot and cache-sidecar codecs against pilosa_tpu's.

Both packages must write the same bytes for the same records, rows and
rank caches, and each must read the other's bytes back to the same
contents: a data directory written by either opens in the other. Then
the op log's crash behaviour (a torn tail at every byte boundary, the
integrity check's verdicts, the rollback of a failed append) and the
group commit (concurrent writers share fsync rounds).
"""

import io
import os
import threading
import time

import numpy as np
import pytest

from pilosa_tpu.core import cache as jcache
from pilosa_tpu.core import rowstore as jrowstore
from pilosa_tpu.core import wal as jwal
from pilosa_tpu_torch.core import cache as tcache
from pilosa_tpu_torch.core import rowstore as trowstore
from pilosa_tpu_torch.core import wal as twal
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW


@pytest.fixture(autouse=True)
def strict_commit():
    """Every test starts and ends with the port's group commit strict and
    no fault hook installed."""
    twal.GROUP_COMMIT.configure(sync_interval=0.0)
    yield
    twal.set_fault_hook(None)
    twal.GROUP_COMMIT.configure(sync_interval=0.0)


def _records(seed: int):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, WORDS_PER_ROW, dtype=np.uint32)
    row_words = np.concatenate([[np.uint64(7)], words.view(np.uint64)])
    return [
        (twal.OP_SET, rng.integers(0, 1 << 40, 37).astype(np.uint64)),
        (twal.OP_CLEAR, rng.integers(0, 1 << 40, 11).astype(np.uint64)),
        (twal.OP_SET, np.empty(0, np.uint64)),  # skipped: nothing to replay
        (twal.OP_ROW_WORDS, row_words.astype(np.uint64)),
        (twal.OP_SET, np.array([SHARD_WIDTH * 3 - 1], np.uint64)),
    ]


def _same_records(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for (op_a, p_a), (op_b, p_b) in zip(a, b):
        assert op_a == op_b
        np.testing.assert_array_equal(p_a, p_b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_records_bytes_match_reference(seed):
    recs = _records(seed)
    data = twal.encode_records(recs)
    assert data == jwal.encode_records(recs)
    nonempty = [r for r in recs if len(r[1])]
    _same_records(jwal.decode_records(data), nonempty)
    _same_records(twal.decode_records(data), nonempty)
    with pytest.raises(ValueError):
        list(twal.decode_records(data[:-1]))


def _row_sets(rng, depth: int):
    """(row_id, kind, data) for one fragment: the planes of a BSI field
    `depth` bits deep (exists, sign, magnitudes), then sparse, dense,
    empty and last-word rows."""
    n_words = SHARD_WIDTH // 32
    out = []
    cols = np.unique(rng.integers(0, SHARD_WIDTH, SHARD_WIDTH // 4)).astype(np.uint32)
    out.append((0, "positions", cols))
    out.append((1, "positions", cols[rng.random(len(cols)) < 0.3]))
    for i in range(depth):
        out.append((2 + i, "positions", cols[rng.random(len(cols)) < 0.5]))
    base = 2 + depth
    out.append((base, "positions", np.unique(rng.integers(0, SHARD_WIDTH, 500)).astype(np.uint32)))
    out.append((base + 1, "words", rng.integers(0, 2**32, n_words, dtype=np.uint32)))
    out.append((base + 2, "positions", np.empty(0, np.uint32)))
    out.append((base + 3, "positions", np.array([SHARD_WIDTH - 32, SHARD_WIDTH - 1], np.uint32)))
    # dense, then cleared below half the crossover: sparse again
    w = rng.integers(0, 2**32, n_words, dtype=np.uint32)
    out.append((base + 4, "words_then_clear", w))
    return out


def _build(mod, n_bits, sets):
    rows = {}
    for row_id, kind, data in sets:
        rb = mod.RowBits(n_bits)
        if kind == "positions":
            rb.add(data)
        else:
            rb.union_words(data)
            if kind == "words_then_clear":
                rb.discard(rb.to_positions()[: int(0.9 * rb.count())])
        rows[row_id] = rb
    return rows


@pytest.mark.parametrize("depth", [0, 1, 2, 8, 16, 31, 32])
def test_snapshot_bytes_match_reference(depth):
    rng = np.random.default_rng(depth)
    sets = _row_sets(rng, depth)
    jrows = _build(jrowstore, SHARD_WIDTH, sets)
    trows = _build(trowstore, SHARD_WIDTH, sets)
    for r in jrows:
        assert trows[r].rep() == jrows[r].rep(), r
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    jwal.write_snapshot_stream(jbuf, 5, SHARD_WIDTH, jrows)
    twal.write_snapshot_stream(tbuf, 5, SHARD_WIDTH, trows)
    assert tbuf.getvalue() == jbuf.getvalue()
    # each package reads the other's bytes back to the same rows
    for read, want in ((twal.read_snapshot_stream, jrows), (jwal.read_snapshot_stream, trows)):
        shard, n_bits, rows = read(io.BytesIO(jbuf.getvalue()))
        assert (shard, n_bits, sorted(rows)) == (5, SHARD_WIDTH, sorted(want))
        for r, rb in rows.items():
            assert rb.rep() == want[r].rep() and rb.count() == want[r].count()
            np.testing.assert_array_equal(rb.to_words(), want[r].to_words())
    with pytest.raises(ValueError, match="truncated"):
        twal.read_snapshot_stream(io.BytesIO(jbuf.getvalue()[:-3]))


def test_snapshot_files_and_index(tmp_path):
    rng = np.random.default_rng(3)
    rows = _build(trowstore, SHARD_WIDTH, _row_sets(rng, 4))
    tp, jp = str(tmp_path / "t.snap"), str(tmp_path / "j.snap")
    twal.write_snapshot(tp, 9, SHARD_WIDTH, rows)
    jwal.write_snapshot(jp, 9, SHARD_WIDTH, _build(jrowstore, SHARD_WIDTH, _row_sets(np.random.default_rng(3), 4)))
    assert open(tp, "rb").read() == open(jp, "rb").read()
    assert not os.path.exists(tp + ".snapshotting")
    assert twal.read_snapshot_index(tp) == jwal.read_snapshot_index(jp)
    with open(tp, "r+b") as f:
        f.truncate(os.path.getsize(tp) - 1)
    with pytest.raises(ValueError, match="truncated"):
        twal.read_snapshot_index(tp)


@pytest.mark.parametrize(
    "cache_type,size,n",
    [("ranked", 50_000, 300), ("ranked", 40, 300), ("lru", 40, 300), ("ranked", 10, 0)],
)
def test_cache_sidecar_matches_reference(tmp_path, cache_type, size, n):
    rng = np.random.default_rng(n + size)
    pairs = list(zip(rng.permutation(10 * n + 1)[:n].tolist(), rng.integers(1, 1000, n).tolist()))
    caches = []
    for mod, name in ((jcache, "j"), (tcache, "t")):
        c = mod.make_cache(cache_type, size)
        c.add_many(pairs)
        mod.write_cache(str(tmp_path / f"{name}.cache"), c)
        caches.append(c)
    data = (tmp_path / "t.cache").read_bytes()
    assert data == (tmp_path / "j.cache").read_bytes()
    assert caches[1].pruned == (n > size)
    for mod in (jcache, tcache):
        c = mod.make_cache(cache_type, size)
        assert mod.read_cache(str(tmp_path / "t.cache"), c)
        assert c.top() == caches[0].top() and c.pruned == caches[0].pruned
    assert not tcache.read_cache(str(tmp_path / "missing.cache"), tcache.make_cache(cache_type, size))
    (tmp_path / "bad.cache").write_bytes(data[:-1] if n else b"PTCACHE1" + data[8:])
    assert not tcache.read_cache(str(tmp_path / "bad.cache"), tcache.make_cache(cache_type, size))


# ---------------------------------------------------------------------------
# the op log on disk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sync_interval", [0.0, 0.05])
def test_torn_tail_every_byte_boundary(tmp_path, sync_interval):
    """A WAL cut at every byte replays exactly the records that fit, as
    the reference's replay of the same bytes does, and both checks give
    the same verdict."""
    twal.GROUP_COMMIT.configure(sync_interval=sync_interval)
    records = [r for r in _records(7) if len(r[1])]
    records[2] = (records[2][0], records[2][1][:33])  # a short OP_ROW_WORDS frame
    p = str(tmp_path / "torn.wal")
    w = twal.WalWriter(p)
    for op, positions in records:
        w.append(op, positions)
    twal.GROUP_COMMIT.wait_durable()
    w.close()
    data = open(p, "rb").read()
    assert data == jwal.encode_records(records)
    spans = np.cumsum([twal._REC_HDR.size + 8 * len(p_) for _, p_ in records]).tolist()
    assert spans[-1] == len(data)
    trunc = str(tmp_path / "trunc.wal")
    for cut in range(len(data) + 1):
        with open(trunc, "wb") as fh:
            fh.write(data[:cut])
        n_want = sum(1 for s in spans if s <= cut)
        got = list(twal.replay_wal(trunc))
        assert len(got) == n_want, (cut, n_want, len(got))
        _same_records(got, records[:n_want])
        _same_records(jwal.replay_wal(trunc), got)
        verdict = twal.check_wal(trunc)
        assert verdict == jwal.check_wal(trunc)
        assert verdict[:2] == (n_want, "ok" if cut in (0, *spans) else "torn")


def test_check_wal_corrupt_verdicts(tmp_path):
    data = twal.encode_records([r for r in _records(4) if len(r[1])])
    first = twal._REC_HDR.size + 37 * 8
    cases = {
        "crc": data[: first + 20] + bytes([data[first + 20] ^ 1]) + data[first + 21 :],
        "magic": data[:first] + b"XXXX" + data[first + 4 :],
        "missing": None,
    }
    for name, blob in cases.items():
        p = str(tmp_path / f"{name}.wal")
        if blob is not None:
            with open(p, "wb") as f:
                f.write(blob)
        verdict = twal.check_wal(p)
        assert verdict == jwal.check_wal(p), name
        assert verdict[1] == ("ok" if blob is None else "corrupt"), (name, verdict)
        assert len(list(twal.replay_wal(p))) == (0 if blob is None else 1)


def test_failed_append_rolls_back(tmp_path):
    """A torn append is truncated away, so the next append replays; a
    writer whose rollback also fails refuses further appends."""
    p = str(tmp_path / "f.wal")
    w = twal.WalWriter(p)
    twal.GROUP_COMMIT.wait_durable(w.append(twal.OP_SET, np.arange(5, dtype=np.uint64)))
    size = os.path.getsize(p)

    def short(point, path):
        if point == "wal.write":
            raise twal.ShortWriteFault()

    twal.set_fault_hook(short)
    with pytest.raises(OSError, match="short write"):
        w.append(twal.OP_SET, np.arange(9, dtype=np.uint64))
    twal.set_fault_hook(None)
    assert os.path.getsize(p) == size
    twal.GROUP_COMMIT.wait_durable(w.append(twal.OP_CLEAR, np.array([3], np.uint64)))
    assert [op for op, _ in twal.replay_wal(p)] == [twal.OP_SET, twal.OP_CLEAR]

    def both(point, path):
        if point == "wal.write":
            raise twal.ShortWriteFault()
        if point == "wal.rollback":
            raise OSError("rollback failed")

    twal.set_fault_hook(both)
    with pytest.raises(OSError):
        w.append(twal.OP_SET, np.arange(9, dtype=np.uint64))
    twal.set_fault_hook(None)
    with pytest.raises(ValueError, match="poisoned"):
        w.append(twal.OP_SET, np.arange(2, dtype=np.uint64))
    w.close()
    w2 = twal.WalWriter(str(tmp_path / "g.wal"))
    w2.close()
    with pytest.raises(ValueError, match="closed"):
        w2.append(twal.OP_SET, np.arange(2, dtype=np.uint64))


def test_truncate_empties_and_skips_empty_records(tmp_path):
    p = str(tmp_path / "t.wal")
    w = twal.WalWriter(p)
    assert w.append(twal.OP_SET, np.empty(0, np.uint64)) is None
    assert os.path.getsize(p) == 0
    twal.GROUP_COMMIT.wait_durable(w.append(twal.OP_SET, np.array([1, 2, 3], np.uint64)))
    w.truncate()
    assert os.path.getsize(p) == 0 and list(twal.replay_wal(p)) == []
    w.close()


def test_lru_fd_cap_reopens_in_append_mode(tmp_path, monkeypatch):
    monkeypatch.setattr(twal, "_MAX_OPEN_WALS", 4)
    writers = [twal.WalWriter(str(tmp_path / f"{i}.wal")) for i in range(12)]
    for rnd in range(3):
        for i, w in enumerate(writers):
            w.append(twal.OP_SET, np.array([i, rnd], np.uint64))
    twal.GROUP_COMMIT.flush()
    assert sum(w._f is not None for w in writers) <= 4
    for i, w in enumerate(writers):
        w.close()
        got = [p.tolist() for _, p in twal.replay_wal(w.path)]
        assert got == [[i, rnd] for rnd in range(3)]


# ---------------------------------------------------------------------------
# group commit
# ---------------------------------------------------------------------------


def test_group_commit_shares_fsync_rounds(tmp_path):
    """8 threads, each appending to its own WAL and waiting for
    durability, take fewer fsync rounds than appends: with a 3 ms fsync
    (as a real disk takes; on tmpfs nothing would queue), the waiters that
    arrive during a round are released together by the next one."""
    twal.set_fault_hook(lambda point, path: time.sleep(0.003) if point == "wal.fsync" else None)
    n_threads, per_thread = 8, 15
    writers = [twal.WalWriter(str(tmp_path / f"{t}.wal")) for t in range(n_threads)]
    s0 = twal.stats_snapshot()
    errs = []
    start = threading.Barrier(n_threads)

    def writer(t):
        try:
            start.wait(10)
            rng = np.random.default_rng(t)
            for _ in range(per_thread):
                tok = writers[t].append(twal.OP_SET, rng.integers(0, 1 << 30, 200).astype(np.uint64))
                twal.GROUP_COMMIT.wait_durable(tok)
        except Exception as e:  # noqa: BLE001 - fail the test
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads) and not errs, errs[:1]
    s1 = twal.stats_snapshot()
    appends = n_threads * per_thread
    rounds = s1["commit_groups"] - s0["commit_groups"]
    assert s1["commits"] - s0["commits"] == appends
    assert 0 < rounds < appends / 2, (rounds, appends)
    assert s1["fsyncs"] - s0["fsyncs"] >= rounds
    for t, w in enumerate(writers):
        w.close()
        assert len(list(twal.replay_wal(w.path))) == per_thread


def test_barrier_defers_to_one_round_and_failures_raise(tmp_path):
    writers = [twal.WalWriter(str(tmp_path / f"{i}.wal")) for i in range(5)]
    s0 = twal.stats_snapshot()
    with twal.GROUP_COMMIT.barrier():
        for w in writers:
            twal.GROUP_COMMIT.wait_durable(w.append(twal.OP_SET, np.array([1], np.uint64)))
        assert twal.stats_snapshot()["commit_groups"] == s0["commit_groups"]
    s1 = twal.stats_snapshot()
    assert s1["commit_groups"] - s0["commit_groups"] == 1 and s1["fsyncs"] - s0["fsyncs"] == 5

    def fail(point, path):
        if point == "wal.fsync":
            raise OSError("disk gone")

    twal.set_fault_hook(fail)
    tok = writers[0].append(twal.OP_SET, np.array([2], np.uint64))
    with pytest.raises(twal.WalSyncError):
        twal.GROUP_COMMIT.wait_durable(tok)
    twal.set_fault_hook(None)
    twal.GROUP_COMMIT.flush()  # the retained dirty writer syncs now
    twal.GROUP_COMMIT.wait_durable(writers[1].append(twal.OP_SET, np.array([3], np.uint64)))
    for w in writers:
        w.close()


def test_interval_mode_acks_before_fsync(tmp_path):
    twal.GROUP_COMMIT.configure(sync_interval=0.05)
    w = twal.WalWriter(str(tmp_path / "i.wal"))
    s0 = twal.stats_snapshot()
    twal.GROUP_COMMIT.wait_durable(w.append(twal.OP_SET, np.array([1], np.uint64)))
    deadline = time.monotonic() + 10
    while twal.stats_snapshot()["fsyncs"] == s0["fsyncs"] and time.monotonic() < deadline:
        time.sleep(0.01)
    assert twal.stats_snapshot()["fsyncs"] > s0["fsyncs"]  # the background syncer ran
    w.close()
