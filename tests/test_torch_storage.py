"""The port's storage layer against pilosa_tpu's: the device cache
contract, and fragments fed the same writes (staged, exact, word-level,
mutex) reading back identical words, positions and rank caches."""

import torch_threads  # noqa: F401  (first: one intra-op thread per test process)
import threading

import numpy as np
import pytest
import torch

from pilosa_tpu.core.fragment import Fragment as JFragment
from pilosa_tpu_torch.core.devcache import DeviceCache, new_owner_token
from pilosa_tpu_torch.core.fragment import Fragment as TFragment
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW


def test_devcache_evicts_lru_over_budget_and_keeps_new_entry():
    c = DeviceCache(budget_bytes=3 * 400)
    owner = new_owner_token()
    for i in range(3):
        c.get_or_build((owner, i), lambda: torch.zeros(100, dtype=torch.int32))
    c.get_or_build((owner, 0), lambda: pytest.fail("cached entry rebuilt"))  # touch 0
    c.get_or_build((owner, 3), lambda: torch.zeros(100, dtype=torch.int32))
    assert c.bytes_used == 3 * 400 and c.evictions == 1
    rebuilt = []
    c.get_or_build((owner, 1), lambda: rebuilt.append(1) or torch.zeros(100, dtype=torch.int32))
    assert rebuilt == [1]  # 1 was the least recently used
    big = c.get_or_build((owner, 9), lambda: torch.zeros(10_000, dtype=torch.int32))
    assert big.numel() == 10_000 and c.bytes_used == 40_000  # admitted alone


def test_devcache_invalidation_by_key_and_owner():
    c = DeviceCache(budget_bytes=1 << 20)
    a, b = new_owner_token(), new_owner_token()
    for owner in (a, b):
        for i in range(2):
            c.get_or_build((owner, i), lambda: torch.ones(4, dtype=torch.int32))
    c.invalidate((a, 0))
    c.invalidate_owners([b])
    assert c.bytes_used == 16
    built = []
    c.get_or_build((a, 0), lambda: built.append("a0") or torch.ones(4, dtype=torch.int32))
    c.get_or_build((b, 1), lambda: built.append("b1") or torch.ones(4, dtype=torch.int32))
    c.get_or_build((a, 1), lambda: built.append("a1") or torch.ones(4, dtype=torch.int32))
    assert built == ["a0", "b1"]


def test_devcache_get_or_build_is_single_flight():
    c = DeviceCache(budget_bytes=1 << 20)
    key = (new_owner_token(), "k")
    calls = []
    gate = threading.Event()

    def build():
        calls.append(1)
        gate.wait(5)
        return torch.arange(8, dtype=torch.int32)

    out = []
    threads = [threading.Thread(target=lambda: out.append(c.get_or_build(key, build))) for _ in range(8)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert len(calls) == 1 and len(out) == 8
    assert all(o is out[0] for o in out)


def test_devcache_failed_build_is_retried():
    c = DeviceCache(budget_bytes=1 << 20)
    key = (new_owner_token(), 0)
    with pytest.raises(RuntimeError):
        c.get_or_build(key, lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    assert c.get_or_build(key, lambda: torch.ones(1, dtype=torch.int32)).item() == 1


def _pair(mutex=False):
    ref = JFragment(None, "i", "f", "standard", 2, mutex=mutex).open()
    port = TFragment(
        "i", "f", "standard", 2, device=torch.device("cpu"),
        dcache=DeviceCache(1 << 30), mutex=mutex,
    )
    return ref, port


def _same(ref, port, rows):
    for r in rows:
        np.testing.assert_array_equal(port.row_words(r), ref.row_words(r))
        np.testing.assert_array_equal(port.row_positions(r), ref.row_positions(r))
        assert port.row_count(r) == ref.row_count(r)
    assert port.cache_top() == ref.cache_top()
    ids = np.asarray(rows, np.uint64)
    np.testing.assert_array_equal(port.cache_counts_exact(ids), ref.cache_counts_exact(ids))
    np.testing.assert_array_equal(port.row_counts_host(list(rows)), ref.row_counts_host(list(rows)))


@pytest.mark.parametrize("burst", [3000, 120_000])  # sort merge; column-mask merge (large bursts)
def test_fragment_writes_match_reference(burst):
    rng = np.random.default_rng(5)
    ref, port = _pair()
    rows = list(range(6))
    for _ in range(3):  # staged bursts merge at the next read barrier
        pos = rng.integers(0, 6, burst).astype(np.uint64) * np.uint64(SHARD_WIDTH) + rng.integers(
            0, SHARD_WIDTH, burst
        ).astype(np.uint64)
        assert port.stage_positions(pos) == ref.stage_positions(pos)
    _same(ref, port, rows)
    # a small burst makes sparse rows 8 and 9, a large one merges into them
    for size in (burst // 100, burst):
        pos = rng.integers(8, 10, size).astype(np.uint64) * np.uint64(SHARD_WIDTH) + rng.integers(
            0, SHARD_WIDTH, size
        ).astype(np.uint64)
        assert port.stage_positions(pos) == ref.stage_positions(pos)
        _same(ref, port, [8, 9])
    # sorted batches (a roaring body's positions) into new and existing rows
    pos = np.unique(rng.integers(4 * SHARD_WIDTH, 12 * SHARD_WIDTH, burst).astype(np.uint64))
    assert port.import_positions(pos, None) == ref.import_positions(pos, None)
    rows = list(range(12))
    _same(ref, port, rows)
    dense = rng.integers(0, 2**32, WORDS_PER_ROW, dtype=np.uint32)
    assert port.import_row_words(1, dense) == ref.import_row_words(1, dense)
    clear = rng.integers(0, 2 * SHARD_WIDTH, 5000).astype(np.uint64)
    assert port.import_positions(None, clear) == ref.import_positions(None, clear)
    for r, c in [(0, 5), (0, 5), (3, SHARD_WIDTH * 2 + 17), (1, 9)]:
        assert port.set_bit(r, c) == ref.set_bit(r, c)
        assert port.clear_bit(r, c + 1) == ref.clear_bit(r, c + 1)
    _same(ref, port, rows)
    cat_p, len_p = port.rows_sparse_concat(rows)
    cat_r, len_r = ref.rows_sparse_concat(rows)
    np.testing.assert_array_equal(cat_p, cat_r)
    np.testing.assert_array_equal(len_p, len_r)
    with pytest.raises(ValueError):
        port.set_bit(0, 5 * SHARD_WIDTH)  # column of another shard


def test_mutex_fragment_matches_reference():
    rng = np.random.default_rng(6)
    ref, port = _pair(mutex=True)
    cols = rng.integers(0, SHARD_WIDTH, 2000).astype(np.uint64)
    cols = np.concatenate([cols, cols[:300]])
    rows = rng.integers(0, 4, len(cols)).astype(np.uint64)
    assert port.bulk_import(rows, cols) == ref.bulk_import(rows, cols)
    for r, c in [(1, 7), (2, 7), (2, 7), (0, int(cols[0]))]:
        assert port.set_bit(r, c) == ref.set_bit(r, c)
    _same(ref, port, range(4))
    with pytest.raises(ValueError):
        port.stage_positions(np.array([1], np.uint64))
    with pytest.raises(ValueError):
        port.import_row_words(0, np.zeros(WORDS_PER_ROW, np.uint32))


def test_bsi_methods_raise():
    """The per-fragment BSI aggregates stay unported: they raise and name
    the stacked path that serves them."""
    _, port = _pair()
    assert port.set_value(1, 8, 3)
    for call in (
        lambda: port.sum(None, 8),
        lambda: port.min(None, 8),
        lambda: port.max(None, 8),
        lambda: port.range_op("lt", 8, 3),
        lambda: port.range_between(8, 1, 3),
        lambda: port.not_null(),
    ):
        with pytest.raises(NotImplementedError, match="stacked path"):
            call()


def test_bsi_fragment_writes_match_reference():
    """Sign + magnitude writes (point and columnar, clears, last write
    wins) leave identical plane rows and point reads."""
    rng = np.random.default_rng(8)
    ref, port = _pair()
    cols = rng.integers(0, SHARD_WIDTH, 4000).astype(np.uint64)
    vals = rng.integers(-(2**19), 2**19, len(cols))
    ref.import_values(cols, vals, 20)
    port.import_values(cols, vals, 20)
    for col, v, clear in [(5, -3, False), (5, 7, False), (int(cols[0]), 0, True), (9, 2**19 - 1, False)]:
        assert port.set_value(col, 20, v, clear) == ref.set_value(col, 20, v, clear)
        assert port.set_value(col, 20, v, clear) == ref.set_value(col, 20, v, clear)
    _same(ref, port, range(22))
    for col in [5, 9, int(cols[0]), int(cols[1]), int(cols[-1]), 123457]:
        assert port.value(col, 20) == ref.value(col, 20)


def test_int_field_round_trips_through_numpy_state():
    """A pilosa_tpu holder's int field (options with a grown bit depth,
    the BSI view's plane rows) through export_state and
    compat.holder_from_numpy reads back the same values and options."""
    from pilosa_tpu.core.field import FieldOptions as JFieldOptions
    from pilosa_tpu.core.holder import Holder as JHolder
    from pilosa_tpu_torch.compat import holder_from_numpy
    from test_torch_executor import export_state

    rng = np.random.default_rng(4)
    ref = JHolder(None).open()
    idx = ref.create_index("i")
    f = idx.create_field("v", JFieldOptions(type="int", min=-100, max=10_000, bit_depth=5))
    cols = rng.choice(3 * SHARD_WIDTH, 5000, replace=False).astype(np.uint64)
    f.import_values(cols, rng.integers(-20, 21, len(cols)))
    f.set_value(2 * SHARD_WIDTH + 1, 9000)  # grows the depth to 14
    state = export_state(ref)
    assert state["i"]["fields"]["v"]["bit_depth"] == 14
    port = holder_from_numpy(state, device="cpu")
    pf = port.index("i").field("v")
    o, jo = pf.options, f.options
    assert (o.type, o.min, o.max, o.base, o.bit_depth) == ("int", jo.min, jo.max, jo.base, jo.bit_depth)
    assert sorted(pf.views) == sorted(f.views)
    for col in list(cols[:200]) + [2 * SHARD_WIDTH + 1, 7]:
        assert pf.value(int(col)) == f.value(int(col))
    bad = export_state(ref)
    bad["i"]["fields"]["v"]["base"] = 3
    with pytest.raises(ValueError, match="base"):
        holder_from_numpy(bad, device="cpu")
