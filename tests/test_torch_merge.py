"""The port's cross-fragment merge barrier against pilosa_tpu's, on the CPU.

Mirrors tests/test_merge.py on the port:

- the key merges: the port's `merge_keys_host` and its device route
  (`merge_keys_device` on a CPU tensor, where `merge_mark` runs its twin;
  its device tensor too) must give the reference `merge_keys_host`'s
  sorted unique keys exactly, `bit_cumsum` its wrapped uint32 cumsums,
  and `word_or_from_sorted` its word deltas (and the naive per-bit OR).
  The reference is held through `merge_keys_host`, never
  `merge_keys_device`, which needs an accelerator backend;
- the barrier, differential: the same staged bursts (duplicates, empty
  and one-key bursts, interleaved set/clear batches) through the port at
  threshold 0 (device route) and -1 (host) and through the reference at
  -1 leave identical bits and rank caches, equal to naive per-bit
  writes; 120 fragments merge in one device launch; the crossover on
  both sides of the threshold; a reader racing the barrier;
- WAL replay: staged frames reopen through one deferred merge;
- the `or_bits` twin three ways (numpy, the reference's
  `word_or_from_sorted` applied as dense delta blocks, the naive model)
  on an empty table, an empty segment, one key, bit 31, the entry's last
  word, a word's run across the kernel's chunk boundary and two rows of
  a planes entry; tables outside the entry are refused before any
  write; the `merge_mark` twin against numpy; the `cuda`-marked test
  holds both kernels to their twins on a card and skips without one.
"""

import threading

import numpy as np
import pytest
import torch

from pilosa_tpu.core import merge as jmerge
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.core.naive import NaiveBitmap
from pilosa_tpu.ops import merge as jops
from pilosa_tpu_torch import Holder as THolder
from pilosa_tpu_torch.core import merge as tmerge
from pilosa_tpu_torch.core.devcache import DeviceCache
from pilosa_tpu_torch.core.fragment import Fragment as TFragment
from pilosa_tpu_torch.ops import kernels as K
from pilosa_tpu_torch.ops import merge as tops
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _merge_env():
    """Restore both packages' process-wide crossover and counters."""
    jold, told = jmerge._device_threshold, tmerge._device_threshold
    yield
    jmerge.configure(device_threshold=jold)
    tmerge.configure(device_threshold=told)
    for m in (jmerge, tmerge, jops, tops):
        m.reset_stats()


def _pairs_set(field):
    """{(row, absolute col)} over every standard-view fragment (a host
    read: it runs each fragment's own read barrier)."""
    out = set()
    v = field.view("standard")
    if v is None:
        return out
    for s in v.available_shards():
        rows, cols = v.fragments[s].pairs()
        out.update((int(r), int(c) + s * SHARD_WIDTH) for r, c in zip(rows.tolist(), cols.tolist()))
    return out


def _cache_tops(field):
    v = field.view("standard")
    return {s: list(v.fragments[s].cache_top()) for s in v.available_shards()}


def _burst(rng, n, n_shards, row_lo=0, row_hi=12):
    rows = rng.integers(row_lo, row_hi, n).astype(np.uint64)
    cols = rng.integers(0, n_shards * SHARD_WIDTH, n).astype(np.uint64)
    return rows, cols


def _field(pkg: str, name: str):
    if pkg == "ref":
        return JHolder().open().create_index(name).create_field("f", JFieldOptions())
    return THolder(device="cpu").open().create_index(name).create_field("f")


# ---------------------------------------------------------------------------
# key merges
# ---------------------------------------------------------------------------


def _dup_heavy(seed: int, n: int, hi: int) -> np.ndarray:
    keys = np.random.default_rng(seed).integers(0, hi, n).astype(np.uint64)
    return np.concatenate([keys, keys[: n // 3], keys[:11]])


@pytest.mark.parametrize(
    "keys",
    [
        _dup_heavy(3, 5000, 1 << 40),
        _dup_heavy(4, 3000, 1 << 12),  # many keys per word: the wrap
        np.empty(0, np.uint64),
        np.array([7], np.uint64),
        np.full(50, 31, np.uint64),
        np.array([(1 << 63) - 1, 0, (1 << 63) - 32, (1 << 63) - 1], np.uint64),
    ],
    ids=["dup-heavy", "dense-words", "empty", "one", "all-equal", "near-2^63"],
)
def test_merge_keys_match_reference(keys):
    """Both routes give the reference's keys; the device route's tensor
    holds the same keys; `bit_cumsum` gives the reference's cumsum."""
    mj, cj = jops.merge_keys_host(keys)
    md, dt = tops.merge_keys_device(keys, CPU)
    for mt in (tops.merge_keys_host(keys), md):
        assert mt.dtype == np.uint64
        np.testing.assert_array_equal(mt, mj)
    assert dt.dtype == torch.int64 and dt.device == CPU
    np.testing.assert_array_equal(dt.numpy().view(np.uint64), mj)
    ct = tops.bit_cumsum(md)
    assert ct.dtype == np.uint32
    np.testing.assert_array_equal(ct, cj)


def test_merge_keys_device_refuses_keys_past_2_63():
    with pytest.raises(ValueError, match="2\\^63"):
        tops.merge_keys_device(np.array([1 << 63], np.uint64), CPU)


@pytest.mark.parametrize("lo_frac", [0, 3], ids=["whole", "mid-slice"])
def test_word_or_matches_reference_and_naive(lo_frac):
    rng = np.random.default_rng(4 + lo_frac)
    pos = np.unique(rng.integers(0, SHARD_WIDTH, 4000).astype(np.uint64))
    merged = tops.merge_keys_host(pos)
    cum = tops.bit_cumsum(merged)
    lo = len(merged) // lo_frac if lo_frac else 0
    widx, wvals = tops.word_or_from_sorted(merged[lo:], cum[lo:])
    jidx, jvals = jops.word_or_from_sorted(merged[lo:], cum[lo:])
    np.testing.assert_array_equal(widx, jidx)
    np.testing.assert_array_equal(wvals, jvals)
    want = np.zeros(SHARD_WIDTH // 32, np.uint32)
    for p in merged[lo:].tolist():
        want[p >> 5] |= np.uint32(1) << np.uint32(p & 31)
    got = np.zeros_like(want)
    got[widx] = wvals
    np.testing.assert_array_equal(got, want)


def test_empty_word_or():
    widx, wvals = tops.word_or_from_sorted(np.empty(0, np.uint64), np.empty(0, np.uint32))
    assert len(widx) == 0 and len(wvals) == 0


def test_merge_mark_twin_matches_numpy():
    rng = np.random.default_rng(6)
    s = np.sort(np.concatenate([rng.integers(0, 1 << 62, 3000), np.full(20, 5)]).astype(np.int64))
    keep, bit = tops.merge_mark(torch.from_numpy(s))
    want_keep = np.ones(len(s), bool)
    want_keep[1:] = s[1:] != s[:-1]
    want_bit = np.where(want_keep, np.uint32(1) << (s & 31).astype(np.uint32), 0).astype(np.uint32)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(bit.numpy().view(np.uint32), want_bit)
    keep, bit = tops.merge_mark(torch.empty(0, dtype=torch.int64))
    assert keep.numel() == 0 and bit.numel() == 0


# or_bits cases: (entry planes D, shards n, {(shard position p, row d):
# columns}); the keys pack each fragment p as segment p of R = D rows
_W = WORDS_PER_ROW
_LAST = SHARD_WIDTH - 1


def _straddling_run():
    """One segment whose word runs straddle warps (32 keys), rounds (256)
    and the kernel's chunk boundary (tops.OR_BITS_CHUNK): the columns
    5..5 + 3 x chunk, every bit, so key i sits in word (i + 5) >> 5."""
    return {(1, 0): np.arange(5, 5 + 3 * tops.OR_BITS_CHUNK)}


def _random_segments(seed):
    rng = np.random.default_rng(seed)
    return {(p, d): rng.integers(0, SHARD_WIDTH, 700) for p in range(3) for d in range(2)}


OR_BITS_CASES = {
    "empty-table": (1, 2, {}),
    "empty-segment": (1, 2, {(0, 0): [], (1, 0): [3, 40]}),
    "one-key": (1, 2, {(1, 0): [77]}),
    "bit-31": (1, 2, {(0, 0): [31, 63, 95, 32 * 9 + 31, _LAST]}),
    "last-word": (2, 3, {(2, 1): [_LAST - 31, _LAST - 1, _LAST], (0, 0): [0]}),
    "chunk-boundary-run": (1, 2, _straddling_run()),
    "planes-two-rows": (2, 3, _random_segments(40)),
}


def _or_bits_case(D, n, segs, seed=41):
    """(entry uint32[D, n, W] with sparse seeded bits, sorted unique int64
    keys, int64[T, 3] table, the entry's bits as a NaiveBitmap of flat bit
    positions) of a case, packed as the barrier packs a group and tabled
    as View._patch_entry tables an entry."""
    rng = np.random.default_rng(seed)
    init = NaiveBitmap(rng.integers(0, D * n * SHARD_WIDTH, 3000).tolist())
    entry = np.zeros(D * n * _W, np.uint32)
    pos = np.array(init.slice(), np.int64)
    np.bitwise_or.at(entry, pos >> 5, (np.uint32(1) << (pos & 31).astype(np.uint32)))
    span = D * SHARD_WIDTH  # a fragment's rows 0..D-1
    keys = np.unique(np.concatenate(
        [np.empty(0, np.int64)]
        + [p * span + d * SHARD_WIDTH + np.asarray(c, np.int64) for (p, d), c in segs.items()]
    ))
    table = []
    for (p, d), c in sorted(segs.items()):
        lo = p * span + d * SHARD_WIDTH
        ks, ke = np.searchsorted(keys, [lo, lo + SHARD_WIDTH])
        table.append((ks, ke, (d * n + p) * _W))
    return entry.reshape(D, n, _W), keys, np.array(table, np.int64).reshape(-1, 3), init


@pytest.mark.parametrize("case", list(OR_BITS_CASES))
def test_or_bits_twin_matches_numpy_reference_and_naive(case):
    entry, keys, table, init = _or_bits_case(*OR_BITS_CASES[case])
    t = torch.from_numpy(entry.view(np.int32).copy())
    kt = torch.from_numpy(keys)
    assert tops.or_bits(t, kt, table) == 0  # nothing crosses to a card
    got = t.numpy().view(np.uint32).reshape(-1)
    # numpy: every key's bit ORed into its row's words
    want = entry.copy().reshape(-1)
    for ks, ke, base in table.tolist():
        col = keys[ks:ke] & _LAST
        np.bitwise_or.at(want, base + (col >> 5), np.uint32(1) << (col & 31).astype(np.uint32))
    np.testing.assert_array_equal(got, want)
    # the reference's patch: a dense delta block per (shard, row) from
    # word_or_from_sorted over the group's wrapped bit cumsum
    _, cum = jops.merge_keys_host(keys.view(np.uint64))
    ref = entry.copy().reshape(-1, _W)
    for ks, ke, base in table.tolist():
        if ke > ks:
            widx, wvals = jops.word_or_from_sorted(keys[ks:ke].view(np.uint64) & np.uint64(_LAST), cum[ks:ke])
            delta = np.zeros(_W, np.uint32)
            delta[widx] = wvals
            ref[base // _W] |= delta
    np.testing.assert_array_equal(got, ref.reshape(-1))
    # the naive model: the entry's bits plus one bit per key
    naive = NaiveBitmap(init.slice())
    for ks, ke, base in table.tolist():
        naive.add(*(base * 32 + (keys[ks:ke] & _LAST)).tolist())
    bits = np.flatnonzero(np.unpackbits(got.view(np.uint8), bitorder="little"))
    assert bits.tolist() == naive.slice()
    # the plain twin agrees with the wrapper
    again = torch.from_numpy(entry.view(np.int32).copy())
    assert tops.or_bits_plain(again, kt, table) is again
    assert torch.equal(again, t)


def test_or_bits_chunks_cut_segments_at_the_kernel_chunk():
    c = tops.OR_BITS_CHUNK
    t = np.array([(0, 0, 0), (0, 2 * c + 1, _W), (5, 6, 0)], np.int64)
    start, end, base = tops._or_bits_chunks(t)
    assert start.tolist() == [0, c, 2 * c, 5]
    assert end.tolist() == [c, 2 * c, 2 * c + 1, 6]
    assert base.tolist() == [_W, _W, _W, 0]


@pytest.mark.parametrize(
    "row",
    [(0, 1, 1), (0, 1, 2 * _W), (0, 1, -_W), (2, 1, 0), (-1, 1, 0), (0, 9, 0)],
    ids=["unaligned-base", "past-the-entry", "negative-base", "start-after-end", "negative-start", "past-the-keys"],
)
def test_or_bits_refuses_tables_outside_the_entry(row):
    """A table row outside the keys or not naming a whole row of the
    entry raises before anything is written (the kernel trusts the
    table the wrapper checked)."""
    entry = torch.arange(2 * _W, dtype=torch.int32).reshape(2, _W)
    before = entry.clone()
    keys = torch.arange(0, 8 * 37, 37, dtype=torch.int64)
    with pytest.raises(IndexError, match="or_bits: table row 1"):
        tops.or_bits(entry, keys, np.array([(0, 8, _W), row], np.int64))
    assert torch.equal(entry, before)


def test_or_bits_refuses_bad_arguments():
    entry = torch.zeros(2, _W, dtype=torch.int32)
    keys = torch.arange(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="contiguous"):
        tops.or_bits(entry[:, ::2], keys, np.zeros((0, 3), np.int64))
    with pytest.raises(TypeError, match="int64"):
        tops.or_bits(entry, keys.to(torch.int32), np.zeros((0, 3), np.int64))
    with pytest.raises(ValueError, match=r"\[T, 3\]"):
        tops.or_bits(entry, keys, np.zeros((2, 2), np.int64))
    assert not entry.any()


# ---------------------------------------------------------------------------
# the barrier
# ---------------------------------------------------------------------------


def _drive(pkg: str, threshold: int, batches, clears=()):
    """One field driven through the staged path; clears (the exact path)
    follow the listed batch index. Returns (pairs, rank-cache tops)."""
    (jmerge if pkg == "ref" else tmerge).configure(device_threshold=threshold)
    f = _field(pkg, "dx")
    clears = dict(clears)
    for i, (rows, cols) in enumerate(batches):
        f.import_bits(rows, cols)
        if i in clears:
            f.import_bits(*clears[i], clear=True)
        if i % 2 == 1:
            f.view("standard").sync_pending()
    f.view("standard").sync_pending()
    return _pairs_set(f), _cache_tops(f)


def _naive(pkg: str, batches, clears=()):
    f = _field(pkg, "nv")
    clears = dict(clears)
    for i, (rows, cols) in enumerate(batches):
        for r, c in zip(rows.tolist(), cols.tolist()):
            f.set_bit(int(r), int(c))
        if i in clears:
            for r, c in zip(*(x.tolist() for x in clears[i])):
                f.clear_bit(int(r), int(c))
    return _pairs_set(f), _cache_tops(f)


def _dup_batches(seed: int, n_batches: int, n: int, n_shards: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        rows, cols = _burst(rng, n, n_shards)
        out.append((np.concatenate([rows, rows[: n // 6]]), np.concatenate([cols, cols[: n // 6]])))
    return out


@pytest.mark.parametrize(
    "batches",
    [
        _dup_batches(11, 4, 3000, 6),
        [(np.empty(0, np.uint64), np.empty(0, np.uint64))] + _dup_batches(12, 1, 10, 2),
        [(np.array([3], np.uint64), np.array([SHARD_WIDTH + 9], np.uint64))] * 3,
    ],
    ids=["duplicates", "empty-then-small", "one-key"],
)
def test_barrier_device_host_reference_naive_identical(batches):
    dev = _drive("port", 0, batches)
    host = _drive("port", -1, batches)
    ref = _drive("ref", -1, batches)
    assert dev == host == ref
    assert dev[0] == _naive("port", batches)[0] == {
        (int(r), int(c)) for rows, cols in batches for r, c in zip(rows.tolist(), cols.tolist())
    }
    assert dev[1] == _naive("port", batches)[1]


def test_interleaved_set_clear_batches():
    rng = np.random.default_rng(12)
    b = [_burst(rng, 2000, 4) for _ in range(3)]
    clears = {1: (b[0][0][:1000], b[0][1][:1000])}
    dev = _drive("port", 0, b, clears)
    assert dev == _drive("port", -1, b, clears) == _drive("ref", -1, b, clears)
    assert dev == _naive("port", b, clears)


def test_one_launch_for_120_fragments():
    tmerge.configure(device_threshold=0)
    n_shards, n = 120, 60_000
    f = _field("port", "burstx")
    rng = np.random.default_rng(13)
    rows = rng.integers(0, 8, n).astype(np.uint64)
    cols = np.concatenate(
        [
            np.arange(n_shards, dtype=np.uint64) * SHARD_WIDTH,
            rng.integers(0, n_shards * SHARD_WIDTH, n - n_shards).astype(np.uint64),
        ]
    )
    f.import_bits(rows, cols)
    v = f.view("standard")
    assert sum(1 for fr in v.fragments.values() if fr._pending_n) == n_shards
    tops.reset_stats()
    tmerge.reset_stats()
    v.sync_pending()
    assert tops.MERGE_STATS["device_launches"] == 1
    snap = tmerge.stats_snapshot()
    assert snap["barriers"] == 1 and snap["device"] == 1 and snap["positions"] == n
    assert snap["batches"] == n_shards
    assert not any(fr._pending_n for fr in v.fragments.values())
    assert _pairs_set(f) == set(zip(rows.tolist(), cols.tolist()))


def test_crossover_boundary_both_sides():
    tmerge.configure(device_threshold=1000)
    f = _field("port", "thr")
    rng = np.random.default_rng(14)
    for n, launches, host in ((999, 0, 1), (1000, 1, 0)):
        f.import_bits(*_burst(rng, n, 3))
        tops.reset_stats()
        f.view("standard").sync_pending()
        assert (tops.MERGE_STATS["device_launches"], tops.MERGE_STATS["host_merges"]) == (launches, host)


def test_auto_crossover_resolves_by_device():
    tmerge.configure(device_threshold=None)
    assert tmerge.device_threshold(CPU) == -1
    assert tmerge.device_threshold(torch.device("cuda", 0)) == tmerge.ACCEL_DEVICE_THRESHOLD == 65536
    f = _field("port", "autox")
    f.import_bits(*_burst(np.random.default_rng(16), 30_000, 6))
    tops.reset_stats()
    tmerge.reset_stats()
    f.view("standard").sync_pending()
    assert (tops.MERGE_STATS["device_launches"], tops.MERGE_STATS["host_merges"]) == (0, 1)
    snap = tmerge.stats_snapshot()
    assert snap["barriers"] == 1 and snap["device"] == 0


def test_concurrent_reader_races_barrier_exactly_once():
    tmerge.configure(device_threshold=0)
    f = _field("port", "race")
    rng = np.random.default_rng(15)
    want, errs = set(), []
    for _ in range(6):
        rows, cols = _burst(rng, 4000, 5)
        f.import_bits(rows, cols)
        want |= set(zip(rows.tolist(), cols.tolist()))
        v = f.view("standard")

        def reader():
            try:
                for fr in list(v.fragments.values()):
                    fr.row_count(0)  # the fragment's own read barrier
            except Exception as e:  # noqa: BLE001 - collected
                errs.append(e)

        t = threading.Thread(target=reader)
        t.start()
        v.sync_pending()
        t.join()
    assert not errs, errs[:1]
    assert _pairs_set(f) == want


def test_stale_generation_skips_the_apply():
    """A host read between the barrier's capture and its apply merges the
    parts itself; the apply then changes nothing."""
    f = _field("port", "gen")
    f.import_bits(np.array([1, 2], np.uint64), np.array([5, 9], np.uint64))
    frag = f.view("standard").fragments[0]
    parts, n_parts, gen, base = frag.pending_snapshot()
    assert (n_parts, base) == (1, frag.version - 1)
    frag.row_count(1)  # merges the pending parts
    assert frag.apply_merged_delta(np.array([SHARD_WIDTH + 5], np.uint64), n_parts, 2, gen) is None
    assert frag._premerged == [] and _pairs_set(f) == {(1, 5), (2, 9)}


# ---------------------------------------------------------------------------
# WAL replay
# ---------------------------------------------------------------------------


def test_wal_replay_lands_through_one_deferred_merge(tmp_path, monkeypatch):
    def open_frag():
        return TFragment("i", "f", "standard", 0, device=CPU, dcache=DeviceCache(1 << 30), path=str(tmp_path / "w")).open()

    frag = open_frag()
    rng = np.random.default_rng(21)
    for _ in range(8):
        pos = rng.integers(0, 8, 500).astype(np.uint64) * np.uint64(SHARD_WIDTH) + rng.integers(
            0, SHARD_WIDTH, 500
        ).astype(np.uint64)
        frag.stage_positions(pos)
    want_pairs = frag.pairs()
    want_top = frag.cache_top()
    frag._wal.close()  # crash: no snapshot, no cache sidecar
    frag._wal = None
    calls = []
    real = tmerge.note_host_sync
    monkeypatch.setattr(tmerge, "note_host_sync", lambda n: (calls.append(n), real(n))[1])
    frag2 = open_frag()
    assert calls == [8]
    rows, cols = frag2.pairs()
    np.testing.assert_array_equal(rows, want_pairs[0])
    np.testing.assert_array_equal(cols, want_pairs[1])
    assert frag2.cache_top() == want_top
    assert frag2._pending_n == 0 and frag2._staged_base_version == 0 and frag2.version == 8
    frag2.close()


# ---------------------------------------------------------------------------
# kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        K._nvcc()
    except RuntimeError:
        pytest.skip("no nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_merge_kernels_match_twins(cuda_device):
    rng = np.random.default_rng(30)
    for keys in (_dup_heavy(3, 100_000, 1 << 40), np.empty(0, np.uint64), np.array([5], np.uint64)):
        got, dt = tops.merge_keys_device(keys, cuda_device)
        want = jops.merge_keys_host(keys)[0]
        np.testing.assert_array_equal(got, want)
        assert dt.device == cuda_device
        np.testing.assert_array_equal(dt.cpu().numpy().view(np.uint64), want)
    for case in OR_BITS_CASES:
        entry, keys, table, _ = _or_bits_case(*OR_BITS_CASES[case])
        t = torch.from_numpy(entry.view(np.int32))
        got = t.to(cuda_device)
        kd = torch.from_numpy(keys).to(cuda_device)
        tops.or_bits(got, kd, table)
        assert torch.equal(got.cpu(), tops.or_bits_plain(t.clone(), torch.from_numpy(keys), table)), case
    # 10^6 random keys over a [4, 8, W] entry, 32 segments
    segs = {(p, d): rng.integers(0, SHARD_WIDTH, 31250) for p in range(8) for d in range(4)}
    entry, keys, table, _ = _or_bits_case(4, 8, segs)
    t = torch.from_numpy(entry.view(np.int32))
    dev_entry = t.to(cuda_device)
    kd = torch.from_numpy(keys).to(cuda_device)
    assert tops.or_bits(dev_entry, kd, table) == 24 * len(tops._or_bits_chunks(table)[0])
    assert torch.equal(dev_entry.cpu(), tops.or_bits_plain(t.clone(), torch.from_numpy(keys), table))
    before = dev_entry.clone()
    with pytest.raises(IndexError):
        tops.or_bits(dev_entry, kd, np.array([(0, 1, dev_entry.numel())], np.int64))
    with pytest.raises(ValueError, match="different devices"):
        tops.or_bits(dev_entry, kd.cpu(), table)
    assert torch.equal(dev_entry, before)
