"""Fragment: one (index, field, view, shard) slab of bits.

The port of pilosa_tpu/core/fragment.py. The host store keeps each row
as sparse positions or dense words (core/rowstore.py), the mutex vector
for mutex fields, and the exact rank cache that unfiltered TopN reads.
Device copies of rows live in the holder's DeviceCache and are dropped on
mutation. Staged ingest (`stage_positions`) appends positions to a
pending buffer that every host read merges first (`_sync_locked`). The
view's merge barrier (core/merge.py) merges the buffers of many
fragments in one pass instead: `pending_snapshot` captures them without
popping, `apply_merged_delta` trims them and parks the merged slice as a
delta layer (unless `_pending_gen` moved, meaning a host read merged
them meanwhile), and `_sync_locked` folds parked layers into the row
store at the next host read.

A fragment with a `path` is durable, in the reference's on-disk format
(core/wal.py): `<path>.snap` holds a snapshot, `<path>.wal` every write
since, `<path>.cache` the rank cache. Every mutation funnel logs its
records before it applies them, and waits for the group commit after it
has released the fragment lock, so no reader waits on an fsync. Past
`max_op_n` changed bits a write snapshots and truncates the WAL. `open`
indexes the snapshot's rows and reads each on demand (`_LazyRows`), then
replays the WAL.

Int (BSI) fragments keep sign + magnitude bit planes as ordinary rows
(BSI_EXISTS_BIT, BSI_SIGN_BIT, then BSI_OFFSET_BIT + i for magnitude bit
i); writes and point reads are host work here, and the aggregates run on
the stacked path (exec/bsistream.py, plan range nodes). Not ported: the
per-fragment BSI aggregates, which raise.

Live transfer (the streaming resize, server/node.py): `begin_streaming`
serializes the row store and arms a named write capture under one lock
hold, so the snapshot plus the records every write funnel appends to the
capture afterwards (`_log`, in the WAL's (op, positions) shape) is the
fragment's state at any later `drain_capture`. `block_writes` arms the
cutover barrier: every write funnel raises TransferCutover until it
lifts or its deadline passes. `from_bytes` replaces the contents
wholesale, `merge_from_bytes` unions a stream in, and
`apply_transfer_records` replays a drained capture through the ordinary
write funnels.

Position convention: pos = row_id * SHARD_WIDTH + (col % SHARD_WIDTH).
"""

from __future__ import annotations

import contextlib
import io
import os
import threading
import time
from itertools import repeat
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.core import blocks
from pilosa_tpu_torch.core import cache as cachemod
from pilosa_tpu_torch.core import merge as merge_mod
from pilosa_tpu_torch.core import rowstore
from pilosa_tpu_torch.core import wal as walmod
from pilosa_tpu_torch.core.devcache import DeviceCache, new_owner_token
from pilosa_tpu_torch.core.rowstore import RowBits
from pilosa_tpu_torch.ops import bitmap as ob
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW
from pilosa_tpu_torch.utils.arrays import group_slices

# changed bits between snapshots (the reference's fragment.go:84 MaxOpN)
DEFAULT_MAX_OP_N = 10_000

# BSI plane rows
BSI_EXISTS_BIT = 0
BSI_SIGN_BIT = 1
BSI_OFFSET_BIT = 2

# a capture past this many positions is dropped and marked lost: the
# destination refetches the snapshot rather than this node buffering an
# unbounded delta for a transfer whose coordinator may have died
CAPTURE_MAX_POSITIONS = 1 << 22


class TransferCaptureLost(Exception):
    """The write capture of a transfer is gone (overflowed, replaced
    wholesale, or never armed): the destination must refetch the
    snapshot (HTTP 410 on the delta route)."""


class TransferCutover(Exception):
    """The fragment is inside its resize-cutover write barrier: writes
    are refused with a retryable error (HTTP 503 + Retry-After) until the
    barrier lifts."""


_BSI_STACKED = (
    "per-fragment BSI aggregates are not ported: Sum/Min/Max and condition "
    "rows run on the stacked path (exec/bsistream.py, exec/plan.py range nodes)"
)


# positions per row from which a set batch merges by column mask, not sort
_MASK_MERGE_MIN = SHARD_WIDTH // 64


def _ordered(a: np.ndarray) -> bool:
    return len(a) < 2 or bool(np.all(a[1:] >= a[:-1]))


def _unique(a: np.ndarray) -> np.ndarray:
    """np.unique(a), without the sort when `a` is already in order (the
    positions of a roaring body or of a row-major batch are)."""
    if not _ordered(a):
        return np.unique(a)
    keep = np.ones(len(a), bool)
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a[keep]


class _LazyRows:
    """A fragment's row store: rows a write touched live in `_mat`, and
    rows of the fragment's snapshot file (none in memory) are indexed from
    the file's headers and read on demand. Reads go through `peek`, which
    builds a snapshot row without keeping it, so staging the rows of a
    reopened fragment onto the device does not double the host's memory
    (the page cache keeps repeated reads cheap). Writes go through
    `get`/`[]`, which keep the row in `_mat`. No fd is held between reads.
    `rebase` indexes the snapshot file at open and again after
    `snapshot()` rewrites it."""

    __slots__ = ("n_bits", "path", "_mat", "_index", "_bulk_f")

    def __init__(self, n_bits: int):
        self.n_bits = n_bits
        self.path: Optional[str] = None  # the snapshot file, once indexed
        self._mat: Dict[int, RowBits] = {}
        self._index: Dict[int, Tuple[int, int, int]] = {}
        self._bulk_f = None  # one fd shared over a bulk() scan

    def rebase(self, path: str) -> None:
        """Index the rows of a snapshot file (rows in `_mat` take
        precedence; after a snapshot they are what was just written)."""
        _, n_bits, index = walmod.read_snapshot_index(path)
        if n_bits != self.n_bits:
            raise ValueError(f"{path}: snapshot width {n_bits} != configured SHARD_WIDTH {self.n_bits}")
        self.path = path
        self._index = index

    @contextlib.contextmanager
    def bulk(self):
        """Hold one fd across a scan of many rows (snapshot writes, cache
        rebuilds); a no-op without snapshot rows."""
        if self._bulk_f is not None or not self._index:
            yield
            return
        with open(self.path, "rb") as f:
            self._bulk_f = f
            try:
                yield
            finally:
                self._bulk_f = None

    def _read_payload(self, off: int, n: int) -> np.ndarray:
        f = self._bulk_f
        if f is not None:
            f.seek(off)
            data = f.read(n * 4)
        else:
            with open(self.path, "rb") as f2:
                f2.seek(off)
                data = f2.read(n * 4)
        if len(data) != n * 4:
            raise ValueError(f"{self.path}: truncated payload at {off}")
        return np.frombuffer(data, dtype="<u4")

    def peek(self, row_id: int) -> Optional[RowBits]:
        """The row for a read, not kept (None if absent)."""
        rb = self._mat.get(row_id)
        if rb is None:
            meta = self._index.get(row_id)
            if meta is None:
                return None
            rep, off, n = meta
            rb = RowBits.from_payload(self.n_bits, rep, self._read_payload(off, n))
        return rb

    def __getitem__(self, row_id: int) -> RowBits:
        rb = self._mat.get(row_id)
        if rb is None:
            rb = self.peek(row_id)
            if rb is None:
                raise KeyError(row_id)
            self._mat[row_id] = rb
        return rb

    def get(self, row_id: int, default=None):
        rb = self._mat.get(row_id)
        if rb is not None:
            return rb
        return self[row_id] if row_id in self._index else default

    def __setitem__(self, row_id: int, rb: RowBits) -> None:
        self._mat[row_id] = rb

    def keys(self):
        return self._mat.keys() | self._index.keys() if self._index else self._mat.keys()

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self.keys())

    def __bool__(self) -> bool:
        return bool(self._mat) or bool(self._index)

    def items(self):
        """(row_id, row) for every row, read as `peek` reads."""
        with self.bulk():
            for row_id in self.keys():
                yield row_id, self.peek(row_id)

    def count_of(self, row_id: int) -> int:
        """A row's cardinality without materializing it: an array row's
        from its header, a dense row's by popcount of its payload."""
        rb = self._mat.get(row_id)
        if rb is not None:
            return rb.count()
        meta = self._index.get(row_id)
        if meta is None:
            return 0
        rep, off, n = meta
        if rep == rowstore.ARRAY_REP:
            return n
        return rowstore._popcount_words(self._read_payload(off, n))

    def rep_payload(self, row_id: int) -> Tuple[int, np.ndarray]:
        """(rep, payload) for a snapshot write, without materializing."""
        rb = self._mat.get(row_id)
        if rb is not None:
            return rb.rep(), rb.payload()
        rep, off, n = self._index[row_id]
        return rep, self._read_payload(off, n)


class StagedTally:
    """A view's running count of staged positions (pending and parked)
    over its fragments, kept by each fragment as it stages, merges and
    folds: admission prices a read barrier from it (sched/cost.py)
    without walking the fragments."""

    __slots__ = ("_mu", "n")

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.n = 0

    def add(self, delta: int) -> None:
        with self._mu:  # fragments of one view stage concurrently
            self.n += delta


class Fragment:
    """One shard of one view of one field. A re-entrant lock guards the
    host structures."""

    def __init__(
        self,
        index: str,
        field: str,
        view: str,
        shard: int,
        *,
        device: torch.device,
        dcache: DeviceCache,
        mutex: bool = False,
        cache_type: str = cachemod.CACHE_TYPE_RANKED,
        cache_size: int = cachemod.DEFAULT_CACHE_SIZE,
        path: Optional[str] = None,
        max_op_n: int = DEFAULT_MAX_OP_N,
        version: int = 0,
    ):
        self.path = path  # None: in memory
        self.max_op_n = max_op_n
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self.device = device
        self.dcache = dcache
        self.cache = cachemod.make_cache(cache_type, cache_size)
        self._cache_top_arrays = None  # memoized (top, rids, cnts)
        self._cache_id_arrays = None  # memoized id-sorted (top, rids, cnts)
        self._mu = threading.RLock()
        self._rows = _LazyRows(SHARD_WIDTH)
        # staged SET positions not yet merged into _rows (stage_positions)
        self._pending: List[np.ndarray] = []
        self._pending_n = 0
        # merge handshake (core/merge.py): _pending_gen moves whenever
        # pending parts are consumed, so a barrier that captured them can
        # tell a reader merged them first; _staged_base_version is the
        # version just before the first unmerged staged batch (each batch
        # bumps the version by one), the version an extent must be keyed
        # at for the barrier's in-place patch to be exact
        self._pending_gen = 0
        self._staged_base_version = version
        # barrier outcomes not yet in _rows: sorted unique position keys,
        # folded in by the next host read (bounded by _LAYER_CAP)
        self._premerged: List[np.ndarray] = []
        self._premerged_n = 0
        # the view's StagedTally, given once the fragment is open; every
        # change of _pending_n + _premerged_n after that goes to it
        self.staged_tally: Optional[StagedTally] = None
        # device rows under _token, multi-row stacks under _stack_token
        self._token = new_owner_token()
        self._stack_token = new_owner_token()
        dcache.tag_owner(self._token, index)
        dcache.tag_owner(self._stack_token, index)
        # monotonic mutation counter; view stack keys carry it. A view
        # starts a re-created fragment above every version its deleted
        # predecessor reached, so no key recorded against the old one
        # revalidates against the new one
        self.version = version
        # mutex fields: col -> owning row
        self._mutex_map: Optional[Dict[int, int]] = {} if mutex else None
        # owner hook fired after any mutation (the View drops the stack
        # entries covering this shard)
        self.on_mutate = None
        self._wal: Optional[walmod.WalWriter] = None
        self._op_n = 0  # changed bits since the last snapshot
        # live-transfer write captures, one a transfer tag (two
        # destinations of one source fragment each see the whole delta):
        # tag -> records, tag -> positions held, tags lost to overflow or
        # a wholesale replace
        self._captures: Dict[str, List[Tuple[int, np.ndarray]]] = {}
        self._capture_ns: Dict[str, int] = {}
        self._captures_lost: set = set()
        # cutover write barrier: a monotonic deadline, 0 = open (a lost
        # release cannot block the fragment's writes past it)
        self._write_block_until = 0.0

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    @property
    def snap_path(self) -> Optional[str]:
        return None if self.path is None else self.path + ".snap"

    @property
    def wal_path(self) -> Optional[str]:
        return None if self.path is None else self.path + ".wal"

    @property
    def cache_path(self) -> Optional[str]:
        return None if self.path is None else self.path + ".cache"

    def open(self) -> "Fragment":
        """Load a durable fragment: index its snapshot (mutex fragments
        load it whole, since the mutex vector needs every bit), replay the
        WAL in order, then rebuild the mutex vector and the rank cache.
        Replay keeps the reference's order: staged sets go back into the
        pending buffer, a clear first merges the pending prefix, a row's
        words commute with staged sets, and open ends with one merge. The
        cache sidecar is trusted only when nothing was replayed."""
        with self._mu:
            if self.path is None or self._wal is not None:
                return self
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            if os.path.exists(self.snap_path):
                self._rows.rebase(self.snap_path)
            replayed = 0
            for op, positions in walmod.replay_wal(self.wal_path):
                if op == walmod.OP_ROW_WORDS:
                    self._apply_row_words(int(positions[0]), np.ascontiguousarray(positions[1:]).view(np.uint32))
                elif op == walmod.OP_SET and self._mutex_map is None:
                    # staged sets go back to the pending buffer and land
                    # through one deferred merge at the end of open
                    if not self._pending:
                        self._staged_base_version = self.version
                    self._pending.append(positions)
                    self._pending_n += len(positions)
                    self.version += 1
                else:
                    self._sync_locked()
                    empty = np.empty(0, np.uint64)
                    self._apply_positions(
                        positions if op == walmod.OP_SET else empty,
                        positions if op == walmod.OP_CLEAR else empty,
                    )
                self._op_n += len(positions)
                replayed += 1
            self._sync_locked()
            self._wal = walmod.WalWriter(self.wal_path)
            self._rebuild_mutex_map()
            if self.cache.cache_type != cachemod.CACHE_TYPE_NONE:
                loaded = replayed == 0 and cachemod.read_cache(self.cache_path, self.cache)
                if not loaded and self._rows:
                    self.recalculate_cache()
            return self

    def _rebuild_mutex_map(self) -> None:
        """The mutex vector from the row store (under _mu)."""
        if self._mutex_map is None:
            return
        self._mutex_map = {}
        for row_id, rb in self._rows.items():
            self._mutex_map.update(zip(rb.to_positions().tolist(), repeat(row_id)))

    def close(self) -> None:
        """Close the WAL, write the cache sidecar and drop the fragment's
        device entries."""
        with self._mu:
            if self._wal is not None:
                self._wal.close()
                self._wal = None
            self.flush_cache()
            self.dcache.invalidate_owners((self._token, self._stack_token))

    def flush_cache(self) -> None:
        """Write the rank cache's sidecar (the reference's flush ticker,
        holder.go:506)."""
        if self.cache_path is None or self.cache.cache_type == cachemod.CACHE_TYPE_NONE:
            return
        with self._mu:
            self._sync_locked()
            cachemod.write_cache(self.cache_path, self.cache)

    def recalculate_cache(self) -> None:
        """Rebuild the rank cache from exact row counts (snapshot rows
        count from their headers and payloads without materializing)."""
        with self._mu, self._rows.bulk():
            self._sync_locked()
            self.cache.clear()
            self.cache.bulk_add((rid, self._rows.count_of(rid)) for rid in self._rows)

    def snapshot(self) -> None:
        """Write a full snapshot, then the cache sidecar, then truncate the
        WAL (the reference's order, fragment.go:2337: a crash before the
        truncate replays the WAL over the new snapshot, and a replayed
        WAL means the sidecar is not trusted). An in-memory fragment has
        nothing to write."""
        with self._mu:
            if self._wal is None:
                return
            self._sync_locked()  # truncate() drops the pending records
            walmod.write_snapshot(self.snap_path, self.shard, SHARD_WIDTH, self._rows)
            self._rows.rebase(self.snap_path)
            self.flush_cache()
            walmod.fault_point("snapshot.pre_truncate", self.snap_path)
            self._wal.truncate()
            self._op_n = 0

    def _log(self, records) -> Optional[int]:
        """Append write records to the WAL and to every armed capture
        (under _mu): the commit token to wait on once the lock is
        released, or None."""
        for op, positions in records:
            self._capture_record(op, positions)
        return self._wal.append_many(records) if self._wal is not None else None

    def _after_write(self, n_changed: int, tok: Optional[int]) -> Optional[int]:
        """Count a durable fragment's changed bits (under _mu) and
        snapshot past max_op_n; a snapshot is fsynced, so it leaves
        nothing to wait for. In memory, staged writes stay deferred to
        the next read barrier."""
        if self._wal is None:
            return tok
        self._op_n += n_changed
        if self._op_n > self.max_op_n:
            self.snapshot()
            return None
        return tok

    # ------------------------------------------------------------------
    # reads (host metadata)
    # ------------------------------------------------------------------

    def row_words(self, row_id: int) -> np.ndarray:
        """Host dense uint32 words for one row (zeros if absent)."""
        with self._mu:
            self._sync_locked()
            rb = self._rows.peek(row_id)
            return rb.to_words() if rb is not None else ob.empty_row()

    def premerge_row_words(self, row_id: int) -> np.ndarray:
        """Host words of one row at the staged-base version: the row store
        plus the parked barrier layers, pending batches left out, and no
        read barrier run. The merge barrier reads it just before a burst's
        layer parks, so the result cache's Count repair has the row's old
        words (core/resultcache.py)."""
        with self._mu:
            rb = self._rows.peek(row_id)
            words = np.array(rb.to_words() if rb is not None else ob.empty_row(), dtype=np.uint32, copy=True)
            lo = np.uint64(row_id) * np.uint64(SHARD_WIDTH)
            for layer in self._premerged:
                s, e = np.searchsorted(layer, (lo, lo + np.uint64(SHARD_WIDTH)))
                if e > s:
                    cols = (layer[s:e] - lo).astype(np.uint32)
                    np.bitwise_or.at(words, cols >> np.uint32(5), np.left_shift(np.uint32(1), cols & np.uint32(31)))
            return words

    def row_positions(self, row_id: int) -> np.ndarray:
        with self._mu:
            self._sync_locked()
            rb = self._rows.peek(row_id)
            return rb.to_positions() if rb is not None else np.empty(0, np.uint32)

    def row_ids(self) -> List[int]:
        with self._mu:
            self._sync_locked()
            return sorted(self._rows)

    def rows_sparse_concat(self, row_ids) -> Tuple[np.ndarray, np.ndarray]:
        """One-lock bulk sparse read for the TopN tally: concatenated
        sorted bit positions of the listed rows plus per-row lengths;
        length -1 marks a dense-rep row (routed through the plane path)."""
        with self._mu, self._rows.bulk():
            self._sync_locked()
            parts = []
            lens = np.empty(len(row_ids), np.int64)
            for i, rid in enumerate(row_ids):
                rb = self._rows.peek(rid)
                if rb is None:
                    lens[i] = 0
                elif rb.dense is not None:
                    lens[i] = -1
                else:
                    p = rb.positions
                    lens[i] = len(p)
                    if len(p):
                        parts.append(p)
            cat = np.concatenate(parts) if parts else np.empty(0, np.uint32)
            return cat, lens

    def rows_words_into(self, row_ids, out: np.ndarray) -> None:
        """Write the listed rows' words into `out` (uint32[k, W], zeroed by
        the caller, which leaves absent rows zero), read under one lock
        and, from a snapshot, one open file."""
        with self._mu, self._rows.bulk():
            self._sync_locked()
            for i, rid in enumerate(row_ids):
                rb = self._rows.peek(rid)
                if rb is not None:
                    out[i] = rb.to_words()

    def rows_device(self, row_ids: Iterable[int]) -> torch.Tensor:
        """Stacked int32[k, W] device matrix for the given rows (one
        cached entry, one transfer)."""
        ids = tuple(row_ids)

        def build() -> torch.Tensor:
            words = np.zeros((len(ids), WORDS_PER_ROW), np.uint32)
            self.rows_words_into(ids, words)
            return ob.from_host(words, self.device)

        with self._mu:
            return self.dcache.get_or_build((self._stack_token, ids), build)

    def pairs(self, row_lo: Optional[int] = None, row_hi: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Bits as (row_ids, in-shard cols) uint64 arrays, row-major sorted,
        optionally only the rows in [row_lo, row_hi) (the exports and
        anti-entropy read these)."""
        with self._mu, self._rows.bulk():
            self._sync_locked()
            rows_out = []
            cols_out = []
            for row_id in sorted(self._rows):
                if (row_lo is not None and row_id < row_lo) or (row_hi is not None and row_id >= row_hi):
                    continue
                pos = self._rows.peek(row_id).to_positions()
                if len(pos):
                    rows_out.append(np.full(len(pos), row_id, dtype=np.uint64))
                    cols_out.append(pos.astype(np.uint64))
            if not rows_out:
                return np.empty(0, np.uint64), np.empty(0, np.uint64)
            return np.concatenate(rows_out), np.concatenate(cols_out)

    # -- anti-entropy (the reference's fragment.go:1762-1874 Blocks) --------

    def block_checksums(self) -> Dict[int, bytes]:
        """Per-100-row-block digests of the host row store, for comparing
        replicas (core/blocks.py)."""
        return blocks.block_checksums(self.pairs())

    def block_pairs(self, block_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, cols) of the bits in one checksum block."""
        return self.pairs(block_id * blocks.HASH_BLOCK_SIZE, (block_id + 1) * blocks.HASH_BLOCK_SIZE)

    def apply_deltas(
        self, sets: Tuple[np.ndarray, np.ndarray], clears: Tuple[np.ndarray, np.ndarray]
    ) -> Tuple[int, int]:
        """Apply an anti-entropy merge's (rows, cols) set and clear deltas
        as one exact write (WAL, row store, device invalidation); returns
        (bits set, bits cleared)."""

        def positions(rows_cols):
            rows, cols = rows_cols
            if not len(rows):
                return None
            return np.asarray(rows, np.uint64) * np.uint64(SHARD_WIDTH) + np.asarray(cols, np.uint64)

        return self.import_positions(positions(sets), positions(clears))

    # -- serialization and live transfer -------------------------------------

    def _stream_locked(self) -> bytes:
        """The row store as one snapshot stream (under _mu, merged)."""
        buf = io.BytesIO()
        walmod.write_snapshot_stream(buf, self.shard, SHARD_WIDTH, self._rows)
        return buf.getvalue()

    def to_bytes(self) -> bytes:
        """The whole fragment in the snapshot format."""
        with self._mu:
            self._sync_locked()
            return self._stream_locked()

    def _arm_capture_locked(self, tag: str) -> None:
        self._captures[tag] = []
        self._capture_ns[tag] = 0
        self._captures_lost.discard(tag)

    def begin_streaming(self, tag: str = "default") -> bytes:
        """A transfer's first step: the snapshot stream, with the `tag`
        capture armed in the same lock hold, so the stream plus the
        drained records is exact at any later drain. Beginning a tag again
        replaces that tag's capture only."""
        with self._mu:
            self._sync_locked()
            blob = self._stream_locked()
            self._arm_capture_locked(tag)
            return blob

    def begin_capture_if_version(self, tag: str, version: int) -> bool:
        """Arm the `tag` capture without serializing, if the fragment is
        still at `version` (a snapshot taken at that version plus the
        capture is then exact). False when a write came between."""
        with self._mu:
            if self.version != version:
                return False
            self._sync_locked()
            if self.version != version:
                return False
            self._arm_capture_locked(tag)
            return True

    def drain_capture(self, tag: str = "default") -> bytes:
        """Pop the `tag` capture's records as one WAL-framed stream; the
        capture stays armed for the next round. TransferCaptureLost when
        there is none to drain."""
        with self._mu:
            records = self._captures.get(tag)
            if records is None:
                why = "write capture overflowed" if tag in self._captures_lost else "no active write capture"
                raise TransferCaptureLost(f"{self.index}/{self.field}/{self.view}/{self.shard}: {why}")
            self._captures[tag] = []
            self._capture_ns[tag] = 0
            return walmod.encode_records(records)

    def end_capture(self, tag: Optional[str] = None) -> None:
        """Stop the `tag` capture (None: every capture). The cutover
        barrier lifts with the last one."""
        with self._mu:
            if tag is None:
                self._captures.clear()
                self._capture_ns.clear()
                self._captures_lost.clear()
            else:
                self._captures.pop(tag, None)
                self._capture_ns.pop(tag, None)
                self._captures_lost.discard(tag)
            if not self._captures:
                self._write_block_until = 0.0

    def block_writes(self, ttl: float) -> None:
        """Arm the cutover barrier for `ttl` seconds: every write funnel
        raises TransferCutover until it lifts. Reads go on."""
        with self._mu:
            self._write_block_until = time.monotonic() + max(ttl, 0.0)

    def unblock_writes(self) -> None:
        with self._mu:
            self._write_block_until = 0.0

    def _check_write_block_locked(self) -> None:
        """At the top of every write funnel (under _mu)."""
        if not self._write_block_until:
            return
        if time.monotonic() >= self._write_block_until:
            self._write_block_until = 0.0  # a lost release heals itself
            return
        raise TransferCutover(f"{self.index}/{self.field}/{self.view}/{self.shard}: resize cutover in progress, retry")

    def _capture_record(self, op: int, positions: np.ndarray) -> None:
        """Append one write record to every armed capture (under _mu); a
        capture past CAPTURE_MAX_POSITIONS is dropped and marked lost."""
        for tag in list(self._captures):
            n = self._capture_ns[tag] + len(positions)
            if n > CAPTURE_MAX_POSITIONS:
                del self._captures[tag]
                del self._capture_ns[tag]
                self._captures_lost.add(tag)
            else:
                self._captures[tag].append((op, positions))
                self._capture_ns[tag] = n

    def apply_transfer_records(self, data: bytes) -> int:
        """Replay a drained capture through the ordinary write funnels
        (WAL, device and cache invalidation as any write). The stream is
        decoded whole first: a torn stream applies nothing. Returns the
        positions applied (the bits of a row-words record)."""
        records = list(walmod.decode_records(data))
        n = 0
        with walmod.GROUP_COMMIT.barrier():
            for op, positions in records:
                if op == walmod.OP_ROW_WORDS:
                    words = np.ascontiguousarray(positions[1:]).view(np.uint32)
                    self.import_row_words(int(positions[0]), words)
                    n += rowstore._popcount_words(words)
                elif op == walmod.OP_SET:
                    self.import_positions(positions, None)
                    n += len(positions)
                else:
                    self.import_positions(None, positions)
                    n += len(positions)
        if self._mutex_map is not None:
            with self._mu:  # the replay went past the mutex vector
                self._sync_locked()
                self._rebuild_mutex_map()
        return n

    def _read_stream(self, data: bytes) -> Dict[int, RowBits]:
        shard, n_bits, rows = walmod.read_snapshot_stream(io.BytesIO(data))
        if shard != self.shard:
            raise ValueError(f"fragment stream is for shard {shard}, not {self.shard}")
        if n_bits != SHARD_WIDTH:
            raise ValueError(f"fragment stream shard width {n_bits} != local {SHARD_WIDTH}")
        return rows

    def merge_from_bytes(self, data: bytes) -> int:
        """Union a snapshot stream into this fragment (a row-words write a
        row), keeping what it holds. Returns the bits newly set. Mutex
        fragments refuse it (ValueError)."""
        rows = self._read_stream(data)
        added = 0
        with walmod.GROUP_COMMIT.barrier():
            for row_id, rb in rows.items():
                words = np.asarray(rb.to_words(), dtype=np.uint32)
                if words.any():
                    added += self.import_row_words(row_id, words)
        return added

    def from_bytes(self, data: bytes) -> None:
        """Replace the fragment's contents with a snapshot stream. Staged
        and parked batches describe the replaced contents and are voided
        (the view's staged tally with them), armed captures turn lost,
        the fragment's device rows and the view's stacks over its shard
        drop, and a durable fragment snapshots at once."""
        rows = self._read_stream(data)
        with self._mu:
            self._note_staged(-(self._pending_n + self._premerged_n))
            self._pending = []
            self._pending_n = 0
            self._pending_gen += 1
            self._premerged = []
            self._premerged_n = 0
            if self._captures:
                self._captures_lost.update(self._captures)
                self._captures.clear()
                self._capture_ns.clear()
            store = _LazyRows(SHARD_WIDTH)
            store._mat = rows
            self._rows = store
            self.dcache.invalidate_owners((self._token, self._stack_token))
            self.version += 1
            if self.on_mutate is not None:
                self.on_mutate()
            self._rebuild_mutex_map()
            self.recalculate_cache()
            if self._wal is not None:
                self.snapshot()

    def row_count(self, row_id: int) -> int:
        with self._mu:
            self._sync_locked()
            return self._rows.count_of(row_id)

    def cache_top(self):
        with self._mu:
            self._sync_locked()
            return self.cache.top()

    def cache_top_arrays(self):
        """(row_ids uint64[], counts uint64[]) of the rank cache in rank
        order, memoized against the cache's own top() snapshot."""
        with self._mu:
            self._sync_locked()
            t = self.cache.top()
            memo = self._cache_top_arrays
            if memo is None or memo[0] is not t:
                n = len(t)
                rids = np.fromiter((p[0] for p in t), np.uint64, n)
                cnts = np.fromiter((p[1] for p in t), np.uint64, n)
                memo = self._cache_top_arrays = (t, rids, cnts)
            return memo[1], memo[2]

    def cache_counts_exact(self, row_ids: np.ndarray) -> Optional[np.ndarray]:
        """uint64 cardinalities for row_ids from the rank cache, or None
        unless the cache is complete (never pruned for capacity)."""
        with self._mu:
            self._sync_locked()
            cache = self.cache
            t = cache.top()
            if getattr(cache, "pruned", True):
                return None  # checked after top(): recalculate may prune
            memo = self._cache_id_arrays
            if memo is None or memo[0] is not t:
                rids, cnts = self.cache_top_arrays()
                o = np.argsort(rids)
                memo = self._cache_id_arrays = (t, rids[o], cnts[o])
            _, rs, cs = memo
            ids = np.asarray(row_ids, np.uint64)
            if not len(rs):
                return np.zeros(len(ids), np.uint64)
            pos = np.searchsorted(rs, ids)
            posc = np.minimum(pos, len(rs) - 1)
            found = (pos < len(rs)) & (rs[posc] == ids)
            return np.where(found, cs[posc], 0).astype(np.uint64)

    def row_counts_host(self, row_ids) -> np.ndarray:
        """Cardinalities of the listed rows as one uint64 vector."""
        with self._mu:
            self._sync_locked()
            count_of = self._rows.count_of
            return np.fromiter((count_of(r) for r in row_ids), np.uint64, len(row_ids))

    def row_counts(
        self, row_ids: List[int], filter_words=None, chunk: int = 256
    ) -> np.ndarray:
        """Cardinality of each listed row, optionally intersected with a
        filter row, counted on the device by the rows_counts kernel."""
        out = np.empty(len(row_ids), dtype=np.uint64)
        for i in range(0, len(row_ids), chunk):
            ids = row_ids[i : i + chunk]
            counts = kernels.rows_counts(self.rows_device(ids), filter_words)
            out[i : i + len(ids)] = counts.cpu().numpy()
        return out

    # ------------------------------------------------------------------
    # writes: everything funnels through _apply_positions / _sync_locked
    # ------------------------------------------------------------------

    def set_bit(self, row_id: int, col: int) -> bool:
        """Set one bit; col is in-shard or an absolute column of this
        shard. Returns True if it changed."""
        pos = self._pos(row_id, col)
        if self._mutex_map is not None:
            return self._set_bit_mutex(row_id, col % SHARD_WIDTH)
        changed, _ = self.import_positions(np.array([pos], np.uint64), None)
        return changed > 0

    def clear_bit(self, row_id: int, col: int) -> bool:
        pos = self._pos(row_id, col)
        _, cleared = self.import_positions(None, np.array([pos], np.uint64))
        return cleared > 0

    def _set_bit_mutex(self, row_id: int, in_shard: int) -> bool:
        # the barrier moves import_positions' commit wait past the lock
        with walmod.GROUP_COMMIT.barrier(), self._mu:
            existing = self._mutex_map.get(in_shard)
            if existing == row_id:
                return False
            to_clear = None
            if existing is not None:
                to_clear = np.array([existing * SHARD_WIDTH + in_shard], np.uint64)
            to_set = np.array([row_id * SHARD_WIDTH + in_shard], np.uint64)
            changed, _ = self.import_positions(to_set, to_clear)
            self._mutex_map[in_shard] = row_id
        return changed > 0

    def import_positions(
        self, to_set: Optional[np.ndarray], to_clear: Optional[np.ndarray]
    ) -> Tuple[int, int]:
        """Batched exact bit mutation by fragment position; merges the
        pending staged delta first so the (n_set, n_clear) counts are
        exact. The set and clear records land in the WAL as one write; the
        commit wait comes after the lock is released."""
        with self._mu:
            self._check_write_block_locked()
            self._sync_locked()
            records = [
                (op, p) for op, p in ((walmod.OP_SET, to_set), (walmod.OP_CLEAR, to_clear)) if p is not None and len(p)
            ]
            tok = self._log(records)
            n_set, n_clear = self._apply_positions(
                to_set if to_set is not None else np.empty(0, np.uint64),
                to_clear if to_clear is not None else np.empty(0, np.uint64),
            )
            tok = self._after_write(n_set + n_clear, tok)
        if tok is not None:
            walmod.GROUP_COMMIT.wait_durable(tok)
        return n_set, n_clear

    def stage_positions(self, positions: np.ndarray, *, notify: bool = True) -> int:
        """Bulk-ingest fast path: append SET positions to the pending
        buffer without merging; the merge is deferred to the next read
        barrier, the WAL record is not. notify=False leaves the
        device-cache invalidation and the on_mutate hook to the caller
        (View.stage_bulk batches them). Not for mutex fields."""
        positions = np.asarray(positions, dtype=np.uint64)
        n = len(positions)
        with self._mu:
            if self._mutex_map is not None:
                raise ValueError("stage_positions is not supported on mutex fields")
            if not n:
                return 0
            self._check_write_block_locked()
            tok = self._log([(walmod.OP_SET, positions)])
            if not self._pending:
                self._staged_base_version = self.version
            self._pending.append(positions)
            self._pending_n += n
            self._note_staged(n)
            self.version += 1
            if notify:
                self.dcache.invalidate_owners((self._token, self._stack_token))
                if self.on_mutate is not None:
                    self.on_mutate()
            tok = self._after_write(n, tok)
        if tok is not None:
            walmod.GROUP_COMMIT.wait_durable(tok)
        return n

    def _sync_locked(self) -> None:
        """Merge the pending staged delta and the parked barrier layers
        into the row store (under _mu), in one pass: both are position
        keys. Versions and device invalidation were handled at stage
        time."""
        if not self._pending_n and not self._premerged:
            return
        if self._pending:
            # parked layers were booked at their barrier
            merge_mod.note_host_sync(len(self._pending))
        parts = self._premerged + self._pending
        self._note_staged(-(self._pending_n + self._premerged_n))
        self._premerged = []
        self._premerged_n = 0
        self._pending = []
        self._pending_n = 0
        self._pending_gen += 1  # a barrier's capture of the parts is stale
        inc = parts[0] if len(parts) == 1 else np.concatenate(parts)
        touched: set = set()
        self._bulk_set_sparse(inc, touched)
        rows_store = self._rows
        self.cache.add_many(
            (rid, rb.count() if (rb := rows_store.get(rid)) is not None else 0)
            for rid in touched
        )

    def _note_staged(self, delta: int) -> None:
        if self.staged_tally is not None and delta:
            self.staged_tally.add(delta)

    def sync_pending_now(self) -> None:
        with self._mu:
            self._sync_locked()

    def pending_snapshot(self):
        """Barrier phase 1: (parts, n_parts, gen, base_version) of the
        current pending delta, or None when nothing is staged. `parts` is
        a copy of the list (the arrays are shared and never written);
        nothing is popped."""
        with self._mu:
            if not self._pending:
                return None
            return list(self._pending), len(self._pending), self._pending_gen, self._staged_base_version

    # parked layers past this many keys fold into the row store at the
    # barrier: a fragment nobody host-reads must not pile them up
    _LAYER_CAP = 1 << 20

    def apply_merged_delta(self, keys_local: np.ndarray, n_parts: int, captured_n: int, gen: int) -> Optional[int]:
        """Barrier phase 2: park `keys_local` (this fragment's slice of the
        merged burst, position keys) in place of the first `n_parts`
        pending batches. Returns the fragment's version, or None when
        `gen` is stale (a host read merged the captured parts first). The
        WAL still holds the staged frames: a crash replays them."""
        with self._mu:
            if gen != self._pending_gen:
                return None
            walmod.fault_point("merge.install", self.path or "")
            del self._pending[:n_parts]
            self._pending_n -= captured_n
            self._pending_gen += 1
            self._staged_base_version += n_parts
            self._premerged.append(keys_local)
            self._premerged_n += len(keys_local)
            self._note_staged(len(keys_local) - captured_n)
            if self._premerged_n > self._LAYER_CAP:
                self._sync_locked()
            return self.version

    def _apply_positions(self, to_set: np.ndarray, to_clear: np.ndarray) -> Tuple[int, int]:
        """The exact mutation funnel (under _mu): row store, mutex vector,
        rank cache and device invalidation."""
        n_set = n_clear = 0
        touched: set = set()
        if len(to_set):
            if self._mutex_map is None:
                n_set += self._bulk_set_sparse(to_set, touched)
            else:
                rows = (to_set // SHARD_WIDTH).astype(np.int64)
                cols = (to_set % SHARD_WIDTH).astype(np.uint32)
                for row_id, sl in group_slices(rows):
                    row_id = int(row_id)
                    rb = self._rows.get(row_id)
                    if rb is None:
                        rb = self._rows[row_id] = RowBits(SHARD_WIDTH)
                    row_cols = cols[sl]
                    n_set += rb.add(row_cols)
                    touched.add(row_id)
                    self._mutex_map.update(zip(row_cols.tolist(), repeat(row_id)))
        if len(to_clear):
            n_clear += self._bulk_clear_sparse(to_clear, touched)
            if self._mutex_map is not None:
                mm = self._mutex_map
                rows = (to_clear // SHARD_WIDTH).astype(np.int64)
                cols = (to_clear % SHARD_WIDTH).astype(np.uint32)
                for row_id, sl in group_slices(rows):
                    row_id = int(row_id)
                    for c in cols[sl].tolist():
                        if mm.get(c) == row_id:
                            del mm[c]
        if touched:
            rows_store = self._rows
            self.cache.add_many(
                (rid, rb.count() if (rb := rows_store.get(rid)) is not None else 0)
                for rid in touched
            )
            self.dcache.invalidate_many((self._token, rid) for rid in touched)
            self.dcache.invalidate_owner(self._stack_token)
            self.version += 1
            if self.on_mutate is not None:
                self.on_mutate()
        return n_set, n_clear

    def _bulk_set_sparse(self, to_set: np.ndarray, touched: set) -> int:
        """Set keyed positions (row*SHARD_WIDTH + col): dense-rep rows OR
        in place; all sparse-rep rows merge in ONE pass over the re-keyed
        concatenation (a dedupe when it is in order, else np.unique, or a
        column mask per row for a large batch over few rows)."""
        rows_arr = to_set // SHARD_WIDTH
        uniq_rows = _unique(rows_arr).astype(np.uint64)
        dense_rows = [
            int(r)
            for r in uniq_rows
            if (rb := self._rows.get(int(r))) is not None and rb.dense is not None
        ]
        n = 0
        if dense_rows:
            m = np.isin(rows_arr, np.array(dense_rows, np.uint64))
            cols = (to_set[m] % SHARD_WIDTH).astype(np.uint32)
            for row_id, sl in group_slices(rows_arr[m].astype(np.int64)):
                n += self._rows[int(row_id)].add(cols[sl])
                touched.add(int(row_id))
            if len(dense_rows) == len(uniq_rows):
                return n
            incoming = to_set[~m]
        else:
            incoming = to_set
        dense_set = set(dense_rows)
        sparse_rows = [int(r) for r in uniq_rows if int(r) not in dense_set]
        parts = [incoming.astype(np.uint64)]
        before = 0
        for rid in sparse_rows:
            rb = self._rows.get(rid)
            if rb is not None and len(rb.positions):
                before += len(rb.positions)
                parts.append(
                    rb.positions.astype(np.uint64) + np.uint64(rid) * np.uint64(SHARD_WIDTH)
                )
        cat = np.concatenate(parts) if len(parts) > 1 else parts[0]
        if not _ordered(cat) and len(incoming) >= len(sparse_rows) * _MASK_MERGE_MIN:
            return n + self._merge_by_mask(incoming, sparse_rows, touched)
        merged = _unique(cat)
        # each row takes a COPY of its slice: a view would pin the buffer
        all_pos = (merged % np.uint64(SHARD_WIDTH)).astype(np.uint32)
        edges = np.searchsorted(
            merged,
            np.array(
                [r * SHARD_WIDTH for r in sparse_rows] + [(sparse_rows[-1] + 1) * SHARD_WIDTH],
                np.uint64,
            ),
        )
        for i, rid in enumerate(sparse_rows):
            rb = self._rows.get(rid)
            if rb is None:
                rb = self._rows[rid] = RowBits(SHARD_WIDTH)
            rb.positions = all_pos[edges[i] : edges[i + 1]].copy()
            rb._maybe_densify()
            touched.add(rid)
        return n + len(merged) - before

    def _merge_by_mask(self, incoming: np.ndarray, sparse_rows: List[int], touched: set) -> int:
        """The sparse-row merge of a large unordered batch over few rows
        (staged column imports): one column mask per row, linear in the
        shard width, instead of a sort of the whole batch."""
        cols = incoming & np.uint64(SHARD_WIDTH - 1)
        rows = incoming // SHARD_WIDTH if len(sparse_rows) > 1 else None
        added = 0
        for rid in sparse_rows:
            rb = self._rows.get(rid)
            if rb is None:
                rb = self._rows[rid] = RowBits(SHARD_WIDTH)
            mask = np.zeros(SHARD_WIDTH, bool)
            mask[cols if rows is None else cols[rows == rid]] = True
            mask[rb.positions] = True
            before = rb.count()
            rb.assign_mask(mask)
            added += rb.count() - before
            touched.add(rid)
        return added

    def _bulk_clear_sparse(self, to_clear: np.ndarray, touched: set) -> int:
        """Clear keyed positions: dense-rep rows per row; sparse-rep rows
        with one merged membership test. Returns bits actually cleared."""
        rows_arr = to_clear // SHARD_WIDTH
        uniq_rows = np.unique(rows_arr).astype(np.uint64)
        dense_rows: List[int] = []
        sparse_rows: List[int] = []
        for r in uniq_rows:
            rb = self._rows.get(int(r))
            if rb is None:
                continue
            (dense_rows if rb.dense is not None else sparse_rows).append(int(r))
        n = 0
        if dense_rows:
            m = np.isin(rows_arr, np.array(dense_rows, np.uint64))
            cols = (to_clear[m] % SHARD_WIDTH).astype(np.uint32)
            for row_id, sl in group_slices(rows_arr[m].astype(np.int64)):
                n += self._rows[int(row_id)].discard(cols[sl])
                touched.add(int(row_id))
        if not sparse_rows:
            return n
        inc_mask = np.isin(rows_arr, np.array(sparse_rows, np.uint64))
        inc = np.unique(to_clear[inc_mask].astype(np.uint64))
        parts = []
        for rid in sparse_rows:
            p = self._rows[rid].positions
            if len(p):
                parts.append(p.astype(np.uint64) + np.uint64(rid) * np.uint64(SHARD_WIDTH))
        if not parts:
            return n
        stored = np.concatenate(parts)
        idx = np.searchsorted(inc, stored)
        idxc = np.minimum(idx, len(inc) - 1)
        hit = (idx < len(inc)) & (inc[idxc] == stored)
        kept = stored[~hit]
        n += len(stored) - len(kept)
        all_pos = (kept % np.uint64(SHARD_WIDTH)).astype(np.uint32)
        edges = np.searchsorted(
            kept,
            np.array(
                [r * SHARD_WIDTH for r in sparse_rows] + [(sparse_rows[-1] + 1) * SHARD_WIDTH],
                np.uint64,
            ),
        )
        for i, rid in enumerate(sparse_rows):
            rb = self._rows[rid]
            sl = all_pos[edges[i] : edges[i + 1]]
            if len(sl) != rb.count():
                rb.positions = sl.copy()
            touched.add(rid)
        return n

    def import_row_words(self, row_id: int, words: np.ndarray) -> int:
        """Word-level bulk union of dense uint32[W] words into one row
        (one OP_ROW_WORDS record). Returns how many bits were newly set."""
        words = np.ascontiguousarray(words, dtype=np.uint32)
        if words.shape != (WORDS_PER_ROW,):
            raise ValueError(
                f"import_row_words: want shape ({WORDS_PER_ROW},), got {words.shape}"
            )
        with self._mu:
            if self._mutex_map is not None:
                raise ValueError("word-level import is not supported on mutex fields")
            self._check_write_block_locked()
            self._sync_locked()
            tok = None
            if self._wal is not None or self._captures:
                payload = np.empty(1 + words.nbytes // 8, np.uint64)
                payload[0] = row_id
                payload[1:] = words.view(np.uint64)
                tok = self._log([(walmod.OP_ROW_WORDS, payload)])
            added = self._apply_row_words(row_id, words)
            tok = self._after_write(added, tok)
        if tok is not None:
            walmod.GROUP_COMMIT.wait_durable(tok)
        return added

    def _apply_row_words(self, row_id: int, words: np.ndarray) -> int:
        rb = self._rows.get(row_id)
        if rb is None:
            rb = self._rows[row_id] = RowBits(SHARD_WIDTH)
        added = rb.union_words(words)
        if added:
            self.cache.add(row_id, rb.count())
            self.dcache.invalidate((self._token, row_id))
            self.dcache.invalidate_owner(self._stack_token)
            self.version += 1
            if self.on_mutate is not None:
                self.on_mutate()
        return added

    def _pos(self, row_id: int, col: int) -> int:
        if col >= SHARD_WIDTH:
            min_col = self.shard * SHARD_WIDTH
            if not min_col <= col < min_col + SHARD_WIDTH:
                raise ValueError(f"column {col} out of bounds for shard {self.shard}")
        return row_id * SHARD_WIDTH + (col % SHARD_WIDTH)

    def bulk_import(self, row_ids: np.ndarray, cols: np.ndarray, clear: bool = False) -> int:
        """Batched exact import; cols may be absolute or in-shard."""
        row_ids = np.asarray(row_ids, dtype=np.uint64)
        cols = np.asarray(cols, dtype=np.uint64) % SHARD_WIDTH
        positions = row_ids * SHARD_WIDTH + cols
        if self._mutex_map is not None and not clear:
            return self._bulk_import_mutex(row_ids, cols)
        if clear:
            return self.import_positions(None, positions)[1]
        return self.import_positions(positions, None)[0]

    def _bulk_import_mutex(self, row_ids: np.ndarray, cols: np.ndarray) -> int:
        """Mutex import: the last write per column wins. The barrier moves
        the commit wait past the lock."""
        with walmod.GROUP_COMMIT.barrier(), self._mu:
            _, last_idx = np.unique(cols[::-1], return_index=True)
            idx = len(cols) - 1 - last_idx
            to_set, to_clear, updates = [], [], {}
            for i in idx:
                col, row = int(cols[i]), int(row_ids[i])
                existing = self._mutex_map.get(col)
                if existing == row:
                    continue
                if existing is not None:
                    to_clear.append(existing * SHARD_WIDTH + col)
                to_set.append(row * SHARD_WIDTH + col)
                updates[col] = row
            n, _ = self.import_positions(
                np.array(to_set, np.uint64) if to_set else None,
                np.array(to_clear, np.uint64) if to_clear else None,
            )
            self._mutex_map.update(updates)
            return n

    # ------------------------------------------------------------------
    # BSI (int fields)
    # ------------------------------------------------------------------

    def contains(self, row_id: int, in_shard: int) -> bool:
        with self._mu:
            self._sync_locked()
            rb = self._rows.peek(row_id)
            return rb is not None and rb.contains(in_shard)

    def set_value(self, col: int, bit_depth: int, value: int, clear: bool = False) -> bool:
        """Sign + magnitude write of one column (clear=True removes it).
        Returns True if any bit changed."""
        in_shard = col % SHARD_WIDTH
        uvalue = abs(value)
        to_set: List[int] = []
        to_clear: List[int] = []
        (to_clear if clear else to_set).append(BSI_EXISTS_BIT * SHARD_WIDTH + in_shard)
        (to_clear if (value >= 0 or clear) else to_set).append(
            BSI_SIGN_BIT * SHARD_WIDTH + in_shard
        )
        for i in range(bit_depth):
            p = (BSI_OFFSET_BIT + i) * SHARD_WIDTH + in_shard
            (to_set if (uvalue >> i) & 1 and not clear else to_clear).append(p)
        n_set, n_clear = self.import_positions(
            np.array(to_set, np.uint64), np.array(to_clear, np.uint64)
        )
        return (n_set + n_clear) > 0

    def import_values(self, cols: np.ndarray, values: np.ndarray, bit_depth: int) -> None:
        """Columnar write; the last write per column wins. Each plane row
        takes its new bits in one word-level pass over the written
        columns (row = (row & ~written) | bits), never as positions. The
        WAL gets the reference's records for the same write (set and
        clear positions of every plane), so either package replays it."""
        cols = np.asarray(cols, dtype=np.uint64) % SHARD_WIDTH
        values = np.asarray(values, dtype=np.int64)
        if not len(cols):
            return
        _, last_idx = np.unique(cols[::-1], return_index=True)
        idx = len(cols) - 1 - last_idx
        cols, values = cols[idx], values[idx]
        icols = cols.astype(np.int64)
        mags = np.abs(values).astype(np.uint64)
        neg = values < 0

        def words_of(sel: np.ndarray) -> np.ndarray:
            bits = np.zeros(SHARD_WIDTH, bool)
            bits[sel] = True
            return np.packbits(bits, bitorder="little").view(np.uint32)

        written = words_of(icols)
        new_rows = {BSI_EXISTS_BIT: written, BSI_SIGN_BIT: words_of(icols[neg])}
        has = []
        for i in range(bit_depth):
            has.append((mags >> np.uint64(i)) & np.uint64(1) != 0)
            new_rows[BSI_OFFSET_BIT + i] = words_of(icols[has[i]])
        with self._mu:
            self._check_write_block_locked()
            self._sync_locked()
            tok = None
            if self._wal is not None or self._captures:
                sw = np.uint64(SHARD_WIDTH)
                to_set = [np.uint64(BSI_EXISTS_BIT) * sw + cols, np.uint64(BSI_SIGN_BIT) * sw + cols[neg]]
                to_clear = [np.uint64(BSI_SIGN_BIT) * sw + cols[~neg]]
                for i, h in enumerate(has):
                    base = np.uint64(BSI_OFFSET_BIT + i) * sw
                    to_set.append(base + cols[h])
                    to_clear.append(base + cols[~h])
                tok = self._log([(walmod.OP_SET, np.concatenate(to_set)), (walmod.OP_CLEAR, np.concatenate(to_clear))])
            touched = []
            n_changed = 0
            for row_id, words in new_rows.items():
                rb = self._rows.get(row_id)
                if rb is None:
                    if not words.any():
                        continue  # clearing a row that does not exist
                    rb = self._rows[row_id] = RowBits(SHARD_WIDTH)
                n_changed += rb.assign_words(written, words)
                touched.append(row_id)
            rows_store = self._rows
            self.cache.add_many((rid, rows_store[rid].count()) for rid in touched)
            self.dcache.invalidate_many((self._token, rid) for rid in touched)
            self.dcache.invalidate_owner(self._stack_token)
            self.version += 1
            if self.on_mutate is not None:
                self.on_mutate()
            tok = self._after_write(n_changed, tok)
        if tok is not None:
            walmod.GROUP_COMMIT.wait_durable(tok)

    def value(self, col: int, bit_depth: int) -> Tuple[int, bool]:
        """(stored value, exists) of one column (a host point read)."""
        with self._mu:
            in_shard = col % SHARD_WIDTH
            if not self.contains(BSI_EXISTS_BIT, in_shard):
                return 0, False
            v = 0
            for i in range(bit_depth):
                if self.contains(BSI_OFFSET_BIT + i, in_shard):
                    v |= 1 << i
            if self.contains(BSI_SIGN_BIT, in_shard):
                v = -v
            return v, True

    def sum(self, filter_words, bit_depth: int):
        raise NotImplementedError(_BSI_STACKED)

    def min(self, filter_words, bit_depth: int):
        raise NotImplementedError(_BSI_STACKED)

    def max(self, filter_words, bit_depth: int):
        raise NotImplementedError(_BSI_STACKED)

    def range_op(self, op: str, bit_depth: int, predicate: int):
        raise NotImplementedError(_BSI_STACKED)

    def range_between(self, bit_depth: int, pmin: int, pmax: int):
        raise NotImplementedError(_BSI_STACKED)

    def not_null(self):
        raise NotImplementedError(_BSI_STACKED)
