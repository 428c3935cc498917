"""Fragment persistence: snapshot files and an append-only op log (WAL).

The port's copy of pilosa_tpu/core/wal.py, byte for byte the same on-disk
format, so a data directory written by either package opens in the other.

Snapshot file (.snap):
    magic  b"PTSNAP01"
    u64 shard, u64 n_bits, u64 n_rows
    n_rows * ( u64 row_id, u8 rep, u64 n_items, payload uint32[n_items] )

WAL file (.wal), per record:
    u32 magic 0x5054574C ("PTWL"), u8 op, u32 n,
    u32 crc32(payload), payload = uint64[n]
    op 0 = set positions, 1 = clear positions, 2 = one row's words
    (payload[0] = row id, payload[1:] = the row's uint32 words as uint64).

A torn tail (a record cut short by a crash, or failing its CRC) ends
replay there. Durability is a group commit (`WalGroupCommit`): an append
is a buffered write and flush under the writer's fd pin; the caller then
waits, outside any fragment lock, for a commit round whose leader fsyncs
every dirty WAL at once, so concurrent writers share fsyncs.
`sync_interval` > 0 acknowledges on the buffered write and fsyncs on that
cadence in the background: a crash of the machine may lose the last
interval's acknowledged writes, a killed process loses none (its bytes
are in the page cache).
"""

from __future__ import annotations

import errno
import os
import struct
import threading
import zlib
from collections import OrderedDict
from contextlib import contextmanager, nullcontext
from typing import IO, Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from pilosa_tpu_torch.core.rowstore import RowBits

SNAP_MAGIC = b"PTSNAP01"
WAL_MAGIC = 0x5054574C
OP_SET = 0
OP_CLEAR = 1
OP_ROW_WORDS = 2

_REC_HDR = struct.Struct("<IBII")

# ---------------------------------------------------------------------------
# fault injection: crash tests install a hook that may raise (a simulated
# I/O error), sleep, or kill the process at a named point. Points:
# "wal.write" (before the framed bytes land), "wal.rollback" (before a
# failed append truncates back), "wal.fsync" (per file, inside a commit
# round), "wal.truncate" (before the post-truncate fsync),
# "wal.commit.pre_fsync" / "wal.commit.post_fsync" (around a round), and
# "snapshot.pre_truncate" (a fragment's snapshot is durable, its WAL not
# yet reset).
# ---------------------------------------------------------------------------

_fault_hook: Optional[Callable[[str, str], None]] = None


class ShortWriteFault(Exception):
    """Raised by a fault hook at "wal.write" to ask for a torn append: the
    writer lands a prefix of the framed bytes, then fails with EIO."""


def set_fault_hook(fn: Optional[Callable[[str, str], None]]) -> None:
    global _fault_hook
    _fault_hook = fn


def fault_point(point: str, path: str = "") -> None:
    hook = _fault_hook
    if hook is not None:
        hook(point, path)


def fsync_dir(path: str) -> None:
    """fsync a directory so a new or renamed entry in it survives a crash
    (fsyncing the file does not persist its directory entry)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_durable(path: str, text: str) -> None:
    """Replace a small metadata file so that a crash leaves the old or the
    new content, and the new one once this returns: write a temp file,
    fsync it, rename it over `path`, fsync the directory."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def remove_durable(path: str) -> None:
    """Remove a file and fsync its directory, so the removal survives a
    crash."""
    os.remove(path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def next_writer_token() -> int:
    """A group-commit token for a log that is not a fragment's WAL (the key
    translation log), from the writers' own sequence."""
    with WalWriter._lru_mu:
        WalWriter._next_tok += 1
        return WalWriter._next_tok


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------


def write_snapshot_stream(f: IO[bytes], shard: int, n_bits: int, rows: Any) -> None:
    """Write the snapshot record stream. `rows` maps row_id -> RowBits; a
    mapping with `rep_payload(row_id)` (the lazy row store) is written
    without materializing its rows."""
    f.write(SNAP_MAGIC)
    f.write(struct.pack("<QQQ", shard, n_bits, len(rows)))
    rep_payload = getattr(rows, "rep_payload", None)
    bulk = getattr(rows, "bulk", None)
    with bulk() if bulk is not None else nullcontext():
        for row_id in sorted(rows):
            if rep_payload is not None:
                rep, payload = rep_payload(row_id)
            else:
                rb = rows[row_id]
                rep, payload = rb.rep(), rb.payload()
            f.write(struct.pack("<QBQ", row_id, rep, len(payload)))
            f.write(payload.astype(np.uint32, copy=False).tobytes())


def _read_exact(f: IO[bytes], n: int) -> bytes:
    """Exactly n bytes, or ValueError: a short stream never parses short."""
    data = f.read(n)
    if len(data) != n:
        raise ValueError(f"truncated snapshot stream: wanted {n} bytes, got {len(data)}")
    return data


def read_snapshot_stream(f: IO[bytes]) -> Tuple[int, int, Dict[int, RowBits]]:
    """Inverse of write_snapshot_stream: (shard, n_bits, rows)."""
    magic = _read_exact(f, 8)
    if magic != SNAP_MAGIC:
        raise ValueError(f"bad snapshot magic {magic!r}")
    shard, n_bits, n_rows = struct.unpack("<QQQ", _read_exact(f, 24))
    rows: Dict[int, RowBits] = {}
    for _ in range(n_rows):
        row_id, rep, n_items = struct.unpack("<QBQ", _read_exact(f, 17))
        payload = np.frombuffer(_read_exact(f, n_items * 4), dtype=np.uint32)
        rows[row_id] = RowBits.from_payload(n_bits, rep, payload)
    return shard, n_bits, rows


def write_snapshot(path: str, shard: int, n_bits: int, rows: Any) -> None:
    """Write a full snapshot atomically: temp file, fsync, rename, then an
    fsync of the directory (a WAL truncated against a snapshot whose
    rename was lost would lose data)."""
    tmp = path + ".snapshotting"
    with open(tmp, "wb") as f:
        write_snapshot_stream(f, shard, n_bits, rows)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def read_snapshot(path: str) -> Tuple[int, int, Dict[int, RowBits]]:
    with open(path, "rb") as f:
        return read_snapshot_stream(f)


def read_snapshot_index(path: str) -> Tuple[int, int, Dict[int, Tuple[int, int, int]]]:
    """Header-only scan: (shard, n_bits, index) with index[row_id] = (rep,
    payload byte offset, n_items). Payloads are seeked over, so opening a
    fragment costs O(rows), not O(bits)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        magic = _read_exact(f, 8)
        if magic != SNAP_MAGIC:
            raise ValueError(f"bad snapshot magic {magic!r}")
        shard, n_bits, n_rows = struct.unpack("<QQQ", _read_exact(f, 24))
        index: Dict[int, Tuple[int, int, int]] = {}
        pos = 32
        for _ in range(n_rows):
            f.seek(pos)
            row_id, rep, n_items = struct.unpack("<QBQ", _read_exact(f, 17))
            payload_off = pos + 17
            if payload_off + n_items * 4 > size:
                raise ValueError("truncated snapshot: payload overruns file")
            index[row_id] = (rep, payload_off, n_items)
            pos = payload_off + n_items * 4
    return shard, n_bits, index


# ---------------------------------------------------------------------------
# the op log
# ---------------------------------------------------------------------------

# Open WAL handles are capped: a holder of thousands of fragments must not
# hold thousands of fds. Writers above the cap close their fd, least
# recently used first, and reopen it in append mode on next use.
_MAX_OPEN_WALS = 256


class WalWriter:
    """Append-only op log of one fragment. The fragment's lock serializes
    its appends; fds are pooled under _MAX_OPEN_WALS."""

    _lru: "OrderedDict[int, WalWriter]" = OrderedDict()
    _lru_mu = threading.Lock()
    _next_tok = 0

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self._pinned = 0  # under _lru_mu; eviction skips pinned fds
        self._closed = False
        self._poisoned = False  # a torn write could not be rolled back
        with WalWriter._lru_mu:
            WalWriter._next_tok += 1
            self._tok = WalWriter._next_tok
        with self._pin():  # fail at construction if the path is bad
            pass

    @contextmanager
    def _pin(self) -> Iterator[IO[bytes]]:
        """Open (or touch) this writer's fd and keep it from LRU eviction
        while pinned. Victims' fds close outside the lock."""
        to_close = []
        sync_dir = None
        with WalWriter._lru_mu:
            if self._closed:
                # a closed writer must not recreate its file (a late write
                # after the fragment was closed or deleted)
                raise ValueError(f"WalWriter for {self.path} is closed")
            if self._f is None:
                created = not os.path.exists(self.path)
                self._f = open(self.path, "ab")
                if created:
                    sync_dir = os.path.dirname(os.path.abspath(self.path))
            WalWriter._lru[self._tok] = self
            WalWriter._lru.move_to_end(self._tok)
            self._pinned += 1
            excess = len(WalWriter._lru) - _MAX_OPEN_WALS
            if excess > 0:
                for tok in list(WalWriter._lru):
                    if excess <= 0:
                        break
                    victim = WalWriter._lru[tok]
                    if victim._pinned:
                        continue
                    del WalWriter._lru[tok]
                    if victim._f is not None:
                        to_close.append(victim._f)
                        victim._f = None
                    excess -= 1
            f = self._f
        if sync_dir is not None:
            fsync_dir(sync_dir)  # a new log's directory entry must survive
        for fh in to_close:
            fh.close()
        try:
            yield f
        finally:
            with WalWriter._lru_mu:
                self._pinned -= 1

    def _write_framed(self, data: bytes) -> Optional[int]:
        """Buffered write and flush of framed records, then mark this
        writer dirty. Returns the commit token the caller passes to
        `GROUP_COMMIT.wait_durable` once it holds no fragment lock.

        A failed or torn write is rolled back (truncated to the offset
        before it), so no later append can land beyond an unreplayable
        tear; if the rollback fails too, the writer is poisoned and every
        later append raises."""
        if self._poisoned:
            raise ValueError(
                f"WAL {self.path} is poisoned: a torn write could not be "
                "rolled back, so further appends would be unreplayable"
            )
        with self._pin() as f:
            end0 = f.seek(0, os.SEEK_END)
            try:
                try:
                    fault_point("wal.write", self.path)
                except ShortWriteFault:
                    f.write(data[: max(1, len(data) // 2)])
                    f.flush()
                    raise OSError(errno.EIO, "[injected] short write", self.path) from None
                f.write(data)
                f.flush()
            except Exception:
                try:
                    fault_point("wal.rollback", self.path)
                    f.truncate(end0)
                    f.seek(end0)
                except Exception:  # noqa: BLE001 - poison, re-raise the original
                    self._poisoned = True
                raise
        return GROUP_COMMIT.mark_dirty(self)

    def append(self, op: int, positions: np.ndarray) -> Optional[int]:
        """Frame one record; an empty one is skipped (None)."""
        return self.append_many([(op, positions)])

    def append_many(self, records: Iterable[Tuple[int, np.ndarray]]) -> Optional[int]:
        """Frame a batch of (op, positions) records and land them with one
        write and flush. Each keeps its own CRC, so a tear between them
        replays the records before it."""
        data = encode_records(records)
        if not data:
            return None
        return self._write_framed(data)

    def _fsync(self) -> None:
        """fsync this file for a commit round (reopening after an LRU
        eviction); a closed writer is a no-op, since close() synced it."""
        try:
            with self._pin() as f:
                fault_point("wal.fsync", self.path)
                os.fsync(f.fileno())
        except ValueError:
            return

    def truncate(self) -> None:
        """Reset after a snapshot absorbed every op, fsynced here: the
        caller trusts the snapshot as the only copy from now on."""
        with self._pin() as f:
            f.truncate(0)
            f.seek(0)
            fault_point("wal.truncate", self.path)
            os.fsync(f.fileno())
        GROUP_COMMIT.forget(self)

    def close(self) -> None:
        GROUP_COMMIT.forget(self)
        with WalWriter._lru_mu:
            self._closed = True
            WalWriter._lru.pop(self._tok, None)
            f, self._f = self._f, None
        # fsync unconditionally: a round in flight may have claimed this
        # writer's dirty mark and will skip it now that it is closed
        if f is not None:
            try:
                f.flush()
                os.fsync(f.fileno())
            except OSError:
                pass  # best effort; open() replays and re-checks
            f.close()
        elif os.path.exists(self.path):
            try:
                with open(self.path, "ab") as f2:
                    os.fsync(f2.fileno())
            except OSError:
                pass


# ---------------------------------------------------------------------------
# group commit
# ---------------------------------------------------------------------------


class WalSyncError(OSError):
    """A commit round's fsync failed: every caller whose append rode that
    round gets this; none is acknowledged on a partial sync."""


# cumulative counters (tests and chip_smoke.py read deltas); under
# GROUP_COMMIT's lock
STATS = {"commits": 0, "commit_groups": 0, "fsyncs": 0, "sync_failures": 0}


class WalGroupCommit:
    """Leader/follower group commit over every open WAL writer. Appenders
    mark their writer dirty and get a token; `wait_durable(token)`, called
    outside any fragment lock, joins the round in flight or leads one that
    fsyncs every dirty file and releases the whole group.

    `sync_interval` 0 (strict): a caller returns once its bytes are
    fsynced. > 0: callers return after the buffered write and a background
    syncer fsyncs on that cadence. `barrier()` folds a bulk call's many
    per-fragment waits into one round at its exit."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._dirty: "OrderedDict[int, WalWriter]" = OrderedDict()
        self._seq = 0  # tokens handed out
        self._done = 0  # highest token a round resolved
        self._leading = False  # one round in flight at most
        # tokens in (_fail_lo, _fail_seq] rode a failed round and raise
        self._fail_lo = 0
        self._fail_seq = 0
        self._fail_exc: Optional[BaseException] = None
        self._sync_interval = 0.0
        self._syncer: Optional[threading.Thread] = None
        self._syncer_wake = threading.Event()
        self._defer = threading.local()

    def configure(self, sync_interval: Optional[float] = None) -> None:
        """Set the cadence. Going from interval to strict flushes what is
        buffered first, so the strict contract holds from this call on."""
        if sync_interval is None:
            return
        with self._mu:
            old = self._sync_interval
            self._sync_interval = max(0.0, float(sync_interval))
            new = self._sync_interval
        if new > 0:
            self._ensure_syncer()
            self._syncer_wake.set()
        elif old > 0:
            self._syncer_wake.set()  # the syncer sees 0 and exits
            self.flush()

    def sync_interval(self) -> float:
        with self._mu:
            return self._sync_interval

    def mark_dirty(self, writer: WalWriter) -> int:
        with self._mu:
            self._dirty[writer._tok] = writer
            self._dirty.move_to_end(writer._tok)
            self._seq += 1
            STATS["commits"] += 1
            token = self._seq
            interval = self._sync_interval
        if interval > 0:
            self._ensure_syncer()
        return token

    def forget(self, writer: WalWriter) -> bool:
        """Drop a writer's dirty mark (truncate fsynced it, or close is
        about to). Returns whether it was dirty."""
        with self._mu:
            return self._dirty.pop(writer._tok, None) is not None

    def wait_durable(self, token: Optional[int] = None) -> None:
        """Block until `token` (None: everything appended so far) is
        durable, or return at once in interval mode. Inside a `barrier()`
        the wait moves to the barrier's exit."""
        if getattr(self._defer, "depth", 0):
            if token is None:
                with self._mu:
                    token = self._seq
            self._defer.token = max(getattr(self._defer, "token", 0), token)
            return
        with self._mu:
            if token is None:
                token = self._seq
            if token <= 0:
                return
            if self._sync_interval > 0:
                # acknowledged on the buffered write, unless the cadence is
                # failing: the loss window would then be unbounded
                if self._fail_exc is not None:
                    raise WalSyncError(
                        "WAL background sync is failing; refusing to ack "
                        f"writes on a broken cadence: {self._fail_exc}"
                    ) from self._fail_exc
                return
        self._wait_strict(token)

    @contextmanager
    def barrier(self) -> Iterator[None]:
        """Fold every wait_durable on this thread into one commit at exit
        (a bulk import over N fragments pays one round). Nested barriers
        fold into the outermost."""
        d = getattr(self._defer, "depth", 0)
        self._defer.depth = d + 1
        try:
            yield
        finally:
            self._defer.depth = d
            if d == 0:
                token = getattr(self._defer, "token", 0)
                self._defer.token = 0
                if token:
                    self.wait_durable(token)

    def flush(self) -> None:
        """One round over everything outstanding, whatever the cadence
        (shutdown, tests, the switch to strict)."""
        with self._mu:
            while self._leading:
                self._cv.wait()
            if not self._dirty:
                return
            self._leading = True
        self._lead_round()
        with self._mu:
            self._check_failed_locked(self._done)

    def _wait_strict(self, token: int) -> None:
        with self._mu:
            while True:
                if self._done >= token:
                    self._check_failed_locked(token)
                    return
                if not self._leading:
                    self._leading = True
                    break
                self._cv.wait()
        self._lead_round()
        with self._mu:
            self._check_failed_locked(token)

    def _check_failed_locked(self, token: int) -> None:
        # only tokens of the failed rounds raise; one an earlier round
        # made durable never fails retroactively
        if self._fail_exc is not None and self._fail_lo < token <= self._fail_seq:
            raise WalSyncError(f"WAL group commit failed: {self._fail_exc}") from self._fail_exc

    def _lead_round(self) -> None:
        try:
            self._sync_round()
        finally:
            with self._mu:
                self._leading = False
                self._cv.notify_all()

    def _sync_round(self) -> None:
        with self._mu:
            batch = list(self._dirty.values())
            self._dirty.clear()
            top = self._seq
            prev_done = self._done
        fault_point("wal.commit.pre_fsync")
        err: Optional[BaseException] = None
        n_synced = 0
        for w in batch:
            try:
                w._fsync()
                n_synced += 1
            except Exception as e:  # noqa: BLE001 - fails the whole group
                err = e
        fault_point("wal.commit.post_fsync")
        with self._mu:
            self._done = top
            if err is None:
                # a successful round re-synced what a failed one left dirty
                self._fail_exc = None
                self._fail_lo = 0
                self._fail_seq = 0
            else:
                # every waiter of this round raises; unsynced writers stay
                # dirty for the next round, and back-to-back failures widen
                # the failing range
                self._fail_lo = min(self._fail_lo, prev_done) if self._fail_exc is not None else prev_done
                self._fail_seq = top
                self._fail_exc = err
                STATS["sync_failures"] += 1
                for w in batch:
                    if not w._closed:
                        self._dirty.setdefault(w._tok, w)
            if batch:
                STATS["commit_groups"] += 1
                STATS["fsyncs"] += n_synced

    def _ensure_syncer(self) -> None:
        with self._mu:
            if self._syncer is not None and self._syncer.is_alive():
                return
            t = threading.Thread(target=self._syncer_loop, name="wal-sync", daemon=True)
            self._syncer = t
            # started under the lock, so no second caller starts another
            t.start()

    def _syncer_loop(self) -> None:
        while True:
            with self._mu:
                interval = self._sync_interval
            if interval <= 0:
                return
            self._syncer_wake.wait(interval)
            self._syncer_wake.clear()
            with self._mu:
                if self._sync_interval <= 0:
                    return
                if self._leading or not self._dirty:
                    continue
                self._leading = True
            try:
                self._lead_round()
            except Exception:  # noqa: BLE001 - keep the cadence; waiters see the failure
                pass


GROUP_COMMIT = WalGroupCommit()


def stats_snapshot() -> Dict[str, int]:
    with GROUP_COMMIT._mu:
        return dict(STATS)


# ---------------------------------------------------------------------------
# the record codec, replay and check
# ---------------------------------------------------------------------------


def encode_records(records: Iterable[Tuple[int, np.ndarray]]) -> bytes:
    """Frame (op, positions) records into one byte string; empty records
    are skipped (nothing to replay)."""
    bufs = []
    for op, positions in records:
        if not len(positions):
            continue
        payload = np.asarray(positions, dtype=np.uint64).tobytes()
        bufs.append(_REC_HDR.pack(WAL_MAGIC, op, len(positions), zlib.crc32(payload)))
        bufs.append(payload)
    return b"".join(bufs)


def decode_records(data: bytes) -> Iterator[Tuple[int, np.ndarray]]:
    """Inverse of encode_records, strict: bytes that end short or fail a
    check raise (unlike replay, which drops a torn tail)."""
    pos = 0
    n_total = len(data)
    while pos < n_total:
        if pos + _REC_HDR.size > n_total:
            raise ValueError("truncated delta stream: partial record header")
        magic, op, n, crc = _REC_HDR.unpack_from(data, pos)
        pos += _REC_HDR.size
        if magic != WAL_MAGIC:
            raise ValueError(f"bad delta record magic at offset {pos - _REC_HDR.size}")
        end = pos + n * 8
        if end > n_total:
            raise ValueError("truncated delta stream: partial payload")
        payload = data[pos:end]
        if zlib.crc32(payload) != crc:
            raise ValueError(f"delta record CRC mismatch at offset {pos}")
        yield op, np.frombuffer(payload, dtype=np.uint64)
        pos = end


def replay_wal(path: str) -> Iterator[Tuple[int, np.ndarray]]:
    """(op, positions) records of a WAL, up to a torn or corrupt tail."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        while True:
            hdr = f.read(_REC_HDR.size)
            if len(hdr) < _REC_HDR.size:
                return
            magic, op, n, crc = _REC_HDR.unpack(hdr)
            if magic != WAL_MAGIC:
                return
            payload = f.read(n * 8)
            if len(payload) < n * 8 or zlib.crc32(payload) != crc:
                return
            yield op, np.frombuffer(payload, dtype=np.uint64)


def check_wal(path: str) -> Tuple[int, str, str]:
    """(n_valid_ops, status, detail) of a WAL: "ok" (every byte is a valid
    record), "torn" (the tail is an incomplete record: a crash during an
    append, which replay drops by design) or "corrupt" (a complete-looking
    record fails its magic or CRC: damage replay would silently drop)."""
    n_ops = 0
    pos = 0
    for _, positions in replay_wal(path):
        n_ops += 1
        pos += _REC_HDR.size + len(positions) * 8
    size = os.path.getsize(path) if os.path.exists(path) else 0
    rest = size - pos
    if rest == 0:
        return n_ops, "ok", ""
    with open(path, "rb") as f:
        f.seek(pos)
        tail = f.read(_REC_HDR.size)
    if len(tail) < _REC_HDR.size:
        return n_ops, "torn", f"{rest}-byte partial header at tail"
    magic, _, n, _ = _REC_HDR.unpack(tail)
    if magic != WAL_MAGIC:
        return n_ops, "corrupt", f"bad record magic at offset {pos}"
    if rest < _REC_HDR.size + n * 8:
        return n_ops, "torn", f"partial payload at tail ({rest} bytes)"
    return n_ops, "corrupt", f"CRC mismatch at offset {pos}"
