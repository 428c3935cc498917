"""Key translation: string key <-> integer id stores.

The port of pilosa_tpu/core/translate.py (one node). One store per keyed
index (column keys) and one per keyed field (row keys): an in-memory
bidirectional map backed by an append-only log at `<dir>/.keys.translate`
of `<QI` records (id, key length) each followed by the key's UTF-8 bytes,
replayed on open. Ids are monotonic from 1; 0 means "not found". A torn
tail record (a crash mid-append) is dropped on open and the file is cut
back to the last whole record, so later appends realign. The log rides
the fragments' WAL group commit (core/wal.py GROUP_COMMIT): under the
strict WAL (sync interval 0) new keys are fsynced before the call that
allocated them returns, so before the keyed write is acknowledged;
otherwise they are fsynced on the WAL's cadence. So after a machine crash
the log keeps every key whose bit the WAL kept. Translation runs on the
host and never touches the card.

In a cluster one node's store is the single writer (the coordinator's).
Every other node's store is `read_only`: it forwards the keys it lacks
to the primary (`forward_fn(keys) -> ids`) and applies the answer, and it
pulls the primary's new entries (`catchup_fn()`) when asked for an id it
does not know. `entries_since(offset)` serves the append log from a
replication offset: a byte offset in the log file, or an entry index for
an in-memory store.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pilosa_tpu_torch.core import wal as walmod

_REC = struct.Struct("<QI")  # id, key length; followed by the key bytes


class TranslateError(Exception):
    pass


class ReadOnlyError(TranslateError):
    """A write to a replica's store with no primary to forward it to."""


class TranslateStore:
    """Bidirectional string <-> id map with an append-only on-disk log
    (path None: in memory)."""

    def __init__(self, path: Optional[str] = None, read_only: bool = False):
        self.path = path
        self.read_only = read_only
        # replication hooks, set by the node (server/node.py wire_translation)
        self.forward_fn = None  # keys -> ids, allocated by the primary
        self.catchup_fn = None  # pull and apply the primary's new entries
        self._lock = threading.RLock()
        self._by_key: Dict[str, int] = {}
        self._by_id: Dict[int, str] = {}
        self._next_id = 1
        self._fh = None
        # a member of the WAL group commit: its token, and whether closed
        self._tok = walmod.next_writer_token()
        self._closed = False

    # -- lifecycle ---------------------------------------------------------

    def open(self) -> "TranslateStore":
        if self.path:
            if os.path.exists(self.path):
                self._replay()
            created = not os.path.exists(self.path)
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "ab")
            if created:  # the new log's directory entry must survive
                walmod.fsync_dir(os.path.dirname(os.path.abspath(self.path)))
        return self

    def close(self) -> None:
        walmod.GROUP_COMMIT.forget(self)
        with self._lock:
            self._closed = True
            if self._fh:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None

    def _fsync(self) -> None:
        """fsync the log for a group-commit round (a closed store synced
        itself on close)."""
        with self._lock:
            if self._fh:
                os.fsync(self._fh.fileno())

    def _replay(self) -> None:
        with open(self.path, "rb") as f:
            data = f.read()
        off = 0
        n = len(data)
        while off + _REC.size <= n:
            id_, klen = _REC.unpack_from(data, off)
            end = off + _REC.size + klen
            if end > n:  # torn tail record: drop it
                break
            key = data[off + _REC.size : end].decode("utf-8")
            self._by_key[key] = id_
            self._by_id[id_] = key
            self._next_id = max(self._next_id, id_ + 1)
            off = end
        if off < n:  # cut the torn tail so appends realign
            with open(self.path, "r+b") as f:
                f.truncate(off)

    # -- writes ------------------------------------------------------------

    def translate_key(self, key: str) -> int:
        """The id of key, allocated if it is new."""
        return self.translate_keys([key])[0]

    def translate_keys(self, keys: Sequence[str]) -> List[int]:
        """The id of every key, in order; new keys get the next ids in
        order of first appearance and are appended to the log together. A
        read-only store forwards the keys it lacks to the primary (outside
        the lock: a slow primary must not stall local reads) and applies
        the ids it answers."""
        if self.read_only:
            with self._lock:
                missing = sorted({k for k in keys if k not in self._by_key})
            if missing:
                if self.forward_fn is None:
                    raise ReadOnlyError(f"translate store is read-only; forward {missing[0]!r} to primary")
                ids = self.forward_fn(missing)
                if len(ids) != len(missing):
                    raise TranslateError(f"primary returned {len(ids)} ids for {len(missing)} keys")
                self.apply_entries(zip(ids, missing))
            with self._lock:
                try:
                    return [self._by_key[k] for k in keys]
                except KeyError as e:
                    raise TranslateError(f"key {e.args[0]!r} missing after primary forward") from None
        token = None
        with self._lock:
            out = []
            new: List[Tuple[int, str]] = []
            by_key = self._by_key
            for key in keys:
                id_ = by_key.get(key)
                if id_ is None:
                    id_ = self._next_id
                    self._next_id += 1
                    by_key[key] = id_
                    self._by_id[id_] = key
                    new.append((id_, key))
                out.append(id_)
            if new:
                token = self._append(new)
        self._wait_durable(token)
        return out

    def _append(self, recs: List[Tuple[int, str]]) -> Optional[int]:
        """Write and flush the records; the group-commit token to wait on
        (outside the lock), or None for an in-memory store."""
        if not self._fh:
            return None
        blob = b"".join(
            _REC.pack(id_, len(kb)) + kb for id_, kb in ((i, k.encode("utf-8")) for i, k in recs)
        )
        self._fh.write(blob)
        self._fh.flush()
        return walmod.GROUP_COMMIT.mark_dirty(self)

    @staticmethod
    def _wait_durable(token: Optional[int]) -> None:
        if token is not None:
            walmod.GROUP_COMMIT.wait_durable(token)

    def apply_entries(self, entries) -> None:
        """Load (id, key) pairs from the primary (a replica's follow path)
        or another holder's store (compat), appending the new ones to the
        log. The same id mapped to another key raises TranslateError: the
        stores have diverged."""
        token = None
        with self._lock:
            new = []
            for id_, key in entries:
                id_ = int(id_)
                existing = self._by_id.get(id_)
                if existing is not None:
                    if existing != key:
                        raise TranslateError(f"id {id_} is {existing!r} here but {key!r} in the source")
                    continue
                self._by_id[id_] = key
                self._by_key[key] = id_
                self._next_id = max(self._next_id, id_ + 1)
                new.append((id_, key))
            if new:
                token = self._append(new)
        self._wait_durable(token)

    # -- reads -------------------------------------------------------------

    def find_key(self, key: str) -> Optional[int]:
        """The id of key, or None: never allocates (a read path)."""
        return self._by_key.get(key)

    def key_for_id(self, id_: int) -> Optional[str]:
        key = self._by_id.get(id_)
        if key is None and self.catchup_fn is not None:
            # a stale replica: pull the primary's new entries once, retry
            try:
                self.catchup_fn()
            except Exception:  # noqa: BLE001 - an unknown id reads as None
                return None
            key = self._by_id.get(id_)
        return key

    def keys_for_ids(self, ids) -> List[Optional[str]]:
        """The key of every id (None where there is none), in one pass; a
        replica catches up from the primary at most once a batch."""
        ids = np.asarray(ids, np.uint64).tolist()
        if self.catchup_fn is not None and any(i not in self._by_id for i in ids):
            try:
                self.catchup_fn()
            except Exception:  # noqa: BLE001 - unknown ids read as None
                pass
        get = self._by_id.get
        return [get(i) for i in ids]

    # -- replication ---------------------------------------------------------

    def entries_since(self, offset: int = 0) -> Tuple[List[Tuple[int, str]], int]:
        """The entries appended at or after `offset`, and the offset after
        them."""
        with self._lock:
            if not self.path or not os.path.exists(self.path):
                items = sorted(self._by_id.items())
                return items[offset:], len(items)
            if self._fh:
                self._fh.flush()
            with open(self.path, "rb") as f:
                f.seek(offset)
                data = f.read()
        out = []
        off = 0
        while off + _REC.size <= len(data):
            id_, klen = _REC.unpack_from(data, off)
            end = off + _REC.size + klen
            if end > len(data):
                break
            out.append((id_, data[off + _REC.size : end].decode("utf-8")))
            off = end
        return out, offset + off
