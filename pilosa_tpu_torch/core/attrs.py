"""Row and column attribute stores.

The port's copy of pilosa_tpu/core/attrs.py, with a plain threading
lock. An in-memory dict persisted as a base JSON snapshot plus a JSONL
append log: each set_attrs appends one delta line instead of rewriting
the whole store, and the log folds back into the snapshot once it grows
past COMPACT_THRESHOLD lines. A torn last line (a crash mid-append) is
ignored on replay and truncated away. The files are the reference's, so
a data dir opens in either package. Anti-entropy reads the store in
blocks of 100 ids with crc32 checksums (blocks, block_data,
block_checksum).
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Dict, List, Optional

import numpy as np

ATTR_BLOCK_SIZE = 100

# Log lines before the delta log folds back into the base snapshot. Small
# enough that replay-on-open stays trivial, large enough that steady
# attr-writing amortizes the snapshot rewrite ~4000x.
COMPACT_THRESHOLD = 4096


class AttrStore:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._mu = threading.RLock()
        self._attrs: Dict[int, dict] = {}
        self._log_f = None
        self._log_n = 0
        self._ids_arr: Optional[np.ndarray] = None  # ids(), memoized
        if path is not None:
            if os.path.exists(path):
                with open(path) as f:
                    self._attrs = {int(k): v for k, v in json.load(f).items()}
            self._replay_log()
            if self._log_n >= COMPACT_THRESHOLD:
                self._compact()

    @property
    def _log_path(self) -> str:
        return self.path + ".log"

    # -- reads -------------------------------------------------------------

    def attrs(self, id: int) -> dict:
        with self._mu:
            return dict(self._attrs.get(id, {}))

    def attrs_many(self, ids: List[int]) -> List[dict]:
        """attrs() of each id, under one lock acquisition."""
        with self._mu:
            get = self._attrs.get
            return [dict(get(i) or ()) for i in ids]

    def ids(self) -> List[int]:
        with self._mu:
            return sorted(self._attrs)

    def ids_array(self) -> np.ndarray:
        """ids() as a sorted uint64 array, rebuilt only after a write adds
        an id."""
        with self._mu:
            if self._ids_arr is None:
                self._ids_arr = np.array(sorted(self._attrs), dtype=np.uint64)
            return self._ids_arr

    # -- writes ------------------------------------------------------------

    def set_attrs(self, id: int, attrs: dict) -> None:
        """Merge attrs; a None value deletes the key (reference semantics)."""
        with self._mu:
            self._apply(id, attrs)
            self._append({str(id): attrs})

    def set_bulk_attrs(self, m: Dict[int, dict]) -> None:
        """Bulk merge; None values are skipped, not deletes (reference
        bulk-import semantics). Normalized before logging so replay can
        use the uniform delete-on-None apply."""
        with self._mu:
            delta = {}
            for id, attrs in m.items():
                clean = {k: v for k, v in attrs.items() if v is not None}
                self._apply(id, clean)
                delta[str(id)] = clean
            self._append(delta)

    def _apply(self, id: int, attrs: dict) -> None:
        cur = self._attrs.get(id)
        if cur is None:
            cur = self._attrs[id] = {}
            self._ids_arr = None
        for k, v in attrs.items():
            if v is None:
                cur.pop(k, None)
            else:
                cur[k] = v

    # -- persistence: base snapshot + JSONL delta log ----------------------

    def _append(self, delta: Dict[str, dict]) -> None:
        if self.path is None:
            return
        if self._log_f is None:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._log_f = open(self._log_path, "a")
        self._log_f.write(json.dumps(delta, separators=(",", ":")) + "\n")
        self._log_f.flush()
        self._log_n += 1
        if self._log_n >= COMPACT_THRESHOLD:
            self._compact()

    def _replay_log(self) -> None:
        """Apply logged deltas over the base snapshot. A torn final line
        (crash mid-append) is ignored, like the WAL's torn-tail rule — and
        the file is TRUNCATED at the torn offset, so the next append
        starts a fresh line instead of concatenating onto the torn one
        (which would corrupt, and on the following restart silently drop,
        an acknowledged write)."""
        if not os.path.exists(self._log_path):
            return
        valid_end = 0
        with open(self._log_path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n"):
                    break  # torn tail: the append never completed
                try:
                    delta = json.loads(line)
                except json.JSONDecodeError:
                    break
                for id_s, attrs in delta.items():
                    self._apply(int(id_s), attrs)
                self._log_n += 1
                valid_end += len(line)
        if valid_end < os.path.getsize(self._log_path):
            with open(self._log_path, "rb+") as f:
                f.truncate(valid_end)

    def _compact(self) -> None:
        """Fold the delta log into the base snapshot atomically: write the
        full state to .tmp, replace the base, then truncate the log. A
        crash between the two leaves a base that already contains every
        logged delta plus a log whose replay is idempotent re-merging."""
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in self._attrs.items()}, f)
        os.replace(tmp, self.path)
        if self._log_f is not None:
            self._log_f.close()
        self._log_f = open(self._log_path, "w")
        self._log_n = 0

    def close(self) -> None:
        """Release the append-log fd (Field.close/Index.close call this —
        a long-lived process reopening holders must not leak one fd per
        disk-backed attr store)."""
        with self._mu:
            if self._log_f is not None:
                self._log_f.close()
                self._log_f = None

    # -- anti-entropy support ---------------------------------------------

    def blocks(self) -> List[dict]:
        """Per-block checksums for replica diffing (one pass over the
        store; block_checksum below serves single-block refreshes)."""
        with self._mu:
            by_block: Dict[int, List[int]] = {}
            for id in sorted(self._attrs):
                by_block.setdefault(id // ATTR_BLOCK_SIZE, []).append(id)
            return [
                {"id": b, "checksum": self._checksum_of(ids)}
                for b, ids in sorted(by_block.items())
            ]

    def _checksum_of(self, ids: List[int]) -> int:
        payload = json.dumps(
            [(i, sorted(self._attrs[i].items())) for i in ids]
        ).encode()
        return zlib.crc32(payload)

    def block_data(self, block_id: int) -> Dict[int, dict]:
        with self._mu:
            lo = block_id * ATTR_BLOCK_SIZE
            hi = lo + ATTR_BLOCK_SIZE
            return {i: dict(a) for i, a in self._attrs.items() if lo <= i < hi}

    def block_checksum(self, block_id: int) -> Optional[int]:
        """Checksum of one block (same serialization as blocks()); None
        when the block holds no attrs. Lets anti-entropy refresh a single
        merged block without re-hashing the whole store."""
        with self._mu:
            lo = block_id * ATTR_BLOCK_SIZE
            hi = lo + ATTR_BLOCK_SIZE
            ids = sorted(i for i in self._attrs if lo <= i < hi)
            if not ids:
                return None
            return self._checksum_of(ids)
