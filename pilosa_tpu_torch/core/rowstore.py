"""Host-side row storage for one fragment.

The TPU-native answer to roaring's three container encodings
(reference: roaring/roaring.go:1940 ArrayMaxSize / runMaxSize thresholds,
optimize() at :2334): on the *host*, a row's in-shard bits are kept either as
a sorted uint32 position array (sparse) or a dense uint32 word vector — the
two representations auto-convert at the memory crossover point, mirroring
roaring's array<->bitmap conversion. On the *device*, everything is dense;
compression never reaches the compute path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# snapshot representation tags (core/wal.py writes them per row)
ARRAY_REP = 0
DENSE_REP = 1

if hasattr(np, "bitwise_count"):  # numpy >= 2.0

    def _popcount_words(words: np.ndarray) -> int:
        return int(np.bitwise_count(words).sum())

else:
    # 16-bit popcount lookup table (128 KiB once) — avoids the 32x blowup of
    # np.unpackbits on hot count paths.
    _POPCNT16 = np.array([bin(i).count("1") for i in range(1 << 16)], dtype=np.uint8)

    def _popcount_words(words: np.ndarray) -> int:
        return int(_POPCNT16[words.view(np.uint16)].sum())


def _word_positions(words: np.ndarray) -> np.ndarray:
    """Sorted uint32 bit positions of dense uint32 words, unpacking only
    the nonzero words (a sparse row's words are mostly zero)."""
    nz = np.flatnonzero(words)
    if not len(nz):
        return np.empty(0, dtype=np.uint32)
    bits = np.unpackbits(words[nz].view(np.uint8).reshape(len(nz), 4), axis=1, bitorder="little")
    r, c = np.nonzero(bits)
    return (nz[r].astype(np.uint32) << np.uint32(5)) | c.astype(np.uint32)


class RowBits:
    """Bits of one (row, shard) pair: sorted uint32 positions or dense words.

    The crossover: a position array costs 4n bytes, dense costs n_words*4
    bytes, so we densify once n > n_words (the same economics as roaring's
    ArrayMaxSize=4096 for 2^16-bit containers, scaled to the full shard).
    """

    __slots__ = ("n_bits", "n_words", "positions", "dense", "_n")

    def __init__(self, n_bits: int):
        self.n_bits = n_bits
        self.n_words = n_bits // 32
        self.positions: Optional[np.ndarray] = np.empty(0, dtype=np.uint32)
        self.dense: Optional[np.ndarray] = None
        self._n = 0  # maintained cardinality while dense (O(1) count())

    # -- representation management ---------------------------------------

    def _maybe_densify(self):
        if self.positions is not None and len(self.positions) > self.n_words:
            self._n = len(self.positions)
            self.dense = self._to_dense()
            self.positions = None

    def _maybe_sparsify(self):
        # Convert back when well under the threshold (hysteresis at 1/2).
        if self.dense is not None:
            n = self.count()
            if n < self.n_words // 2:
                self.positions = self.to_positions()
                self.dense = None

    def _to_dense(self) -> np.ndarray:
        if not len(self.positions):  # a new row: no bool pass to pack
            return np.zeros(self.n_words, dtype=np.uint32)
        bits = np.zeros(self.n_bits, dtype=bool)
        bits[self.positions] = True
        return np.packbits(bits, bitorder="little").view(np.uint32)

    # -- reads -------------------------------------------------------------

    def count(self) -> int:
        """Cardinality in O(1): maintained incrementally while dense, the
        array length while sparse. Exact counts being free host metadata is
        what lets TopN answer from rank caches with no device pass (the
        reference recounts rows because its cache counts are approximate,
        cache.go:136-300)."""
        if self.dense is not None:
            return self._n
        return len(self.positions)

    def to_words(self) -> np.ndarray:
        """Dense uint32 word vector. The dense branch hands out a read-only
        view of the live buffer (not a copy): mutating it would desync the
        maintained cardinality, which TopN answers from with no recount."""
        if self.dense is not None:
            w = self.dense.view()
            w.flags.writeable = False
            return w
        return self._to_dense()

    def to_positions(self) -> np.ndarray:
        if self.dense is not None:
            return _word_positions(self.dense)
        return self.positions.copy()

    def contains(self, pos: int) -> bool:
        if self.dense is not None:
            return bool((self.dense[pos >> 5] >> np.uint32(pos & 31)) & np.uint32(1))
        i = np.searchsorted(self.positions, pos)
        return i < len(self.positions) and self.positions[i] == pos

    def any(self) -> bool:
        if self.dense is not None:
            return bool(self.dense.any())
        return len(self.positions) > 0

    # -- mutations ---------------------------------------------------------

    def add(self, new: np.ndarray) -> int:
        """Set the given positions; returns how many were newly set."""
        new = np.asarray(new, dtype=np.uint32)
        if new.size == 0:
            return 0
        if self.dense is not None:
            w = new >> 5
            m = np.uint32(1) << (new & np.uint32(31))
            before = (self.dense[w] & m) != 0
            np.bitwise_or.at(self.dense, w, m)
            # recount duplicates: a position listed twice must count once
            if before.all():
                return 0
            uniq = np.unique(new[~before])
            self._n += len(uniq)
            return len(uniq)
        merged = np.union1d(self.positions, new)
        changed = len(merged) - len(self.positions)
        self.positions = merged.astype(np.uint32)
        self._maybe_densify()
        return changed

    def union_words(self, words: np.ndarray) -> int:
        """Union a dense word vector in; returns how many bits were newly
        set. The word-level bulk path (the reference unions whole serialized
        bitmaps in place the same way, roaring.go:1511 ImportRoaringBits)."""
        words = np.asarray(words, dtype=np.uint32)
        if not words.any():
            return 0
        before = self.count()
        if self.dense is None:
            self.dense = self._to_dense()
            self.positions = None
        np.bitwise_or(self.dense, words, out=self.dense)
        self._n = _popcount_words(self.dense)
        added = self._n - before
        self._maybe_sparsify()
        return added

    def assign_mask(self, mask: np.ndarray) -> None:
        """Set the row to the columns of a bool [n_bits] mask, sparse or
        dense by its count as the crossover rule says."""
        n = int(np.count_nonzero(mask))
        if n > self.n_words:
            self.dense = np.packbits(mask, bitorder="little").view(np.uint32)
            self.positions = None
            self._n = n
        else:
            self.positions = np.flatnonzero(mask).astype(np.uint32)
            self.dense = None

    def assign_words(self, mask: np.ndarray, words: np.ndarray) -> int:
        """Overwrite the bits under a dense word mask with `words` (a
        subset of it): row = (row & ~mask) | words. The word-level path
        of columnar int imports. Returns how many bits changed.

        The row ends in the representation the reference's set-then-clear
        of the same bits leaves (pilosa_tpu Fragment.import_values), so
        snapshots of either package are byte-identical: a sparse row
        densifies only if its union with `words` passes n_words, and a
        dense row sparsifies below n_words // 2."""
        if self.dense is not None:
            changed = _popcount_words((self.dense & mask) ^ words)
            np.bitwise_and(self.dense, np.bitwise_not(mask), out=self.dense)
            np.bitwise_or(self.dense, words, out=self.dense)
            self._n = _popcount_words(self.dense)
            self._maybe_sparsify()
            return changed
        old = self._to_dense()
        changed = _popcount_words((old & mask) ^ words)
        new = (old & np.bitwise_not(mask)) | words
        if _popcount_words(old | words) <= self.n_words:
            self.positions = np.flatnonzero(np.unpackbits(new.view(np.uint8), bitorder="little")).astype(np.uint32)
            return changed
        self.dense = new
        self.positions = None
        self._n = _popcount_words(new)
        self._maybe_sparsify()
        return changed

    def discard(self, gone: np.ndarray) -> int:
        """Clear the given positions; returns how many were actually cleared."""
        gone = np.asarray(gone, dtype=np.uint32)
        if gone.size == 0:
            return 0
        if self.dense is not None:
            gone = np.unique(gone)
            w = gone >> 5
            m = np.uint32(1) << (gone & np.uint32(31))
            before = (self.dense[w] & m) != 0
            np.bitwise_and.at(self.dense, w, np.bitwise_not(m))
            cleared = int(before.sum())
            self._n -= cleared
            self._maybe_sparsify()
            return cleared
        kept = np.setdiff1d(self.positions, gone)
        changed = len(self.positions) - len(kept)
        self.positions = kept.astype(np.uint32)
        return changed

    # -- serialization (snapshot payload) ----------------------------------

    def rep(self) -> int:
        return DENSE_REP if self.dense is not None else ARRAY_REP

    def payload(self) -> np.ndarray:
        return self.dense if self.dense is not None else self.positions

    @classmethod
    def from_payload(cls, n_bits: int, rep: int, payload: np.ndarray) -> "RowBits":
        rb = cls(n_bits)
        if rep == DENSE_REP:
            rb.dense = payload.astype(np.uint32, copy=True)
            rb.positions = None
            rb._n = _popcount_words(rb.dense)
        else:
            rb.positions = payload.astype(np.uint32, copy=True)
        return rb
