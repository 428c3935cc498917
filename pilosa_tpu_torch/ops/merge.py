"""Sort and dedupe of staged position keys, and the in-place OR of
merged bit keys into resident device entries.

The port of pilosa_tpu/ops/merge.py plus the device half of the
reference's extent patch (core/view.py `_patch_entry`). The barrier
(core/merge.py) packs every staged fragment's pending positions into one
key array (segment in the high bits, row and column below) and merges it
here in one pass:

- `merge_keys_host`: a sort and a first-occurrence mask (np.unique's
  result: numpy 2.3's np.unique finds unique integers through a hash
  table, about 50x slower than a sort at 2^21 keys);
- `merge_keys_device`: the same keys computed on a device: `torch.sort`
  of the keys as int64 (the barrier keeps them below 2^63, so int64 order
  is uint64 order), then the `merge_mark` kernel (first-occurrence mask
  and word bit in one pass) and compaction by the mask. Keys go up from
  pinned host memory without blocking; the merged keys come back in one
  read and also stay on the device, where the patches read them.

`or_bits` ORs a merged key range per (shard, row) into a resident entry
in place: bit `k & (SHARD_WIDTH - 1)` of the row that a segment table
row names. The reference's patch uploads dense 128 KiB delta blocks
built from the keys' wrapped uint32 bit cumsum (`word_or_from_sorted`);
`bit_cumsum` and `word_or_from_sorted` stay here as the tests' oracle of
that form, and no path builds per-word deltas on the host any more.

On a CUDA tensor `merge_mark` and `or_bits` launch their kernels
(cuda/merge_kernels.cu) and count them in `kernels.LAUNCHES`; on a CPU
tensor they run their plain twins below. `MERGE_STATS` counts merges by
route (`device_launches`: device merges, one per barrier burst).
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_ROW

MERGE_STATS = {"device_launches": 0, "host_merges": 0}

# packed keys stay below this (core/merge.py guards the packing)
KEY_LIMIT = 1 << 63

_MASK32 = 0xFFFFFFFF


def reset_stats() -> None:
    MERGE_STATS["device_launches"] = 0
    MERGE_STATS["host_merges"] = 0


# ---------------------------------------------------------------------------
# merge_mark  (ops/merge.py _merge_sorted_u64 after its sort)
# ---------------------------------------------------------------------------


def merge_mark_plain(s: torch.Tensor):
    """(keep bool[n], bit int32[n]) of sorted int64 keys: keep marks each
    key's first occurrence, bit is 1 << (key & 31) where kept, else 0."""
    keep = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    if s.numel() > 1:
        keep[1:] = s[1:] != s[:-1]
    one = torch.ones(s.shape, dtype=torch.int32, device=s.device)
    bit = torch.where(keep, one << (s & 31).to(torch.int32), torch.zeros_like(one))
    return keep, bit


def merge_mark(s: torch.Tensor):
    """merge_mark_plain's contract; a contiguous int64[n] of sorted keys."""
    if s.dtype != torch.int64 or s.dim() != 1:
        raise TypeError(f"merge_mark: want a 1-d int64 tensor, got {s.dtype} {tuple(s.shape)}")
    if not s.is_contiguous():
        raise ValueError("merge_mark: tensor must be contiguous")
    if kernels._route(s) == "cpu":
        return merge_mark_plain(s)
    n = s.numel()
    keep = torch.empty(n, dtype=torch.bool, device=s.device)
    bit = torch.empty(n, dtype=torch.int32, device=s.device)
    if n:
        rc = kernels.library().pt_merge_mark(s.data_ptr(), n, keep.data_ptr(), bit.data_ptr(), kernels._stream(s))
        kernels._launched("merge_mark", rc)
    return keep, bit


# ---------------------------------------------------------------------------
# or_bits  (core/view.py _patch_entry, device part)
# ---------------------------------------------------------------------------

# keys per CTA of the or_bits kernel (kOrBitsChunk in cuda/merge_kernels.cu)
OR_BITS_CHUNK = 1024


def _or_bits_args(entry: torch.Tensor, keys: torch.Tensor, table) -> np.ndarray:
    """The checked host segment table as int64[T, 3]; raises before any
    write. Each row (key_start, key_end, dst_word_base) must take keys
    inside `keys` and name a whole row of the entry."""
    kernels._words(entry, "or_bits entry")
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise TypeError(f"or_bits: keys must be a contiguous 1-d int64 tensor, got {keys.dtype} {tuple(keys.shape)}")
    kernels._route(entry, keys)
    t = _table(table)
    ks, ke, base = t.T
    bad = (ks < 0) | (ks > ke) | (ke > keys.numel()) | (base < 0) | (base % WORDS_PER_ROW != 0) | (
        base > entry.numel() - WORDS_PER_ROW
    )
    if bad.any():
        i = int(bad.argmax())
        if ks[i] < 0 or ks[i] > ke[i] or ke[i] > keys.numel():
            raise IndexError(f"or_bits: table row {i} takes keys [{ks[i]}, {ke[i]}) of {keys.numel()}")
        raise IndexError(
            f"or_bits: table row {i} writes words [{base[i]}, {base[i] + WORDS_PER_ROW}), not a whole row "
            f"of an entry of {entry.numel()} words"
        )
    return t


def _table(table) -> np.ndarray:
    t = np.asarray(table, dtype=np.int64)
    if t.size == 0:
        return t.reshape(0, 3)
    if t.ndim != 2 or t.shape[1] != 3:
        raise ValueError(f"or_bits: the segment table must be [T, 3], got {t.shape}")
    return t


def _key_index(t: np.ndarray) -> tuple:
    """(the key positions every table row takes, in order; each one's
    row of the table)."""
    lens = t[:, 1] - t[:, 0]
    row = np.repeat(np.arange(len(t)), lens)
    first = np.cumsum(lens) - lens
    return t[row, 0] + np.arange(int(lens.sum())) - first[row], row


def or_bits_plain(entry: torch.Tensor, keys: torch.Tensor, table) -> torch.Tensor:
    """or_bits' contract in PyTorch: the bits of a row's unique keys are
    distinct powers of two within a word, so their int64 sum into a zero
    delta is their OR; the sum wraps to 32 bits (bit 31 kept) before it
    is ORed into the int32 words."""
    t = _table(table)
    idx, row = _key_index(t)
    if not len(idx):
        return entry
    dev = entry.device
    k = keys[torch.from_numpy(idx).to(dev)]
    col = k & (SHARD_WIDTH - 1)
    word = torch.from_numpy(t[row, 2]).to(dev) + (col >> 5)
    delta = torch.zeros(entry.numel(), dtype=torch.int64, device=dev)
    delta.index_add_(0, word, torch.ones_like(col) << (col & 31))
    flat = entry.view(-1)
    flat |= (((delta + (1 << 31)) & _MASK32) - (1 << 31)).to(torch.int32)
    return entry


def _or_bits_chunks(t: np.ndarray) -> tuple:
    """The kernel's chunk table as three int64 columns (key_start,
    key_end, dst_word_base), each segment cut into runs of at most
    OR_BITS_CHUNK keys; empty segments give none."""
    ks, ke, base = t.T
    n = (ke - ks + (OR_BITS_CHUNK - 1)) // OR_BITS_CHUNK
    seg = np.repeat(np.arange(len(t)), n)
    start = ks[seg] + OR_BITS_CHUNK * (np.arange(len(seg)) - np.repeat(np.cumsum(n) - n, n))
    return start, np.minimum(start + OR_BITS_CHUNK, ke[seg]), base[seg]


def or_bits(entry: torch.Tensor, keys: torch.Tensor, table) -> int:
    """For each row (key_start, key_end, dst_word_base) of `table` and each
    key k in keys[key_start:key_end]: entry.flat[dst_word_base + (c >> 5)]
    |= 1 << (c & 31), c = k & (SHARD_WIDTH - 1), in place. `keys` are a
    barrier group's sorted unique merged keys (int64, on the entry's
    device), each table row's range inside one shard row of the packing;
    `table` is int64[T, 3] on the host, checked here (a row outside the
    keys or not naming a whole row of the entry raises IndexError before
    any write). A CUDA
    entry takes one launch, its chunk table copied from a pinned slot on
    the launch stream. Returns the bytes copied to the card (0 on the
    CPU)."""
    t = _or_bits_args(entry, keys, table)
    if kernels._route(entry) == "cpu":
        or_bits_plain(entry, keys, t)
        return 0
    start, end, base = _or_bits_chunks(t)
    n = len(start)
    if not n:
        return 0
    _, rc = kernels._STAGING.launch(
        entry.device,
        (start, end, base),
        lambda host, nbytes, tab, stream: kernels.library().pt_or_bits(
            host, nbytes, tab, entry.data_ptr(), keys.data_ptr(), n, SHARD_WIDTH - 1, stream
        ),
    )
    kernels._launched("or_bits", rc)
    return 24 * n


# ---------------------------------------------------------------------------
# key merges
# ---------------------------------------------------------------------------


def merge_keys_host(keys: np.ndarray) -> np.ndarray:
    """Sorted unique uint64 keys in one vectorized host pass: np.unique's
    keys, from a sort."""
    MERGE_STATS["host_merges"] += 1
    merged = np.sort(np.asarray(keys, dtype=np.uint64))
    if len(merged) > 1:
        merged = merged[np.concatenate(([True], merged[1:] != merged[:-1]))]
    return merged


def merge_keys_on(s: torch.Tensor) -> torch.Tensor:
    """The device merge of int64 keys already on `s.device`: the sorted
    unique keys, on the device."""
    s = torch.sort(s).values
    keep, _ = merge_mark(s)
    return s[keep]


def merge_keys_device(keys: np.ndarray, device: torch.device):
    """merge_keys_host's keys, computed on `device` (one upload, one sort,
    one merge_mark launch, one compaction, one read back): (uint64 numpy
    keys, the same keys as an int64 tensor on `device`). Keys must lie
    below 2^63."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    if len(keys) and int(keys.max()) >= KEY_LIMIT:
        raise ValueError("merge_keys_device: keys must lie below 2^63")
    host = torch.from_numpy(keys.view(np.int64))
    if device.type == "cuda":
        host = host.pin_memory()
    merged = merge_keys_on(host.to(device, non_blocking=True))
    MERGE_STATS["device_launches"] += 1
    return merged.cpu().numpy().view(np.uint64), merged


def bit_cumsum(merged: np.ndarray) -> np.ndarray:
    """The inclusive uint32 cumsum of each sorted unique key's bit
    `1 << (key & 31)`: the second output of the reference's merge, which
    `word_or_from_sorted` turns into per-word deltas."""
    bits = np.uint32(1) << (np.asarray(merged, np.uint64) & np.uint64(31)).astype(np.uint32)
    return np.cumsum(bits, dtype=np.uint32)


def word_or_from_sorted(pos: np.ndarray, cum: np.ndarray):
    """(word_idx int64[], word_val uint32[]) of a slice of sorted unique
    in-row positions and its aligned inclusive bit cumsum: the per-word
    OR of the slice, from uint32 differences of the wrapped cumsum."""
    if not len(pos):
        return np.empty(0, np.int64), np.empty(0, np.uint32)
    widx = (pos >> np.uint64(5)).astype(np.int64)
    last = np.concatenate([np.flatnonzero(widx[1:] != widx[:-1]), [len(widx) - 1]]).astype(np.int64)
    ends = cum[last].astype(np.uint32, copy=False)
    # exact Python ints, then wrap: numpy scalar overflow warns
    base = np.uint32((int(cum[0]) - (1 << (int(pos[0]) & 31))) & _MASK32)
    starts = np.empty(len(ends), np.uint32)
    starts[0] = base
    starts[1:] = ends[:-1]
    return widx[last], ends - starts
