"""Sort, dedupe and word-OR of staged position keys, and the in-place OR
of merged word deltas into resident device entries.

The port of pilosa_tpu/ops/merge.py plus the device half of the
reference's extent patch (core/view.py `_patch_entry`). The barrier
(core/merge.py) packs every staged fragment's pending positions into one
key array (segment in the high bits, row and column below) and merges it
here in one pass:

- `merge_keys_host`: a sort and a first-occurrence mask (np.unique's
  result: numpy 2.3's np.unique finds unique integers through a hash
  table, about 50x slower than a sort at 2^21 keys) plus the inclusive
  uint32 cumsum of each kept key's bit `1 << (key & 31)`;
- `merge_keys_device`: the same contract on a device: `torch.sort` of
  the keys as int64 (the barrier keeps them below 2^63, so int64 order is
  uint64 order), then the `merge_mark` kernel (first-occurrence mask and
  bit in one pass), `torch.cumsum` in int64 masked to 32 bits (the
  uint32 wrap), and compaction by the mask. Keys go up from pinned host
  memory without blocking; results come back in one read.

Within one word the kept bits are distinct powers of two, so OR equals
sum, and the per-word differences of the wrapped cumsum are exact
(`word_or_from_sorted`). `or_words` applies such (flat word offset, OR
value) pairs to an entry in place; it checks the offsets on the host
copy of the pairs, then uploads them, and the kernel trusts them. The
offsets are unique, so the kernel needs no atomics.

On a CUDA tensor `merge_mark` and `or_words` launch their kernels
(cuda/merge_kernels.cu) and count them in `kernels.LAUNCHES`; on a CPU
tensor they run their plain twins below. `MERGE_STATS` counts merges by
route (`device_launches`: device merges, one per barrier burst).
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.ops import kernels

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
# or_words  (core/view.py _patch_entry, device part)
# ---------------------------------------------------------------------------


def _or_words_check(entry: torch.Tensor, off: torch.Tensor, val: torch.Tensor) -> None:
    kernels._words(entry, "or_words entry")
    kernels._words(val, "or_words val")
    if off.dtype != torch.int64 or not off.is_contiguous():
        raise TypeError("or_words: offsets must be a contiguous int64 tensor")
    if off.dim() != 1 or off.shape != val.shape:
        raise ValueError(f"or_words: offsets {tuple(off.shape)} and values {tuple(val.shape)} differ")


def or_words_plain(entry: torch.Tensor, off: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    flat = entry.view(-1)
    flat[off] = flat[off] | val
    return entry


def or_words(entry: torch.Tensor, off: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """entry.flat[off[k]] |= val[k] in place, for unique offsets; returns
    `entry`. `off` (int64) and `val` (int32) are host tensors: an offset
    outside [0, entry.numel()) raises here. A CUDA entry gets them from
    pinned memory on its launch stream, then `or_words_device`. Every
    tensor contiguous (a strided view is refused)."""
    _or_words_check(entry, off, val)
    if off.device.type != "cpu" or val.device.type != "cpu":
        raise ValueError(f"or_words: pairs must lie on the host, not {off.device} / {val.device}")
    if off.numel() and (int(off.min()) < 0 or int(off.max()) >= entry.numel()):
        raise IndexError(
            f"or_words: offsets [{int(off.min())}, {int(off.max())}] outside an entry of {entry.numel()} words"
        )
    if kernels._route(entry) == "cpu":
        return or_words_plain(entry, off, val)
    dev = entry.device
    return or_words_device(entry, off.pin_memory().to(dev, non_blocking=True), val.pin_memory().to(dev, non_blocking=True))


def or_words_device(entry: torch.Tensor, off: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """The or_words kernel on pairs already on the entry's device, whose
    offsets the caller checked (`or_words` does): the kernel does not."""
    _or_words_check(entry, off, val)
    if kernels._route(entry, off, val) == "cpu":
        raise ValueError("or_words_device: the entry lies on the host; use or_words")
    k = off.numel()
    if k:
        rc = kernels.library().pt_or_words(entry.data_ptr(), off.data_ptr(), val.data_ptr(), k, kernels._stream(entry))
        kernels._launched("or_words", rc)
    return entry


# ---------------------------------------------------------------------------
# key merges
# ---------------------------------------------------------------------------


def merge_keys_host(keys: np.ndarray):
    """(sorted unique uint64 keys, inclusive uint32 cumsum of their bits)
    in one vectorized host pass: np.unique's keys, from a sort."""
    MERGE_STATS["host_merges"] += 1
    merged = np.sort(np.asarray(keys, dtype=np.uint64))
    if len(merged) > 1:
        merged = merged[np.concatenate(([True], merged[1:] != merged[:-1]))]
    bits = np.uint32(1) << (merged & np.uint64(31)).astype(np.uint32)
    cum = np.cumsum(bits, dtype=np.uint32)
    return merged, cum


def merge_keys_on(s: torch.Tensor):
    """The device merge of int64 keys already on `s.device`: (sorted
    unique keys, int64 cumsum masked to 32 bits), both on the device."""
    s = torch.sort(s).values
    keep, bit = merge_mark(s)
    cum = torch.cumsum(bit, 0, dtype=torch.int64) & _MASK32
    return s[keep], cum[keep]


def merge_keys_device(keys: np.ndarray, device: torch.device):
    """merge_keys_host's result, computed on `device` (one upload, one
    sort, one merge_mark launch, one scan, one read back). Keys must lie
    below 2^63."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    if len(keys) and int(keys.max()) >= KEY_LIMIT:
        raise ValueError("merge_keys_device: keys must lie below 2^63")
    host = torch.from_numpy(keys.view(np.int64))
    if device.type == "cuda":
        host = host.pin_memory()
    merged, cum = merge_keys_on(host.to(device, non_blocking=True))
    MERGE_STATS["device_launches"] += 1
    return (
        merged.cpu().numpy().view(np.uint64),
        cum.to(torch.int32).cpu().numpy().view(np.uint32),
    )


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
