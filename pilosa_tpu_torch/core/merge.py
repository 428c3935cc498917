"""Cross-fragment merge barrier over staged ingest deltas.

The port of pilosa_tpu/core/merge.py. Staged writes (`stage_positions`)
append positions to each fragment's pending buffer; a read used to merge
them fragment by fragment (`Fragment._sync_locked`). `merge_barrier`
takes every staged fragment a read touches, packs their pending
positions into ONE uint64 key array (segment in the high bits, the
fragment position row * SHARD_WIDTH + column below), sorts and dedupes
it in one pass (on the device at or above `device_threshold`, one
vectorized host pass below it: ops/merge.py) and hands each fragment its
merged slice back as a parked delta layer. The host row store takes the
layer at the fragment's next host read; the device is kept exact at once
by ORing the same merged keys into the resident stack entries
(core/view.py), from where they already are: the device route's merge
leaves them on the card, the host route uploads each group's once.

Handshake (no fragment lock is held across another's, and none during
the merge): `pending_snapshot` records, under each fragment's lock, its
pending parts, their count, `_pending_gen` and `_staged_base_version`,
popping nothing, so a reader in `_sync_locked` mid-merge still merges
everything itself. `apply_merged_delta` re-checks the generation under
the lock: if a reader merged the captured parts meanwhile, the apply is
skipped; otherwise the parts are trimmed, the layer parks and the
generation moves.

Device merges are split by fragment groups so one launch's keys and
scratch (about 64 bytes a key) fit the free device memory; each group is
one launch and one `MERGE_STATS["device_launches"]`.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.ops import merge as ops_merge
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WIDTH_EXPONENT

# AUTO crossover on a CUDA device: bursts of at least this many staged
# positions merge on the card; on the CPU the host pass always wins
ACCEL_DEVICE_THRESHOLD = 65536
# device bytes one key needs through the sort, mark, scan and compaction
_DEVICE_BYTES_PER_KEY = 64

_device_threshold: Optional[int] = None

_stats_mu = threading.Lock()
_counters: Dict[str, float] = {
    "barrier_ms": 0.0,  # wall ms in barriers that merged something
    "merge_ms": 0.0,  # of which in the key merges themselves
    "barriers": 0,  # such barriers
    "batches": 0,  # staged buffers merged (barrier or per fragment)
    "device": 0,  # barriers that merged on the device
    "positions": 0,  # raw staged positions merged by barriers
}

_UNSET = object()


def configure(device_threshold=_UNSET) -> None:
    """Install the `[ingest] merge-device-threshold` knob, process wide:
    None selects AUTO, < 0 keeps every merge on the host, 0 sends every
    merge to the device."""
    global _device_threshold
    if device_threshold is not _UNSET:
        _device_threshold = None if device_threshold is None else int(device_threshold)


def device_threshold(device: Optional[torch.device] = None) -> int:
    """The resolved crossover for merges whose fragments live on
    `device` (AUTO: ACCEL_DEVICE_THRESHOLD on CUDA, -1 on the CPU)."""
    if _device_threshold is not None:
        return _device_threshold
    return ACCEL_DEVICE_THRESHOLD if device is not None and device.type == "cuda" else -1


def reset_stats() -> None:
    with _stats_mu:
        for k in _counters:
            _counters[k] = 0.0 if k.endswith("_ms") else 0


def note_host_sync(n_batches: int) -> None:
    """Book a per-fragment merge of `n_batches` staged buffers, so
    `batches` counts every buffer once however it was merged."""
    with _stats_mu:
        _counters["batches"] += n_batches


def stats_snapshot() -> Dict[str, float]:
    with _stats_mu:
        return dict(_counters)


class GroupKeys:
    """One barrier group's merged keys, sorted and unique, which every
    FragMerge of the group indexes with its key ranges: the host array,
    and the keys on the device the patches run on. The device route
    keeps the tensor its merge made; the host route uploads once, from
    pinned memory, when the first entry needs a patch. A stream other
    than the one the keys were made on waits for them, and the tensor is
    recorded on it, so the keys outlive every launch that reads them."""

    __slots__ = ("host", "_dev", "_stream", "_ready")

    def __init__(self, host: np.ndarray, dev: Optional[torch.Tensor] = None):
        self.host = host
        self._dev = dev
        self._stream = self._ready = None
        if dev is not None and dev.is_cuda:
            self._mark(dev.device)

    def _mark(self, device: torch.device) -> None:
        self._stream = torch.cuda.current_stream(device)
        self._ready = torch.cuda.Event()
        self._ready.record(self._stream)

    def on(self, device: torch.device):
        """(the keys as int64 on `device`, the bytes this call uploaded)."""
        uploaded = 0
        if self._dev is None:
            host = torch.from_numpy(self.host.view(np.int64))
            if device.type == "cuda":
                self._dev = host.pin_memory().to(device, non_blocking=True)
                self._mark(device)
                uploaded = self.host.nbytes
            else:
                self._dev = host
        if self._stream is not None:
            stream = torch.cuda.current_stream(device)
            if stream != self._stream:
                stream.wait_event(self._ready)
                self._dev.record_stream(stream)
        return self._dev, uploaded


class FragMerge:
    """One fragment's barrier outcome: for each row id the merge touched,
    the [start, end) range of its keys in the group's merged `keys`
    (GroupKeys, shared by the group's FragMerges). `clean` means the
    fragment moved from `base_version` to `new_version` by exactly the
    captured staged batches, so an entry keyed at `base_version` can be
    patched in place to `new_version`."""

    __slots__ = (
        "frag", "shard", "applied", "clean", "base_version", "new_version", "keys", "_ranges", "old_words",
    )

    def __init__(self, frag, keys: GroupKeys, rows, starts, ends):
        self.frag = frag
        self.shard = frag.shard
        self.applied = False
        self.clean = False
        self.base_version = -1
        self.new_version = -1
        self.keys = keys
        self._ranges = dict(zip(rows, zip(starts, ends)))
        # row id -> host words at base_version, taken before the layer
        # parked, for the rows cached Counts watch (core/resultcache.py)
        self.old_words: Dict[int, np.ndarray] = {}

    @property
    def rows(self) -> List[int]:
        """The row ids the merge touched, ascending."""
        return list(self._ranges)

    def word_delta(self, row_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """(word indexes, OR-ed bits) of this row's merged delta, from the
        host copy of its merged keys (the Count repair's input)."""
        s, e = self._ranges[row_id]
        cols = (self.keys.host[s:e] & np.uint64(SHARD_WIDTH - 1)).astype(np.int64)
        if not len(cols):
            return np.empty(0, np.int64), np.empty(0, np.uint32)
        widx = cols >> 5
        bits = np.left_shift(np.uint32(1), (cols & 31).astype(np.uint32))
        first = np.flatnonzero(np.concatenate(([True], widx[1:] != widx[:-1])))
        return widx[first], np.bitwise_or.reduceat(bits, first)

    def key_range(self, row_id: int) -> Optional[Tuple[int, int]]:
        """[start, end) of this row's merged keys in `keys`, or None when
        the merge did not touch the row. Every key in it is
        segment * span + row * SHARD_WIDTH + column, with a span that is
        a SHARD_WIDTH multiple, so key & (SHARD_WIDTH - 1) is the column."""
        return self._ranges.get(row_id)


def _repair_interest(frag) -> set:
    """Rows of the fragment's (index, field, view) that repairable cached
    Counts watch; with no such Count, one dict lookup and nothing read."""
    from pilosa_tpu_torch.core.resultcache import RESULT_CACHE

    return RESULT_CACHE.interest_rows(frag.index, frag.field, frag.view)


def _groups(caps, device: torch.device, use_device: bool) -> List[list]:
    """Split the captures into groups whose keys fit one device merge,
    beside the merged keys of every group, which stay on the device
    (8 bytes a key) until the barrier's patches are enqueued."""
    if not use_device or device.type != "cuda":
        return [caps]
    free, _ = torch.cuda.mem_get_info(device)
    kept = 8 * sum(len(p) for c in caps for p in c[1])
    cap_keys = max(1, (free - kept) // _DEVICE_BYTES_PER_KEY)
    groups, cur, n = [], [], 0
    for c in caps:
        k = sum(len(p) for p in c[1])
        if cur and n + k > cap_keys:
            groups.append(cur)
            cur, n = [], 0
        cur.append(c)
        n += k
    groups.append(cur)
    return groups


def merge_barrier(frags) -> List[FragMerge]:
    """Merge the pending deltas of every staged fragment in `frags` in one
    batched pass. Returns a FragMerge per fragment whose delta was
    captured (applied or not). Mutex fragments never stage."""
    staged = [f for f in frags if f is not None and f._pending_n]
    if not staged:
        return []
    t0 = time.perf_counter()
    caps = []
    for f in staged:
        snap = f.pending_snapshot()
        if snap is not None:
            caps.append((f,) + snap)
    if not caps:
        return []
    device = caps[0][0].device
    n_pos = sum(len(p) for c in caps for p in c[1])
    thr = device_threshold(device)
    use_device = thr >= 0 and n_pos >= thr
    out: List[FragMerge] = []
    n_batches = 0
    merged_any = False
    for group in _groups(caps, device, use_device):
        res = _merge_group(group, device, use_device)
        if res is None:
            continue
        merged_any = True
        fms, nb = res
        out.extend(fms)
        n_batches += nb
    if not merged_any:
        return out
    dt_ms = (time.perf_counter() - t0) * 1000.0
    with _stats_mu:
        _counters["barrier_ms"] += dt_ms
        _counters["barriers"] += 1
        _counters["batches"] += n_batches
        _counters["positions"] += n_pos
        if use_device:
            _counters["device"] += 1
    return out


def _merge_group(caps, device: torch.device, use_device: bool):
    """One merge over a group of captures: ([FragMerge], batches applied),
    or None when the packing would pass 2^63 (each fragment then merges
    on its own)."""
    parts_flat: List[np.ndarray] = []
    part_seg: List[int] = []
    for i, cap in enumerate(caps):
        for part in cap[1]:
            parts_flat.append(part)
            part_seg.append(i)
    combined = parts_flat[0] if len(parts_flat) == 1 else np.concatenate(parts_flat)
    # per-fragment span, a SHARD_WIDTH multiple: key >> SHARD_WIDTH_EXPONENT
    # stays (segment, row) unique and the low 5 bits stay the word's bit
    max_pos = int(combined.max())
    row_span = ((max_pos >> SHARD_WIDTH_EXPONENT) + 1) << SHARD_WIDTH_EXPONENT
    if len(caps) * row_span >= ops_merge.KEY_LIMIT:
        for cap in caps:
            cap[0].sync_pending_now()
        return None
    if len(caps) > 1 or part_seg[0]:
        seg_off = np.repeat(
            np.array(part_seg, np.uint64) * np.uint64(row_span), [len(p) for p in parts_flat]
        )
        combined = combined + seg_off
    rows_per_seg = row_span >> SHARD_WIDTH_EXPONENT

    t0 = time.perf_counter()
    if use_device:
        keys = GroupKeys(*ops_merge.merge_keys_device(combined, device))
    else:
        keys = GroupKeys(ops_merge.merge_keys_host(combined))
    merged = keys.host
    merge_ms = (time.perf_counter() - t0) * 1000.0
    with _stats_mu:
        _counters["merge_ms"] += merge_ms

    seg_edges = np.searchsorted(merged, np.arange(len(caps) + 1, dtype=np.uint64) * np.uint64(row_span))
    local = merged - np.repeat(np.arange(len(caps), dtype=np.uint64) * np.uint64(row_span), np.diff(seg_edges))
    rowkeys = merged >> np.uint64(SHARD_WIDTH_EXPONENT)
    bounds = np.flatnonzero(rowkeys[1:] != rowkeys[:-1]) + 1
    starts_g = np.concatenate(([0], bounds)).astype(np.int64)
    ends_g = np.concatenate((bounds, [len(merged)])).astype(np.int64)
    rk_start = rowkeys[starts_g]
    row_of = (rk_start % np.uint64(rows_per_seg)).astype(np.int64).tolist()
    starts_l = starts_g.tolist()
    ends_l = ends_g.tolist()
    frag_edges = np.searchsorted(rk_start, np.arange(len(caps) + 1, dtype=np.uint64) * np.uint64(rows_per_seg)).tolist()
    seg_edges_l = seg_edges.tolist()

    out: List[FragMerge] = []
    n_batches = 0
    for i, (f, parts, n_parts, gen, base_version) in enumerate(caps):
        rlo, rhi = frag_edges[i], frag_edges[i + 1]
        if rlo == rhi:
            continue
        fm = FragMerge(f, keys, row_of[rlo:rhi], starts_l[rlo:rhi], ends_l[rlo:rhi])
        fm.base_version = base_version
        # Count repair: the host words at base_version of every row a
        # cached Count watches (untouched ones too: a tree patch needs
        # them from the same snapshot), read before the layer parks. A
        # host read merging between here and the apply moves the
        # generation and the capture goes with the failed FragMerge.
        for rid in _repair_interest(f):
            fm.old_words[rid] = f.premerge_row_words(rid)
        # the layer is a copy: a view would pin the group's merged array
        res = f.apply_merged_delta(
            local[seg_edges_l[i] : seg_edges_l[i + 1]].copy(), n_parts, sum(map(len, parts)), gen
        )
        if res is not None:
            # pending parts are a contiguous version range (any other
            # mutation drains pending first, under the lock), so the
            # captured delta moves the content exactly base -> base + n
            fm.applied = True
            fm.clean = True
            fm.new_version = base_version + n_parts
            n_batches += n_parts
        out.append(fm)
    return out, n_batches
