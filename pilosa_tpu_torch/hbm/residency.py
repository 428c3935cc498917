"""Extent-granular operand residency.

The port of pilosa_tpu/hbm/residency.py. A stacked query operand is
int32[S, W] (one row across S shards) or int32[D, S, W] (D BSI planes x S
shards). Staged whole, a device budget below one query's working set
re-uploads the whole operand set on every query. Here the shard axis is
cut into EXTENTS of `extent_rows` shards (the `[hbm] extent-rows` knob,
default 256), each its own entry of the holder's DeviceCache, so under
pressure only evicted extents upload again. A stack of at most
`extent_rows` shards, or any stack with `extent_rows` 0, stays one
("mono") entry.

Each extent's key carries its own slice of the fragments' versions, so a
write to one shard re-keys only the extent covering it; each entry
records the shard ids it covers, which `invalidate_owner_shard` and the
merge barrier's patch pass (core/view.py) match against.

Anti-thrash: staging pins the operand's resident extents first, then
builds the missing ones, so building extent k never evicts extent k-1.
The pins go to the plan's ExtentTable, released in the plan's dispatch
`finally` (exec/plan.py), or, without a table, right after assembly,
also on an exception.

Assembly: the extents are joined with one `torch.cat` on the device into
an operand the cache does not keep (keeping it would double residency);
a one-extent stack is the cached entry itself. No query result aliases
an operand (row-mode plans write a fresh stack, exec/plan.py), so none
outlives its pin on an entry a barrier may patch in place. The counters `assemblies`
and `assembly_bytes` count the joins. Kernels that read extents through
pointer tables, with no join, are later work. The prefetcher
(hbm/prefetch.py) stages a waiting query's extents through this layer
under `prefetching()`: what it stages counts as `prefetch_staged`, and a
query's later hit on such an extent as a `prefetch_hit`.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

import numpy as np
import torch

from pilosa_tpu_torch.core import devcache
from pilosa_tpu_torch.core.devcache import DeviceCache
from pilosa_tpu_torch.ops.bitmap import from_host

DEFAULT_EXTENT_ROWS = 256

_extent_rows = DEFAULT_EXTENT_ROWS

_stats_mu = threading.Lock()
_counters: Dict[str, int] = {
    "restage_bytes": 0,  # host -> device bytes staged through this layer
    "extent_patches": 0,  # resident entries patched in place by a barrier
    "extent_patch_batches": 0,  # or_bits launches those patches made
    "patch_upload_bytes": 0,  # host -> device bytes of the patches: tables, host-route keys
    "patch_keys": 0,  # merged keys those launches ORed into entries
    "assemblies": 0,  # torch.cat joins of extents into one operand
    "assembly_bytes": 0,  # bytes those joins wrote
    "prefetch_staged": 0,  # extents the prefetcher staged
    "prefetch_hits": 0,  # query stagings that found one of them resident
}
# extents the prefetcher staged that no query has hit yet
_prefetched_keys: Set[Tuple] = set()
_tls = threading.local()


@contextmanager
def prefetching() -> Iterator[None]:
    """Mark this thread as the prefetch worker while the block runs."""
    _tls.active = True
    try:
        yield
    finally:
        _tls.active = False


def _in_prefetch() -> bool:
    return getattr(_tls, "active", False)


def _note_acquired(key: Tuple, built: bool) -> None:
    """Book a prefetcher's staging, or a query's hit on one."""
    if _in_prefetch():
        if built:
            with _stats_mu:
                _counters["prefetch_staged"] += 1
                _prefetched_keys.add(key)
        return
    if not built:
        with _stats_mu:
            if key in _prefetched_keys:
                _prefetched_keys.discard(key)
                _counters["prefetch_hits"] += 1


def configure(extent_rows: Optional[int] = None, pin_timeout: Optional[float] = None) -> None:
    """Install the `[hbm]` knobs (cli/config.py -> server/node.py), process
    wide. extent_rows <= 0 stages every stack whole; pin_timeout is the
    stale-pin valve of every device cache."""
    global _extent_rows
    if extent_rows is not None:
        _extent_rows = int(extent_rows)
    if pin_timeout is not None:
        devcache.set_default_pin_timeout(float(pin_timeout))


def extent_rows() -> int:
    return _extent_rows


def _bump(key: str, value: int = 1) -> None:
    with _stats_mu:
        _counters[key] += value


def reset_stats() -> None:
    with _stats_mu:
        for k in _counters:
            _counters[k] = 0
        _prefetched_keys.clear()


def stats_snapshot(cache: Optional[DeviceCache] = None) -> Dict[str, int]:
    """The layer's counters, plus the cache's residency gauges when a
    cache is given."""
    with _stats_mu:
        out = dict(_counters)
    if cache is not None:
        snap = cache.stats_snapshot()
        for k in ("resident_extents", "pinned_bytes", "evicted_extent_bytes"):
            out[k] = snap[k]
    return out


def note_extent_patch(batches: int, upload_bytes: int, keys: int) -> None:
    """Book one in-place patch of a resident entry (core/view.py)."""
    with _stats_mu:
        _counters["extent_patches"] += 1
        _counters["extent_patch_batches"] += batches
        _counters["patch_upload_bytes"] += upload_bytes
        _counters["patch_keys"] += keys


class ExtentTable:
    """The extents one lowered plan's operands are pinned on. One pin per
    key moves here from staging; `release` (idempotent) unpins them."""

    __slots__ = ("cache", "_keys", "_released")

    def __init__(self, cache: DeviceCache) -> None:
        self.cache = cache
        self._keys: List[Tuple] = []
        self._released = False

    def add(self, keys: List[Tuple]) -> None:
        if self._released:
            self.cache.unpin_all(keys)
            return
        self._keys.extend(keys)

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self.cache.unpin_all(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    @property
    def keys(self) -> List[Tuple]:
        return list(self._keys)


def _stage(
    cache: DeviceCache,
    key_base: Tuple,
    n_shards: int,
    build_slice: Callable[[int, int], np.ndarray],
    shard_axis: int,
    device: torch.device,
    table: Optional[ExtentTable],
    versions: Optional[Tuple[int, ...]],
    shards: Optional[Tuple[int, ...]],
) -> torch.Tensor:
    """One device operand from per-extent cache entries; build_slice(lo,
    hi) gives the host words of shard positions [lo, hi). Every entry
    ends pinned once, the pin owned by `table` or released here."""
    rows = _extent_rows
    keys = _extent_keys(key_base, n_shards, versions)
    fresh: Set[Tuple] = set()

    def built(lo: int, hi: int, key: Tuple) -> torch.Tensor:
        arr = from_host(build_slice(lo, hi), device)
        _bump("restage_bytes", arr.numel() * 4)
        fresh.add(key)
        return arr

    if len(keys) == 1:
        key = keys[0]
        arr = cache.get_or_build(key, lambda: built(0, n_shards, key), extent=True, pin=True, shards=shards)
        _note_acquired(key, key in fresh)
        if table is not None:
            table.add([key])
        else:
            cache.unpin(key)
        return arr

    spans = [(lo, min(lo + rows, n_shards)) for lo in range(0, n_shards, rows)]
    # pass 1: pin every resident extent before building a missing one
    pinned = [cache.pin_if_present(k) for k in keys]
    held = [k for k, r in zip(keys, pinned) if r]
    parts: List[torch.Tensor] = []
    try:
        for (lo, hi), key, was_resident in zip(spans, keys, pinned):
            arr = cache.get(key) if was_resident else None
            if was_resident and arr is None:
                # invalidated between the pin and the get: rebuild
                cache.unpin(key)
                held.remove(key)
            if arr is None:
                arr = cache.get_or_build(
                    key,
                    lambda lo=lo, hi=hi, key=key: built(lo, hi, key),
                    extent=True,
                    pin=True,
                    shards=None if shards is None else shards[lo:hi],
                )
                held.append(key)
            _note_acquired(key, key in fresh)
            parts.append(arr)
    except BaseException:
        cache.unpin_all(held)
        raise
    if table is not None:
        table.add(held)
        held = []
    try:
        if len(parts) == 1:
            return parts[0]
        out = torch.cat(parts, dim=shard_axis)
        _bump("assemblies")
        _bump("assembly_bytes", out.numel() * 4)
        return out
    finally:
        cache.unpin_all(held)


def _extent_keys(key_base: Tuple, n_shards: int, versions: Optional[Tuple[int, ...]]) -> List[Tuple]:
    """The cache keys of an operand's extents: one whole-stack key, or
    one a run of _extent_rows shards."""
    rows = _extent_rows
    if rows <= 0 or n_shards <= rows:
        return [key_base if versions is None else key_base + ("mono", versions)]
    return [
        key_base + ("ext", rows, i) + (() if versions is None else (versions[lo : lo + rows],))
        for i, lo in enumerate(range(0, n_shards, rows))
    ]


def resident(cache: DeviceCache, key_base: Tuple, n_shards: int, versions: Optional[Tuple[int, ...]] = None) -> bool:
    """Whether staging this operand would copy nothing: every extent is
    cached. Pins nothing."""
    return cache.contains_all(_extent_keys(key_base, n_shards, versions))


def stage_row_stack(
    cache: DeviceCache,
    key_base: Tuple,
    n_shards: int,
    build_slice: Callable[[int, int], np.ndarray],
    device: torch.device,
    table: Optional[ExtentTable] = None,
    versions: Optional[Tuple[int, ...]] = None,
    shards: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    """int32[S, W] operand: extents cut axis 0 (the shard axis)."""
    return _stage(cache, key_base, n_shards, build_slice, 0, device, table, versions, shards)


def stage_plane_stack(
    cache: DeviceCache,
    key_base: Tuple,
    n_shards: int,
    build_slice: Callable[[int, int], np.ndarray],
    device: torch.device,
    table: Optional[ExtentTable] = None,
    versions: Optional[Tuple[int, ...]] = None,
    shards: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    """int32[D, S, W] operand: extents cut axis 1, each carrying all D
    planes of its shards."""
    return _stage(cache, key_base, n_shards, build_slice, 1, device, table, versions, shards)
